"""Sharded training state as a layout — the counterpart of
:mod:`tpudist.parallel.fsdp`.

In the JAX package FSDP (ZeRO-3), ZeRO-1 and tensor parallelism are
layouts: a ``NamedSharding`` a leaf of the state, and the SPMD partitioner
inserts the collectives.  Here a layout is a plan, a :class:`Layout`: for
every leaf of the state — each parameter and, when an optimizer is given,
each leaf of the optimizer state the JAX package's optax chain would hold —
its spec on the mesh axes, one entry a dimension of the port's tensor
(``None``: not split), and the leaf's shape and item size.  The runtime that
carries a plan out around the train step is :mod:`tpudist_torch.parallel.
zero` (``make_lm_train_step(state_sharding=...)``).

The rules are the JAX package's: :func:`_leaf_spec` shards a leaf's largest
dimension that the axis divides (the first on a tie), replicating leaves of
fewer than ``min_size`` elements.  The port stores linear weights ``[out,
in]`` where flax keeps kernels ``[in, out]``; a module lists those weights
in ``jax_transposed`` and the rule is decided on the JAX-shaped view, so
that a square ``proj`` shards the same logical dimension as in JAX.

The optimizer leaves mirror optax's state trees (:func:`optimizer_leaves`):
Adam/AdamW keep ``mu`` and ``nu`` a parameter, Lion ``mu``, Adafactor
``v_row``, ``v_col`` and ``v`` with optax's ``(1,)`` placeholders; each
optax step counter is one int32 scalar, where the port's optimizers keep a
``step`` a parameter (one counter for the chain, a second for a learning
rate schedule, as optax's ``scale_by_schedule``).  So
:func:`state_bytes_per_device` counts the same bytes as JAX's on the same
tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpudist_torch.parallel.overlap import (ag_matmul, axis_ring,
                                            overlap_mode)
from tpudist_torch.parallel.ring import LocalRing
from tpudist_torch.runtime.mesh import AXIS_DATA

__all__ = ["Layout", "Leaf", "fsdp_sharding", "merge_shardings",
           "optimizer_leaves", "overlap_fsdp_mlp", "overlap_mode",
           "param_leaves",
           "state_bytes_per_device", "zero1_sharding"]

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the state: its shape as the port holds it, whether the
    JAX package holds it transposed (a linear weight), its item size, and
    its spec on the port's dimensions."""

    shape: Tuple[int, ...]
    transposed: bool
    itemsize: int
    spec: Spec

    @property
    def jax_shape(self) -> Tuple[int, ...]:
        return tuple(reversed(self.shape)) if self.transposed else self.shape

    @property
    def jax_spec(self) -> Spec:
        """The spec on the JAX-shaped view (the JAX package's ``P``)."""
        return tuple(reversed(self.spec)) if self.transposed else self.spec

    def replicated(self) -> bool:
        return all(a is None for a in self.spec)

    def split(self) -> Tuple[Optional[int], Optional[str]]:
        """``(dimension, axis)`` of the split, ``(None, None)`` when
        replicated (a leaf splits over one axis at most here)."""
        for d, a in enumerate(self.spec):
            if a is not None:
                return d, a
        return None, None


@dataclasses.dataclass(frozen=True)
class Layout:
    """A plan over the state: ``leaves`` maps a key — a parameter's name,
    or ``opt/<name>/<slot>`` and ``opt/count<i>`` for the optimizer state —
    to its :class:`Leaf`; ``mesh`` is the port's mesh the specs name axes
    of (its process groups carry the plan out)."""

    leaves: Dict[str, Leaf]
    axis_sizes: Dict[str, int]
    mesh: object = dataclasses.field(default=None, compare=False)

    @property
    def params(self) -> Dict[str, Leaf]:
        return {k: v for k, v in self.leaves.items()
                if not k.startswith("opt/")}

    @property
    def opt_state(self) -> Dict[str, Leaf]:
        return {k: v for k, v in self.leaves.items() if k.startswith("opt/")}


def _leaf_spec(shape, n: int, axis_name: str, min_size: int) -> Spec:
    """Shard the largest dimension divisible by ``n``; replicate leaves that
    are small (gather overhead beats the memory win) or indivisible — the
    JAX package's rule on a shape, as a tuple spec."""
    shape = tuple(shape)
    if len(shape) == 0 or np.prod(shape) < min_size:
        return (None,) * len(shape)
    candidates = [d for d in range(len(shape)) if shape[d] % n == 0]
    if not candidates:
        return (None,) * len(shape)
    dim = max(candidates, key=lambda d: shape[d])
    spec = [None] * len(shape)
    spec[dim] = axis_name
    return tuple(spec)


def _transposed(model, name: str) -> bool:
    # the MoE FFN keeps the JAX package's [E, in, out] stacks as they are
    words = name.split(".")
    return words[-1] in getattr(model, "jax_transposed", ()) and \
        "moe" not in words


def param_leaves(model: torch.nn.Module) -> Dict[str, tuple]:
    """``{name: (shape, transposed, itemsize)}`` of ``model``'s parameters,
    ``transposed`` for each ``jax_transposed`` weight."""
    return {name: (tuple(p.shape), _transposed(model, name),
                   p.element_size())
            for name, p in model.named_parameters()}


def _factored(jax_shape, min_dim: int = 128):
    if len(jax_shape) < 2:
        return None
    order = np.argsort(jax_shape)
    if jax_shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def optimizer_leaves(model: torch.nn.Module, optimizer) -> Dict[str, tuple]:
    """The leaves of the optax state the JAX package's
    ``build_optimizer`` would hold for ``optimizer`` (built by
    :func:`tpudist_torch.train.optim.build_optimizer` or a torch Adam/AdamW)
    over ``model``'s parameters, as ``{key: (shape, transposed, itemsize)}``:
    ``counters`` int32 scalars (``optimizer.jax_counters``, 1 by default),
    then each parameter's slots."""
    from tpudist_torch.train.optim import Adafactor, Lion

    counters = int(getattr(optimizer, "jax_counters", 1))
    out = {f"opt/count{i}": ((), False, 4) for i in range(counters)}
    for name, (shape, t, itemsize) in param_leaves(model).items():
        def slot(key, port_shape, transposed=t):
            out[f"opt/{name}/{key}"] = (tuple(int(n) for n in port_shape),
                                        transposed, itemsize)

        if isinstance(optimizer, Adafactor):
            jax_shape = tuple(reversed(shape)) if t else shape
            dims = _factored(jax_shape)
            if dims is None:
                slot("v_row", (1,), False)
                slot("v_col", (1,), False)
                slot("v", shape)
            else:
                d1, d0 = dims
                slot("v_row", np.delete(jax_shape, d0), False)
                slot("v_col", np.delete(jax_shape, d1), False)
                slot("v", (1,), False)
        elif isinstance(optimizer, Lion):
            slot("mu", shape)
        else:
            slot("mu", shape)
            slot("nu", shape)
    return out


def _axis_size(mesh, axis_name: str) -> int:
    shape = getattr(mesh, "shape", mesh)
    return int(shape.get(axis_name, 1))


def make_layout(leaves: Dict[str, Leaf], mesh) -> Layout:
    """A :class:`Layout` of ``leaves`` on ``mesh`` (the port's mesh, or a
    ``{axis: size}`` dict for the rule alone)."""
    return Layout(leaves, dict(getattr(mesh, "shape", mesh)),
                  mesh if hasattr(mesh, "shape") else None)


def _rule(leaves: Dict[str, tuple], n: int, axis_name: str,
          min_size: int) -> Dict[str, Leaf]:
    out = {}
    for key, (shape, transposed, itemsize) in leaves.items():
        leaf = Leaf(shape, transposed, itemsize, ())
        jspec = _leaf_spec(leaf.jax_shape, n, axis_name, min_size)
        out[key] = dataclasses.replace(
            leaf, spec=tuple(reversed(jspec)) if transposed else jspec)
    return out


def fsdp_sharding(mesh, model: torch.nn.Module, optimizer=None, *,
                  axis_name: str = AXIS_DATA,
                  min_size: int = 1024) -> Layout:
    """ZeRO-3 layout of ``model``'s parameters and, when ``optimizer`` is
    given, of its state: every leaf of at least ``min_size`` elements
    sharded along its largest ``axis_name``-divisible dimension (decided on
    the JAX-shaped view), the rest replicated.  ``mesh`` is the port's mesh
    (or a ``{axis: size}`` dict for the rule alone)."""
    n = _axis_size(mesh, axis_name)
    leaves = param_leaves(model)
    if optimizer is not None:
        leaves.update(optimizer_leaves(model, optimizer))
    return make_layout(_rule(leaves, n, axis_name, min_size), mesh)


def zero1_sharding(mesh, model: torch.nn.Module, optimizer, *,
                   axis_name: str = AXIS_DATA,
                   min_size: int = 1024) -> Layout:
    """ZeRO-1: the parameters replicated, the optimizer state sharded by
    the FSDP rule — each rank updates its slice of the moments and one
    all-gather of the updated parameters runs a step."""
    n = _axis_size(mesh, axis_name)
    params = {k: Leaf(s, t, i, (None,) * len(s))
              for k, (s, t, i) in param_leaves(model).items()}
    opt = _rule(optimizer_leaves(model, optimizer), n, axis_name, min_size)
    return make_layout({**params, **opt}, mesh)


def merge_shardings(primary: Layout, fallback: Layout) -> Layout:
    """Leaf-wise composition: ``primary``'s spec unless it is fully
    replicated, else ``fallback``'s — e.g. TP where it splits, FSDP for
    everything TP leaves replicated."""
    if set(primary.leaves) != set(fallback.leaves):
        raise ValueError("merge_shardings needs two layouts of one state")
    leaves = {k: (fallback.leaves[k] if v.replicated() else v)
              for k, v in primary.leaves.items()}
    sizes = {**fallback.axis_sizes, **primary.axis_sizes}
    return Layout(leaves, sizes, primary.mesh or fallback.mesh)


def state_bytes_per_device(layout: Layout) -> int:
    """Analytic per-device bytes of the state under ``layout`` (replicated
    leaves count whole, sharded ones their shard), the JAX accounting:
    integer division of the leaf's bytes by its axes' sizes."""
    total = 0
    for leaf in layout.leaves.values():
        size = int(math.prod(leaf.shape or (1,)))
        div = 1
        for axis in leaf.spec:
            if axis is not None:
                div *= layout.axis_sizes[axis]
        total += size * leaf.itemsize // div
    return total


def overlap_fsdp_mlp(mesh, *, axis_name: str = AXIS_DATA,
                     overlap: Optional[str] = None, activation=None):
    """The overlapped FSDP MLP, an ``mlp_fn(params, x) -> y`` for the
    Block's dense-FFN seam (``create_transformer(mlp_fn=...)``), or
    ``None`` when the mode (:func:`~tpudist_torch.parallel.overlap.
    overlap_mode` of ``overlap``) resolves to off, the JAX function's
    return for the dense path.

    ``params`` are this rank's pieces of the block's FFN kernels in the
    JAX layout, as the FSDP layout leaves them: ``wi [d, ff/n]`` (a column
    shard) and ``wo [ff/n, d]`` (a contraction shard), over the ``n`` ranks
    of ``mesh``'s ``axis_name`` axis; ``x [b, s, d]`` this rank's rows.
    ``wi`` is gathered by columns into the first matmul (``ag_matmul``
    ``gather='rhs'``: the same numbers as the whole matmul), ``wo`` by
    contraction into the second (``'contract'``: one partial product a
    hop), each hop a send/receive on the process group, so no all-gather of
    either kernel runs.  The pieces' gradients come out of the hops'
    backward already summed over the axis.  ``mlp_fn.pieces(wi, wo)`` cuts
    this rank's pieces from whole kernels (the Block does so when its
    weights are not sharded).  ``activation`` defaults to the Block's
    tanh GELU."""
    import torch.nn.functional as F

    mode = overlap_mode(overlap)
    if mode == "off":
        return None
    ring = axis_ring(mesh, axis_name)
    if isinstance(ring, LocalRing) and ring.size > 1:
        raise ValueError(f"the overlapped FSDP MLP pipelines over the ranks "
                         f"of an axis; the {axis_name!r} axis is one rank's "
                         "devices")
    act = activation if activation is not None else (
        lambda t: F.gelu(t, approximate="tanh"))

    def mlp_fn(params: dict, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        t = x.reshape(b * s, d)
        h = act(ag_matmul(t, params["wi"], axis=ring, mode=mode,
                          gather="rhs"))
        y = ag_matmul(h, params["wo"], axis=ring, mode=mode,
                      gather="contract")
        return y.reshape(b, s, d).to(x.dtype)

    def pieces(wi: torch.Tensor, wo: torch.Tensor):
        n, i = ring.size, ring.indices[0]
        return wi.chunk(n, 1)[i], wo.chunk(n, 0)[i]

    mlp_fn.overlap, mlp_fn.axis_name = mode, axis_name
    mlp_fn.ring, mlp_fn.pieces = ring, pieces
    return mlp_fn
