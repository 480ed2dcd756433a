"""Tensor parallelism: the Megatron column/row pair — the counterpart of
:mod:`tpudist.parallel.tensor_parallel`.

The ``model`` axis is the devices one rank owns (:mod:`tpudist_torch.
runtime.mesh`; on one card the shards fold onto it).  An MLP ``{'w1': [d,
f], 'b1': [f], 'w2': [f, d], 'b2': [d]}`` (kernels ``[in, out]``, as the
JAX package holds them) splits ``w1`` and ``b1`` by columns and ``w2`` by
rows, one slice a model device (:func:`mlp_param_sharding` names the specs,
:func:`shard_mlp_params` cuts the slices); :func:`tp_mlp_shard` runs the
pair with one sum of the partial outputs — Megatron's ``f`` (the input to
every device, the gradients summed back) and ``g`` (the partials summed,
the gradient to every device), autograd functions of
:mod:`tpudist_torch.models.transformer`.  The whole transformer's split is
:func:`tpudist_torch.models.transformer.transformer_tp_sharding` with its
:class:`~tpudist_torch.models.transformer.TPBlock`.

:func:`tp_mlp_overlap_shard` is the pair with no monolithic collective:
the batch arrives sharded over the model devices, the input gather is
pipelined into the first matmul and the reduction is a pipelined
reduce-scatter fused into the second (:mod:`tpudist_torch.parallel.
overlap`), so the output comes back batch-sharded.  ``make_tp_mlp(overlap=
'ring'|'bidir')`` (or the ``TPUDIST_OVERLAP`` knob) runs it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from tpudist_torch.parallel.overlap import (ag_matmul, matmul_rs,
                                            overlap_mode)
from tpudist_torch.parallel.ring import LocalRing
from tpudist_torch.runtime.mesh import AXIS_MODEL

__all__ = ["column_spec", "init_mlp_params", "make_tp_mlp",
           "mlp_param_sharding", "row_spec", "shard_mlp_params",
           "tp_mlp_overlap_shard", "tp_mlp_shard"]

def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def column_spec(axis_name: str = AXIS_MODEL) -> tuple:
    """Weight ``[in, out]`` split on ``out``."""
    return (None, axis_name)


def row_spec(axis_name: str = AXIS_MODEL) -> tuple:
    """Weight ``[in, out]`` split on ``in``: partial sums, summed after."""
    return (axis_name, None)


def mlp_param_sharding(mesh, params: dict, *,
                       axis_name: str = AXIS_MODEL) -> Dict[str, tuple]:
    """The specs of a ``{'w1','b1','w2','b2'}`` MLP: ``w1`` column-split,
    ``w2`` row-split, ``b1`` split to match, ``b2`` replicated."""
    specs = {"w1": column_spec(axis_name), "b1": (axis_name,),
             "w2": row_spec(axis_name), "b2": (None,)}
    return {k: specs[k] for k in params}


def shard_mlp_params(params: dict, devices: Sequence) -> List[dict]:
    """One ``{'w1','b1','w2','b2'}`` dict a model device: its column slice
    of ``w1``/``b1``, its row slice of ``w2``, ``b2`` on the first device
    only (added once, after the sum).  Differentiable: the slices' gradients
    reach ``params``."""
    m = len(devices)
    f = params["w1"].shape[1]
    if f % m:
        raise ValueError(f"hidden width {f} does not divide over a model "
                         f"axis of {m}")
    k = f // m
    out = []
    for i, dev in enumerate(devices):
        cols = slice(i * k, (i + 1) * k)
        part = {"w1": params["w1"][:, cols].to(dev),
                "b1": params["b1"][cols].to(dev),
                "w2": params["w2"][cols].to(dev)}
        if i == 0:
            part["b2"] = params["b2"].to(dev)
        out.append(part)
    return out


def tp_mlp_shard(shards: Sequence[dict], x: torch.Tensor, *,
                 activation: Callable = _gelu) -> torch.Tensor:
    """The column→row pair over the model devices' ``shards``
    (:func:`shard_mlp_params`) for ``x [batch, d]`` replicated over them:
    ``act(x·w1 + b1)`` on each, its partial ``·w2``, one sum (``g``) on
    ``x``'s device, ``+ b2``."""
    from tpudist_torch.models.transformer import _CopyToShards, _SumShards

    devices = tuple(s["w1"].device for s in shards)
    xs = _CopyToShards.apply(devices, x)
    parts = [activation(xi @ s["w1"] + s["b1"]) @ s["w2"]
             for xi, s in zip(xs, shards)]
    return _SumShards.apply(x.device, *parts) + shards[0]["b2"].to(x.device)


def tp_mlp_overlap_shard(shards: Sequence[dict], xs: Sequence[torch.Tensor],
                         *, activation: Callable = _gelu,
                         mode: str = "ring") -> List[torch.Tensor]:
    """The collective-matmul twin of :func:`tp_mlp_shard`: the same weight
    shards (:func:`shard_mlp_params`), but ``xs`` are the model devices'
    row chunks of the batch (``[batch/n, d]`` each, on its shard's device).
    ``allgather(x)·w1`` is pipelined over a ring of the shards' devices
    (:func:`~tpudist_torch.parallel.overlap.ag_matmul`, ``gather='lhs'``)
    and the row-parallel sum is a pipelined reduce-scatter fused into
    ``·w2`` (:func:`~tpudist_torch.parallel.overlap.matmul_rs`): each device
    returns its own rows of the output, ``+ b2``.  The gather half gives
    the same numbers as :func:`tp_mlp_shard`; the reduce-scatter sums the
    partials in ring order."""
    ring = LocalRing(len(shards), devices=[s["w1"].device for s in shards])
    h = ag_matmul(list(xs), [s["w1"] for s in shards], axis=ring, mode=mode,
                  gather="lhs")
    h = [activation(hi + s["b1"]) for hi, s in zip(h, shards)]
    out = matmul_rs(h, [s["w2"] for s in shards], axis=ring, mode=mode)
    b2 = shards[0]["b2"]
    return [o + b2.to(o.device) for o in out]


def make_tp_mlp(mesh, *, axis_name: str = AXIS_MODEL, batch_axis=None,
                activation: Callable = _gelu, overlap=None) -> Callable:
    """``mlp(params, x) -> y``: whole ``params`` (the JAX function's
    global view) cut over the mesh's model devices, ``x [batch, d]`` this
    rank's rows (its share of the ``data`` batch when ``batch_axis`` is
    ``'data'``: the process group splits the batch, nothing here does),
    run through :func:`tp_mlp_shard`.  ``overlap`` (``None``: the
    ``TPUDIST_OVERLAP`` knob, :func:`~tpudist_torch.parallel.overlap.
    overlap_mode`) ``'ring'``/``'bidir'`` runs :func:`tp_mlp_overlap_shard`
    instead: the batch (which must divide by the model axis) is cut into
    one row chunk a device and the chunks' outputs joined on ``x``'s
    device; ``batch_axis`` must then be ``None``, as in JAX (the model axis
    carries the batch pipeline)."""
    mode = overlap_mode(overlap)
    if mode != "off" and batch_axis is not None:
        raise ValueError(
            "overlapped TP MLP pipelines the batch over the model axis; "
            "batch_axis must be None")
    if batch_axis not in (None, "data"):
        raise ValueError(f"batch_axis must be None or 'data', got "
                         f"{batch_axis!r}")
    devices = tuple(mesh.devices)
    if len(devices) != mesh.shape.get(axis_name, 1):
        raise ValueError(f"the mesh's {axis_name} axis has "
                         f"{mesh.shape.get(axis_name, 1)} places but "
                         f"{len(devices)} devices")

    def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
        shards = shard_mlp_params(params, devices)
        if mode == "off":
            return tp_mlp_shard(shards, x, activation=activation)
        if x.shape[0] % len(devices):
            raise ValueError(f"a batch of {x.shape[0]} rows does not divide "
                             f"over a model axis of {len(devices)}")
        xs = [c.to(d) for c, d in zip(x.chunk(len(devices)), devices)]
        out = tp_mlp_overlap_shard(shards, xs, activation=activation,
                                   mode=mode)
        return torch.cat([o.to(x.device) for o in out])

    return mlp


def init_mlp_params(generator: torch.Generator, d_model: int,
                    d_hidden: int) -> dict:
    """The dense MLP, drawn from ``generator`` (on the CPU): normal kernels
    scaled by ``1/√fan_in``, zero biases, as the JAX function draws them
    (not the same numbers: tests carry the JAX arrays across)."""
    w1 = torch.randn(d_model, d_hidden, generator=generator) / d_model ** 0.5
    w2 = torch.randn(d_hidden, d_model, generator=generator) / d_hidden ** 0.5
    return {"w1": w1, "b1": torch.zeros(d_hidden), "w2": w2,
            "b2": torch.zeros(d_model)}
