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

The overlapped bodies (``tp_mlp_overlap_shard``, ``make_tp_mlp(overlap=
'ring'|'bidir')``, the ``TPUDIST_OVERLAP`` knob) are A6c's collective
matmuls and raise.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from tpudist_torch.parallel.fsdp import overlap_mode
from tpudist_torch.runtime.mesh import AXIS_MODEL

__all__ = ["column_spec", "init_mlp_params", "make_tp_mlp",
           "mlp_param_sharding", "row_spec", "shard_mlp_params",
           "tp_mlp_overlap_shard", "tp_mlp_shard"]

_A6C_OVERLAP = ("the overlapped (collective-matmul) TP MLP is not ported "
                "yet: ROADMAP queue A, item A6c (parallel/overlap.py)")


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


def tp_mlp_overlap_shard(*args, **kwargs):
    """The collective-matmul body: A6c."""
    raise NotImplementedError(_A6C_OVERLAP)


def make_tp_mlp(mesh, *, axis_name: str = AXIS_MODEL, batch_axis=None,
                activation: Callable = _gelu, overlap=None) -> Callable:
    """``mlp(params, x) -> y``: whole ``params`` (the JAX function's
    global view) cut over the mesh's model devices, ``x [batch, d]`` this
    rank's rows (its share of the ``data`` batch when ``batch_axis`` is
    ``'data'``: the process group splits the batch, nothing here does),
    run through :func:`tp_mlp_shard`.  ``overlap`` other than ``None`` /
    ``'off'`` (and the ``TPUDIST_OVERLAP`` knob) is A6c's."""
    if overlap_mode(overlap) != "off":
        raise NotImplementedError(_A6C_OVERLAP)
    if batch_axis not in (None, "data"):
        raise ValueError(f"batch_axis must be None or 'data', got "
                         f"{batch_axis!r}")
    devices = tuple(mesh.devices)
    if len(devices) != mesh.shape.get(axis_name, 1):
        raise ValueError(f"the mesh's {axis_name} axis has "
                         f"{mesh.shape.get(axis_name, 1)} places but "
                         f"{len(devices)} devices")

    def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
        return tp_mlp_shard(shard_mlp_params(params, devices), x,
                            activation=activation)

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
