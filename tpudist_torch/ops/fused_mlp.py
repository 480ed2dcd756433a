"""The toy MLP forward in one kernel.

The PyTorch/CUDA counterpart of :mod:`tpudist.ops.fused_mlp`: ``h = x``,
then ``h = leaky(h @ W_i + b_i)`` for every layer but the last, which has
no activation (LeakyReLU slope 0.01), all in f32 with full-f32 products.

:func:`pack_params` packs a weight set once — the counterpart of
``pad_params``, but at the layers' true widths: one contiguous f32 buffer
(per layer ``W [d_in, d_out]`` row-major, then ``b [d_out]``) and a small
int32 table of the widths, both on the weights' device.  :func:`fused_mlp`
then runs the forward per batch: on a CUDA tensor it launches the
hand-written kernel ``csrc/fused_mlp.cu`` (or raises), on a CPU tensor it
runs :func:`mlp_reference`, the plain chain of ``x @ w + b`` and ``where``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from tpudist_torch.ops import _build

#: the widest layer the kernel takes (the JAX kernel's ``LANE`` tile)
LANE = 128
#: LeakyReLU's negative slope (torch.nn.LeakyReLU's default)
NEGATIVE_SLOPE = 0.01


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_fused_mlp.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i,
                                  p]
    lib.tpd_fused_mlp.restype = i


@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """A weight set packed for :func:`fused_mlp` by :func:`pack_params`."""

    params: torch.Tensor  # f32 [sum of d_in * d_out + d_out over layers]
    widths: Tuple[int, ...]  # (d_in, d_1, ..., d_out)
    table: torch.Tensor  # int32 [n_layers + 1], ``widths`` on the device
    max_layer_floats: int  # the longest layer's share of ``params``

    @property
    def d_out(self) -> int:
        return self.widths[-1]


def pack_params(weights: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                ) -> PackedMLP:
    """Pack ``[(w [d_in, d_out], b [d_out]), ...]`` (consecutive layers'
    widths chained, every width at most :data:`LANE`) into one f32 buffer on
    the weights' device."""
    if not weights:
        raise ValueError("pack_params needs at least one layer")
    widths = [int(weights[0][0].shape[0])]
    device = weights[0][0].device
    for i, (w, b) in enumerate(weights):
        if w.dim() != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: want w [d_in, d_out] and b "
                             f"[d_out], got {tuple(w.shape)} and "
                             f"{tuple(b.shape)}")
        if w.shape[0] != widths[-1]:
            raise ValueError(f"layer {i} takes width {w.shape[0]}, the "
                             f"previous layer gives {widths[-1]}")
        if w.device != device or b.device != device:
            raise ValueError("pack_params takes the weights on one device")
        widths.append(int(w.shape[1]))
    if min(widths) < 1 or max(widths) > LANE:
        raise ValueError(f"every width must lie in [1, {LANE}], got "
                         f"{widths}")
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for w, b in weights for t in (w, b)])
    table = torch.tensor(widths, dtype=torch.int32, device=device)
    return PackedMLP(flat.contiguous(), tuple(widths), table,
                     max(din * dout + dout
                         for din, dout in zip(widths[:-1], widths[1:])))


def unpack_params(packed: PackedMLP) -> List[Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """The ``[(w, b), ...]`` list of a packed weight set, as views of its
    buffer."""
    out, off = [], 0
    for din, dout in zip(packed.widths[:-1], packed.widths[1:]):
        w = packed.params[off:off + din * dout].view(din, dout)
        off += din * dout
        out.append((w, packed.params[off:off + dout]))
        off += dout
    return out


def fused_mlp(x: torch.Tensor, packed: PackedMLP) -> torch.Tensor:
    """The fused forward of ``x [batch, d_in]`` f32 through ``packed`` →
    ``[batch, d_out]`` f32.

    Any batch size: the kernel masks the ragged edge, so unlike the JAX
    function (whose grid needs ``block_batch`` to divide the batch) no batch
    raises.  A CUDA tensor launches the kernel or raises; a CPU tensor runs
    :func:`mlp_reference`."""
    if x.dim() != 2 or x.shape[1] != packed.widths[0]:
        raise ValueError(f"x must be [batch, {packed.widths[0]}], got "
                         f"{tuple(x.shape)}")
    if x.device != packed.params.device:
        raise ValueError(f"x on {x.device}, the packed weights on "
                         f"{packed.params.device}")
    if x.device.type == "cpu":
        return mlp_reference(x, unpack_params(packed))
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("fused_mlp takes a contiguous float32 x")
    batch = x.shape[0]
    out = torch.empty((batch, packed.d_out), dtype=torch.float32,
                      device=x.device)
    if batch == 0:
        return out
    lib = _build.load("fused_mlp", _declare)
    ptr = _build.ptr
    rc = lib.tpd_fused_mlp(ptr(x), ptr(packed.params), ptr(packed.table),
                           ptr(out), batch, len(packed.widths) - 1,
                           max(packed.widths), packed.params.numel(),
                           packed.max_layer_floats,
                           _build.stream_of(x.device))
    _build.check(lib, rc, "fused_mlp")
    fused_mlp.launches += 1
    return out


#: kernel launches since the last reset (the main path's proof of use)
fused_mlp.launches = 0


def leaky_relu(h: torch.Tensor) -> torch.Tensor:
    """``where(h >= 0, h, NEGATIVE_SLOPE * h)``, as flax's ``leaky_relu``."""
    return torch.where(h >= 0, h, NEGATIVE_SLOPE * h)


def mlp_reference(x: torch.Tensor, weights) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mlp` over the ``[(w, b), ...]``
    list: ``x @ w + b``, LeakyReLU after every layer but the last."""
    h = x
    for i, (w, b) in enumerate(weights):
        h = h @ w + b
        if i + 1 < len(weights):
            h = leaky_relu(h)
    return h
