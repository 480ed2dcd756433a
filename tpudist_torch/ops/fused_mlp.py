"""The toy MLP forward in one kernel.

The PyTorch/CUDA counterpart of :mod:`tpudist.ops.fused_mlp`: ``h = x``,
then ``h = leaky(h @ W_i + b_i)`` for every layer but the last, which has
no activation (LeakyReLU slope 0.01), all in f32 with full-f32 products.

:func:`pack_params` packs a weight set once — the counterpart of
``pad_params``, but padding each width only to an even number (not to 128):
one contiguous f32 buffer (per layer ``W [pad2(d_in), pad2(d_out)]``
row-major, then ``b [pad2(d_out)]``, the padding zero) and a small int32
table of the true widths, both on the weights' device.  :func:`fused_mlp`
then runs the forward per batch: on a CUDA tensor it launches the
hand-written kernel ``csrc/fused_mlp.cu`` on the arm and grid that
:func:`_mlp_plan` picks (or raises), on a CPU tensor it runs
:func:`mlp_reference`, the plain chain of ``x @ w + b`` and ``where``.
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
#: the register-blocked arm takes padded widths up to this
#: (``csrc/fused_mlp.cu`` kSmallMax); wider layers take the tiled arm
SMALL_MAX = 32
#: rows a thread on the register-blocked arm, largest first, by the bound
#: of the padded widths (16 or 32) they are instantiated for
SMALL_ROWS = {16: (4, 2, 1), 32: (2, 1)}
#: floats of packed weights the register-blocked arm stages at once (48 KB;
#: past it, one layer at a time) — ``csrc/fused_mlp.cu`` kAllFloats
ALL_FLOATS = 12288
#: threads of a CTA at most, and of every tiled-arm CTA (kMaxThreads)
MAX_THREADS = 128
#: the tiled arm's shared memory: two activation tiles of ``[rows, LANE +
#: 4]`` and two staged layers of ``LANE * LANE + LANE`` floats
ACT_LD, W_LAYER = LANE + 4, LANE * LANE + LANE
#: SMs of an H100 SXM, the plan's default when no card is asked
H100_SMS = 132
#: layers whose widths reach the kernel by value (``kDimsCap``; past them
#: it reads the device table)
DIMS_CAP = 32


class MlpLaunch(ctypes.Structure):
    """One call's launch as ``csrc/fused_mlp.cu`` reads it (``MlpLaunch``,
    field for field): a plan of :func:`_mlp_plan` for one weight set and
    batch, built once and passed by pointer."""

    _fields_ = ([("batch", ctypes.c_longlong), ("blocks", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in (
                    "n_layers", "arm", "cn", "r", "threads", "rows_per_cta",
                    "total_floats", "w_floats", "smem")]
                + [("widths", ctypes.c_int * (DIMS_CAP + 1))])


def _declare(lib) -> None:
    p = ctypes.c_void_p
    lib.tpd_fused_mlp.argtypes = [p, p, p, p, ctypes.POINTER(MlpLaunch), p]
    lib.tpd_fused_mlp.restype = ctypes.c_int


def pad2(w: int) -> int:
    """A width padded to an even number (the packing's zero padding)."""
    return w + (w & 1)


@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """A weight set packed for :func:`fused_mlp` by :func:`pack_params`."""

    params: torch.Tensor  # f32, per layer W [pad2(d_in), pad2(d_out)], b
    widths: Tuple[int, ...]  # true widths (d_in, d_1, ..., d_out)
    table: torch.Tensor  # int32 [n_layers + 1], ``widths`` on the device
    max_layer_floats: int  # the longest layer's share of ``params``
    #: (batch, device index) -> MlpLaunch, built at a batch's first call
    launch_cache: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)

    @property
    def d_out(self) -> int:
        return self.widths[-1]


def pack_params(weights: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                ) -> PackedMLP:
    """Pack ``[(w [d_in, d_out], b [d_out]), ...]`` (consecutive layers'
    widths chained, every width at most :data:`LANE`) into one f32 buffer on
    the weights' device, each width zero-padded to an even number and the
    buffer to a multiple of 4 floats."""
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
    sizes = [pad2(din) * pad2(dout) + pad2(dout)
             for din, dout in zip(widths[:-1], widths[1:])]
    total = sum(sizes)
    flat = torch.zeros(total + (-total) % 4, dtype=torch.float32,
                       device=device)
    views = _layer_views(flat, widths)
    with torch.no_grad():
        for (w, b), (pw, pb) in zip(weights, views):
            pw.copy_(w.detach())
            pb.copy_(b.detach())
    table = torch.tensor(widths, dtype=torch.int32, device=device)
    return PackedMLP(flat, tuple(widths), table, max(sizes))


def _layer_views(flat: torch.Tensor, widths) -> List[Tuple[torch.Tensor,
                                                          torch.Tensor]]:
    """The true-width ``(w, b)`` views of each layer of a packed buffer."""
    out, off = [], 0
    for din, dout in zip(widths[:-1], widths[1:]):
        dinp, doutp = pad2(din), pad2(dout)
        w = flat[off:off + dinp * doutp].view(dinp, doutp)[:din, :dout]
        off += dinp * doutp
        out.append((w, flat[off:off + dout]))
        off += doutp
    return out


def unpack_params(packed: PackedMLP) -> List[Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """The ``[(w, b), ...]`` list of a packed weight set at its true widths,
    as views of its buffer."""
    return _layer_views(packed.params, packed.widths)


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """How :func:`fused_mlp` launches ``csrc/fused_mlp.cu``."""

    arm: str  # "small" (register-blocked rows) or "wide" (tiled)
    cn: int  # small: the padded widths' bound, 16 or 32; wide: LANE
    rows: int  # rows a thread: R (small) or the micro-tile's TM (wide)
    threads: int  # a CTA's
    rows_per_cta: int
    blocks: int
    smem: int  # dynamic shared memory a CTA, bytes


def _mlp_plan(widths: Tuple[int, ...], batch: int,
              sms: int = H100_SMS) -> MlpPlan:
    """The arm and grid for ``batch`` rows through layers of ``widths``
    (true widths) on a card of ``sms`` SMs.

    Every padded width at most :data:`SMALL_MAX`: the register-blocked arm.
    R rows a thread, the largest of :data:`SMALL_ROWS` that still leaves
    four warps for every SM (else 1); at R = 1 a CTA takes ``batch / sms``
    rows (at most 128, in whole warps), so the grid covers every SM from a
    batch of ``sms`` rows up; at R > 1 ``blocks`` counts the row tiles,
    which the kernel's launcher hands to as many CTAs as the card holds.
    Any wider layer: the tiled arm, 64-row tiles (TM 8) where they give
    every SM a CTA, else 32 (TM 4)."""
    padded = [pad2(w) for w in widths]
    if max(padded) > SMALL_MAX:
        tm = 8 if -(-batch // 64) >= sms else 4
        rows = 8 * tm
        return MlpPlan("wide", LANE, tm, MAX_THREADS, rows, -(-batch // rows),
                       4 * (2 * rows * ACT_LD + 2 * W_LAYER))
    cn = 16 if max(padded) <= 16 else SMALL_MAX
    sizes = [a * b + b for a, b in zip(padded[:-1], padded[1:])]
    r = next((c for c in SMALL_ROWS[cn] if -(-batch // (32 * c)) >= 4 * sms),
             1)
    if r > 1:
        threads, rows = MAX_THREADS, MAX_THREADS * r
    else:
        rows = min(MAX_THREADS, -(-batch // sms))
        threads = 32 * -(-rows // 32)
    total = sum(sizes) + (-sum(sizes)) % 4  # pack_params' buffer
    # the staged weights (all layers, or one at a time past 48 KB); at R > 1
    # also the x of two row tiles, for a grid of the CTAs the card holds at
    # once (the kernel's launcher sizes it) that walks the tiles, bringing
    # in the next tile's x while it computes one
    smem = 4 * ((total if total <= ALL_FLOATS else max(sizes))
                + (2 * rows * widths[0] if r > 1 else 0))
    return MlpPlan("small", cn, r, threads, rows, -(-batch // rows), smem)


def _launch_struct(packed: PackedMLP, batch: int, sms: int) -> MlpLaunch:
    """The kernel's ``MlpLaunch`` for ``batch`` rows through ``packed`` on a
    card of ``sms`` SMs."""
    plan = _mlp_plan(packed.widths, batch, sms)
    n = len(packed.widths) - 1
    return MlpLaunch(batch, plan.blocks, n, int(plan.arm == "wide"),
                     plan.cn, plan.rows, plan.threads, plan.rows_per_cta,
                     packed.params.numel(), packed.max_layer_floats,
                     plan.smem, (ctypes.c_int * (DIMS_CAP + 1))(
                         *packed.widths[:DIMS_CAP + 1]))


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
    key = (batch, x.device.index)
    launch = packed.launch_cache.get(key)
    if launch is None:
        if len(packed.launch_cache) >= 64:
            packed.launch_cache.clear()
        launch = packed.launch_cache[key] = _launch_struct(
            packed, batch,
            torch.cuda.get_device_properties(x.device).multi_processor_count)
    lib = _build.load("fused_mlp", _declare)
    ptr = _build.ptr
    rc = lib.tpd_fused_mlp(ptr(x), ptr(packed.params), ptr(packed.table),
                           ptr(out), launch, _build.stream_of(x.device))
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
