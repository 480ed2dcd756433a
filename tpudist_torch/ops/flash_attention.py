"""Flash attention: the FlashAttention-2 forward and its dq and dk/dv
backward passes.

The PyTorch/CUDA counterpart of :mod:`tpudist.ops.flash_attention`.  On CUDA
tensors :func:`flash_forward`, :func:`flash_backward_dq`,
:func:`flash_backward_dq_delta` and :func:`flash_backward_dkv` launch the
hand-written kernels ``csrc/flash_attention.cu`` and
``csrc/flash_backward.cu`` (bf16 on the tensor cores, f32 on CUDA-core FMAs;
every head dim from 1 to :data:`MAX_HEAD_DIM`; any sequence length); on CPU
tensors they run
:func:`flash_forward_reference` and :func:`flash_backward_reference`.
:class:`FlashAttention` ties them into an autograd function with the JAX
``custom_vjp``'s residuals and lse cotangent.

The forward and the backward each have three arms on CUDA
(:func:`_fwd_arm`, :func:`_bwd_arm`): Hopper warpgroup MMAs (``wgmma``) for
bf16 at head dims 64 and 128 (the forward warp-specialised: a producer
warpgroup feeding two consumer warpgroups over a TMA ring; the backward's
dq kernel can also form the delta ``rowsum(out·dout) − dlse`` itself);
``mma.sync``
tiles for bf16 at every other head dim (compiled for the padded widths
:data:`PAD_HEAD_DIMS`, zero past the real head dim); CUDA-core FMAs for
f32.

Layouts are the JAX package's: q ``[b, h, s, dh]``, k/v ``[b, h_kv, s,
dh]`` (grouped-query attention natively: ``h_kv`` divides ``h``), lse ``[b,
h, s]`` f32 in the scaled-score domain.  The band ``lo <= q − k < hi``
covers causal, a sliding window and a shifted ``(lo, hi)`` band
(:func:`_normalize_band`).  A row with no live key gets out 0 and lse
``-1e30``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpudist_torch.ops import _build
from tpudist_torch.ops.paged_attention import SMEM_LIMIT

_MASK_VALUE = -1e30
_UNBOUNDED = 1 << 30  # kUnbounded in csrc/flash_common.cuh
#: the widest head dim the CUDA kernels take (kMaxHeadDim in
#: csrc/flash_common.cuh); wider ones raise, naming ROADMAP A6f
MAX_HEAD_DIM = 256
#: the padded widths the bf16 mma.sync tiles are compiled for
#: (pad_head_dim in csrc/flash_common.cuh): a head dim runs at the first
#: that holds it, its columns past the real head dim zero
PAD_HEAD_DIMS = (16, 32, 64, 96, 128, 256)

Band = Tuple[Optional[int], Optional[int]]


def _normalize_band(causal, window) -> Band:
    """Reduce (causal, window) to the band ``lo <= q − k < hi`` (either side
    ``None`` = unbounded): ``window`` ``None`` (plain causal / full), an
    ``int`` W (causal sliding window: band [0, W)), or an explicit ``(lo,
    hi)`` tuple (requires ``causal=False``, since the band subsumes it)."""
    if window is None:
        return (0, None) if causal else (None, None)
    if isinstance(window, tuple):
        if causal:
            raise ValueError("band-tuple window subsumes causal; pass "
                             "causal=False")
        lo, hi = window
        if lo is not None and hi is not None and lo >= hi:
            raise ValueError(f"empty band: lo {lo} >= hi {hi}")
        return lo, hi
    if not causal:
        raise ValueError("sliding window requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return 0, window


def band_live_pairs(seq_q: int, seq_k: int, band: Band) -> int:
    """Exact number of (q, k) pairs inside the band (the work unit of the
    kernels' flop counts, as the JAX cost estimates count it)."""
    lo, hi = band
    q = torch.arange(seq_q, dtype=torch.int64)
    k_hi = torch.clamp(q - (lo if lo is not None else -seq_k), max=seq_k - 1)
    k_lo = torch.clamp(q - ((hi if hi is not None else seq_q + seq_k) - 1),
                       min=0)
    return int(torch.clamp(k_hi - k_lo + 1, min=0).sum())


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, heads, seq, head_dim]")
    b, h, _, d = q.shape
    h_kv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} incompatible with q "
                         f"{tuple(q.shape)}")
    if h % h_kv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {h_kv}")
    return b, h, h_kv, d


def _band_mask(q0: int, rows: int, seq_k: int, band: Band, device):
    """``[rows, seq_k]`` bool: query rows ``q0..`` x keys inside the band."""
    lo, hi = band
    diff = (torch.arange(q0, q0 + rows, device=device)[:, None]
            - torch.arange(seq_k, device=device)[None])
    keep = torch.ones_like(diff, dtype=torch.bool)
    if lo is not None:
        keep &= diff >= lo
    if hi is not None:
        keep &= diff < hi
    return keep


def _expand_kv(t, group: int):
    return t if group == 1 else t.repeat_interleave(group, dim=1)


def flash_forward_reference(q, k, v, band: Band, out_f32: bool = False,
                            block_q: int = 128):
    """Plain PyTorch forward: a dense band-masked softmax over query blocks
    of ``block_q`` rows.  Scores are f32 products of input-dtype operands
    times ``dh**-0.5``, masked to -1e30; the unnormalized probabilities
    ``exp(s − max)`` are rounded to ``v``'s dtype for P·V and divided by
    their f32 sum afterwards (the kernels' cast points).  Returns ``(out
    [b, h, sq, dh], lse [b, h, sq] f32)``; dead rows give 0 and -1e30."""
    _, h, h_kv, d = _shapes(q, k, v)
    sq, sk = q.shape[2], k.shape[2]
    scale = d ** -0.5
    kf = _expand_kv(k, h // h_kv).float()
    vf = _expand_kv(v, h // h_kv)
    outs, lses = [], []
    for q0 in range(0, sq, block_q):
        qf = q[:, :, q0:q0 + block_q].float()
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        keep = _band_mask(q0, qf.shape[2], sk, band, q.device)
        s = torch.where(keep, s, torch.tensor(_MASK_VALUE, device=q.device))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        dead = m <= _MASK_VALUE * 0.5
        o = torch.matmul(p.to(v.dtype).float(), vf.float()) / l
        outs.append(torch.where(dead, torch.zeros_like(o), o))
        lses.append(torch.where(dead, torch.full_like(m, _MASK_VALUE),
                                m + torch.log(l))[..., 0])
    out = torch.cat(outs, dim=2)
    out = out if out_f32 or q.dtype == torch.float32 else out.to(q.dtype)
    return out, torch.cat(lses, dim=2)


def flash_backward_reference(q, k, v, do, lse, delta, band: Band,
                             block_q: int = 128):
    """Plain PyTorch backward with the Pallas kernels' formulas:
    ``p = exp(s − lse)·live``, ``dp = do·vᵀ``, ``ds = p·(dp − Δ)·scale``,
    ``dq = ds·k``, ``dk = dsᵀ·q``, ``dv = pᵀ·do`` with ``ds`` and ``p``
    rounded to the input dtype before their products, f32 accumulation,
    and each GQA group summed into its KV head.  ``do`` is taken in
    ``q``'s dtype.  Returns ``(dq, dk, dv)`` in the input dtypes."""
    b, h, h_kv, d = _shapes(q, k, v)
    group = h // h_kv
    sq, sk = q.shape[2], k.shape[2]
    scale = d ** -0.5
    do = do.to(q.dtype)
    kx = _expand_kv(k, group)
    kf = kx.float()
    vf = _expand_kv(v, group).float()
    dqs = []
    dk = torch.zeros(b, h, sk, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, sq, block_q):
        rows = slice(q0, q0 + block_q)
        qb, dob = q[:, :, rows], do[:, :, rows]
        s = torch.matmul(qb.float(), kf.transpose(-1, -2)) * scale
        keep = _band_mask(q0, qb.shape[2], sk, band, q.device)
        s = torch.where(keep, s, torch.tensor(_MASK_VALUE, device=q.device))
        row_lse = lse[:, :, rows, None].float()
        live = (row_lse > _MASK_VALUE * 0.5).float()
        p = torch.exp(s - row_lse) * live
        dp = torch.matmul(dob.float(), vf.transpose(-1, -2))
        ds = p * (dp - delta[:, :, rows, None].float()) * scale
        dqs.append(torch.matmul(ds.to(k.dtype).float(), kf))
        dk += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                           qb.float())
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                           dob.float())
    dq = torch.cat(dqs, dim=2).to(q.dtype)
    dk = dk.view(b, h_kv, group, sk, d).sum(dim=2).to(k.dtype)
    dv = dv.view(b, h_kv, group, sk, d).sum(dim=2).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------- kernels


def _declare_fwd(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_flash_forward.argtypes = ([p] * 5 + [i] * 10 + [ctypes.c_float]
                                      + [p])
    lib.tpd_flash_forward.restype = i


def _declare_bwd(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_flash_backward_dq.argtypes = ([p] * 9 + [i] * 9
                                          + [ctypes.c_float] + [p])
    lib.tpd_flash_backward_dq.restype = i
    lib.tpd_flash_backward_dkv.argtypes = ([p] * 8 + [i] * 9
                                           + [ctypes.c_float] + [p])
    lib.tpd_flash_backward_dkv.restype = i


def _check_cuda(what: str, tensors, dtype) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} needs 16-byte aligned tensors")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bfloat16 or float32, not {dtype}")


def _band_ints(band: Band):
    lo, hi = band
    return (-_UNBOUNDED if lo is None else int(lo),
            _UNBOUNDED if hi is None else int(hi))


def pad_head_dim(d: int) -> int:
    """The padded width of the bf16 mma.sync tiles that hold head dim
    ``d`` (:data:`PAD_HEAD_DIMS`)."""
    for p in PAD_HEAD_DIMS:
        if d <= p:
            return p
    raise ValueError(f"head_dim {d} is past the flash kernels' "
                     f"{MAX_HEAD_DIM} (ROADMAP A6f)")


def mma_smem(kind: str, d: int) -> int:
    """Dynamic shared memory of one CTA of the bf16 mma.sync arm of
    ``kind`` (``"fwd"``, ``"dq"``, ``"dkv"``) at head dim ``d``: the
    ``[rows][DP + 8]`` bf16 tiles of ``csrc/flash_attention.cu`` and
    ``csrc/flash_backward.cu`` (forward: a 64-row Q tile and one 64-key K
    and V tile; dq: Q and dO tiles and double-buffered K/V tiles; dk/dv:
    64-key K and V tiles, double-buffered 32-row Q and dO tiles and their
    row scalars)."""
    ld = pad_head_dim(d) + 8
    tiles = {"fwd": 64 + 2 * 64, "dq": 2 * 64 + 4 * 64,
             "dkv": 2 * 64 + 4 * 32}[kind]
    return tiles * ld * 2 + (4 * 32 * 4 if kind == "dkv" else 0)


def f32_smem(kind: str, d: int) -> int:
    """Dynamic shared memory of one CTA of the f32 arm of ``kind`` at
    head dim ``d`` (16 query rows, 32-key tiles; rows read across a warp
    padded to an odd width)."""
    odd = d | 1
    floats = {"fwd": 16 * d + 32 * odd + 32 * d + 16 * 32 + 3 * 16,
              "dq": 2 * 16 * d + 2 * 32 * odd + 16 * 32 + 2 * 16,
              "dkv": 2 * 32 * odd + 2 * 16 * odd + 2 * 32 * 17
              + 2 * 16}[kind]
    return floats * 4


def _check_smem(what: str, kind: str, arm: str, d: int) -> None:
    """Raise before a launch whose CTA of the mma.sync or f32 arm of
    ``kind`` would need more shared memory at head dim ``d`` than one CTA
    may use (the wgmma arms take only head dims 64 and 128)."""
    if arm == "wgmma":
        return
    smem = (f32_smem if arm == "f32" else mma_smem)(kind, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: head_dim {d} takes {smem} bytes of "
                         f"shared memory on the {arm} arm, past the "
                         f"{SMEM_LIMIT} one CTA may use")


def _geometry(what: str, q, k, v):
    b, h, h_kv, d = _shapes(q, k, v)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {d} is past the kernels' "
                         f"{MAX_HEAD_DIM} (ROADMAP A6f)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: q, k, v must share one dtype")
    return b, h, h_kv, d


# the kernels' arms (enum Arm in csrc/flash_attention.cu and
# csrc/flash_backward.cu)
_ARMS = {"f32": 0, "mma": 1, "wgmma": 2}
_WGMMA_DIMS = (64, 128)
#: the forward's wgmma arm (csrc/flash_attention.cu): query rows a CTA (two
#: consumer warpgroups of 64), keys a K/V tile, and the K/V ring's stages
#: by head dim
FWD_WGMMA_ROWS, FWD_WGMMA_KEYS = 128, 128
FWD_WGMMA_STAGES = {64: 4, 128: 3}


def fwd_wgmma_smem(d: int) -> int:
    """Shared memory of one forward wgmma CTA at head dim ``d``: two ``[64,
    d]`` Q tiles and the ring of ``[128, d]`` K and V tiles in bf16, plus 2
    KB for the mbarriers and the 1024-byte alignment of the tiles."""
    return (FWD_WGMMA_ROWS + 2 * FWD_WGMMA_STAGES[d] * FWD_WGMMA_KEYS) \
        * d * 2 + 2048


def _fwd_arm(q) -> str:
    """The arm a CUDA forward call takes: ``wgmma`` for bf16 at head dims
    64 and 128 (warp-specialised, TMA-fed), ``mma`` (mma.sync) for bf16 at
    every other head dim, ``f32``."""
    if q.dtype == torch.float32:
        return "f32"
    return "wgmma" if q.shape[-1] in _WGMMA_DIMS else "mma"


def _launch_fwd(arm: str, q, k, v, band: Band, out_f32: bool = False):
    """One launch of the forward kernel on ``arm`` (inputs checked by the
    caller).  ``chip_smoke.py`` and the CUDA tests also call it to time and
    hold the bf16 arms on the same inputs."""
    b, h, h_kv, d = _shapes(q, k, v)
    if arm == "wgmma" and (d not in _WGMMA_DIMS
                           or q.dtype != torch.bfloat16):
        raise ValueError(f"the forward's wgmma arm takes bf16 at head dims "
                         f"{_WGMMA_DIMS}, not {q.dtype} at {d}")
    if (arm == "f32") != (q.dtype == torch.float32):
        raise ValueError(f"arm {arm!r} does not take {q.dtype}")
    _geometry("flash_forward", q, k, v)
    _check_smem("flash_forward", "fwd", arm, d)
    sq, sk = q.shape[2], k.shape[2]
    f32_out = out_f32 or q.dtype == torch.float32
    out = torch.empty(b, h, sq, d, device=q.device,
                      dtype=torch.float32 if f32_out else q.dtype)
    lse = torch.empty(b, h, sq, device=q.device, dtype=torch.float32)
    lib = _build.load("flash_attention", _declare_fwd)
    lo, hi = _band_ints(band)
    ptr = _build.ptr
    rc = lib.tpd_flash_forward(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), b, h, h_kv, sq, sk, d,
        lo, hi, _ARMS[arm], int(f32_out), d ** -0.5,
        _build.stream_of(q.device))
    _build.check(lib, rc, "flash_forward")
    flash_forward.launches += 1
    flash_forward.launches_wgmma += arm == "wgmma"
    return out, lse


def flash_forward(q, k, v, band: Band, out_f32: bool = False,
                  block_q: int = 128):
    """The forward over ``band``: ``(out, lse)``.  CUDA tensors launch
    ``csrc/flash_attention.cu`` on :func:`_fwd_arm`'s arm (``block_q``
    tiles only the plain version); CPU tensors run
    :func:`flash_forward_reference`."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, band, out_f32, block_q)
    _check_cuda("flash_forward", [q, k, v], q.dtype)
    return _launch_fwd(_fwd_arm(q), q, k, v, band, out_f32)


#: the arm a CUDA backward call takes: the forward's rule (``wgmma`` for
#: bf16 at head dims 64 and 128, ``mma`` for bf16 at every other head dim,
#: ``f32``)
_bwd_arm = _fwd_arm


def _bwd_check(what: str, q, k, v, do, rows_f32):
    _check_cuda(what, [q, k, v, do] + list(rows_f32), q.dtype)
    b, h, h_kv, d = _geometry(what, q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise TypeError(f"{what}: do must match q's shape and dtype")
    rows = (b, h, q.shape[2])
    if any(tuple(t.shape) != rows or t.dtype != torch.float32
           for t in rows_f32):
        raise TypeError(f"{what}: lse, delta and g_lse must be float32 "
                        f"{rows}")
    return b, h, h_kv, d


def _launch_dq(arm: str, q, k, v, do, lse, delta, band: Band, out=None,
               g_lse=None):
    """One launch of the dq kernel on ``arm`` (inputs checked by the
    caller); with ``out`` the kernel writes ``rowsum(out·do) − g_lse`` into
    ``delta`` and uses it.  ``chip_smoke.py`` and the CUDA tests also call
    it to time and hold the bf16 arms on the same inputs."""
    b, h, h_kv, d = _shapes(q, k, v)
    _check_smem("flash_backward_dq", "dq", arm, d)
    dq = torch.empty_like(q)
    lib = _build.load("flash_backward", _declare_bwd)
    lo, hi = _band_ints(band)
    ptr = _build.ptr
    rc = lib.tpd_flash_backward_dq(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(out),
        ptr(g_lse), ptr(dq), b, h, h_kv, q.shape[2], k.shape[2], d, lo, hi,
        _ARMS[arm], d ** -0.5, _build.stream_of(q.device))
    _build.check(lib, rc, "flash_backward_dq")
    flash_backward_dq.launches += 1
    flash_backward_dq.launches_wgmma += arm == "wgmma"
    return dq


def _launch_dkv(arm: str, q, k, v, do, lse, delta, band: Band):
    """One launch of the dk/dv kernel on ``arm``, as :func:`_launch_dq`."""
    b, h, h_kv, d = _shapes(q, k, v)
    _check_smem("flash_backward_dkv", "dkv", arm, d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_backward", _declare_bwd)
    lo, hi = _band_ints(band)
    ptr = _build.ptr
    rc = lib.tpd_flash_backward_dkv(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk),
        ptr(dv), b, h, h_kv, q.shape[2], k.shape[2], d, lo, hi, _ARMS[arm],
        d ** -0.5, _build.stream_of(q.device))
    _build.check(lib, rc, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    flash_backward_dkv.launches_wgmma += arm == "wgmma"
    return dk, dv


def flash_backward_dq(q, k, v, do, lse, delta, band: Band,
                      block_q: int = 128):
    """dq of the backward (``do`` in q's dtype, ``delta = rowsum(out·dout)
    − dlse``; the JAX ``_flash_backward`` inputs).  CUDA tensors launch the
    dq kernel of ``csrc/flash_backward.cu`` on :func:`_bwd_arm`'s arm; CPU
    tensors run the plain backward."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, do, lse, delta, band,
                                        block_q)[0]
    _bwd_check("flash_backward_dq", q, k, v, do, [lse, delta])
    return _launch_dq(_bwd_arm(q), q, k, v, do, lse, delta, band)


def flash_backward_dq_delta(q, k, v, do, lse, out, g_lse, band: Band,
                            block_q: int = 128):
    """``(dq, delta)`` of the backward from the forward's ``out`` and the
    cotangents: ``delta = rowsum(out·do) − g_lse`` (``g_lse`` ``None``: no
    lse cotangent), f32 ``[b, h, sq]``, the input of
    :func:`flash_backward_dkv`.  CUDA tensors launch the wgmma dq kernel,
    which forms delta itself before its first KV tile (bf16 at head dims 64
    and 128, ``out`` and ``do`` in q's dtype and shape; other inputs
    raise); CPU tensors run the plain delta and backward."""
    if q.device.type == "cpu":
        delta = (out.float() * do.float()).sum(dim=-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        return flash_backward_reference(q, k, v, do, lse, delta, band,
                                        block_q)[0], delta
    rows = [lse] if g_lse is None else [lse, g_lse]
    b, h, _, d = _bwd_check("flash_backward_dq_delta", q, k, v, do, rows)
    _check_cuda("flash_backward_dq_delta", [q, out], q.dtype)
    if _bwd_arm(q) != "wgmma" or out.shape != q.shape \
            or out.dtype != q.dtype:
        raise ValueError(f"flash_backward_dq_delta forms delta in the wgmma "
                         f"dq kernel: bf16 q and out at head dims "
                         f"{_WGMMA_DIMS}, not {q.dtype}/{out.dtype} at {d}")
    delta = torch.empty(b, h, q.shape[2], device=q.device,
                        dtype=torch.float32)
    dq = _launch_dq("wgmma", q, k, v, do, lse, delta, band, out, g_lse)
    return dq, delta


def flash_backward_dkv(q, k, v, do, lse, delta, band: Band,
                       block_q: int = 128):
    """``(dk, dv)`` of the backward, each GQA group summed into its KV
    head.  CUDA tensors launch the dk/dv kernel of
    ``csrc/flash_backward.cu`` on :func:`_bwd_arm`'s arm; CPU tensors run
    the plain backward."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, do, lse, delta, band,
                                        block_q)[1:]
    _bwd_check("flash_backward_dkv", q, k, v, do, [lse, delta])
    return _launch_dkv(_bwd_arm(q), q, k, v, do, lse, delta, band)


#: kernel launches since the last reset (the main path's proof of use), and
#: those of the wgmma arms
flash_forward.launches = 0
flash_forward.launches_wgmma = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0
flash_backward_dq.launches_wgmma = 0
flash_backward_dkv.launches_wgmma = 0


def _folds_delta(q, out, g_out) -> bool:
    """Whether a CUDA backward forms delta in the dq kernel: the wgmma arm,
    with ``out`` and its cotangent in q's dtype (``out_f32`` keeps the
    plain delta over the f32 cotangent)."""
    return _bwd_arm(q) == "wgmma" and out.dtype == g_out.dtype == q.dtype


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` of the band attention, differentiable in both outputs.

    Forward: :func:`flash_forward`, saving ``q, k, v, out, lse``.  Backward:
    the lse cotangent shifts the delta the kernels consume (``delta =
    rowsum(out·g_out) − g_lse``, where JAX's ``_bwd`` computes it), then the
    dq pass and the dk/dv pass.  On CUDA the wgmma arm's dq kernel forms
    delta itself (:func:`flash_backward_dq_delta`) and the dk/dv kernel
    reads it; the other arms (and ``out_f32``) take delta from plain tensor
    ops, as the CPU's plain backward does.  A cotangent autograd would fill
    with zeros arrives as ``None`` (``set_materialize_grads(False)``): no
    lse cotangent subtracts nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, window=None, out_f32=False,
                block_q=128):
        band = _normalize_band(causal, window)
        out, lse = flash_forward(q, k, v, band, out_f32, block_q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.band, ctx.block_q = band, block_q
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:  # only the lse reaches the loss
            g_out = torch.zeros_like(out)
        if g_lse is not None:
            g_lse = g_lse.float().contiguous()
        if q.device.type == "cuda" and _folds_delta(q, out, g_out):
            do = g_out.contiguous()
            dq, delta = flash_backward_dq_delta(q, k, v, do, lse, out, g_lse,
                                                ctx.band)
            dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, ctx.band)
            return dq, dk, dv, None, None, None, None
        delta = (out.float() * g_out.float()).sum(dim=-1)
        if g_lse is not None:
            delta = delta - g_lse
        do = g_out.to(q.dtype).contiguous()
        args = (q, k, v, do, lse, delta.contiguous(), ctx.band, ctx.block_q)
        if q.device.type == "cpu":
            dq, dk, dv = flash_backward_reference(*args)
        else:
            dq = flash_backward_dq(*args)
            dk, dv = flash_backward_dkv(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             block_q: int = 128, block_k: int = 128,
                             out_f32: bool = False, window=None):
    """Flash attention that also returns the per-row logsumexp ``[b, h,
    sq]`` (f32, scaled-score domain); differentiable in both outputs.  The
    JAX argument order minus ``interpret``.  Neither block size has any
    effect on CUDA tensors, whose kernels use their own compile-time tiles:
    ``block_q`` only chunks the plain version's query rows on the CPU, and
    ``block_k`` is accepted for JAX's order and changes nothing anywhere.
    ``out_f32`` emits the output in f32 whatever the input dtype."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got ({block_q}, "
                         f"{block_k})")
    return FlashAttention.apply(q, k, v, causal, window, out_f32, block_q)


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128, window=None):
    """Flash attention over ``[batch, heads, seq, head_dim]`` inputs (the
    output of :func:`flash_attention_with_lse`)."""
    out, _ = flash_attention_with_lse(q, k, v, causal, block_q, block_k,
                                      False, window)
    return out


# grouped-query K/V are consumed natively (fewer KV heads than q heads)
flash_attention.supports_gqa = True
flash_attention_with_lse.supports_gqa = True
