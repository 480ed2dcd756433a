"""Paged decode attention: the block table walked in-kernel.

The PyTorch/CUDA counterpart of :mod:`tpudist.ops.paged_attention`.  On a
CUDA tensor :func:`paged_attention` launches the hand-written Hopper kernel
``csrc/paged_attention.cu`` (see its header for the design and what bounds
it); on a CPU tensor it runs :func:`paged_attention_reference`, the plain
gather-to-dense version of the same contract.  Layouts are the JAX
package's: ``q [S, nh, s, dh]``, pool ``[L, nb, n_kv, bs, dh]``, scales
``[L, nb, n_kv]``, ``table [S, M]`` with sentinel ``nb``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpudist_torch.ops import _build

_MASK_VALUE = -1e30


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_paged_attention.argtypes = (
        [p] * 11 + [i] * 11 + [ctypes.c_float, i, i, p])
    lib.tpd_paged_attention.restype = i


def check_paged_inputs(q, pool_k, pool_v, scale_k, scale_v, table, pos0,
                       fresh_k, fresh_v, layer, ints=()):
    """Device, dtype, shape and contiguity checks shared by the paged
    kernels' wrappers (``fresh_*`` is the window buffer or the chunk)."""
    S, nh, _, dh = q.shape
    L, nb, n_kv, bs, pdh = pool_k.shape
    tensors = (q, pool_k, pool_v, scale_k, scale_v, table, pos0, fresh_k,
               fresh_v) + tuple(ints)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged kernels take contiguous tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if pool_k.dtype not in (torch.float32, torch.bfloat16, torch.int8) \
            or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"pool dtype {pool_k.dtype}/{pool_v.dtype}")
    if fresh_k.dtype != q.dtype or fresh_v.dtype != q.dtype:
        raise TypeError("window/chunk K/V must be in q's dtype")
    if scale_k.dtype != torch.float32 or scale_v.dtype != torch.float32:
        raise TypeError("scales must be float32")
    for t in (table, pos0) + tuple(ints):
        if t.dtype != torch.int32:
            raise TypeError("tables and cursors must be int32")
    if pool_v.shape != pool_k.shape or pdh != dh:
        raise ValueError(f"pool {tuple(pool_k.shape)} vs q {tuple(q.shape)}")
    if scale_k.shape != (L, nb, n_kv) or scale_v.shape != (L, nb, n_kv):
        raise ValueError(f"scales must be {(L, nb, n_kv)}")
    if table.dim() != 2 or table.shape[0] != S or pos0.shape != (S,):
        raise ValueError("table must be [S, M] and pos0 [S]")
    if nh % n_kv:
        raise ValueError(f"n_heads {nh} must be a multiple of n_kv {n_kv}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if fresh_k.shape != fresh_v.shape or fresh_k.shape[:2] != (S, n_kv) \
            or fresh_k.shape[3] != dh:
        raise ValueError(f"fresh K/V {tuple(fresh_k.shape)}")


def _check_smem(R: int, dh: int, bs: int) -> None:
    R = min(R, 16)  # query rows per CTA (paged_common.cuh kRowsPerCta)
    floats = 2 * R * dh + 2 * bs * (dh + 4) + R * bs + 3 * R
    if floats * 4 > 227 * 1024:
        raise ValueError(
            f"{R} query rows x dh {dh} x block {bs} exceed the 227 KB of "
            "shared memory one CTA may use")


def paged_attention(q, pool_k, pool_v, scale_k, scale_v, table, pos0, fill,
                    wk, wv, *, layer: int, window: Optional[int] = None):
    """Paged decode attention over a block pool, one model layer.

    - ``q [S, n_heads, s, dh]`` — the window's queries (rope-rotated);
    - ``pool_k``/``pool_v [L, nb, n_kv, bs, dh]`` — the whole pool (int8
      when quantized), ``scale_k``/``scale_v [L, nb, n_kv]`` f32;
    - ``table [S, M]`` int32 block ids (sentinel ``nb``), ``pos0 [S]`` the
      live prefix length, ``fill [S]`` window tokens before this call's
      queries;
    - ``wk``/``wv [S, n_kv, W, dh]`` — the uncommitted window buffer in q's
      dtype, this call's tokens at ``[fill, fill + s)``.

    Returns ``[S, n_heads, s, dh]`` in q's dtype.  A CUDA tensor launches
    the kernel (or raises); a CPU tensor runs the plain version."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pool_k, pool_v, scale_k, scale_v, table, pos0, fill, wk, wv,
            layer=layer, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    check_paged_inputs(q, pool_k, pool_v, scale_k, scale_v, table, pos0, wk,
                       wv, layer, ints=(fill,))
    S, nh, s, dh = q.shape
    L, nb, n_kv, bs, _ = pool_k.shape
    R = (nh // n_kv) * s
    _check_smem(R, dh, bs)
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _declare)
    ptr = _build.ptr
    rc = lib.tpd_paged_attention(
        ptr(q), ptr(pool_k), ptr(pool_v), ptr(scale_k), ptr(scale_v),
        ptr(table), ptr(pos0), ptr(fill), ptr(wk), ptr(wv), ptr(out),
        S, n_kv, R, s, dh, nb, bs, table.shape[1], wk.shape[2], layer,
        0 if window is None else int(window), float(dh ** -0.5),
        _build.dtype_code(q.dtype), _build.dtype_code(pool_k.dtype),
        _build.stream_of(q.device))
    _build.check(lib, rc, "paged_attention")
    paged_attention.launches += 1
    return out


#: kernel launches since the last reset (the main path's proof of use)
paged_attention.launches = 0


def _dense_view(pool, scale, rows, layer, compute):
    """Gather ``rows [S, M]`` (sentinels clamped into masked territory) of
    one layer's pool into ``[S, n_kv, M * bs, dh]`` in the compute dtype."""
    S, M = rows.shape
    _, _, n_kv, bs, dh = pool.shape
    g = pool[layer][rows].to(compute)                  # [S, M, nk, bs, dh]
    if pool.dtype == torch.int8:
        g = g * scale[layer][rows][..., None, None].to(compute)
    return g.movedim(2, 1).reshape(S, n_kv, M * bs, dh)


def paged_attention_reference(q, pool_k, pool_v, scale_k, scale_v, table,
                              pos0, fill, wk, wv, *, layer: int,
                              window: Optional[int] = None):
    """Plain PyTorch version of :func:`paged_attention` (gather to dense,
    one masked softmax per query) — the kernel's equivalence oracle."""
    S, nh, s, dh = q.shape
    _, nb, n_kv, bs, _ = pool_k.shape
    M = table.shape[1]
    W = wk.shape[2]
    group = nh // n_kv
    compute = q.dtype
    rows = table.long().clamp(max=nb - 1)
    ks = torch.cat([_dense_view(pool_k, scale_k, rows, layer, compute),
                    wk.to(compute)], dim=2)
    vs = torch.cat([_dense_view(pool_v, scale_v, rows, layer, compute),
                    wv.to(compute)], dim=2)
    qg = q.reshape(S, n_kv, group, s, dh)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg.float(), ks.float()) \
        * (dh ** -0.5)
    dev = q.device
    kpos = torch.arange(M * bs + W, device=dev)
    in_pool = kpos < M * bs
    pos0 = pos0.long()
    fill = fill.long()
    ar = torch.arange(s, device=dev)
    qpos = pos0[:, None] + fill[:, None] + ar[None]               # [S, s]
    live = torch.where(
        in_pool[None, None],
        kpos[None, None] < pos0[:, None, None],
        (kpos[None, None] - M * bs)
        <= fill[:, None, None] + ar[None, :, None])              # [S, s, K]
    if window is not None:
        abs_k = torch.where(in_pool[None, None], kpos[None, None],
                            pos0[:, None, None] + kpos[None, None] - M * bs)
        live = live & (abs_k > qpos[:, :, None] - window)
    scores = torch.where(live[:, None, None], scores,
                         torch.tensor(_MASK_VALUE, device=dev))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqk,bnkd->bngqd", w.to(compute).float(), vs.float())
    return out.reshape(S, nh, s, dh).to(q.dtype)
