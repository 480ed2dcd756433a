"""Paged decode attention: the block table walked in-kernel.

The PyTorch/CUDA counterpart of :mod:`tpudist.ops.paged_attention`.  On a
CUDA tensor :func:`paged_attention` launches the hand-written Hopper kernel
``csrc/paged_attention.cu`` (see its header for the design and what bounds
it); on a CPU tensor it runs :func:`paged_attention_reference`, the plain
gather-to-dense version of the same contract.  Layouts are the JAX
package's: ``q [S, nh, s, dh]``, pool ``[L, nb, n_kv, bs, dh]``, scales
``[L, nb, n_kv]``, ``table [S, M]`` with sentinel ``nb``.

The kernel has two arms (:func:`_decode_arm`): a split walk on the tensor
cores for bf16 q over bf16 or int8 pools at head dims 16, 32, 64 and 128
(each lane's table cut into spans of :data:`SPLIT_KEYS` keys, one CTA a
span, the partials merged by logsumexp in the same launch), and the
CUDA-core walk for the rest.  :func:`_decode_split_reference` is the plain
model of the split walk's schedule, for the tests.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from tpudist_torch.ops import _build

_MASK_VALUE = -1e30
#: shared memory one CTA may use on the H100 (bytes)
SMEM_LIMIT = 227 * 1024
#: the split walk (csrc/paged_attention.cu): keys a split owns
#: (kSplitKeys), keys a tile (kKeys), warps a CTA (kWarps), a warp's ring of
#: tile buffers (kBufs) and query rows a CTA (kRows)
SPLIT_KEYS, TC_KEYS, TC_WARPS, TC_BUFS, TC_ROWS = 128, 16, 4, 2, 16
#: head dims the split walk is instantiated for
TC_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
#: query rows per CTA of the CUDA-core arm (paged_common.cuh kRowsPerCta)
CC_ROWS = 16
_ARMS = {"cc": 0, "tc": 1}


class DecodePlan(NamedTuple):
    """How one call launches: the arm (``"tc"`` the split walk on the
    tensor cores, ``"cc"`` the CUDA-core walk), query rows a CTA, splits of
    a lane's table (1 on the CUDA-core arm) and shared memory a CTA
    (bytes)."""

    arm: str
    rows: int
    splits: int
    smem: int


def _decode_arm(q, pool, dh: int) -> str:
    """The arm a CUDA decode call takes: ``"tc"`` for bf16 q over a bf16 or
    int8 pool at a head dim of :data:`TC_HEAD_DIMS`, else ``"cc"``."""
    if q.dtype == torch.bfloat16 and dh in TC_HEAD_DIMS \
            and pool.dtype in (torch.bfloat16, torch.int8):
        return "tc"
    return "cc"


def _decode_plan(arm: str, R: int, dh: int, bs: int, M: int) -> DecodePlan:
    """The launch on ``arm`` of one kv head group of ``R = group * s`` query
    rows at head dim ``dh``, KV block ``bs`` and table width ``M``.  The
    split walk: :data:`TC_ROWS` rows a CTA, ``ceil(M * bs / SPLIT_KEYS)``
    splits, shared memory the larger of the warps' rings (K and V tiles of
    :data:`TC_KEYS` bf16 rows padded by 8) and their merge (the f32
    fragments of O, m and l).  The CUDA-core walk: f32 in shared memory, q
    and the accumulator of up to :data:`CC_ROWS` rows, one block of K and V
    rows padded by 4, the scores and three row vectors."""
    if arm == "tc":
        ring = TC_WARPS * TC_BUFS * 2 * TC_KEYS * (dh + 8) * 2
        merge = TC_WARPS * (dh // 2 + 4) * 32 * 4
        return DecodePlan("tc", TC_ROWS, -(-M * bs // SPLIT_KEYS),
                          max(ring, merge))
    r = min(R, CC_ROWS)
    ld = dh + 4 if dh % 4 == 0 else dh + 1
    floats = 2 * r * dh + 2 * bs * ld + r * bs + 3 * r
    return DecodePlan("cc", r, 1, floats * 4)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_paged_attention.argtypes = (
        [p] * 13 + [i] * 11 + [ctypes.c_float, i, i, i, p])
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


def _check_smem(plan, dh: int, bs: int) -> None:
    """Raise where ``plan``'s shared memory (a decode or prefill plan)
    does not fit one CTA."""
    if plan.smem > SMEM_LIMIT:
        raise ValueError(
            f"{plan.rows} query rows x dh {dh} x block {bs} take "
            f"{plan.smem} bytes of shared memory on the {plan.arm} arm, "
            f"past the {SMEM_LIMIT} one CTA may use")


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
    the kernel on :func:`_decode_arm`'s arm (or raises); a CPU tensor runs
    the plain version."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pool_k, pool_v, scale_k, scale_v, table, pos0, fill, wk, wv,
            layer=layer, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, pool_k, pool_v, scale_k, scale_v, table, pos0, fill,
                   wk, wv, layer, window)


#: kernel launches since the last reset (the main path's proof of use), and
#: those of the split walk on the tensor cores
paged_attention.launches = 0
paged_attention.launches_tc = 0

# the split walk's merge counters (zeros, left zero by the kernel) and f32
# partials, by device; grown as calls need
_workspace: dict = {}


def _split_workspace(device, n_count: int, n_part: int):
    counts, part = _workspace.get(device, (None, None))
    if counts is None or counts.numel() < n_count:
        counts = torch.zeros(max(n_count, 1), dtype=torch.int32,
                             device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1), dtype=torch.float32,
                           device=device)
    _workspace[device] = (counts, part)
    return counts, part


def _launch(q, pool_k, pool_v, scale_k, scale_v, table, pos0, fill, wk, wv,
            layer, window, arm=None):
    """Check the inputs, plan (or force ``arm``: ``"cc"`` takes any input,
    ``"tc"`` only what :func:`_decode_arm` gives it), launch and count."""
    check_paged_inputs(q, pool_k, pool_v, scale_k, scale_v, table, pos0, wk,
                       wv, layer, ints=(fill,))
    S, nh, s, dh = q.shape
    L, nb, n_kv, bs, _ = pool_k.shape
    M = table.shape[1]
    R = (nh // n_kv) * s
    planned = _decode_arm(q, pool_k, dh)
    if arm not in (None, "cc", planned):
        raise ValueError(f"arm {arm!r}: {planned!r} serves {q.dtype} over "
                         f"{pool_k.dtype} at dh {dh}")
    plan = _decode_plan(arm or planned, R, dh, bs, M)
    _check_smem(plan, dh, bs)
    counts = part = None
    if plan.arm == "tc":
        if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v, wk, wv)):
            raise ValueError("the split walk copies 16-byte chunks: q, the "
                             "pools and the window must be 16-byte aligned")
        tiles = S * n_kv * -(-R // TC_ROWS)
        counts, part = _split_workspace(
            q.device, tiles, tiles * plan.splits * (dh // 2 + 4) * 32)
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _declare)
    ptr = _build.ptr
    rc = lib.tpd_paged_attention(
        ptr(q), ptr(pool_k), ptr(pool_v), ptr(scale_k), ptr(scale_v),
        ptr(table), ptr(pos0), ptr(fill), ptr(wk), ptr(wv), ptr(out),
        ptr(part), ptr(counts), S, n_kv, R, s, dh, nb, bs, M, wk.shape[2],
        layer, 0 if window is None else int(window), float(dh ** -0.5),
        _build.dtype_code(q.dtype), _build.dtype_code(pool_k.dtype),
        _ARMS[plan.arm], _build.stream_of(q.device))
    _build.check(lib, rc, "paged_attention")
    paged_attention.launches += 1
    paged_attention.launches_tc += plan.arm == "tc"
    return out


def _paged_attention_on_arm(arm: str, q, pool_k, pool_v, scale_k, scale_v,
                            table, pos0, fill, wk, wv, *, layer: int,
                            window: Optional[int] = None):
    """:func:`paged_attention` on CUDA tensors with the arm (``"tc"`` or
    ``"cc"``; the CUDA-core arm takes any input) forced rather than
    planned, to time the arms beside each other on the same inputs."""
    if arm not in _ARMS:
        raise ValueError(f"arm {arm!r}: 'tc' or 'cc'")
    return _launch(q, pool_k, pool_v, scale_k, scale_v, table, pos0, fill,
                   wk, wv, layer, window, arm=arm)


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


def _decode_split_partials(q, pool_k, pool_v, scale_k, scale_v, table, pos0,
                           fill, wk, wv, *, layer: int,
                           window: Optional[int] = None,
                           split_keys: int = SPLIT_KEYS):
    """The split walk's per-split partials, one lane at a time (used only by
    the tests): for lane ``b`` a list of ``(m [n_kv, R], l [n_kv, R], acc
    [n_kv, R, dh])`` f32 over its live splits.  Split ``z`` owns pool keys
    ``[z·split_keys, (z + 1)·split_keys)`` below the live prefix; the split
    of the prefix's end (a new one when it ends on a span boundary, unless
    the table is full) also takes the window columns ``[0, min(W, fill +
    s))``.  Within a split: scores in f32 times ``dh**-0.5``, masked to
    -1e30 (prefix, per-query window column and sliding window as in
    :func:`paged_attention_reference`), ``m`` the row max, ``p = exp(s −
    m)`` summed unrounded into ``l`` and rounded to q's dtype for ``acc =
    p·V``.  A row with no live key in a split keeps ``m = -1e30`` there and
    ``p = 1`` on every masked key, as the kernel does."""
    S, nh, s, dh = q.shape
    _, nb, n_kv, bs, _ = pool_k.shape
    M, W = table.shape[1], wk.shape[2]
    group, R = nh // n_kv, (nh // n_kv) * s
    compute = q.dtype
    rows = table.long().clamp(max=nb - 1)
    kd = _dense_view(pool_k, scale_k, rows, layer, compute).float()
    vd = _dense_view(pool_v, scale_v, rows, layer, compute).float()
    splits = -(-M * bs // split_keys)
    i = torch.arange(s).repeat(group)                          # [R]
    out = []
    for b in range(S):
        p0, f = int(pos0[b]), int(fill[b])
        kend = min(p0, M * bs)
        pool_splits = -(-kend // split_keys)
        ws = min(kend // split_keys, splits - 1)
        qpos = p0 + f + i                                      # [R]
        qb = q[b].reshape(n_kv, R, dh).float()
        parts = []
        for z in range(max(pool_splits, ws + 1)):
            k0, k1 = z * split_keys, min(kend, (z + 1) * split_keys)
            ks, vs = [kd[b, :, k0:k1]], [vd[b, :, k0:k1]]
            abs_k = [torch.arange(k0, k1)]
            keep = [torch.ones(R, max(k1 - k0, 0), dtype=torch.bool)]
            if z == ws:
                cols = torch.arange(min(W, f + s))
                ks.append(wk[b, :, :len(cols)].float())
                vs.append(wv[b, :, :len(cols)].float())
                abs_k.append(p0 + cols)
                keep.append(cols[None] <= f + i[:, None])
            kz, vz = torch.cat(ks, 1), torch.cat(vs, 1)
            ak, live = torch.cat(abs_k), torch.cat(keep, 1)    # [K], [R, K]
            if window is not None:
                live = live & (ak[None] > qpos[:, None] - window)
            sc = torch.einsum("nrd,nkd->nrk", qb, kz) * (dh ** -0.5)
            sc = torch.where(live[None], sc, torch.tensor(_MASK_VALUE))
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[..., None])
            acc = torch.einsum("nrk,nkd->nrd", p.to(compute).float(), vz)
            parts.append((m, p.sum(dim=-1), acc))
        out.append(parts)
    return out


def _merge_split_partials(parts):
    """One lane's partials merged by logsumexp: ``Σ w_z·acc_z / Σ w_z·l_z``
    with ``w_z = exp(m_z − max m)``, so a split where a row saw no live key
    (``m_z = -1e30``) weighs 0 beside one where it did."""
    m = torch.stack([p[0] for p in parts])                     # [Z, n_kv, R]
    w = torch.exp(m - m.amax(dim=0))
    l = (w * torch.stack([p[1] for p in parts])).sum(dim=0)
    acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(dim=0)
    return acc / l[..., None]


def _decode_split_reference(q, pool_k, pool_v, scale_k, scale_v, table,
                            pos0, fill, wk, wv, *, layer: int,
                            window: Optional[int] = None,
                            split_keys: int = SPLIT_KEYS):
    """Plain PyTorch model of the split walk's schedule (used only by the
    tests): :func:`_decode_split_partials` merged per lane by
    :func:`_merge_split_partials`.  Returns ``[S, n_heads, s, dh]`` in q's
    dtype, the contract of :func:`paged_attention_reference`."""
    S, nh, s, dh = q.shape
    lanes = _decode_split_partials(
        q, pool_k, pool_v, scale_k, scale_v, table, pos0, fill, wk, wv,
        layer=layer, window=window, split_keys=split_keys)
    out = torch.stack([_merge_split_partials(parts) for parts in lanes])
    return out.reshape(S, nh, s, dh).to(q.dtype)
