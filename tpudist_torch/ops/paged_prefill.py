"""Paged prefill attention with in-kernel KV block writes.

The PyTorch/CUDA counterpart of :mod:`tpudist.ops.paged_prefill`.  On a
CUDA tensor :func:`paged_prefill_attention` launches the hand-written
Hopper kernel ``csrc/paged_prefill.cu`` (attention over the pool prefix plus
the causal chunk, then the touched blocks merged and requantized into
separate outputs); on a CPU tensor it runs :func:`paged_prefill_reference`.
The attention has two arms, chosen by :func:`_prefill_plan`: bf16
tensor-core tiles (``mma.sync``) at head dims 16, 32, 64 and 128, and the
CUDA-core code shared with the decode kernel for f32 and other head dims.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from tpudist_torch.ops import _build
from tpudist_torch.ops.paged_attention import (CC_ROWS, SMEM_LIMIT,
                                               _MASK_VALUE, _check_smem,
                                               _decode_plan, _dense_view,
                                               check_paged_inputs)

#: head dims the tensor-core arm is instantiated for (bf16 tiles take
#: multiples of 16, up to 128: the decode's split walk's set)
TC_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
#: keys per K/V tile of the tensor-core arm (csrc/paged_prefill.cu kTile)
#: and its K/V tile buffers (kStages)
TC_TILE, TC_STAGES = 64, 3
#: query rows per CTA of the tensor-core arm (kRows: 64 rows ran faster
#: than 32 on the H100 in every timed call)
TC_ROWS = 64


class PrefillPlan(NamedTuple):
    """How one call launches: the arm (``"tc"`` tensor cores, ``"cc"``
    CUDA cores), query rows per CTA and shared memory per CTA (bytes)."""

    arm: str
    rows: int
    smem: int


def _prefill_plan(dtype, dh: int, R: int, bs: int) -> PrefillPlan:
    """The launch of one kv head group of ``R = group * P`` query rows at
    head dim ``dh`` and KV block ``bs`` in compute dtype ``dtype``: bf16 at
    a head dim of :data:`TC_HEAD_DIMS` takes the tensor-core arm
    (:data:`TC_ROWS` rows a CTA: Q, then :data:`TC_STAGES` K and V tiles of
    :data:`TC_TILE` keys, bf16 rows padded by 8), anything else the
    CUDA-core arm (f32 in shared memory: q and the accumulator of up to
    :data:`CC_ROWS` rows, one block of K and V rows padded by 4, the
    scores and three row vectors)."""
    if dtype == torch.bfloat16 and dh in TC_HEAD_DIMS:
        return PrefillPlan(
            "tc", TC_ROWS, (TC_ROWS + 2 * TC_STAGES * TC_TILE) * (dh + 8) * 2)
    return _cc_plan(dh, R, bs)


def _cc_plan(dh: int, R: int, bs: int) -> PrefillPlan:
    """The CUDA-core arm: the decode kernel's walk (its plan)."""
    plan = _decode_plan("cc", R, dh, bs, 1)
    return PrefillPlan("cc", plan.rows, plan.smem)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_paged_prefill.argtypes = (
        [p] * 16 + [i] * 11 + [ctypes.c_float, i, i, i, p])
    lib.tpd_paged_prefill.restype = i


def paged_prefill_attention(q, k_new, v_new, pool_k, pool_v, scale_k,
                            scale_v, table, wtable, pos0, clen, *,
                            layer: int, window: Optional[int] = None):
    """Paged prefill attention + block writes, one model layer.

    - ``q [S, n_heads, P, dh]`` — the chunk's queries at absolute
      positions ``pos0 + i`` (rope-rotated);
    - ``k_new``/``v_new [S, n_kv, P, dh]`` — the chunk's K/V in q's dtype;
    - pool, scales, ``table``, ``pos0`` — as in
      :func:`tpudist_torch.ops.paged_attention.paged_attention`;
    - ``wtable [S, Mw]`` int32 — ids of the blocks the chunk touches
      (logical block ``pos0 // bs + w``), sentinel ``nb`` past the span;
    - ``clen [S]`` int32 — each lane's live chunk length (``<= P``).

    Returns ``(o, qk, qv, sk, sv)``: ``o [S, n_heads, P, dh]``, the touched
    blocks ``[S, Mw, n_kv, bs, dh]`` in the pool's dtype and their scales
    ``[S, Mw, n_kv]`` f32 (ones unless int8) — for ``commit_quantized``."""
    if q.device.type == "cpu":
        return paged_prefill_reference(
            q, k_new, v_new, pool_k, pool_v, scale_k, scale_v, table,
            wtable, pos0, clen, layer=layer, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k_new, v_new, pool_k, pool_v, scale_k, scale_v,
                   table, wtable, pos0, clen, layer, window)


#: kernel launches since the last reset (the main path's proof of use);
#: ``launches_tc`` / ``launches_cc`` split them by arm
paged_prefill_attention.launches = 0
paged_prefill_attention.launches_tc = 0
paged_prefill_attention.launches_cc = 0


def _launch(q, k_new, v_new, pool_k, pool_v, scale_k, scale_v, table,
            wtable, pos0, clen, layer, window, arm=None, writes=True):
    """Check the inputs, plan (or force ``arm``, ``"tc"`` or ``"cc"``),
    launch and count the launch; without ``writes`` the kernel writes no
    block (zero-size block outputs)."""
    check_paged_inputs(q, pool_k, pool_v, scale_k, scale_v, table, pos0,
                       k_new, v_new, layer, ints=(wtable, clen))
    S, nh, P, dh = q.shape
    L, nb, n_kv, bs, _ = pool_k.shape
    if k_new.shape[2] != P:
        raise ValueError(f"chunk K/V length {k_new.shape[2]} != q's {P}")
    if wtable.dim() != 2 or wtable.shape[0] != S or clen.shape != (S,):
        raise ValueError("wtable must be [S, Mw] and clen [S]")
    Mw = wtable.shape[1] if writes else 0
    R = (nh // n_kv) * P
    if arm == "cc":
        plan = _cc_plan(dh, R, bs)
    else:
        plan = _prefill_plan(q.dtype, dh, R, bs)
        if arm not in (None, plan.arm):
            raise ValueError(f"arm {arm!r}: {plan.arm!r} serves {q.dtype} "
                             f"at dh {dh}")
    _check_smem(plan, dh, bs)
    o = torch.empty_like(q)
    if plan.arm == "tc" and any(
            t.data_ptr() % 16 for t in (q, k_new, v_new, pool_k, pool_v, o)):
        raise ValueError("the tensor-core arm copies 16-byte chunks: q, the "
                         "chunk K/V and the pools must be 16-byte aligned")
    qk = torch.empty((S, Mw, n_kv, bs, dh), dtype=pool_k.dtype,
                     device=q.device)
    qv = torch.empty_like(qk)
    sk = torch.empty((S, Mw, n_kv), dtype=torch.float32, device=q.device)
    sv = torch.empty_like(sk)
    lib = _build.load("paged_prefill", _declare)
    ptr = _build.ptr
    rc = lib.tpd_paged_prefill(
        ptr(q), ptr(k_new), ptr(v_new), ptr(pool_k), ptr(pool_v),
        ptr(scale_k), ptr(scale_v), ptr(table), ptr(wtable), ptr(pos0),
        ptr(clen), ptr(o), ptr(qk), ptr(qv), ptr(sk), ptr(sv),
        S, n_kv, R, P, dh, nb, bs, table.shape[1], Mw, layer,
        0 if window is None else int(window), float(dh ** -0.5),
        _build.dtype_code(q.dtype), _build.dtype_code(pool_k.dtype),
        int(plan.arm == "tc"), _build.stream_of(q.device))
    _build.check(lib, rc, "paged_prefill_attention")
    fn = paged_prefill_attention
    fn.launches += 1
    if plan.arm == "tc":
        fn.launches_tc += 1
    else:
        fn.launches_cc += 1
    return o, qk, qv, sk, sv


def _paged_prefill_on_arm(arm: str, q, k_new, v_new, pool_k, pool_v,
                          scale_k, scale_v, table, wtable, pos0, clen, *,
                          layer: int, window: Optional[int] = None,
                          writes: bool = True):
    """:func:`paged_prefill_attention` on CUDA tensors with the arm
    (``"tc"`` or ``"cc"``; the CUDA-core arm takes any dtype and head dim)
    forced rather than planned, to time the arms beside each other on the
    same inputs; ``writes=False`` times the attention alone."""
    if arm not in ("tc", "cc"):
        raise ValueError(f"arm {arm!r}: 'tc' or 'cc'")
    return _launch(q, k_new, v_new, pool_k, pool_v, scale_k, scale_v, table,
                   wtable, pos0, clen, layer, window, arm=arm, writes=writes)


def paged_prefill_reference(q, k_new, v_new, pool_k, pool_v, scale_k,
                            scale_v, table, wtable, pos0, clen, *,
                            layer: int, window: Optional[int] = None):
    """Plain PyTorch version of :func:`paged_prefill_attention` — same
    mask, merge and quantization contract, gathered to dense."""
    S, nh, P, dh = q.shape
    _, nb, n_kv, bs, _ = pool_k.shape
    M = table.shape[1]
    Mw = wtable.shape[1]
    group = nh // n_kv
    compute = q.dtype
    dev = q.device
    rows = table.long().clamp(max=nb - 1)
    ks = torch.cat([_dense_view(pool_k, scale_k, rows, layer, compute),
                    k_new.to(compute)], dim=2)
    vs = torch.cat([_dense_view(pool_v, scale_v, rows, layer, compute),
                    v_new.to(compute)], dim=2)
    qg = q.reshape(S, n_kv, group, P, dh)
    scores = torch.einsum("bngqd,bnkd->bngqk", qg.float(), ks.float()) \
        * (dh ** -0.5)
    pos0 = pos0.long()
    clen = clen.long()
    kpos = torch.arange(M * bs + P, device=dev)
    in_pool = kpos < M * bs
    row = torch.arange(P, device=dev)
    live = torch.where(
        in_pool[None, None],
        kpos[None, None] < pos0[:, None, None],
        (kpos[None, None] - M * bs) <= row[None, :, None])
    if window is not None:
        qpos = pos0[:, None] + row[None]
        abs_k = torch.where(in_pool[None, None], kpos[None, None],
                            pos0[:, None, None] + kpos[None, None] - M * bs)
        live = live & (abs_k > qpos[:, :, None] - window)
    scores = torch.where(live[:, None, None], scores,
                         torch.tensor(_MASK_VALUE, device=dev))
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", w.to(compute).float(), vs.float())
    o = o.reshape(S, nh, P, dh).to(q.dtype)

    # writes: merge the chunk into the touched blocks, requantize
    wrows = wtable.long().clamp(max=nb - 1)                    # [S, Mw]
    blk0 = (torch.div(pos0, bs, rounding_mode="floor")[:, None]
            + torch.arange(Mw, device=dev)[None]) * bs         # [S, Mw]
    kpos_w = blk0[..., None] + torch.arange(bs, device=dev)    # [S, Mw, bs]
    in_new = ((kpos_w >= pos0[:, None, None])
              & (kpos_w < (pos0 + clen)[:, None, None]))
    ci = (kpos_w - pos0[:, None, None]).clamp(0, P - 1)

    def write(chunk, pool, scale):
        orig = pool[layer][wrows].to(compute)          # [S, Mw, nk, bs, dh]
        if pool.dtype == torch.int8:
            orig = orig * scale[layer][wrows][..., None, None].to(compute)
        idx = ci[:, :, None, :, None].expand(S, Mw, n_kv, bs, dh)
        src = chunk[:, None].expand(S, Mw, n_kv, P, dh)
        new = torch.gather(src, 3, idx)
        merged = torch.where(in_new[:, :, None, :, None], new.to(compute),
                             orig)
        if pool.dtype == torch.int8:
            v32 = merged.float()
            amax = v32.abs().amax(dim=(-2, -1))
            # divide by a tensor: PyTorch's CUDA division by a Python
            # scalar multiplies by its reciprocal, not IEEE amax / 127
            sc = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                             torch.ones_like(amax))
            qq = torch.clamp(torch.round(v32 / sc[..., None, None]),
                             -127, 127).to(torch.int8)
            return qq, sc.float()
        return (merged.to(pool.dtype),
                torch.ones((S, Mw, n_kv), dtype=torch.float32, device=dev))

    qk, sk = write(k_new, pool_k, scale_k)
    qv, sv = write(v_new, pool_v, scale_v)
    return o, qk, qv, sk, sv
