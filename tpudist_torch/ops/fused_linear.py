"""Fused linear kernels of the adapter serving path: RoPE+QKV and the LoRA
gather-matmul.

The PyTorch/CUDA counterparts of :mod:`tpudist.ops.fused_linear`.  On CUDA
tensors the wrappers launch the hand-written Hopper kernels
``csrc/fused_rope_qkv.cu`` and ``csrc/lora_delta.cu`` (see their headers for
the designs and what bounds them); on CPU tensors they run the plain
versions :func:`fused_rope_qkv_reference` and :func:`lora_delta_reference`.
Arguments keep the JAX package's layouts.
"""

from __future__ import annotations

import ctypes

import torch

from tpudist_torch.ops import _build

#: LoRA ranks the CUDA kernel is instantiated for (``csrc/lora_delta.cu``)
LORA_RANKS = (1, 2, 4, 8, 16, 32, 64)
#: rows a slot up to which ``lora_delta`` takes the cluster arm (decode,
#: the draft steps, the speculative verify's K + 1); ``csrc/lora_delta.cu``
#: kDecodeRows
LORA_DECODE_ROWS = 8


def _declare_rope(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_fused_rope_qkv.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float,
                                                            i, p]
    lib.tpd_fused_rope_qkv.restype = i


def _declare_lora(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_lora_delta.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.tpd_lora_delta.restype = i
    lib.tpd_lora_max_clusters.argtypes = [i, ctypes.POINTER(i)]
    lib.tpd_lora_max_clusters.restype = i


def _lora_arm(T: int) -> str:
    """``lora_delta``'s CUDA arm for ``T`` rows a slot: ``"cluster"`` (one
    thread-block cluster a slot splitting the factors, its partial sums
    meeting in distributed shared memory) up to :data:`LORA_DECODE_ROWS`,
    ``"staged"`` (A staged through shared memory, 16 rows a CTA) past it."""
    return "cluster" if T <= LORA_DECODE_ROWS else "staged"


def lora_max_active_clusters(S: int = 8) -> int:
    """How many clusters of ``lora_delta``'s cluster arm (bf16, rank 8, a
    grid for ``S`` slots) the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _build.load("lora_delta", _declare_lora)
    n = ctypes.c_int(0)
    _build.check(lib, lib.tpd_lora_max_clusters(S, ctypes.byref(n)),
                 "lora_delta cluster occupancy")
    return n.value


def _check_qkv_args(h, w, offsets, extra, on, n_heads, n_kv, dh):
    if h.dim() != 3:
        raise ValueError(f"h must be [S, T, d], got {tuple(h.shape)}")
    S, T, d = h.shape
    dtot = (n_heads + 2 * n_kv) * dh
    if w.dim() != 2 or w.shape[0] != d or w.shape[1] != dtot:
        raise ValueError(f"qkv kernel shape {tuple(w.shape)} does not match "
                         f"d={d}, n_heads={n_heads}, n_kv={n_kv}, dh={dh}")
    if n_kv < 1 or n_heads % n_kv:
        raise ValueError(f"n_heads {n_heads} must be a multiple of n_kv "
                         f"{n_kv}")
    if offsets.shape != (S,):
        raise ValueError(f"offsets must be [S] = [{S}]")
    if extra is not None and extra.shape != (S, T, dtot):
        raise ValueError(f"extra must be {(S, T, dtot)}, got "
                         f"{tuple(extra.shape)}")
    if on is not None and on.shape != (S,):
        raise ValueError(f"on must be [S] = [{S}]")
    return S, T, d, dtot


def fused_rope_qkv(h, w, offsets, extra=None, on=None, *, n_heads: int,
                   n_kv: int, dh: int, base: float = 10000.0,
                   rope: bool = True):
    """Fused QKV projection + head split + rotary embedding.

    - ``h [S, T, d]`` — post-norm activations in the compute dtype;
    - ``w [d, n_heads·dh + 2·n_kv·dh]`` — the qkv projection in the JAX
      layout.  The port's ``Block.qkv`` is ``[dtot, d]``: pass its
      transposed view ``qkv.t()``, which the kernel reads in place (a
      row-major ``w`` is copied to that form first);
    - ``offsets [S]`` int32 — each slot's absolute position of its first
      row;
    - ``extra [S, T, dtot]`` — an optional additive delta (the LoRA qkv
      delta), applied before the rotation where ``on [S]`` (int32 or bool)
      is non-zero; ``on=None`` applies it everywhere;
    - ``rope=False`` skips the rotation.

    Returns ``(q [S, n_heads, T, dh], k [S, n_kv, T, dh], v)``, contiguous,
    in ``h``'s dtype, with q and k rotated."""
    S, T, d, dtot = _check_qkv_args(h, w, offsets, extra, on, n_heads, n_kv,
                                    dh)
    if h.device.type == "cpu":
        return fused_rope_qkv_reference(h, w, offsets, extra, on,
                                        n_heads=n_heads, n_kv=n_kv, dh=dh,
                                        base=base, rope=rope)
    if h.device.type != "cuda":
        raise ValueError(f"fused_rope_qkv runs on cuda or cpu, not "
                         f"{h.device}")
    if h.dtype not in (torch.float32, torch.bfloat16) or w.dtype != h.dtype \
            or (extra is not None and extra.dtype != h.dtype):
        raise TypeError(f"h, w and extra must share one dtype (float32 or "
                        f"bfloat16), got {h.dtype} / {w.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError("offsets must be int32")
    if on is not None and on.dtype not in (torch.int32, torch.bool):
        raise TypeError("on must be int32 or bool")
    if dh % 32:
        raise ValueError(f"fused_rope_qkv's CUDA kernel is instantiated for "
                         f"head dims that are multiples of 32, not {dh}")
    if d % 64:
        raise ValueError(f"fused_rope_qkv's CUDA kernel takes d_model a "
                         f"multiple of 64, not {d}")
    wt = w.t()
    if not wt.is_contiguous():
        wt = wt.contiguous()
    for t in (h, offsets, extra, on, wt):
        if t is not None and t.device != h.device:
            raise ValueError(f"tensor on {t.device}, h on {h.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError("fused_rope_qkv takes contiguous h, offsets, "
                             "extra and on")
    q = torch.empty(S, n_heads, T, dh, dtype=h.dtype, device=h.device)
    k = torch.empty(S, n_kv, T, dh, dtype=h.dtype, device=h.device)
    v = torch.empty_like(k)
    if S * T == 0:
        return q, k, v
    lib = _build.load("fused_rope_qkv", _declare_rope)
    ptr = _build.ptr
    rc = lib.tpd_fused_rope_qkv(
        ptr(h), ptr(wt), ptr(offsets), ptr(extra), ptr(on), ptr(q), ptr(k),
        ptr(v), S, T, d, n_heads, n_kv, dh,
        int(on is not None and on.dtype == torch.bool), int(bool(rope)),
        float(base), _build.dtype_code(h.dtype),
        _build.stream_of(h.device))
    _build.check(lib, rc, "fused_rope_qkv")
    fused_rope_qkv.launches += 1
    return q, k, v


#: kernel launches since the last reset (the main path's proof of use)
fused_rope_qkv.launches = 0


def fused_rope_qkv_reference(h, w, offsets, extra=None, on=None, *,
                             n_heads: int, n_kv: int, dh: int,
                             base: float = 10000.0, rope: bool = True):
    """Plain PyTorch version of :func:`fused_rope_qkv`: the product in
    ``h``'s dtype, the ``on`` select of ``+ extra``, the head split and
    :func:`~tpudist_torch.models.transformer.rope_rotate` — the port's
    unfused arm composed as the JAX reference composes it."""
    from tpudist_torch.models.transformer import rope_rotate

    S, T, _ = h.shape
    qkv = torch.matmul(h, w)
    if extra is not None:
        m = (torch.ones(S, dtype=torch.bool, device=h.device) if on is None
             else on != 0)
        qkv = torch.where(m[:, None, None], qkv + extra, qkv)

    def heads(t, n):
        return t.reshape(S, T, n, dh).transpose(1, 2).contiguous()

    q = heads(qkv[..., :n_heads * dh], n_heads)
    k = heads(qkv[..., n_heads * dh:(n_heads + n_kv) * dh], n_kv)
    v = heads(qkv[..., (n_heads + n_kv) * dh:], n_kv)
    if rope:
        q = rope_rotate(q, base=base, offset=offsets)
        k = rope_rotate(k, base=base, offset=offsets)
    return q, k, v


def lora_delta(x, pool_a, pool_b, ids, *, layer: int):
    """LoRA gather-matmul: ``delta[s] = (x[s] @ A[ids[s]]) @ B[ids[s]]``
    without gathering the factors.

    - ``x [S, T, d_in]`` — activations in the compute dtype;
    - ``pool_a [L, B, d_in, r]`` / ``pool_b [L, B, r, d_out]`` — the FULL
      f32 adapter pools, rounded to the compute dtype as they are read;
    - ``ids [S]`` int32 — per-slot adapter blocks (the sentinel ``B``
      clamps to ``B - 1``; the caller's ``on`` select discards it).

    Returns ``[S, T, d_out]`` in ``x``'s dtype.  On CUDA, ``T`` up to
    :data:`LORA_DECODE_ROWS` takes the cluster arm (:func:`_lora_arm`;
    ``lora_delta.launches_cluster`` counts it), longer ``T`` the staged
    kernel."""
    if x.dim() != 3 or pool_a.dim() != 4 or pool_b.dim() != 4:
        raise ValueError("x must be [S, T, d_in], the pools [L, B, ...]")
    S, T, d_in = x.shape
    L, B, pd_in, r = pool_a.shape
    d_out = pool_b.shape[-1]
    if pd_in != d_in or pool_b.shape[:3] != (L, B, r):
        raise ValueError(f"pools {tuple(pool_a.shape)} / "
                         f"{tuple(pool_b.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if ids.shape != (S,):
        raise ValueError(f"ids must be [S] = [{S}]")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if x.device.type == "cpu":
        return lora_delta_reference(x, pool_a, pool_b, ids, layer=layer)
    if x.device.type != "cuda":
        raise ValueError(f"lora_delta runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if pool_a.dtype != torch.float32 or pool_b.dtype != torch.float32:
        raise TypeError("the adapter pools must be float32")
    if ids.dtype != torch.int32:
        raise TypeError("ids must be int32")
    if r not in LORA_RANKS:
        raise ValueError(f"lora_delta's CUDA kernel is instantiated for "
                         f"ranks {LORA_RANKS}, not {r}")
    for t in (x, pool_a, pool_b, ids):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("lora_delta takes contiguous tensors")
    return _launch_lora(_lora_arm(T), x, pool_a, pool_b, ids, layer)


def _launch_lora(arm: str, x, pool_a, pool_b, ids, layer: int):
    """Launch ``lora_delta``'s kernel on ``arm`` (``"cluster"`` or
    ``"staged"``) for arguments :func:`lora_delta` has checked; only
    ``chip_smoke.py`` and the CUDA tests force an arm."""
    S, T, d_in = x.shape
    B, r, d_out = pool_a.shape[1], pool_a.shape[3], pool_b.shape[-1]
    if arm not in ("cluster", "staged") or (
            arm == "cluster" and T > LORA_DECODE_ROWS):
        raise ValueError(f"no lora_delta arm {arm!r} for T {T}")
    out = torch.empty(S, T, d_out, dtype=x.dtype, device=x.device)
    if S * T * d_out == 0:
        return out
    lib = _build.load("lora_delta", _declare_lora)
    ptr = _build.ptr
    cluster = arm == "cluster"
    rc = lib.tpd_lora_delta(ptr(x), ptr(pool_a), ptr(pool_b), ptr(ids),
                            ptr(out), S, T, d_in, d_out, B, r, layer,
                            _build.dtype_code(x.dtype), int(cluster),
                            _build.stream_of(x.device))
    _build.check(lib, rc, "lora_delta")
    lora_delta.launches += 1
    lora_delta.launches_cluster += cluster
    return out


#: kernel launches since the last reset (the main path's proof of use), and
#: those of them on the cluster arm
lora_delta.launches = 0
lora_delta.launches_cluster = 0


def lora_delta_reference(x, pool_a, pool_b, ids, *, layer: int):
    """Plain PyTorch version of :func:`lora_delta`: the clamped gather of
    each slot's factors, rounded to ``x``'s dtype, and the double
    product."""
    B = pool_a.shape[1]
    rows = ids.long().clamp(0, B - 1)
    a = pool_a[layer][rows].to(x.dtype)     # [S, d_in, r]
    b = pool_b[layer][rows].to(x.dtype)     # [S, r, d_out]
    return torch.bmm(torch.bmm(x, a), b)
