"""Fused linear kernels of the adapter serving path: RoPE+QKV and the LoRA
gather-matmul.

The PyTorch/CUDA counterparts of :mod:`tpudist.ops.fused_linear`.  On CUDA
tensors the wrappers launch the hand-written Hopper kernels
``csrc/fused_rope_qkv.cu`` and ``csrc/lora_delta.cu`` (see their headers for
the designs and what bounds them); on CPU tensors they run the plain
versions :func:`fused_rope_qkv_reference` and :func:`lora_delta_reference`.
:func:`_rope_qkv_split_reference` is the plain model of the RoPE+QKV split
arm's depth sum, for the tests.  Arguments keep the JAX package's layouts.
"""

from __future__ import annotations

import ctypes

import torch

from tpudist_torch.ops import _build

#: ``fused_rope_qkv``'s CUDA arms, by their code in
#: ``csrc/fused_rope_qkv.cu`` (enum Arm)
ROPE_ARMS = ("f32", "mma", "split", "wgmma")
#: rows (S·T) up to which bf16 takes the split arm (kSplitRows), its CTAs a
#: cluster, one depth slice each (kSplitKS), and the depth it takes at most
#: (kSplitMaxDepth)
ROPE_SPLIT_ROWS, ROPE_SPLIT_KS, ROPE_SPLIT_MAX_D = 64, 8, 8192
#: output columns a split cluster owns (kSplitCols): half of them rotation
#: pairs' first halves, half their partners, so the head dim must be a
#: multiple of it; the split arm also cuts the depth in 16-deep steps, and
#: the wgmma arm in 64-deep tiles (ROPE_WGMMA_DEPTH)
ROPE_SPLIT_COLS = 64
ROPE_SPLIT_STEP, ROPE_WGMMA_DEPTH = 16, 64
#: the wgmma arm's rows a CTA (kWgRows), its ring stages of 64-deep tiles
#: (kWgStages) and the head dims it is instantiated for
ROPE_TILE_ROWS, ROPE_STAGES = 64, 4
ROPE_WGMMA_HEAD_DIMS = (64, 128)
#: the rank widths ``csrc/lora_delta.cu`` is compiled for with the rank
#: fixed at the width, and the padded widths that take any other rank at
#: run time: the first that holds it, its columns past the rank zero; a
#: rank past the widest in chunks of it
LORA_RANK_WIDTHS = (1, 2, 4, 8, 16, 32, 64)
LORA_PAD_WIDTHS = (4, 16, 64)
#: the widest rank the cluster arm takes (its ``[T, r]`` intermediate lives
#: in 32·r bytes of shared memory); wider ranks take the staged arm
LORA_CLUSTER_MAX_RANK = 4096
#: rows a slot up to which ``lora_delta`` takes the cluster arm (decode,
#: the draft steps, the speculative verify's K + 1); ``csrc/lora_delta.cu``
#: kDecodeRows
LORA_DECODE_ROWS = 8


def _declare_rope(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_fused_rope_qkv.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float,
                                                            i, i, p]
    lib.tpd_fused_rope_qkv.restype = i
    lib.tpd_rope_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.tpd_rope_max_clusters.restype = i
    lib.tpd_rope_empty.argtypes = [i, i, p]
    lib.tpd_rope_empty.restype = i


def _rope_arm(M: int, dh: int, d: int, dtype) -> str:
    """``fused_rope_qkv``'s CUDA arm for ``M = S·T`` rows of depth ``d`` at
    head dim ``dh``: ``"f32"`` for float32; for bfloat16 ``"split"`` (the
    depth split over a thread-block cluster, partial sums meeting in
    distributed shared memory) up to :data:`ROPE_SPLIT_ROWS` rows and
    :data:`ROPE_SPLIT_MAX_D` deep (a multiple of :data:`ROPE_SPLIT_STEP`) at
    head dims that are multiples of :data:`ROPE_SPLIT_COLS`, else
    ``"wgmma"`` (64-row x one-head tiles over a TMA ring) at head dims
    :data:`ROPE_WGMMA_HEAD_DIMS` and depths in whole
    :data:`ROPE_WGMMA_DEPTH` tiles, else ``"mma"`` (64 x 32 tiles on
    mma.sync: any head dim and depth)."""
    if dtype == torch.float32:
        return "f32"
    if _rope_takes("split", M, dh, d):
        return "split"
    return "wgmma" if _rope_takes("wgmma", M, dh, d) else "mma"


def _rope_takes(arm: str, M: int, dh: int, d: int) -> bool:
    """Whether bf16 ``arm`` takes ``M`` rows of depth ``d`` at head dim
    ``dh`` (the mma.sync arm takes every shape)."""
    if arm == "split":
        return (M <= ROPE_SPLIT_ROWS and d <= ROPE_SPLIT_MAX_D
                and d % ROPE_SPLIT_STEP == 0 and dh % ROPE_SPLIT_COLS == 0)
    if arm == "wgmma":
        return dh in ROPE_WGMMA_HEAD_DIMS and d % ROPE_WGMMA_DEPTH == 0
    return arm == "mma"


def rope_max_active_clusters(M: int = 8, d: int = 1024,
                             dtot: int = 3072) -> int:
    """How many clusters of ``fused_rope_qkv``'s split arm (``M`` rows,
    depth ``d``, ``dtot`` output columns) the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _build.load("fused_rope_qkv", _declare_rope)
    n = ctypes.c_int(0)
    _build.check(lib, lib.tpd_rope_max_clusters(M, d, dtot, ctypes.byref(n)),
                 "fused_rope_qkv cluster occupancy")
    return n.value


def _launch_empty(ctas: int = 1, cluster: bool = False):
    """Launch an empty kernel of ``ctas`` CTAs (in clusters of
    :data:`ROPE_SPLIT_KS` with ``cluster``) on the current CUDA stream: the
    timer's floor for a launch of that grid (``chip_smoke.py`` only)."""
    lib = _build.load("fused_rope_qkv", _declare_rope)
    _build.check(lib, lib.tpd_rope_empty(ctas, int(cluster),
                                         _build.stream_of("cuda")),
                 "empty kernel")


def _declare_lora(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_lora_delta.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.tpd_lora_delta.restype = i
    lib.tpd_lora_max_clusters.argtypes = [i, ctypes.POINTER(i)]
    lib.tpd_lora_max_clusters.restype = i


def _lora_arm(T: int, r: int = 1) -> str:
    """``lora_delta``'s CUDA arm for ``T`` rows a slot at rank ``r``:
    ``"cluster"`` (one thread-block cluster a slot splitting the factors,
    its partial sums meeting in distributed shared memory) up to
    :data:`LORA_DECODE_ROWS` rows and :data:`LORA_CLUSTER_MAX_RANK`,
    ``"staged"`` (A staged through shared memory, 16 rows a CTA) past
    either."""
    return ("cluster" if T <= LORA_DECODE_ROWS
            and r <= LORA_CLUSTER_MAX_RANK else "staged")


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
    - ``rope=False`` skips the rotation (any head dim; the rotation splits
      the head dim in halves, so ``rope=True`` takes an even one, as the
      JAX kernel's rotation does).

    Returns ``(q [S, n_heads, T, dh], k [S, n_kv, T, dh], v)``, contiguous,
    in ``h``'s dtype, with q and k rotated.  On CUDA the arm follows
    :func:`_rope_arm`; ``fused_rope_qkv.launches_split`` and
    ``.launches_wgmma`` count the split and wgmma arms."""
    S, T, d, dtot = _check_qkv_args(h, w, offsets, extra, on, n_heads, n_kv,
                                    dh)
    if rope and dh % 2:
        raise ValueError(f"the rotation splits a head in halves: an odd head "
                         f"dim {dh} takes rope=False (ROADMAP A6f)")
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
    for t in (h, offsets, extra, on, w):
        if t is not None and t.device != h.device:
            raise ValueError(f"tensor on {t.device}, h on {h.device}")
        if t is not None and t is not w and not t.is_contiguous():
            raise ValueError("fused_rope_qkv takes contiguous h, offsets, "
                             "extra and on")
    return _launch_rope(_rope_arm(S * T, dh, d, h.dtype), h, w, offsets,
                        extra, on, n_heads=n_heads, n_kv=n_kv, dh=dh,
                        base=base, rope=rope)


_FREQS: dict = {}


def _rope_freqs(half: int, base: float, device):
    """The device's table of :func:`~tpudist_torch.models.transformer.
    rope_freqs` for ``(half, base)``, formed once."""
    key = (half, float(base), str(device))
    if key not in _FREQS:
        from tpudist_torch.models.transformer import rope_freqs

        _FREQS[key] = rope_freqs(half, base, device)
    return _FREQS[key]


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes
    (the kernels read h and the weight 16 bytes at a time)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _launch_rope(arm: str, h, w, offsets, extra=None, on=None, *,
                 n_heads: int, n_kv: int, dh: int, base: float = 10000.0,
                 rope: bool = True):
    """Launch ``fused_rope_qkv``'s kernel on ``arm`` (one of
    :data:`ROPE_ARMS`) for CUDA arguments :func:`fused_rope_qkv` has
    checked; only ``chip_smoke.py`` and the CUDA tests force an arm.  An
    arm the shapes or the dtype do not fit raises before any launch."""
    S, T, d = h.shape
    M, bf16 = S * T, h.dtype == torch.bfloat16
    if arm not in ROPE_ARMS or (arm == "f32") == bf16 or (
            bf16 and not _rope_takes(arm, M, dh, d)):
        raise ValueError(f"no fused_rope_qkv arm {arm!r} for {h.dtype}, "
                         f"S·T {M}, d {d}, head dim {dh}")
    wt = w.t()
    if not wt.is_contiguous():
        wt = wt.contiguous()
    h, wt, extra = _aligned(h), _aligned(wt), _aligned(extra)
    freqs = (_rope_freqs(dh // 2, base, h.device)
             if arm in ("split", "wgmma") else None)
    q = torch.empty(S, n_heads, T, dh, dtype=h.dtype, device=h.device)
    k = torch.empty(S, n_kv, T, dh, dtype=h.dtype, device=h.device)
    v = torch.empty_like(k)
    if M == 0:
        return q, k, v
    lib = _build.load("fused_rope_qkv", _declare_rope)
    ptr = _build.ptr
    rc = lib.tpd_fused_rope_qkv(
        ptr(h), ptr(wt), ptr(offsets), ptr(extra), ptr(on), ptr(freqs),
        ptr(q), ptr(k), ptr(v), S, T, d, n_heads, n_kv, dh,
        int(on is not None and on.dtype == torch.bool), int(bool(rope)),
        float(base), _build.dtype_code(h.dtype), ROPE_ARMS.index(arm),
        _build.stream_of(h.device))
    _build.check(lib, rc, "fused_rope_qkv")
    fused_rope_qkv.launches += 1
    fused_rope_qkv.launches_split += arm == "split"
    fused_rope_qkv.launches_wgmma += arm == "wgmma"
    return q, k, v


#: kernel launches since the last reset (the main path's proof of use), and
#: those of them on the split and on the wgmma arm
fused_rope_qkv.launches = 0
fused_rope_qkv.launches_split = 0
fused_rope_qkv.launches_wgmma = 0


def fused_rope_qkv_reference(h, w, offsets, extra=None, on=None, *,
                             n_heads: int, n_kv: int, dh: int,
                             base: float = 10000.0, rope: bool = True):
    """Plain PyTorch version of :func:`fused_rope_qkv`: the product in
    ``h``'s dtype, the ``on`` select of ``+ extra``, the head split and
    :func:`~tpudist_torch.models.transformer.rope_rotate` — the port's
    unfused arm composed as the JAX reference composes it."""
    return _finish_qkv(torch.matmul(h, w), offsets, extra, on,
                       n_heads=n_heads, n_kv=n_kv, dh=dh, base=base,
                       rope=rope)


def _rope_qkv_split_reference(h, w, offsets, extra=None, on=None, *,
                              n_heads: int, n_kv: int, dh: int,
                              base: float = 10000.0, rope: bool = True,
                              ks: int = ROPE_SPLIT_KS):
    """Plain model of the split arm's sum: the depth cut into ``ks`` slices
    of whole 16-deep steps as ``csrc/fused_rope_qkv.cu`` cuts it (the last
    slices shorter or empty), each slice's product in f32, the partials
    summed in rank order and rounded to ``h``'s dtype once; then the delta,
    the head split and the rotation of :func:`fused_rope_qkv_reference`."""
    d = h.shape[-1]
    if d % 16:
        raise ValueError(f"the split arm cuts the depth in 16-deep steps, "
                         f"not {d}")
    per = -(-(d // 16) // ks)
    acc = None
    for r in range(ks):
        k0, k1 = min(d, 16 * r * per), min(d, 16 * (r + 1) * per)
        part = torch.matmul(h[..., k0:k1].float(), w[k0:k1].float())
        acc = part if acc is None else acc + part
    return _finish_qkv(acc.to(h.dtype), offsets, extra, on, n_heads=n_heads,
                       n_kv=n_kv, dh=dh, base=base, rope=rope)


def _finish_qkv(qkv, offsets, extra, on, *, n_heads: int, n_kv: int,
                dh: int, base: float, rope: bool):
    """The product's epilogue as the port's unfused arm composes it: the
    ``on`` select of ``+ extra``, the head split and
    :func:`~tpudist_torch.models.transformer.rope_rotate`."""
    from tpudist_torch.models.transformer import rope_rotate

    S, T, _ = qkv.shape
    if extra is not None:
        m = (torch.ones(S, dtype=torch.bool, device=qkv.device) if on is None
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

    Returns ``[S, T, d_out]`` in ``x``'s dtype.  On CUDA, any rank; ``T``
    up to :data:`LORA_DECODE_ROWS` takes the cluster arm (:func:`_lora_arm`;
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
    for t in (x, pool_a, pool_b, ids):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("lora_delta takes contiguous tensors")
    return _launch_lora(_lora_arm(T, r), x, pool_a, pool_b, ids, layer)


def _launch_lora(arm: str, x, pool_a, pool_b, ids, layer: int):
    """Launch ``lora_delta``'s kernel on ``arm`` (``"cluster"`` or
    ``"staged"``) for arguments :func:`lora_delta` has checked; only
    ``chip_smoke.py`` and the CUDA tests force an arm."""
    S, T, d_in = x.shape
    B, r, d_out = pool_a.shape[1], pool_a.shape[3], pool_b.shape[-1]
    if arm not in ("cluster", "staged") or (
            arm == "cluster" and _lora_arm(T, r) != "cluster"):
        raise ValueError(f"no lora_delta arm {arm!r} for T {T}, rank {r}")
    out = torch.empty(S, T, d_out, dtype=x.dtype, device=x.device)
    if S * T * d_out == 0:
        return out
    if r == 0:  # an empty adapter adds nothing
        return out.zero_()
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
