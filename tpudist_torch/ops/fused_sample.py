"""Fused sampling prep: the decode step's tail in one pass, and the
speculative verify's residual prep.

The PyTorch/CUDA counterpart of :mod:`tpudist.ops.fused_sample`.  On a CUDA
tensor :func:`fused_sample_prep` launches the hand-written kernel
``csrc/fused_sample.cu`` (grammar mask, greedy arg-max, temperature scale,
top-k / top-p filters); on a CPU tensor it runs
:func:`fused_sample_reference`.  The filters sort each row in one CTA's
shared memory, so with a filter on the kernel takes rows of at most
:data:`MAX_SORT_V` values and raises above.  :func:`fused_residual_prep`
(the same source's second entry point, any vocab) and
:func:`fused_residual_reference` follow the same rule.
"""

from __future__ import annotations

import ctypes

import torch

from tpudist_torch.ops import _build

#: the longest row the kernel's shared-memory sort takes (top-k / top-p);
#: ``kMaxSortV`` in ``csrc/fused_sample.cu``
MAX_SORT_V = 4096


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_fused_sample.argtypes = ([p] * 8 + [i] * 5 + [ctypes.c_float]
                                     + [p])
    lib.tpd_fused_sample.restype = i
    lib.tpd_fused_residual.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.tpd_fused_residual.restype = i


def fused_sample_prep(logits, temps, gallow=None, gidx=None, gstate=None, *,
                      top_k: int = 0, top_p: float = 0.0):
    """Fused sampling prep over ``logits [S, V]`` f32.

    ``temps [S]`` f32 (0 = greedy); ``gallow [G+1, n_states, V]`` bool with
    ``gidx``/``gstate [S]`` int32 — each slot's grammar row — or all
    ``None``.  Returns ``(masked [S, V] f32, scaled [S, V] f32, greedy [S]
    int32)``: the grammar-masked logits, those divided by ``max(temp,
    1e-6)`` (and filtered by ``top_k``/``top_p``), and the arg-max of
    ``masked`` (lowest index on ties)."""
    if logits.device.type == "cpu":
        return fused_sample_reference(logits, temps, gallow, gidx, gstate,
                                      top_k=top_k, top_p=top_p)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_sample_prep runs on cuda or cpu, not "
                         f"{logits.device}")
    grammar = gallow is not None
    S, V = logits.shape
    if (0 < top_k < V or 0.0 < top_p < 1.0) and V > MAX_SORT_V:
        raise ValueError(
            f"top_k / top_p filtering sorts a row in one CTA's shared memory: "
            f"vocab {V} exceeds the kernel's limit of {MAX_SORT_V}")
    tensors = [logits, temps] + ([gallow, gidx, gstate] if grammar else [])
    for t in tensors:
        if t.device != logits.device or not t.is_contiguous():
            raise ValueError("fused_sample_prep takes contiguous tensors on "
                             "one device")
    if logits.dtype != torch.float32 or temps.dtype != torch.float32 \
            or temps.shape != (S,):
        raise TypeError("logits [S, V] and temps [S] must be float32")
    G1 = n_states = 0
    if grammar:
        if gallow.dtype != torch.bool or gallow.dim() != 3 \
                or gallow.shape[2] != V:
            raise TypeError("gallow must be bool [G+1, n_states, V]")
        if gidx.dtype != torch.int32 or gstate.dtype != torch.int32 \
                or gidx.shape != (S,) or gstate.shape != (S,):
            raise TypeError("gidx / gstate must be int32 [S]")
        G1, n_states = gallow.shape[0], gallow.shape[1]
    masked = torch.empty_like(logits)
    scaled = torch.empty_like(logits)
    greedy = torch.empty(S, dtype=torch.int32, device=logits.device)
    lib = _build.load("fused_sample", _declare)
    ptr = _build.ptr
    rc = lib.tpd_fused_sample(
        ptr(logits), ptr(temps), ptr(gallow), ptr(gidx), ptr(gstate),
        ptr(masked), ptr(scaled), ptr(greedy), S, V, G1, n_states,
        int(top_k), float(top_p), _build.stream_of(logits.device))
    _build.check(lib, rc, "fused_sample_prep")
    fused_sample_prep.launches += 1
    return masked, scaled, greedy


#: kernel launches since the last reset (the main path's proof of use)
fused_sample_prep.launches = 0


def fused_sample_reference(logits, temps, gallow=None, gidx=None,
                           gstate=None, *, top_k: int = 0,
                           top_p: float = 0.0):
    """Plain PyTorch version of :func:`fused_sample_prep`, top-k and top-p
    included (value-space semantics: ties at the threshold survive)."""
    S, V = logits.shape
    lg = logits.float()
    neg = torch.finfo(torch.float32).min
    if gallow is not None:
        allow = gallow[gidx.long().clamp(max=gallow.shape[0] - 1),
                       gstate.long().clamp(max=gallow.shape[1] - 1)]
        lg = torch.where(allow, lg, torch.tensor(neg, device=lg.device))
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    sc = lg / torch.clamp(temps.float(), min=1e-6)[:, None]
    if 0 < top_k < V:
        kth = torch.topk(sc, top_k, dim=-1).values[..., -1:]
        sc = torch.where(sc < kth, torch.tensor(neg, device=sc.device), sc)
    if 0.0 < top_p < 1.0:
        srt = torch.sort(sc, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        keep = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]],
                         dim=-1) < top_p
        keep[:, 0] = True
        cutoff = torch.where(keep, srt, torch.tensor(
            float("inf"), device=sc.device)).amin(dim=-1, keepdim=True)
        sc = torch.where(sc < cutoff, torch.tensor(neg, device=sc.device), sc)
    return lg, sc, greedy


def fused_residual_prep(lt, ld, temps):
    """Speculative-verify prep over the target and draft logits ``lt`` /
    ``ld [S, k, V]`` (f32 or bf16) at the ``k`` draft positions, with
    ``temps [S]`` f32.  Returns ``(pt, pd, res_logits)``, each ``[S, k, V]``
    f32: ``softmax(l / max(temp, 1e-6))`` of both, and the residual sampling
    logits ``log(max(pt - pd, 0) + 1e-30)`` — ``lt / temp`` on a row whose
    residual is empty.  A CUDA tensor launches the kernel (or raises); a CPU
    tensor runs :func:`fused_residual_reference`."""
    if lt.device.type == "cpu":
        return fused_residual_reference(lt, ld, temps)
    if lt.device.type != "cuda":
        raise ValueError(f"fused_residual_prep runs on cuda or cpu, not "
                         f"{lt.device}")
    for t in (lt, ld, temps):
        if t.device != lt.device or not t.is_contiguous():
            raise ValueError("fused_residual_prep takes contiguous tensors "
                             "on one device")
    if lt.dim() != 3 or ld.shape != lt.shape:
        raise ValueError(f"lt / ld must both be [S, k, V], got "
                         f"{tuple(lt.shape)} and {tuple(ld.shape)}")
    S, k, V = lt.shape
    if temps.dtype != torch.float32 or temps.shape != (S,):
        raise TypeError("temps must be float32 [S]")
    for t in (lt, ld):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"lt / ld must be float32 or bfloat16, got "
                            f"{t.dtype}")
    pt, pd, lr = (torch.empty((S, k, V), dtype=torch.float32,
                              device=lt.device) for _ in range(3))
    if pt.numel() == 0:
        return pt, pd, lr
    lib = _build.load("fused_sample", _declare)
    ptr = _build.ptr
    rc = lib.tpd_fused_residual(
        ptr(lt), ptr(ld), ptr(temps), ptr(pt), ptr(pd), ptr(lr), S, k, V,
        int(lt.dtype == torch.bfloat16), int(ld.dtype == torch.bfloat16),
        _build.stream_of(lt.device))
    _build.check(lib, rc, "fused_residual_prep")
    fused_residual_prep.launches += 1
    return pt, pd, lr


#: kernel launches since the last reset (the main path's proof of use)
fused_residual_prep.launches = 0


def fused_residual_reference(lt, ld, temps):
    """Plain PyTorch version of :func:`fused_residual_prep` (the JAX
    ``_accept`` formulas: IEEE divisions by a tensor, ``exp(x - max) /
    sum``)."""
    temp = torch.clamp(temps.float(), min=1e-6)[:, None, None]
    xt = lt.float() / temp
    xd = ld.float() / temp

    def softmax(x):
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        return e / e.sum(dim=-1, keepdim=True)

    pt, pd = softmax(xt), softmax(xd)
    res = torch.clamp(pt - pd, min=0.0)
    has_res = (res > 0).any(dim=-1, keepdim=True)
    return pt, pd, torch.where(has_res, torch.log(res + 1e-30), xt)
