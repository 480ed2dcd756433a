"""Fused sampling prep: the decode step's tail in one pass, and the
speculative verify's residual prep.

The PyTorch/CUDA counterpart of :mod:`tpudist.ops.fused_sample`.  On a CUDA
tensor :func:`fused_sample_prep` launches the hand-written kernel
``csrc/fused_sample.cu`` (grammar mask, greedy arg-max, temperature scale,
top-k / top-p filters by radix select, any vocab); on a CPU tensor it runs
:func:`fused_sample_reference`.  :func:`fused_residual_prep` (the same
source's second entry point) and :func:`fused_residual_reference` follow the
same rule.  Each kernel has two arms, picked by a pure-Python plan
(:func:`_sample_arm`, :func:`_residual_arm`): short rows on one CTA a row
with the row in registers, long rows on a thread-block cluster a row with
the row's slices in shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from tpudist_torch.ops import _build

#: the arms of both kernels, by their code in ``csrc/fused_sample.cu``
#: (enum Arm)
SAMPLE_ARMS = ("row", "cluster")
#: threads of a sampling CTA, one a histogram bin (``kThreads``); values a
#: thread of the row arm holds (``kRowMaxNV``: rows up to 4096)
SAMPLE_THREADS, SAMPLE_ROW_MAX_NV = 256, 16
#: the residual row arm: values a thread holds (``kResRowMaxNV``: rows up
#: to 4096)
RESIDUAL_ROW_MAX_NV = 16
#: f32 values a CTA of the sampling prep's cluster arm holds in shared
#: memory (``kSliceCap``; the residual's holds half as many pairs): the rest
#: of a longer slice waits in the kernel's outputs
SLICE_CAP = 40960
#: CTAs a row of the cluster arms (instantiated sizes; 16 is past the
#: portable 8 and asks for ``cudaFuncAttributeNonPortableClusterSizeAllowed``)
CLUSTER_SIZES = (2, 4, 8, 16)
#: the longest row each kernel's row arm takes before the plan moves to the
#: cluster arm (the crossover measured on the H100, ``PERF.md`` §6)
SAMPLE_ROW_MAX_V, RESIDUAL_ROW_MAX_V = 4096, 2048
#: the largest cluster the plans pick, and the CTAs the plans fill the
#: H100's 132 SMs with (two a SM: a cluster arm's CTA leaves room for a
#: second at the shapes measured)
MAX_CLUSTER, WAVE_CTAS = 16, 264


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpd_fused_sample.argtypes = ([p] * 8 + [i] * 5 + [ctypes.c_float]
                                     + [i, i, p])
    lib.tpd_fused_sample.restype = i
    lib.tpd_fused_residual.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.tpd_fused_residual.restype = i


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _cluster_size(rows: int, V: int) -> int:
    """CTAs a row of a cluster arm: the largest size up to
    :data:`MAX_CLUSTER` whose grid fits :data:`WAVE_CTAS` (``rows * C <=
    264``) and leaves each CTA a value a thread; 2 where none does."""
    for C in sorted(CLUSTER_SIZES, reverse=True):
        if C <= MAX_CLUSTER and rows * C <= WAVE_CTAS \
                and V >= C * SAMPLE_THREADS:
            return C
    return CLUSTER_SIZES[0]


def _sample_arm(S: int, V: int) -> tuple:
    """``fused_sample_prep``'s CUDA arm for ``S`` rows of ``V`` values:
    ``("row", NV)`` — one CTA a row, ``NV`` values a thread in registers (a
    power of two) — up to :data:`SAMPLE_ROW_MAX_V`, else ``("cluster",
    C)``, a cluster of ``C`` CTAs a row (:func:`_cluster_size`).  The
    filters do not move the crossover (measured on the H100 with and
    without them, ``PERF.md`` §6)."""
    if V <= SAMPLE_ROW_MAX_V:
        return "row", _pow2_at_least(-(-V // SAMPLE_THREADS))
    return "cluster", _cluster_size(S, V)


def _residual_arm(rows: int, V: int) -> tuple:
    """``fused_residual_prep``'s CUDA arm for ``rows = S * k`` rows of
    ``V`` values: ``("row", NV)`` — one CTA a row, ``NV`` values a thread
    in registers — up to :data:`RESIDUAL_ROW_MAX_V`, else ``("cluster",
    C)``."""
    if V <= RESIDUAL_ROW_MAX_V:
        return "row", _pow2_at_least(-(-V // SAMPLE_THREADS))
    return "cluster", _cluster_size(rows, V)


def _check_width(arm: str, width: int, V: int, max_nv: int,
                 what: str) -> None:
    """Raise unless the forced arm holds a row of ``V``: the row arm's
    values a thread (a power of two up to ``max_nv``) times the CTA's
    threads, the cluster arm one of :data:`CLUSTER_SIZES`."""
    if arm == "row":
        if width not in [1 << i for i in range(max_nv.bit_length())] \
                or V > width * SAMPLE_THREADS:
            raise ValueError(f"{what}: the row arm holds {width} values a "
                             f"thread, not a row of {V}")
    elif arm == "cluster":
        if width not in CLUSTER_SIZES:
            raise ValueError(f"{what}: no cluster arm of {width} CTAs "
                             f"({CLUSTER_SIZES})")
    else:
        raise ValueError(f"{what}: no arm {arm!r} ({SAMPLE_ARMS})")


def fused_sample_prep(logits, temps, gallow=None, gidx=None, gstate=None, *,
                      top_k: int = 0, top_p: float = 0.0):
    """Fused sampling prep over ``logits [S, V]`` f32.

    ``temps [S]`` f32 (0 = greedy); ``gallow [G+1, n_states, V]`` bool with
    ``gidx``/``gstate [S]`` int32 — each slot's grammar row — or all
    ``None``.  Returns ``(masked [S, V] f32, scaled [S, V] f32, greedy [S]
    int32)``: the grammar-masked logits, those divided by ``max(temp,
    1e-6)`` (and filtered by ``top_k``/``top_p``), and the arg-max of
    ``masked`` (lowest index on ties).  A CUDA tensor takes the arm
    :func:`_sample_arm` plans (``launches_row`` / ``launches_cluster``
    count them)."""
    if logits.device.type == "cpu":
        return fused_sample_reference(logits, temps, gallow, gidx, gstate,
                                      top_k=top_k, top_p=top_p)
    arm, width = _sample_arm(logits.shape[0], logits.shape[-1])
    return _launch_sample(arm, width, logits, temps, gallow, gidx, gstate,
                          top_k=top_k, top_p=top_p)


def _launch_sample(arm: str, width: int, logits, temps, gallow=None,
                   gidx=None, gstate=None, *, top_k: int = 0,
                   top_p: float = 0.0):
    """:func:`fused_sample_prep`'s kernel on a given arm (``"row"`` with
    ``width`` values a thread, ``"cluster"`` with ``width`` CTAs a row):
    the plan's choice, or a forced one for ``chip_smoke.py`` and the CUDA
    tests."""
    if logits.device.type != "cuda":
        raise ValueError(f"fused_sample_prep runs on cuda or cpu, not "
                         f"{logits.device}")
    grammar = gallow is not None
    if logits.dim() != 2 or logits.shape[1] < 1:
        raise ValueError(f"logits must be [S, V] with V >= 1, got "
                         f"{tuple(logits.shape)}")
    S, V = logits.shape
    _check_width(arm, width, V, SAMPLE_ROW_MAX_NV, "fused_sample_prep")
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
    if S == 0:
        return masked, scaled, greedy
    lib = _build.load("fused_sample", _declare)
    ptr = _build.ptr
    rc = lib.tpd_fused_sample(
        ptr(logits), ptr(temps), ptr(gallow), ptr(gidx), ptr(gstate),
        ptr(masked), ptr(scaled), ptr(greedy), S, V, G1, n_states,
        int(top_k), float(top_p), SAMPLE_ARMS.index(arm), width,
        _build.stream_of(logits.device))
    _build.check(lib, rc, "fused_sample_prep")
    fused_sample_prep.launches += 1
    if arm == "row":
        fused_sample_prep.launches_row += 1
    else:
        fused_sample_prep.launches_cluster += 1
    if grammar:
        fused_sample_prep.launches_grammar += 1
    return masked, scaled, greedy


#: kernel launches since the last reset (the main path's proof of use), in
#: all, by arm, and those that carried grammar operands (a constrained
#: engine's launches: its pool rides every call, free lanes on the
#: sentinel block)
fused_sample_prep.launches = 0
fused_sample_prep.launches_row = 0
fused_sample_prep.launches_cluster = 0
fused_sample_prep.launches_grammar = 0


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
    residual is empty.  A CUDA tensor launches the kernel on the arm
    :func:`_residual_arm` plans (``launches_row`` / ``launches_cluster``
    count them), or raises; a CPU tensor runs
    :func:`fused_residual_reference`."""
    if lt.device.type == "cpu":
        return fused_residual_reference(lt, ld, temps)
    if lt.dim() != 3:
        raise ValueError(f"lt / ld must both be [S, k, V], got "
                         f"{tuple(lt.shape)} and {tuple(ld.shape)}")
    S, k, V = lt.shape
    arm, width = _residual_arm(S * k, V)
    return _launch_residual(arm, width, lt, ld, temps)


def _launch_residual(arm: str, width: int, lt, ld, temps):
    """:func:`fused_residual_prep`'s kernel on a given arm (``"row"`` with
    ``width`` values a thread, ``"cluster"`` with ``width`` CTAs a row)."""
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
    _check_width(arm, width, V, RESIDUAL_ROW_MAX_NV, "fused_residual_prep")
    lib = _build.load("fused_sample", _declare)
    ptr = _build.ptr
    rc = lib.tpd_fused_residual(
        ptr(lt), ptr(ld), ptr(temps), ptr(pt), ptr(pd), ptr(lr), S, k, V,
        int(lt.dtype == torch.bfloat16), int(ld.dtype == torch.bfloat16),
        SAMPLE_ARMS.index(arm), width, _build.stream_of(lt.device))
    _build.check(lib, rc, "fused_residual_prep")
    fused_residual_prep.launches += 1
    if arm == "row":
        fused_residual_prep.launches_row += 1
    else:
        fused_residual_prep.launches_cluster += 1
    return pt, pd, lr


#: kernel launches since the last reset (the main path's proof of use), in
#: all and by arm
fused_residual_prep.launches = 0
fused_residual_prep.launches_row = 0
fused_residual_prep.launches_cluster = 0


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
