#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``tpudist_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in
order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``tpudist_torch/csrc`` (one
   ``nvcc`` per source, all at once);
3. each serving kernel against its plain PyTorch version at the serving
   slice's shapes (8 slots, dh 128, KV block 16, 128 blocks per lane, window
   8, chunk 64, vocab 256): bf16 and int8 pools, ragged cursors with partial
   blocks, sentinel table tails, ragged chunk lengths, a sliding window;
   written int8 blocks must be byte-identical; the sampling filters top-k 5,
   top-p 0.9, both, and ties (top-k exact, top-p within the stated margin).
   The paged decode kernel also runs the speculative verify's call (q
   ``[8, 8, s, 128]``, s = 5 and 9, a K + 1 window at fill 0; bf16 and int8
   pools, ragged cursors, a window, GQA 8/2); every decode case runs on
   the split walk (twice: the second call must equal the first) and on the
   CUDA-core walk it replaced (``decode_readings``), and the two arms are
   timed in turns at the decode step and the s = 5 verify.  The paged
   prefill's tensor-core arm
   is also held at GQA (8 q heads over 2 kv heads), chunks 16 and 128 and
   window 40, and its CUDA-core arm at the serving shape; both arms, and
   the tensor-core arm's attention without its block writes, are timed on
   the same inputs, each split by kernel under ``torch.profiler``.  Each
   kernel is timed with CUDA events
   (median of 30 after warm-up, L2 flushed between launches) beside its
   plain version, its bound and, where one PyTorch call computes the same
   function, that call; the s = 5 verify beside the s = 1 step and beside
   SDPA over the gathered view under the verify rows' own mask;
3b. the flash forward, dq and dk/dv kernels against their plain versions at
   the training path's shapes (b 8, h 8, s 2048, dh 128, bf16, causal), a
   GQA sliding-window case (h_kv 2, window 512), a non-causal ragged length
   (s 1000), head dim 64 (one tile; GQA 8/1 under a band at s 2047), dead
   rows, an f32 case and head dims 32 and 16 (bf16 and f32), elementwise,
   per row and over the whole tensor (:func:`flash_case_readings`); on the
   forward's wgmma arm also its f32 output, on the backward's wgmma arm
   the dq kernel that forms delta itself.  Timed as in phase 3, forward
   and backward each beside the mma.sync arm that their wgmma arm replaced
   in the same call, in turns (the replaced forward held first on the same
   inputs); the yardstick is
   ``scaled_dot_product_attention(is_causal=True)``, forward alone and
   forward + backward, and its backward beside FlashAttention's backward
   alone (dq forming delta, dk/dv);
3c. the fused RoPE+QKV and LoRA gather-matmul kernels against their plain
   versions at the adapter path's shapes (8 slots, d 1024, decode T 1, the
   speculative verify's T 5 and prefill T 64, rank 8, lane ids mixing
   adapters, base lanes and the sentinel), a GQA case, a rope-off ragged
   case and f32 cases (:func:`linear_agreement`: elementwise, per row and
   over the tensor), ``fused_rope_qkv`` on the arm ``_rope_arm`` picks
   (its counters must show that arm) and, for bf16, on the mma.sync arm
   too, with the split and wgmma arms' edges (the verify's T 5, ragged S 3
   x T 5 under GQA, 64 rows, 65 rows at head dim 64); timed as in phase 3
   beside the unfused chain ``fused_rope=False`` runs and ``F.linear`` of
   the product alone; ``fused_rope_qkv``'s split arm (decode, the T 5
   verify) and wgmma arm (prefill) beside the mma.sync arm they replaced,
   and ``lora_delta``'s cluster arm (decode and verify) beside the staged
   kernel it replaced, in turns; an empty kernel's time (one CTA, and the
   split arm's grid of clusters: the timer's floor); the card's
   ``cudaOccupancyMaxActiveClusters`` for both cluster arms;
3d. the residual prep of the speculative verify against its plain version
   at ``[8, 4, 256]`` (temperatures 0, 0.7, 1.3, an empty-residual row),
   ``[8, 2, 17]``, ``[8, 4, 32000]`` and a bf16 input
   (:func:`residual_close`), timed as in phase 3;
3e. the fused toy-MLP kernel against its plain version (``MLP_CASES``: the
   toy model's weights at batches 256, 4096, a ragged 1000 and 2**20, and
   five 128-wide layers), within ``MLP_PLAIN_REL`` of it and
   ``MLP_F64_REL`` of float64 numpy, timed as in phase 3 (and with the
   host's launch, as 3c) beside its bound and the plain chain, with the
   launch plan (arm, rows a thread and a CTA, grid) of each case;
4. the main path: ``InferenceServer`` on the d1024 / 8-layer / 8-head /
   ff4096 / vocab-256 / max_len-2048 RoPE TransformerLM in bf16 (random
   weights from a seed), 16 greedy requests with prompts of 1-300 tokens
   (chunked prefill) and 16-64 new tokens; every request must finish
   "length", every kernel's launch count (zeroed just before) must grow,
   the paged prefill's tensor-core arm must serve every prefill launch and
   the paged decode's split walk every decode launch;
4b. the adapter path: the same model and server geometry with
   ``fused_rope``, ``adapters`` and ``lora_kernel`` on, 4 adapters of rank
   8 loaded, 16 greedy requests of which a third are base lanes;
   ``fused_rope_qkv`` must launch once and ``lora_delta`` three times per
   layer and forward (``fused_rope_qkv``'s split arm serving every decode
   forward and its wgmma arm every prefill chunk; ``lora_delta``'s cluster
   arm the decode launches, the staged arm the prefill chunks), every
   base lane must equal the same
   request on the server without adapters and every adapter lane must
   differ from it, or
   equal it only where the CPU f32 path shows the adapter acting and the
   card's stream leaving an f32 stream at a near tie
   (:func:`adapter_lane_ties`);
4c. speculative decoding on phase 4's server and requests (``spec=True,
   spec_k=4``, the tied 4-layer draft): 12 greedy spec lanes, 2 greedy
   ``spec=False`` lanes, 2 lanes sampled at temperature 0.8.  Every request
   must finish "length"; ``fused_residual_prep`` must launch once a spec
   block and the paged decode kernel once a layer of every decode-arm
   forward (8 a target forward, 4 a draft forward), every launch on the
   split walk; every greedy lane must
   equal its phase-4 stream or leave it first at a near tie of the card's
   logits (:func:`hold_greedy_streams`);
4d. the same on phase 4b's adapter server and traffic (every lane greedy,
   held against phase 4b's streams; ``fused_rope_qkv`` and ``lora_delta``
   once / three times a layer of every target and draft forward, every
   decode, draft and verify forward on ``fused_rope_qkv``'s split arm and
   every prefill chunk on its wgmma arm);
5. where the time goes: one admission prefill and one decode block of the
   same model under ``torch.profiler`` (device busy time, idle share, the
   heaviest kernels), on phase 4's engine and on phase 4b's; 5c: one
   speculative block (draft propose + verify) per emitted token beside
   phase 5's decode block;
6. one prompt's logits through the paged prefill path on the card (bf16,
   kernels) against the port's CPU plain path (f32, same weights); 5b: the
   same for one adapter lane through the fused RoPE+QKV arm;
7. the training main path: ``tpudist_torch.train``'s step on the d1024 /
   8-layer / 8-head / ff4096 / vocab-256 / seq-2048 LM with learned
   positions, batch 8, bf16 compute over f32 masters, Adam lr 3e-4, on
   increment-chain tokens, for 30 steps: losses, median step ms after 3
   warm-up steps, tokens/s, MFU, peak memory; the loss must fall and every
   flash kernel (counts zeroed just before) must launch 8 times a step, all
   on the wgmma arms (forward, dq and dk/dv);
8. where the training time goes: one step under ``torch.profiler``;
9. gradients at batch 2, same weights: the bf16 kernel path against the
   card's f32 plain path (dense attention, no kernel): the loss and every
   parameter's gradient by cosine similarity;
10. the toy ``demo.py`` path: ``python -m tpudist_torch.examples.demo
   --dry_run --seed 0`` for the reference's 1000 iterations, as a
   subprocess under the torchrun contract at world size 1 (the NCCL group,
   DDP, the device-group loss all-reduce) in a temporary directory, with
   ``--backend ici`` and then ``--backend host``: exit 0, 1000 metric rows,
   both losses from about 3 to at most 0.3;
11. the toy benches (``tpudist_torch.bench``): ``bench_toy`` (samples/s of
   the scanned two-model step) and ``bench_fused_mlp`` at batch 4096 (the
   kernel against the plain chain), counts zeroed just before — the fused
   kernel must launch once a timed call at least; then one toy step window
   under ``torch.profiler``.

It prints the kernels' JSON record (a kernel with several arms also lists
each arm's time on the same inputs and its launches on the main path) and
the ``nvidia-smi`` line before the last line, which is the contract line
``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without CUDA or outside the repository.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # CUDA-core f32 peak

SLOTS, HEADS, DH, BS, M, W, P, V, LAYERS = 8, 8, 128, 16, 128, 8, 64, 256, 8
MODEL = dict(vocab=256, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
             max_len=2048, rope=True)
# the training main path: benchmarks/mfu_hunt.py GEOM as bench.py bench_lm
# trains it (learned positions, max_len = seq_len, batch 8, Adam 3e-4)
TRAIN_ARGS = ["--device", "cuda", "--seq_len", "2048", "--d_model", "1024",
              "--n_layers", "8", "--n_heads", "8", "--d_ff", "4096",
              "--vocab", "256", "--batch_size", "8", "--precision", "bf16",
              "--lr", "3e-4", "--seed", "0"]
TRAIN_STEPS, TRAIN_WARMUP = 30, 3
# phase 3b's cases: (name, b, h, h_kv, s, head dim, dtype, band); head dim
# 32 is ``python -m tpudist_torch.train``'s default model (d 128, 4 heads).
# bf16 at head dims 64 and 128 runs the backward's wgmma arm, whose dq
# kernel is also held with the delta it forms itself
FLASH_CASES = (("main path", 8, 8, 8, 2048, DH, "bf16", (0, None)),
               ("GQA + window 512", 2, 8, 2, 2048, DH, "bf16", (0, 512)),
               ("non-causal, s 1000", 2, 8, 8, 1000, DH, "bf16",
                (None, None)),
               ("dh 64 one tile", 1, 2, 2, 64, 64, "bf16", (None, None)),
               ("dh 64 GQA 8/1 band, s 2047", 1, 8, 1, 2047, 64, "bf16",
                (-20, 64)),
               ("dead rows, s 130", 2, 4, 4, 130, DH, "bf16", (10, 40)),
               ("f32 causal", 1, 4, 4, 512, DH, "f32", (0, None)),
               ("dh 32 causal", 8, 4, 4, 512, 32, "bf16", (0, None)),
               ("dh 16 GQA band", 2, 4, 2, 300, 16, "bf16", (-20, 64)),
               ("dh 32 f32 window", 2, 4, 2, 300, 32, "f32", (0, 40)))
# the delta the dq kernel forms (rowsum(out·do) - dlse in f32) against the
# plain one, relative to rowsum(|out·do|) + |dlse|: two f32 sums of 128
# products in different orders, each within ~128·2**-24 of that magnitude
DELTA_REL_MAX = 1e-5
SERVE_KERNELS = ("paged_attention", "paged_prefill", "fused_sample")
TRAIN_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
ADAPTER_KERNELS = ("fused_rope_qkv", "lora_delta")
# the adapter-serving path (phases 3c, 4b, 5b): ServeConfig's pool (8 blocks
# of rank 8), 4 adapters loaded, names cycling so a third of the lanes are
# base lanes; ragged decode cursors and prefill chunk starts of the main
# path, and which lanes carry an adapter
RANK, N_ADAPTERS = 8, 4
# the speculative path's draft length: its verify runs SPEC_K + 1 rows a slot
SPEC_K = 4
# phase 4c's traffic beside the 12 greedy spec lanes: greedy lanes with
# spec=False, and lanes sampled at temperature 0.8 (spec on)
SPEC_OFF_LANES, SAMPLED_LANES = (3, 9), (6, 13)
# the largest top-2 gap of the card's bf16 logits at which a greedy spec
# lane may leave its non-speculative stream (hold_greedy_streams).  On the
# H100 7 lanes of phases 4c and 4d left theirs, every one where the gap was
# 0.015625, one bf16 step of a logit in [2, 4); phase 6 reads card logits
# at most 0.0445 (3 such steps) off the f32 plain path.  The bound is 4
# steps; a wrong verify row moves logits by far more than that.
NEAR_TIE_GAP = 0.0625
ADAPTER_NAMES = ("a0", None, "a1", "a2", None, "a3")
DECODE_OFFS = [37, 364, 120, 250, 5, 300, 180, 64]
PREFILL_OFFS = [0, 64, 128, 0, 192, 64, 256, 0]
LANE_ON = [1, 0, 1, 1, 0, 1, 1, 0]
LORA_IDS = [0, 8, 1, 8, 2, 3, 8, 0]  # 8 = the sentinel of an 8-block pool
# agreement of the fused linear kernels with their plain versions (phase
# 3c): (elementwise against |ref| + the row's largest |ref|, per row, over
# the tensor) by dtype
# the bounds sit above the H100's readings over the phase's cases: bf16
# 3.6e-3, 4.2e-3 and 2.4e-4 (the LoRA prefill products: the plain version's
# cuBLAS sums the 4096-deep intermediate in another order and rounds it to
# bf16 one step apart; fused_rope_qkv's split arm sums the depth in 8
# slices and reads 3.1e-3, 1.4e-3 and 1.2e-4, its wgmma and mma.sync arms
# 0 — bit for bit), f32 1.3e-6, 1.6e-6 and 3.2e-7.  A missed delta or a
# wrong rotation angle moves whole rows by 0.1 or more.
LINEAR_BOUNDS = {"bf16": (2 ** -7, 2 ** -7, 2 ** -10),
                 "f32": (1e-5, 1e-5, 2e-6)}
# gradient agreement, bf16 kernel path vs f32 plain path on the same batch
# (phase 9).  Readings on the H100 (tests/torch_flash_faults.py; the same
# on the mma.sync arm and on the wgmma arm): the sound kernels leave 1 -
# cosine at 6.2e-5 at worst over the 52 parameters and the loss 1.1e-4
# apart; a bf16 plain path (dense attention, no kernel) reads 6.3e-5 and
# 1.4e-4, so that is bf16's own rounding.  On the wgmma arm, dropping the
# last (64-query) dk/dv step of every KV tile reads 1.1e-3, the diagonal
# dS·K tile of every Q tile 7.4e-3, half of every row sum of the folded
# delta 0.40 (the mma.sync arm's 32-query step read 5.2e-4).  The bounds
# sit 4.8 and 9 times above the sound readings.
GRAD_COS_MIN, LOSS_REL_MAX = 0.9997, 1e-3
# phase 3e's cases (name, weights, batch): the toy model's weights at the
# bench's batch 4096, the JAX bench's block of 256, a ragged batch and 2**20
# rows, and five 128-wide layers (the widest shape the JAX kernel takes)
MLP_CASES = (("toy b256", "toy", 256), ("toy b4096", "toy", 4096),
             ("toy ragged b1000", "toy", 1000),
             ("toy b1048576", "toy", 1 << 20),
             ("wide 128x5 b4096", "wide", 4096))
# the kernel against its plain version (both full f32, summed in another
# order; H100 readings at most 3.4e-7) and against float64 numpy
# (bench.py's own bound; readings at most 6.2e-7), relative to the
# output's largest magnitude
MLP_PLAIN_REL, MLP_F64_REL = 1e-5, 1e-4
# phase 10: the reference demo's own run (demo.py:88, 1000 iterations) from
# seed 0.  The losses end at most 0.3 (the toy data's noise floor is an MSE
# of 0.25); at 300 iterations neither this port (0.321 and 0.311 on the
# CPU) nor the JAX demo (0.374 and 0.276 on its 8-device CPU mesh) is
# there yet.
DEMO_ITERATIONS = 1000
DEMO_ARGS = ["--dry_run", "--seed", "0", "--total_iterations",
             str(DEMO_ITERATIONS)]
DEMO_LOSS_MAX = 0.3


def log(msg: str) -> None:
    print(msg, flush=True)


def entry_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    entry (``dkv_wgmma<128>``), or the mangled name if it has no template
    arguments."""
    for m in re.finditer(r"\d+", mangled):
        n, end = int(m.group()), m.end()
        args = re.match(r"I((?:Li-?\d+E)+)E", mangled[end + n:])
        if args and re.fullmatch(r"[A-Za-z_]\w*", mangled[end:end + n]):
            return (mangled[end:end + n] + "<"
                    + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">")
    return mangled


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# a ~2 ms spin the device runs ahead of each timed call (cycles at the H100's
# ~1.98 GHz boost clock)
SPIN_CYCLES = 4_000_000


def time_ms(torch, fn, flush, n: int = 30, warmup: int = 5,
            spin: bool = True) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events), the
    L2 cache flushed before each.  With ``spin`` the device runs a ~2 ms
    spin kernel before the start event, so the host has queued ``fn``'s
    launches by the time the device reaches them and the events see the
    device work alone; without it (as PRs 1-2 timed) the events also see
    the host's wrapper and launch overhead, which dominates a kernel of a
    few microseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_split(torch, fn, flush, names, n: int = 30) -> dict:
    """Device ms of each kernel of ``fn`` (each launched once a call), under
    ``torch.profiler`` over ``n`` calls, each after an L2 flush as
    :func:`time_ms` times them: ``{name: ms}``, the mean over the launches
    of kernels whose name contains ``name``, for each of ``names``.  The
    mean is over the launches the window recorded: on the H100 a window
    now and then comes back with some or all of them missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        seen = {name: [] for name in names}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for name in names:
                if name in e.name:
                    seen[name].append(e.time_range.elapsed_us() / 1e3)
        if all(len(t) >= n // 2 for t in seen.values()):
            if any(len(t) < n for t in seen.values()):
                got = {k: len(v) for k, v in seen.items()}
                log(f"  profiler window: {got} of {n} launches recorded")
            return {name: statistics.mean(t) for name, t in seen.items()}
    raise AssertionError(f"the profiler recorded too few launches of "
                         f"{names}: {({k: len(v) for k, v in seen.items()})}")


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def decode_inputs(torch, dev, gen, pos0, quant, fill, window_cols=W, s=1,
                  n_kv=HEADS):
    S = SLOTS
    nb = 1024
    q = torch.randn(S, HEADS, s, DH, generator=gen, device=dev).bfloat16()
    if quant:
        pk = torch.randint(-127, 128, (LAYERS, nb, n_kv, BS, DH),
                           generator=gen, device=dev, dtype=torch.int8)
        pv = torch.randint(-127, 128, (LAYERS, nb, n_kv, BS, DH),
                           generator=gen, device=dev, dtype=torch.int8)
        sk = torch.rand(LAYERS, nb, n_kv, generator=gen, device=dev) * 0.02
        sv = torch.rand(LAYERS, nb, n_kv, generator=gen, device=dev) * 0.02
    else:
        pk = torch.randn(LAYERS, nb, n_kv, BS, DH, generator=gen,
                         device=dev).bfloat16()
        pv = torch.randn(LAYERS, nb, n_kv, BS, DH, generator=gen,
                         device=dev).bfloat16()
        sk = torch.ones(LAYERS, nb, n_kv, device=dev)
        sv = torch.ones(LAYERS, nb, n_kv, device=dev)
    pos0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    table = torch.full((S, M), nb, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    used = 0
    for b in range(S):
        live = -(-int(pos0[b]) // BS)
        table[b, :live] = perm[used:used + live]  # sentinel tail after
        used += live
    fill = torch.tensor(fill, dtype=torch.int32, device=dev)
    wk = torch.randn(S, n_kv, window_cols, DH, generator=gen,
                     device=dev).bfloat16()
    wv = torch.randn(S, n_kv, window_cols, DH, generator=gen,
                     device=dev).bfloat16()
    return [q, pk, pv, sk, sv, table, pos0, fill, wk, wv]


def prefill_inputs(torch, dev, gen, pos0, clen, quant, n_kv=HEADS, chunk=P):
    """One prefill call's inputs: q of ``HEADS`` heads and a ``chunk`` of
    K/V over ``n_kv`` kv heads (GQA below ``HEADS``), the pool holding each
    lane's prefix, the write table of the engine's rule."""
    from tpudist_torch.models.paged import PagedKVConfig, _Paged

    base = decode_inputs(torch, dev, gen, [p + chunk for p in pos0], quant,
                         [0] * SLOTS, n_kv=n_kv)
    q = torch.randn(SLOTS, HEADS, chunk, DH, generator=gen,
                    device=dev).bfloat16()
    kn = torch.randn(SLOTS, n_kv, chunk, DH, generator=gen,
                     device=dev).bfloat16()
    vn = torch.randn(SLOTS, n_kv, chunk, DH, generator=gen,
                     device=dev).bfloat16()
    pos0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    clen = torch.tensor(clen, dtype=torch.int32, device=dev)

    from types import SimpleNamespace

    geom = SimpleNamespace(  # the pool geometry _Paged reads off a model
        n_layers=LAYERS, n_kv=n_kv, head_dim=DH, max_len=M * BS,
        dtype=torch.bfloat16)
    pg = _Paged(geom, SLOTS, PagedKVConfig(1024, BS, quant), dev)
    wtable = pg.write_tables(base[5], pos0, clen, chunk,
                             torch.ones(SLOTS, dtype=torch.bool, device=dev))
    return [q, kn, vn] + base[1:6] + [wtable, pos0, clen]


def dense_sdpa(torch, q, pool_k, pool_v, scale_k, scale_v, table, keep_cols,
               fresh_k, fresh_v, layer):
    """(library yardstick) one ``scaled_dot_product_attention`` call over
    the gathered dense K/V (gathered here, outside the timed call) under
    the boolean mask ``keep_cols [S, 1, Tq, K]``, as a closure."""
    import torch.nn.functional as F

    from tpudist_torch.ops.paged_attention import _dense_view

    rows = table.long().clamp(max=pool_k.shape[1] - 1)
    k = torch.cat([_dense_view(pool_k, scale_k, rows, layer, q.dtype),
                   fresh_k], 2)
    v = torch.cat([_dense_view(pool_v, scale_v, rows, layer, q.dtype),
                   fresh_v], 2)
    return lambda: F.scaled_dot_product_attention(q, k, v,
                                                  attn_mask=keep_cols)


def close_bf16(torch, out, ref, vmax: float) -> float:
    """Max |out - ref|, raising past ``2**-7 * vmax + 2**-8 * |ref|``.
    Both sides compute in f32 and round to bf16 at different points: the
    kernel rounds the unnormalized probabilities exp(s - m) (online softmax),
    the plain version the normalized weights (JAX's kernel and reference
    differ the same way), each a 2**-9 relative step of a weight, so an
    output (a weighted mean of V) moves by at most ~2 * 2**-9 * max|V|;
    both then round the output itself (2**-9 * |out| each)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if not bool((err <= 2 ** -7 * vmax + 2 ** -8 * ref.abs()).all()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def v_max(pool_v, scale_v, fresh_v) -> float:
    """Largest |V| the attention can see (int8 pools dequantized)."""
    if pool_v.dtype.is_floating_point:
        pool = float(pool_v.float().abs().max())
    else:
        pool = 127.0 * float(scale_v.max())
    return max(pool, float(fresh_v.float().abs().max()))


# phase 3's decode cases: (pos0, int8 pool, fill, window, s, kv heads).
# pos0: an empty lane, partial blocks, lanes past several 128-key splits,
# near and at max_len, prefixes ending on a split boundary; a sliding window
# that leaves whole early splits without a live key; the speculative
# verify's s = K + 1 queries over a K + 1 window at fill 0 (K = 4 and 8),
# MHA and GQA 8/2 (36 query rows a kv head: three row tiles)
_RAGGED = [0, 1, 17, 100, 255, 364, 1000, 2040]
DECODE_CASES = (
    (_RAGGED, False, [0, 3, 7, 1, 0, 5, 2, 0], None, 1, HEADS),
    (_RAGGED, True, [1, 0, 2, 7, 4, 0, 6, 3], None, 1, HEADS),
    ([5, 33, 80, 160, 200, 640, 999, 1500], False, [0, 1, 2, 3, 4, 5, 6, 7],
     100, 1, HEADS),
    ([128, 256, 2048, 0, 127, 129, 383, 384], False, [0, 0, 0, 0, 7, 7, 3, 3],
     None, 1, HEADS),
    ([5, 33, 80, 160, 200, 640, 999, 1500], True, [0, 1, 2, 3, 4, 5, 6, 7],
     40, 1, 2),
) + tuple(
    (_RAGGED[:7] + [2048 - s - 7], quant, [0] * SLOTS, window, s, n_kv)
    for s, quant, window, n_kv in ((5, False, None, HEADS),
                                   (5, True, None, HEADS),
                                   (9, False, None, HEADS),
                                   (9, True, None, HEADS),
                                   (5, False, 100, HEADS),
                                   (9, False, None, 2), (5, True, 40, 2)))


def decode_readings(torch, dev, gen) -> dict:
    """Phase 3's decode cases (``DECODE_CASES``, layers 0 and 7) on the
    planned arm (the split walk for bf16 dh 128) and on the CUDA-core arm,
    each within :func:`close_bf16`'s bound of the plain version; the split
    walk's output equal, bit for bit, to a second call's (its merge counters
    are left zero).  Verdicts under ``ok``; nothing raises."""
    from tpudist_torch import ops
    from tpudist_torch.ops.paged_attention import (_paged_attention_on_arm,
                                                   paged_attention,
                                                   paged_attention_reference)

    res = dict(err=0.0, verify_err=0.0, cc_err=0.0, ok=True, failed=[],
               repeat_equal=True, tc_launches=0, launches=0)
    ops.reset_launch_counts()
    for pos0, quant, fill, window, s, n_kv in DECODE_CASES:
        args = decode_inputs(torch, dev, gen, pos0, quant, fill,
                             window_cols=W if s == 1 else s, s=s, n_kv=n_kv)
        vmax = v_max(args[2], args[4], args[9])
        for layer in (0, LAYERS - 1):
            out = paged_attention(*args, layer=layer, window=window)
            again = paged_attention(*args, layer=layer, window=window)
            cc = _paged_attention_on_arm("cc", *args, layer=layer,
                                         window=window)
            ref = paged_attention_reference(*args, layer=layer,
                                            window=window)
            torch.cuda.synchronize()
            res["repeat_equal"] &= bool(torch.equal(out, again))
            for key, got in (("verify_err" if s > 1 else "err", out),
                             ("cc_err", cc)):
                try:
                    res[key] = max(res[key], close_bf16(torch, got, ref,
                                                        vmax))
                except AssertionError:
                    res["ok"] = False
                    res["failed"].append(dict(
                        pos0=pos0[:3], quant=quant, window=window, s=s,
                        n_kv=n_kv, layer=layer, arm=key,
                        max_abs_err=float((got.float() - ref.float())
                                          .abs().max())))
    res["launches"] = paged_attention.launches
    res["tc_launches"] = paged_attention.launches_tc
    # two planned calls a case and layer, both on the split walk, and one
    # forced CUDA-core call
    res["ok"] &= res["repeat_equal"] and res["tc_launches"] \
        == 2 * (res["launches"] - res["tc_launches"]) > 0
    ops.reset_launch_counts()
    return res


def check_kernels(torch, dev):
    from tpudist_torch import ops
    from tpudist_torch.ops.fused_sample import (fused_sample_prep,
                                                fused_sample_reference)
    from tpudist_torch.ops.paged_attention import (_paged_attention_on_arm,
                                                   paged_attention,
                                                   paged_attention_reference)
    from tpudist_torch.ops.paged_prefill import (TC_ROWS,
                                                 _paged_prefill_on_arm,
                                                 paged_prefill_attention,
                                                 paged_prefill_reference)

    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rec = {}

    # -- row 1: paged decode attention (the split walk and the CUDA-core
    # arm against the plain version)
    dec = decode_readings(torch, dev, gen)
    if not dec["ok"]:
        raise AssertionError(f"paged decode kernel disagrees with its plain "
                             f"version: {dec}")
    err, verify_err = dec["err"], dec["verify_err"]
    err = max(err, verify_err)

    # timing at main-path cursors (prompts of 1-300 plus 16-64 new tokens):
    # a decode step (s 1, fill 3 of a K = 8 window) and a K = 4 verify
    # (s 5, fill 0); the verify moves the same bytes but 5 times the q and
    # output rows (and its own 5-column window)
    pos0 = [37, 364, 120, 250, 5, 300, 180, 64]
    live = sum(-(-p // BS) for p in pos0)

    def decode_bytes(args):
        return (2 * args[0].numel() * 2  # q in, out
                + 2 * live * HEADS * BS * DH * 2  # live K/V blocks
                + live * 4 + SLOTS * 8  # table entries, pos0, fill
                + 2 * args[8].numel() * 2)  # window K/V

    vargs = decode_inputs(torch, dev, gen, pos0, False, [0] * SLOTS,
                          window_cols=5, s=5)
    vflops = 4 * HEADS * DH * sum(p + i + 1 for p in pos0 for i in range(5))
    # the verify rows' own mask over the dense view: the lane's prefix, and
    # window columns up to the row (fill 0)
    kpos = torch.arange(M * BS + 5, device=dev)
    vkeep = torch.where(
        kpos < M * BS, kpos < torch.tensor(pos0, device=dev)[:, None, None],
        (kpos - M * BS) <= torch.arange(5, device=dev)[None, :, None])
    verify = dict(
        s=5, max_abs_err=verify_err,
        ms=time_ms(torch, lambda: paged_attention(*vargs, layer=3), flush),
        plain_ms=time_ms(torch, lambda: paged_attention_reference(
            *vargs, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, vargs[0], *vargs[1:6], vkeep[:, None], vargs[8],
            vargs[9], 3), flush),
        bound=bound(decode_bytes(vargs), vflops, H100_BF16_FLOPS))
    fill = [3] * SLOTS
    args = decode_inputs(torch, dev, gen, pos0, False, fill)
    nbytes = decode_bytes(args)
    flops = 4 * HEADS * DH * sum(p + f + 1 for p, f in zip(pos0, fill))
    keep = (torch.arange(M * BS + W, device=dev)[None]
            < torch.tensor(pos0, device=dev)[:, None])
    keep[:, M * BS:M * BS + fill[0] + 1] = True
    rec["paged_attention"] = dict(
        route="cuda", source="tpudist_torch/csrc/paged_attention.cu",
        replaces="tpudist/ops/paged_attention.py:162", max_abs_err=err,
        ms=time_ms(torch, lambda: paged_attention(*args, layer=3), flush),
        plain_ms=time_ms(torch, lambda: paged_attention_reference(
            *args, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, args[0], *args[1:6], keep[:, None, None], args[8],
            args[9], 3), flush),
        bound=bound(nbytes, flops, H100_BF16_FLOPS), cc_max_abs_err=dec[
            "cc_err"])
    # the arms on the same inputs, in turns (cc, tc, tc, cc): the split walk
    # and the CUDA-core walk it replaced, at the decode step and the verify
    turns = {key: {"tc": [], "cc": []} for key in ("s1", "s5")}
    for arm in ("cc", "tc", "tc", "cc"):
        for key, a in (("s1", args), ("s5", vargs)):
            turns[key][arm].append(time_ms(
                torch, lambda: _paged_attention_on_arm(arm, *a, layer=3),
                flush))
    rec["paged_attention"]["arm_ms"] = turns["s1"]
    verify["arm_ms"] = turns["s5"]

    # -- row 2: paged prefill attention + block writes: the main path's
    # shape (MHA, chunk 64) at layers 0 and 7, then GQA (8 q heads over 2
    # kv heads: 64-row tiles span q heads), chunk 16 (R under one tile)
    # and chunk 128 (two chunk tiles), each with and without a window; bf16
    # and int8 pools.  The serving shape runs the tensor-core arm.
    err = 0.0
    pos0 = [0, 5, 64, 100, 300, 17, 1000, 0]
    clen = [64, 1, 30, 64, 0, 50, 64, 10]
    cases = [dict(n_kv=HEADS, chunk=P, layers=(0, LAYERS - 1))] + [
        dict(n_kv=n_kv, chunk=chunk, layers=(LAYERS - 1,))
        for n_kv, chunk in ((2, P), (HEADS, 16), (HEADS, 128))]
    for c in cases:
        for quant in (True, False):
            cl = [min(x, c["chunk"]) for x in clen]
            args = prefill_inputs(torch, dev, gen, pos0, cl, quant,
                                  n_kv=c["n_kv"], chunk=c["chunk"])
            vmax = v_max(args[4], args[6], args[2])
            for layer, window in ([(lay, None) for lay in c["layers"]]
                                  + [(1, 40)]):
                ops.reset_launch_counts()
                out = paged_prefill_attention(*args, layer=layer,
                                              window=window)
                ref = paged_prefill_reference(*args, layer=layer,
                                              window=window)
                torch.cuda.synchronize()
                if paged_prefill_attention.launches_tc != 1:
                    raise AssertionError("a bf16 dh-128 prefill did not run "
                                         "the tensor-core arm")
                err = max(err, close_bf16(torch, out[0], ref[0], vmax))
                for a, b in zip(out[1:], ref[1:]):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            "prefill kernel's written blocks/scales differ "
                            "from the plain version's")
    # the CUDA-core arm on the main path's shape, held as well
    args = prefill_inputs(torch, dev, gen, pos0, clen, False)
    out = _paged_prefill_on_arm("cc", *args, layer=3, window=40)
    ref = paged_prefill_reference(*args, layer=3, window=40)
    torch.cuda.synchronize()
    cc_err = close_bf16(torch, out[0], ref[0], v_max(args[4], args[6],
                                                      args[2]))
    # the tensor-core arm over these lanes too: one CTA walks each lane, so
    # the lane at pos0 1000 (16 prefix tiles) sets the time
    long_ms = time_ms(torch, lambda: paged_prefill_attention(*args, layer=3),
                      flush)
    pos0 = [0, 64, 128, 0, 192, 64, 256, 0]  # chunked prefill of prompts
    clen = [64, 64, 64, 37, 44, 64, 30, 12]
    args = prefill_inputs(torch, dev, gen, pos0, clen, False)
    wt = args[8]
    live_blocks = sum(-(-p // BS) for p in pos0)
    touched = int((wt < 1024).sum())
    nbytes = (2 * args[0].numel() * 2 + 2 * args[1].numel() * 2
              + 2 * (live_blocks + touched) * HEADS * BS * DH * 2
              + 2 * wt.numel() * HEADS * (BS * DH * 2 + 4)
              + wt.numel() * 4 + (live_blocks + touched) * 4 + SLOTS * 8)
    flops = 4 * HEADS * DH * sum(c * p + c * (c + 1) // 2
                                 for p, c in zip(pos0, clen))
    kpos = torch.arange(M * BS + P, device=dev)
    p0 = torch.tensor(pos0, device=dev)[:, None, None]
    row = torch.arange(P, device=dev)[None, :, None]
    keep = torch.where(kpos < M * BS, kpos < p0, (kpos - M * BS) <= row)
    planned = lambda: paged_prefill_attention(*args, layer=3)  # noqa: E731
    # the arms on the same inputs, each split by kernel: the tensor-core
    # arm is one launch (its block writes run in extra CTAs beside the
    # attention), and alone without them; the CUDA-core arm launches the
    # attention, then the same block writes as a kernel of their own
    tc, cc = ("prefill_tc_kernel",), ("paged_attention_kernel",
                                      "prefill_write_kernel")
    arms = {
        "tc": (tc, planned),
        "tc attention alone": (tc, lambda: _paged_prefill_on_arm(
            "tc", *args, layer=3, writes=False)),
        "cc": (cc, lambda: _paged_prefill_on_arm("cc", *args, layer=3))}
    arm_rec = {name: dict(ms=time_ms(torch, fn, flush),
                          split=kernel_split(torch, fn, flush, names))
               for name, (names, fn) in arms.items()}
    rec["paged_prefill"] = dict(
        route="cuda", source="tpudist_torch/csrc/paged_prefill.cu",
        replaces="tpudist/ops/paged_prefill.py:189", max_abs_err=err,
        ms=arm_rec["tc"]["ms"],
        plain_ms=time_ms(torch, lambda: paged_prefill_reference(
            *args, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, args[0], *args[3:8], keep[:, None], args[1], args[2], 3),
            flush),
        bound=bound(nbytes, flops, H100_BF16_FLOPS),
        kernel_ms=arm_rec["tc"]["split"][tc[0]],
        attn_ms=arm_rec["tc attention alone"]["split"][tc[0]],
        write_ms=arm_rec["cc"]["split"][cc[1]],
        cc_max_abs_err=cc_err, arms=arm_rec, long_lanes_ms=long_ms)

    # -- row 3: fused sampling prep
    err = 0.0
    lg = torch.randn(SLOTS, V, generator=gen, device=dev)
    lg[0, [3, 9, 200]] = 10.0  # tied maxima: lowest index wins
    lg[1] = 0.0
    temps = torch.tensor([0, 0.7, 1.3, 0, 2, 0.5, 0, 1], device=dev)
    gallow = torch.rand(3, 5, V, generator=gen, device=dev) > 0.3
    gallow[2] = True
    gidx = torch.tensor([0, 2, 1, 2, 0, 1, 2, 0], dtype=torch.int32,
                        device=dev)
    gstate = torch.tensor([1, 0, 3, 4, 2, 0, 1, 4], dtype=torch.int32,
                          device=dev)
    for a in ((lg, temps), (lg, temps, gallow, gidx, gstate)):
        out = fused_sample_prep(*a)
        ref = fused_sample_reference(*a)
        for x, y in zip(out, ref):
            if not torch.equal(x, y):
                raise AssertionError("fused_sample_prep differs from its "
                                     "plain version")
    if int(out[2][1]) != 0 or int(fused_sample_prep(lg, temps)[2][0]) != 3:
        raise AssertionError("arg-max ties must pick the lowest index")
    lgf = lg.clone()
    lgf[2, :12] = 3.0  # ties straddling the k-th value
    lgf[3] = 0.5  # a flat row
    for tk, tp in ((5, 0.0), (0, 0.9), (5, 0.9), (12, 0.0)):
        for a in ((lgf, temps), (lgf, temps, gallow, gidx, gstate)):
            check_filters(torch, fused_sample_prep(*a, top_k=tk, top_p=tp),
                          fused_sample_reference(*a, top_k=tk, top_p=tp),
                          fused_sample_reference(*a, top_k=tk)[1], tp)
    nbytes = SLOTS * V * 4 * 3 + SLOTS * 4 * 2
    rec["fused_sample"] = dict(
        route="cuda", source="tpudist_torch/csrc/fused_sample.cu",
        replaces="tpudist/ops/fused_sample.py:79", max_abs_err=err,
        ms=time_ms(torch, lambda: fused_sample_prep(lg, temps), flush),
        plain_ms=time_ms(torch, lambda: fused_sample_reference(lg, temps),
                         flush),
        library_ms=None, bound=bound(nbytes, 3 * SLOTS * V, H100_F32_FLOPS))
    for name, r in rec.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.5f} ms by "
            f"{r['bound'][1]})")
    pr = rec["paged_prefill"]
    log(f"kernel paged_prefill, tensor-core arm ({TC_ROWS} rows a CTA): "
        f"{pr['ms']:.4f} ms, one launch of {pr['kernel_ms']:.4f} ms on the "
        f"device; attention alone {pr['attn_ms']:.4f} ms, the block writes "
        f"as a kernel of their own {pr['write_ms']:.4f} ms (profiler, per "
        f"call); arms on the same inputs: " + "; ".join(
            f"{name} {a['ms']:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in a["split"].items()) + ")"
            for name, a in pr["arms"].items())
        + f"; CUDA-core arm max_abs_err {pr['cc_max_abs_err']:.3g}; "
        f"lanes up to pos0 1000 {pr['long_lanes_ms']:.4f} ms")
    log(f"kernel paged_attention, verify s 5 and 9 (bf16, int8, window, "
        f"GQA 8/2): max_abs_err {verify_err:.3g}; s 5 timed "
        f"{verify['ms']:.4f} ms (plain {verify['plain_ms']:.4f} ms, library "
        f"{verify['library_ms']:.4f} ms, bound "
        f"{verify['bound'][0]:.5f} ms by {verify['bound'][1]}) beside s 1 "
        f"{rec['paged_attention']['ms']:.4f} ms")
    for key, arms in (("s 1", rec["paged_attention"]["arm_ms"]),
                      ("verify s 5", verify["arm_ms"])):
        log(f"kernel paged_attention {key}, arms in turns (cc, tc, tc, cc): "
            f"{arms['cc'][0]:.4f}, {arms['tc'][0]:.4f}, {arms['tc'][1]:.4f}, "
            f"{arms['cc'][1]:.4f} ms; split walk / CUDA-core "
            f"{sum(arms['tc']) / sum(arms['cc']):.3f}")
    log(f"kernel paged_attention: split walk s 5 / s 1 "
        f"{sum(verify['arm_ms']['tc']) / sum(rec['paged_attention']['arm_ms']['tc']):.3f}; "
        f"CUDA-core arm max_abs_err {dec['cc_err']:.3g}; "
        f"{dec['tc_launches']} checking launches on the split walk")
    rec["paged_attention"]["verify"] = verify
    del flush
    ops.reset_launch_counts()
    return rec


def residual_close(torch, out, ref, lt, temps) -> float:
    """The residual prep against its plain version, with the CPU test's
    tolerances (tests/test_torch_spec.py): ``pt`` and ``pd`` to ``rtol
    2e-6, atol 1e-7`` (the kernel sums each softmax in another order), the
    same rows with an empty residual, those rows' logits ``lt / temp`` bit
    for bit, the residual probabilities ``exp(lr)`` to ``atol 1e-6``.
    Returns the largest difference of ``pt``, ``pd`` and ``exp(lr)``."""
    err = 0.0
    for a, b in zip(out[:2], ref[:2]):
        if not torch.allclose(a, b, rtol=2e-6, atol=1e-7):
            raise AssertionError("fused_residual_prep's softmax differs from "
                                 "its plain version")
        err = max(err, float((a - b).abs().max()))
    has = [(torch.clamp(x[0] - x[1], min=0) > 0).any(-1) for x in (out, ref)]
    if not torch.equal(has[0], has[1]):
        raise AssertionError("fused_residual_prep finds another set of "
                             "empty residuals than its plain version")
    temp = torch.clamp(temps, min=1e-6)[:, None, None]
    scaled = (lt.float() / temp)[~has[0]]
    if not (torch.equal(out[2][~has[0]], scaled)
            and torch.equal(ref[2][~has[0]], scaled)):
        raise AssertionError("an empty residual row is not lt / temp bit "
                             "for bit")
    pe, re = out[2][has[0]].exp(), ref[2][has[0]].exp()
    if not torch.allclose(pe, re, rtol=0, atol=1e-6):
        raise AssertionError("fused_residual_prep's residual differs from "
                             "its plain version")
    return max(err, float((pe - re).abs().max()) if pe.numel() else 0.0)


def check_residual(torch, dev):
    """Phase 3d: the residual prep kernel against its plain version at the
    verify's main shape ``[8, 4, 256]`` (temperatures 0, 0.7 and 1.3, one
    row with draft == target), a prime vocab and a 32000 vocab (the row
    loop), f32 and a bf16 input; timed as in phase 3."""
    from tpudist_torch import ops
    from tpudist_torch.ops.fused_sample import (fused_residual_prep,
                                                fused_residual_reference)

    gen = torch.Generator(device=dev).manual_seed(99)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    temps = torch.tensor([0, 0.7, 1.3, 0.7, 0, 1.3, 0.7, 1.3], device=dev)
    err = 0.0
    for k, vocab, dtype in ((4, V, torch.float32), (2, 17, torch.float32),
                            (4, 32000, torch.float32),
                            (4, V, torch.bfloat16)):
        lt = torch.randn(SLOTS, k, vocab, generator=gen, device=dev) * 3
        ld = torch.randn(SLOTS, k, vocab, generator=gen, device=dev) * 3
        ld[2] = lt[2]  # an empty residual
        lt, ld = lt.to(dtype), ld.to(dtype)
        out = fused_residual_prep(lt, ld, temps)
        ref = fused_residual_reference(lt, ld, temps)
        torch.cuda.synchronize()
        err = max(err, residual_close(torch, out, ref, lt, temps))
    lt = torch.randn(SLOTS, 4, V, generator=gen, device=dev) * 3
    ld = torch.randn(SLOTS, 4, V, generator=gen, device=dev) * 3
    nbytes = SLOTS * 4 * V * (2 * 4 + 3 * 4) + SLOTS * 4
    rec = dict(
        route="cuda", source="tpudist_torch/csrc/fused_sample.cu",
        replaces="tpudist/ops/fused_sample.py:219", max_abs_err=err,
        ms=time_ms(torch, lambda: fused_residual_prep(lt, ld, temps), flush),
        plain_ms=time_ms(torch, lambda: fused_residual_reference(
            lt, ld, temps), flush),
        library_ms=None,
        # ~12 f32 operations an entry: 4 divisions, 2 exps, 3 subtractions,
        # a max, an add and a log
        bound=bound(nbytes, 12 * SLOTS * 4 * V, H100_F32_FLOPS))
    log(f"kernel fused_residual_prep: max_abs_err {err:.3g}, "
        f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, library none, "
        f"bound {rec['bound'][0]:.6f} ms by {rec['bound'][1]})")
    del flush
    ops.reset_launch_counts()
    return {"fused_residual_prep": rec}


def check_filters(torch, out, ref, topk_row, top_p: float) -> None:
    """Sampling outputs with top-k / top-p on: masked, greedy and top-k
    exact.  A top-p kept set may differ from the plain version's only where
    the softmax mass before a value lies within ``V * 2**-23`` of
    ``top_p``: the kernel sums the sorted row's probabilities in another
    order than a sequential cumsum, each of V additions rounding by at most
    2**-24 relative on either side."""
    import numpy as np

    for x, y in ((out[0], ref[0]), (out[2], ref[2])):
        if not torch.equal(x, y):
            raise AssertionError("fused_sample_prep differs from its plain "
                                 "version")
    if top_p == 0.0:
        if not torch.equal(out[1], ref[1]):
            raise AssertionError("top-k filtered logits differ")
        return
    neg = torch.finfo(torch.float32).min
    o, r, t = (x.cpu().numpy() for x in (out[1], ref[1], topk_row))
    n_vocab = o.shape[1]
    for row in range(o.shape[0]):
        diff = np.flatnonzero((o[row] == neg) != (r[row] == neg))
        srt = np.sort(t[row].astype(np.float64))[::-1]
        p = np.exp(srt - srt[0])
        before = np.concatenate([[0.0], np.cumsum(p / p.sum())[:-1]])
        for pos in diff:
            first = int(np.flatnonzero(srt == float(t[row, pos]))[0])
            if abs(before[first] - top_p) > n_vocab * 2.0 ** -23:
                raise AssertionError(
                    f"top-p kept sets differ at mass {before[first]} "
                    f"(top_p {top_p})")
    kept = out[1] > neg
    if not torch.equal(out[1][kept], ref[1][kept]):
        raise AssertionError("top-p kept values differ")


# ---------------------------------------------------------------------------
# phase 3b: the flash kernels against their plain versions


def flash_agreement(torch, out, ref, dtype, grad: bool = True,
                    vmax: float = 0.0) -> dict:
    """How a flash output or gradient agrees with its plain version, against
    the stated bounds.

    Elementwise: f32 sums in another order only (``1e-4 * max|ref| + 1e-4 *
    |ref|``).  bf16 gradients round ds and p to bf16 before their products
    on both sides, and a value on a rounding boundary can land one bf16 step
    (2**-8) apart: ``2**-7 * max|ref| + 2**-7 * |ref|``.  The bf16 output
    takes :func:`close_bf16`'s bound over ``vmax`` = max|V|.

    Per row (the last axis) and over the whole tensor, since an elementwise
    bound scaled by the largest value cannot see a fault confined to rows
    whose values are small (a causal row over n keys has |out| ~ n**-0.5):
    ``|err_row| <= row * |ref_row| + floor * mean_rows |ref_row|`` and
    ``|err| / |ref| <= rms``.  Readings of the sound kernels on the H100 over
    the phase's cases (tests/torch_flash_faults.py): bf16 outputs at most
    5.7e-3 per row and 2.3e-3 overall; bf16 gradients, whose rows can
    cancel to nearly nothing, at most 0.025 of the mean row per row and
    1.9e-4 overall (the wgmma arm and the dq forming delta included); f32
    below 7e-7 per row and 5e-6 of the mean row.  So
    bf16 takes ``row = 2**-6``, ``rms = 2**-7`` and for gradients ``floor =
    2**-4``; f32 takes ``row = rms = 1e-5`` and for gradients ``floor =
    1e-4``.  Half of one KV tile's P·V dropped in one head's last Q tile
    reads 0.26 per row at the main-path shapes and passes the elementwise
    bound alone."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    top = float(ref.abs().max())
    if dtype == torch.float32:
        ok = bool((err <= 1e-4 * top + 1e-4 * ref.abs()).all())
        row, floor, rms = 1e-5, (1e-4 if grad else 0.0), 1e-5
    elif grad:
        ok = bool((err <= 2 ** -7 * top + 2 ** -7 * ref.abs()).all())
        row, floor, rms = 2 ** -6, 2 ** -4, 2 ** -7
    else:
        ok = bool((err <= 2 ** -7 * vmax + 2 ** -8 * ref.abs()).all())
        row, floor, rms = 2 ** -6, 0.0, 2 ** -7
    ref_rows, err_rows = ref.norm(dim=-1), (out - ref).norm(dim=-1)
    rel = float((out - ref).norm() / ref.norm().clamp(min=1e-30))
    return dict(
        max_abs_err=float(err.max()), max_ref=top, elementwise_ok=ok,
        rows_ok=bool((err_rows <= row * ref_rows
                      + floor * float(ref_rows.mean())).all()),
        worst_row=float((err_rows / ref_rows.clamp(min=1e-30)).max()),
        worst_row_of_mean=float(err_rows.max() / ref_rows.mean()),
        rel_rms=rel, rms_ok=rel <= rms)


def flash_close(torch, out, ref, dtype, what: str, grad: bool = True,
                vmax: float = 0.0) -> float:
    """Max |out - ref|, raising unless :func:`flash_agreement` holds."""
    r = flash_agreement(torch, out, ref, dtype, grad, vmax)
    if not (r["elementwise_ok"] and r["rows_ok"] and r["rms_ok"]):
        raise AssertionError(f"{what} disagrees with its plain version: {r}")
    return r["max_abs_err"]


def flash_case_readings(torch, gen, case) -> dict:
    """One ``FLASH_CASES`` case on the card: the forward, dq and dk/dv
    kernels against their plain versions (:func:`flash_agreement` of out,
    dq, dk, dv; lse within ``1e-4 + 1e-5·|lse|``).  On the forward's wgmma
    arm also its ``out_f32`` output (the bf16 output's bound, on f32
    values).  On the backward's wgmma arm also the dq kernel that forms
    delta itself, with a random lse cotangent: its delta within
    ``DELTA_REL_MAX`` of the plain one, its dq against the plain dq, and bit
    for bit the explicit-delta arm's dq on its delta.  Every check's verdict
    is under ``ok``."""
    from tpudist_torch.ops.flash_attention import (
        _bwd_arm, _fwd_arm, flash_backward_dkv, flash_backward_dq,
        flash_backward_dq_delta, flash_backward_reference, flash_forward,
        flash_forward_reference)

    name, b, h, h_kv, s, d, dt, band = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                  .to(dtype) for shape in ((b, h, s, d), (b, h_kv, s, d),
                                           (b, h_kv, s, d), (b, h, s, d)))
    vmax = float(v.float().abs().max())
    out, lse = flash_forward(q, k, v, band)
    ref, rlse = flash_forward_reference(q, k, v, band)
    delta = (ref.float() * g.float()).sum(-1).contiguous()
    dq = flash_backward_dq(q, k, v, g, rlse, delta, band)
    dk, dv = flash_backward_dkv(q, k, v, g, rlse, delta, band)
    rq, rk, rv = flash_backward_reference(q, k, v, g, rlse, delta, band)
    torch.cuda.synchronize()
    res = dict(case=name, arm=_bwd_arm(q), fwd_arm=_fwd_arm(q), lse_ok=bool(
        ((lse - rlse).abs() <= 1e-4 + 1e-5 * rlse.abs()).all()))
    for t, a, r, grad in (("out", out, ref, False), ("dq", dq, rq, True),
                          ("dk", dk, rk, True), ("dv", dv, rv, True)):
        res[t] = flash_agreement(torch, a, r, dtype, grad, vmax)
    if res["fwd_arm"] == "wgmma":
        o32, l32 = flash_forward(q, k, v, band, out_f32=True)
        r32, _ = flash_forward_reference(q, k, v, band, out_f32=True)
        torch.cuda.synchronize()
        res["out_f32"] = flash_agreement(torch, o32, r32, dtype, False, vmax)
        res["lse_ok"] &= bool(
            ((l32 - rlse).abs() <= 1e-4 + 1e-5 * rlse.abs()).all())
    if res["arm"] == "wgmma":
        g_lse = torch.randn(b, h, s, generator=gen, device="cuda")
        fq, fdelta = flash_backward_dq_delta(q, k, v, g, rlse, ref, g_lse,
                                             band)
        pdelta = (ref.float() * g.float()).sum(-1) - g_lse
        mag = (ref.float() * g.float()).abs().sum(-1) + g_lse.abs()
        rq = flash_backward_reference(q, k, v, g, rlse, pdelta, band)[0]
        eq = flash_backward_dq(q, k, v, g, rlse, fdelta, band)
        torch.cuda.synchronize()
        res["delta_rel"] = float(((fdelta - pdelta).abs() / mag).max())
        res["dq_fold"] = flash_agreement(torch, fq, rq, dtype)
        res["fold_equals_explicit"] = bool(torch.equal(fq, eq))
    checks = [res["lse_ok"]] + [
        r["elementwise_ok"] and r["rows_ok"] and r["rms_ok"]
        for r in (res[t] for t in ("out", "out_f32", "dq", "dk", "dv",
                                   "dq_fold") if t in res)]
    if "delta_rel" in res:
        checks += [res["delta_rel"] <= DELTA_REL_MAX,
                   res["fold_equals_explicit"]]
    res["ok"] = all(checks)
    return res


def check_flash(torch, dev):
    """Phase 3b: forward, dq and dk/dv kernels against their plain versions
    on ``FLASH_CASES`` (:func:`flash_case_readings`), then timed at the
    training path's shapes beside the mma.sync arm the wgmma arm replaced
    and the folded delta beside the given one."""
    import torch.nn.functional as F

    from tpudist_torch import ops
    from tpudist_torch.ops.flash_attention import (
        FlashAttention, _launch_dkv, _launch_dq, _launch_fwd,
        band_live_pairs, flash_backward_dkv, flash_backward_dq,
        flash_backward_dq_delta, flash_backward_reference, flash_forward,
        flash_forward_reference)

    gen = torch.Generator(device=dev).manual_seed(4321)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def inputs(b, h, h_kv, s, dtype, d=DH):
        def r(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)
        return (r(b, h, s, d), r(b, h_kv, s, d), r(b, h_kv, s, d),
                r(b, h, s, d))

    err = {"flash_forward": 0.0, "flash_backward_dq": 0.0,
           "flash_backward_dkv": 0.0}
    fold = dict(delta_rel=0.0, dq_max_abs_err=0.0, cases=0)
    for case in FLASH_CASES:
        r = flash_case_readings(torch, gen, case)
        if not r["ok"]:
            raise AssertionError(f"flash kernels disagree with their plain "
                                 f"versions ({case[0]}): {r}")
        err["flash_forward"] = max(err["flash_forward"],
                                   r["out"]["max_abs_err"])
        err["flash_backward_dq"] = max(err["flash_backward_dq"],
                                       r["dq"]["max_abs_err"],
                                       r.get("dq_fold", r["dq"])
                                       ["max_abs_err"])
        err["flash_backward_dkv"] = max(err["flash_backward_dkv"],
                                        r["dk"]["max_abs_err"],
                                        r["dv"]["max_abs_err"])
        if "delta_rel" in r:
            fold["delta_rel"] = max(fold["delta_rel"], r["delta_rel"])
            fold["dq_max_abs_err"] = max(fold["dq_max_abs_err"],
                                         r["dq_fold"]["max_abs_err"])
            fold["cases"] += 1
        log(f"flash {case[0]}: b {case[1]} h {case[2]}/{case[3]} s "
            f"{case[4]} dh {case[5]} {case[6]}, forward on the "
            f"{r['fwd_arm']} arm, backward on the {r['arm']} arm: agrees"
            + (f"; folded delta rel {r['delta_rel']:.2e}, dq equal to the "
               f"given-delta arm's" if "delta_rel" in r else ""))

    # timing at the main path's shapes (b 8, h 8, s 2048, dh 128, causal)
    b, h, s, band = 8, 8, 2048, (0, None)
    q, k, v, g = inputs(b, h, h, s, bf16)
    out, lse = flash_forward(q, k, v, band)
    # the forward's mma.sync arm, which the wgmma arm replaced at this
    # shape, held on the same inputs before it is timed beside it
    mout, mlse = _launch_fwd("mma", q, k, v, band)
    ref, rlse = flash_forward_reference(q, k, v, band)
    torch.cuda.synchronize()
    for o_, l_ in ((out, lse), (mout, mlse)):
        flash_close(torch, o_, ref, bf16, "the forward's arms", False,
                    float(v.float().abs().max()))
        if not bool(((l_ - rlse).abs() <= 1e-4 + 1e-5 * rlse.abs()).all()):
            raise AssertionError("the forward's lse disagrees with its "
                                 "plain version")
    del mout, mlse, ref, rlse
    delta = (out.float() * g.float()).sum(-1).contiguous()
    work = b * h * band_live_pairs(s, s, band)
    elt = q.numel()
    io = 4 * elt * 2  # q, k, v, do (or out) in bf16
    rows = b * h * s * 4  # one f32 per query row (lse, delta)

    def plain_dq_delta():
        dl = (out.float() * g.float()).sum(-1)
        return flash_backward_reference(q, k, v, g, lse, dl, band)[0], dl

    shapes = dict(
        flash_forward=(io + rows, 4 * work * DH,
                       lambda: flash_forward(q, k, v, band),
                       lambda: flash_forward_reference(q, k, v, band),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=True),
                       "tpudist/ops/flash_attention.py:283",
                       "tpudist_torch/csrc/flash_attention.cu"),
        # the main path's dq: the kernel forms delta from out and do
        flash_backward_dq=(io + elt * 2 + 2 * rows + elt * 2,
                           6 * work * DH + 2 * elt,
                           lambda: flash_backward_dq_delta(
                               q, k, v, g, lse, out, None, band),
                           plain_dq_delta, None,
                           "tpudist/ops/flash_attention.py:622",
                           "tpudist_torch/csrc/flash_backward.cu"),
        flash_backward_dkv=(io + 2 * rows + 2 * elt * 2, 8 * work * DH,
                            lambda: flash_backward_dkv(q, k, v, g, lse,
                                                       delta, band),
                            lambda: flash_backward_reference(
                                q, k, v, g, lse, delta, band), None,
                            "tpudist/ops/flash_attention.py:669",
                            "tpudist_torch/csrc/flash_backward.cu"),
    )
    rec = {}
    for name, (nbytes, flops, kern, plain, lib, replaces, src) in \
            shapes.items():
        rec[name] = dict(
            route="cuda", source=src, replaces=replaces,
            max_abs_err=err[name], ms=time_ms(torch, kern, flush),
            plain_ms=time_ms(torch, plain, flush, n=5, warmup=1),
            library_ms=time_ms(torch, lib, flush) if lib else None,
            bound=bound(nbytes, flops, H100_BF16_FLOPS))
    # the same call: dq with a given delta, and the mma.sync arm that the
    # wgmma arm replaced at this shape, in turns (mma, wgmma, wgmma, mma)
    given_ms = time_ms(torch, lambda: flash_backward_dq(
        q, k, v, g, lse, delta, band), flush)
    arms = {"mma": [], "wgmma": []}
    for arm in ("mma", "wgmma", "wgmma", "mma"):
        arms[arm].append(dict(
            dq=time_ms(torch, lambda: _launch_dq(arm, q, k, v, g, lse, delta,
                                                 band), flush),
            dkv=time_ms(torch, lambda: _launch_dkv(arm, q, k, v, g, lse,
                                                   delta, band), flush)))
    fwd_arms = {"mma": [], "wgmma": []}
    for arm in ("mma", "wgmma", "wgmma", "mma"):
        fwd_arms[arm].append(time_ms(torch, lambda: _launch_fwd(
            arm, q, k, v, band), flush))
    rec["flash_forward"]["replaced_ms"] = fwd_arms["mma"]
    rec["flash_forward"]["arm_ms"] = fwd_arms["wgmma"]
    rec["flash_backward_dq"]["given_delta_ms"] = given_ms
    rec["flash_backward_dq"]["replaced_ms"] = [a["dq"] for a in arms["mma"]]
    rec["flash_backward_dkv"]["replaced_ms"] = [a["dkv"]
                                                for a in arms["mma"]]
    rec["flash_backward_dq"]["arm_ms"] = [a["dq"] for a in arms["wgmma"]]
    rec["flash_backward_dkv"]["arm_ms"] = [a["dkv"] for a in arms["wgmma"]]
    # forward + backward: FlashAttention (fwd, dq with delta, dk/dv)
    # against one scaled_dot_product_attention forward + backward
    qa, ka, va = (t.detach().requires_grad_(True) for t in (q, k, v))

    def ours():
        o, _ = FlashAttention.apply(qa, ka, va, True)
        o.backward(g)

    def sdpa():
        o = F.scaled_dot_product_attention(qa, ka, va, is_causal=True)
        o.backward(g)

    # the backward alone (dq forming delta, dk/dv against SDPA's backward),
    # over one forward graph kept alive between the timed calls
    o_ours, _ = FlashAttention.apply(qa, ka, va, True)
    o_sdpa = F.scaled_dot_product_attention(qa, ka, va, is_causal=True)
    fwd_bwd = dict(ms=time_ms(torch, ours, flush),
                   library_ms=time_ms(torch, sdpa, flush),
                   bwd_ms=time_ms(torch, lambda: torch.autograd.grad(
                       o_ours, (qa, ka, va), g, retain_graph=True), flush),
                   library_bwd_ms=time_ms(torch, lambda: torch.autograd.grad(
                       o_sdpa, (qa, ka, va), g, retain_graph=True), flush),
                   bound_ms=bound(io + 2 * rows + 3 * elt * 2,
                                  18 * work * DH, H100_BF16_FLOPS)[0],
                   folded_delta=fold)
    for name, r in rec.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.5f} ms by "
            f"{r['bound'][1]})")
    dq_r, dkv_r = rec["flash_backward_dq"], rec["flash_backward_dkv"]
    fw = rec["flash_forward"]
    log(f"flash forward arms, same call (mma, wgmma, wgmma, mma): "
        f"{fw['replaced_ms'][0]:.4f}, {fw['arm_ms'][0]:.4f}, "
        f"{fw['arm_ms'][1]:.4f}, {fw['replaced_ms'][1]:.4f} ms; wgmma / "
        f"mma.sync {sum(fw['arm_ms']) / sum(fw['replaced_ms']):.3f}; SDPA "
        f"causal forward {fw['library_ms']:.4f} ms")
    log(f"flash backward arms, same call (mma, wgmma, wgmma, mma): dq "
        f"{dq_r['replaced_ms'][0]:.4f}, {dq_r['arm_ms'][0]:.4f}, "
        f"{dq_r['arm_ms'][1]:.4f}, {dq_r['replaced_ms'][1]:.4f} ms; dk/dv "
        f"{dkv_r['replaced_ms'][0]:.4f}, {dkv_r['arm_ms'][0]:.4f}, "
        f"{dkv_r['arm_ms'][1]:.4f}, {dkv_r['replaced_ms'][1]:.4f} ms; the "
        f"wgmma dq forming delta {dq_r['ms']:.4f} ms, given delta "
        f"{dq_r['given_delta_ms']:.4f} ms; folded delta over "
        f"{fold['cases']} cases: rel {fold['delta_rel']:.2e} <= "
        f"{DELTA_REL_MAX}")
    log(f"flash fwd+bwd (FlashAttention): {fwd_bwd['ms']:.4f} ms, SDPA "
        f"fwd+bwd {fwd_bwd['library_ms']:.4f} ms, bound "
        f"{fwd_bwd['bound_ms']:.5f} ms; backward alone "
        f"{fwd_bwd['bwd_ms']:.4f} ms, SDPA backward "
        f"{fwd_bwd['library_bwd_ms']:.4f} ms")
    del flush, q, k, v, g, qa, ka, va, o_ours, o_sdpa
    ops.reset_launch_counts()
    return rec, fwd_bwd


# ---------------------------------------------------------------------------
# phase 3c: the fused RoPE+QKV and LoRA gather-matmul kernels


def linear_agreement(torch, out, ref, dtype: str) -> dict:
    """How a fused linear kernel's output agrees with its plain version:
    elementwise against ``|ref|`` plus the largest ``|ref|`` of its row (a
    rotated pair mixes two values of a row), per row (the last axis) and
    over the whole tensor, against ``LINEAR_BOUNDS[dtype]``."""
    out, ref = out.float(), ref.float()
    diff = out - ref
    scale = ref.abs() + ref.abs().amax(dim=-1, keepdim=True)
    elem, row, rms = LINEAR_BOUNDS[dtype]
    r = dict(
        max_abs_err=float(diff.abs().max()),
        worst_elem=float((diff.abs() / scale.clamp(min=1e-30)).max()),
        worst_row=float((diff.norm(dim=-1)
                         / ref.norm(dim=-1).clamp(min=1e-30)).max()),
        rel_rms=float(diff.norm() / ref.norm().clamp(min=1e-30)))
    r["ok"] = (r["worst_elem"] <= elem and r["worst_row"] <= row
               and r["rel_rms"] <= rms)
    return r


def linear_close(torch, out, ref, dtype: str, what: str) -> dict:
    r = linear_agreement(torch, out, ref, dtype)
    if not r["ok"]:
        raise AssertionError(f"{what} disagrees with its plain version: {r}")
    return r


def qkv_inputs(torch, dev, gen, S, T, nh, n_kv, dh, dtype, offs,
               extra=True, on_bool=False):
    """``fused_rope_qkv`` arguments: h, the qkv weight as the port stores it
    (``[dtot, d]``, passed as its transposed view), offsets, the delta and
    the lane mask."""
    d, dtot = nh * dh, (nh + 2 * n_kv) * dh

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    on = torch.tensor((LANE_ON * S)[:S], device=dev,
                      dtype=torch.bool if on_bool else torch.int32)
    return (r(S, T, d), r(dtot, d, scale=d ** -0.5).t(),
            torch.tensor(offs, dtype=torch.int32, device=dev),
            r(S, T, dtot, scale=0.1) if extra else None,
            on if extra else None)


def lora_inputs(torch, dev, gen, S, T, d_in, d_out, dtype, rank, ids,
                blocks=8):
    """``lora_delta`` arguments over an ``[LAYERS, blocks, ...]`` pool
    (factors scaled as ``make_adapter_factors`` scales them)."""
    x = torch.randn(S, T, d_in, generator=gen, device=dev).to(dtype)
    a = torch.randn(LAYERS, blocks, d_in, rank, generator=gen,
                    device=dev) * d_in ** -0.5
    b = torch.randn(LAYERS, blocks, rank, d_out, generator=gen,
                    device=dev) * 0.05
    return x, a, b, torch.tensor(ids, dtype=torch.int32, device=dev)


def unfused_qkv(torch, h, w, offsets, extra, on, nh, n_kv, dh):
    """The chain ``fused_rope=False`` runs for one layer: ``F.linear``, the
    adapter select, the head split and two ``rope_rotate``."""
    import torch.nn.functional as F

    from tpudist_torch.models.transformer import rope_rotate

    S, T, _ = h.shape
    qkv = F.linear(h, w.t())
    if extra is not None:
        qkv = torch.where(on[:, None, None] != 0, qkv + extra, qkv)
    q = qkv[..., :nh * dh].reshape(S, T, nh, dh).transpose(1, 2)
    k = qkv[..., nh * dh:(nh + n_kv) * dh].reshape(S, T, n_kv,
                                                   dh).transpose(1, 2)
    v = qkv[..., (nh + n_kv) * dh:].reshape(S, T, n_kv, dh).transpose(1, 2)
    return rope_rotate(q, offset=offsets), rope_rotate(k, offset=offsets), v


def check_fused_linear(torch, dev):
    """Phase 3c: both kernels against their plain versions at the main
    path's shapes (decode T 1, the verify's T 5, prefill T 64, 8 slots, d
    1024, rank 8), a GQA case, a rope-off ragged case and f32 cases, each
    ``fused_rope_qkv`` case on the arm ``_rope_arm`` picks and the bf16
    ones also on the mma.sync arm; then timed as in phase 3:
    ``fused_rope_qkv``'s split and wgmma arms beside the mma.sync arm they
    replaced and ``lora_delta``'s cluster arm beside the staged arm, on the
    same inputs, in turns; ``F.linear`` of the qkv product alone; an empty
    kernel (the timer's floor for a tiny launch and for the split arm's
    grid); and the card's ``cudaOccupancyMaxActiveClusters`` for both
    cluster arms."""
    import torch.nn.functional as F

    from tpudist_torch import ops
    from tpudist_torch.ops.fused_linear import (LORA_DECODE_ROWS,
                                                ROPE_SPLIT_COLS,
                                                ROPE_SPLIT_KS, _launch_empty,
                                                _launch_lora, _launch_rope,
                                                _rope_arm, fused_rope_qkv,
                                                fused_rope_qkv_reference,
                                                lora_delta,
                                                lora_delta_reference,
                                                lora_max_active_clusters,
                                                rope_max_active_clusters)

    gen = torch.Generator(device=dev).manual_seed(5678)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    readings = {}
    # (name, S, T, nh, n_kv, dh, dtype, rope, extra, offsets)
    qkv_cases = (
        ("decode", SLOTS, 1, HEADS, HEADS, DH, bf16, True, True,
         DECODE_OFFS),
        ("prefill", SLOTS, P, HEADS, HEADS, DH, bf16, True, True,
         PREFILL_OFFS),
        ("GQA n_kv 2, T 16", SLOTS, 16, HEADS, 2, DH, bf16, True, True,
         DECODE_OFFS),
        ("rope off, ragged T 37, dh 64", 3, 37, 4, 4, 64, bf16, False,
         False, [0, 5, 9]),
        ("f32 GQA, bool mask", 5, 9, 4, 2, 64, f32, True, True,
         [0, 3, 11, 100, 2000]))
    worst = {"fused_rope_qkv": 0.0, "lora_delta": 0.0}

    def hold_qkv(name, S, T, nh, n_kv, dh, dtype, rope, extra, offs, g,
                 on_bool):
        dt = "bf16" if dtype == bf16 else "f32"
        args = qkv_inputs(torch, dev, g, S, T, nh, n_kv, dh, dtype, offs,
                          extra, on_bool=on_bool)
        kw = dict(n_heads=nh, n_kv=n_kv, dh=dh, rope=rope)
        ref = fused_rope_qkv_reference(*args, **kw)
        arm = _rope_arm(S * T, dh, nh * dh, dtype)
        ops.reset_launch_counts()
        outs = {arm: fused_rope_qkv(*args, **kw)}
        ran = {a: getattr(fused_rope_qkv, f"launches_{a}")
               for a in ("split", "wgmma")}
        if ran.get(arm, 1) != 1 or sum(ran.values()) != (arm in ran):
            raise AssertionError(f"fused_rope_qkv {name}: launched {ran}, "
                                 f"the plan says {arm}")
        if dtype == bf16 and arm != "mma":  # the arm the new ones replaced
            outs["mma"] = _launch_rope("mma", *args, **kw)
        torch.cuda.synchronize()
        for a, out in outs.items():
            for part, x, y in zip("qkv", out, ref):
                key = f"fused_rope_qkv {name} {part}" + (
                    " (mma arm)" if a != arm else "")
                r = linear_close(torch, x, y, dt, key)
                readings[key] = r
                worst["fused_rope_qkv"] = max(worst["fused_rope_qkv"],
                                              r["max_abs_err"])
        log(f"fused_rope_qkv {name}: agrees on the {arm} arm"
            + (" and the mma arm" if len(outs) > 1 else ""))

    for name, S, T, nh, n_kv, dh, dtype, rope, extra, offs in qkv_cases:
        hold_qkv(name, S, T, nh, n_kv, dh, dtype, rope, extra, offs, gen,
                 dtype == f32)
    # (name, S, T, d_in, d_out, dtype, rank, ids)
    # (the cases added later come last, so the earlier ones keep the draws
    # of the generator they were read against)
    lora_cases = (
        ("qkv decode", SLOTS, 1, 1024, 3072, bf16, RANK, LORA_IDS),
        ("wi decode", SLOTS, 1, 1024, 4096, bf16, RANK, LORA_IDS),
        ("wo prefill", SLOTS, P, 4096, 1024, bf16, RANK, LORA_IDS),
        ("qkv prefill", SLOTS, P, 1024, 3072, bf16, RANK, LORA_IDS),
        ("f32 rank 2, ragged", 3, 37, 256, 200, f32, 2, [1, 8, 7]),
        ("rank 64, sentinel only", 2, 5, 512, 300, bf16, 64, [8, 8]),
        ("wo decode", SLOTS, 1, 4096, 1024, bf16, RANK, LORA_IDS),
        ("wi verify", SLOTS, SPEC_K + 1, 1024, 4096, bf16, RANK, LORA_IDS))
    for name, S, T, d_in, d_out, dtype, rank, ids in lora_cases:
        dt = "bf16" if dtype == bf16 else "f32"
        args = lora_inputs(torch, dev, gen, S, T, d_in, d_out, dtype, rank,
                           ids)
        for layer in (0, LAYERS - 1):
            out = lora_delta(*args, layer=layer)
            ref = lora_delta_reference(*args, layer=layer)
            torch.cuda.synchronize()
            r = linear_close(torch, out, ref, dt,
                             f"lora_delta {name} layer {layer}")
            readings[f"lora_delta {name} layer {layer}"] = r
            worst["lora_delta"] = max(worst["lora_delta"], r["max_abs_err"])
        log(f"lora_delta {name}: agrees")

    # the split and wgmma arms' own edges, on a generator of their own (the
    # cases above keep the draws they were read against): the verify's T
    # 5, a ragged S 3 x T 5 under GQA with a bool mask, the split arm's
    # last row count (64) and the wgmma arm's first (65, a row tile cut
    # mid-slot) at head dim 64
    gen2 = torch.Generator(device=dev).manual_seed(5679)
    for name, S, T, nh, n_kv, dh, rope, extra, offs, on_bool in (
            ("verify T 5", SLOTS, SPEC_K + 1, HEADS, HEADS, DH, True, True,
             DECODE_OFFS, False),
            ("split GQA 8/2, S 3 x T 5", 3, 5, HEADS, 2, DH, True, True,
             [7, 1999, 64], True),
            ("split 64 rows, rope off", 4, 16, HEADS, 2, DH, False, True,
             [0, 3, 5, 9], False),
            ("wgmma 65 rows, dh 64", 5, 13, 16, 4, 64, True, True,
             [0, 100, 1000, 5, 17], False)):
        hold_qkv(name, S, T, nh, n_kv, dh, bf16, rope, extra, offs, gen2,
                 on_bool)

    for kname in ADAPTER_KERNELS:
        rs = [r for k, r in readings.items() if k.startswith(kname)]
        log(f"{kname} readings, worst over {len(rs)} outputs: "
            + ", ".join(f"{m} {max(r[m] for r in rs):.3g}"
                        for m in ("worst_elem", "worst_row", "rel_rms")))
    rec, timings = {}, {}
    d, dtot = HEADS * DH, 3 * HEADS * DH
    for label, T, offs in (("decode", 1, DECODE_OFFS),
                           ("prefill", P, PREFILL_OFFS),
                           ("verify", SPEC_K + 1, DECODE_OFFS)):
        args = qkv_inputs(torch, dev, gen, SLOTS, T, HEADS, HEADS, DH, bf16,
                          offs)
        kw = dict(n_heads=HEADS, n_kv=HEADS, dh=DH)
        rows = SLOTS * T
        nbytes = 2 * (d * dtot + rows * d + 2 * rows * dtot) + SLOTS * 8
        t = timings[f"fused_rope_qkv {label}"] = dict(
            ms=time_ms(torch, lambda: fused_rope_qkv(*args, **kw), flush),
            host_ms=time_ms(torch, lambda: fused_rope_qkv(*args, **kw),
                            flush, spin=False),
            plain_ms=time_ms(torch, lambda: fused_rope_qkv_reference(
                *args, **kw), flush),
            unfused_ms=time_ms(torch, lambda: unfused_qkv(
                torch, *args, HEADS, HEADS, DH), flush),
            bound=bound(nbytes, 2 * rows * d * dtot, H100_BF16_FLOPS))
        # the product alone through one PyTorch call: a yardstick for the
        # product, not for the function (no single call adds the delta and
        # rotates)
        wt = args[1].t()
        t["linear_ms"] = time_ms(torch, lambda: F.linear(args[0], wt), flush)
        # the new arm and the mma.sync arm it replaced, in turns
        arm = _rope_arm(rows, DH, d, bf16)
        t["arm"], t["arm_ms"] = arm, {"mma": [], arm: []}
        for a in ("mma", arm, arm, "mma"):
            t["arm_ms"][a].append(time_ms(torch, lambda: _launch_rope(
                a, *args, **kw), flush))
    # the timer's floor: an empty kernel of one CTA, and one of the split
    # arm's grid at decode (clusters of ROPE_SPLIT_KS CTAs)
    split_ctas = ROPE_SPLIT_KS * dtot // ROPE_SPLIT_COLS
    floor = dict(one_cta=time_ms(torch, lambda: _launch_empty(1), flush),
                 split_grid=time_ms(torch, lambda: _launch_empty(
                     split_ctas, True), flush), split_ctas=split_ctas)
    log(f"timer floor (time_ms of an empty kernel): one CTA "
        f"{floor['one_cta']:.4f} ms, {split_ctas} CTAs in clusters of "
        f"{ROPE_SPLIT_KS} {floor['split_grid']:.4f} ms")
    for label, T, d_in, d_out in (("qkv decode", 1, 1024, 3072),
                                  ("wi decode", 1, 1024, 4096),
                                  ("wo decode", 1, 4096, 1024),
                                  ("wi verify", SPEC_K + 1, 1024, 4096),
                                  ("wi prefill", P, 1024, 4096)):
        args = lora_inputs(torch, dev, gen, SLOTS, T, d_in, d_out, bf16,
                           RANK, LORA_IDS)
        blocks = len({min(i, 7) for i in LORA_IDS})
        rows = SLOTS * T
        nbytes = (2 * rows * (d_in + d_out) + SLOTS * 4
                  + blocks * RANK * (d_in + d_out) * 4)
        t = timings[f"lora_delta {label}"] = dict(
            ms=time_ms(torch, lambda: lora_delta(*args, layer=3), flush),
            host_ms=time_ms(torch, lambda: lora_delta(*args, layer=3),
                            flush, spin=False),
            plain_ms=time_ms(torch, lambda: lora_delta_reference(
                *args, layer=3), flush),
            bound=bound(nbytes, 2 * rows * RANK * (d_in + d_out),
                        H100_BF16_FLOPS))
        if T <= LORA_DECODE_ROWS:  # the staged arm it replaced, in turns
            arm_ms = {"cluster": [], "staged": []}
            for arm in ("staged", "cluster", "cluster", "staged"):
                arm_ms[arm].append(time_ms(torch, lambda: _launch_lora(
                    arm, *args, 3), flush))
            t["arm_ms"] = arm_ms
    clusters = lora_max_active_clusters(SLOTS)
    log(f"lora_delta cluster arm: at most {clusters} clusters of 8 CTAs "
        f"resident at once (cudaOccupancyMaxActiveClusters; {SLOTS} a "
        f"call)")
    rope_clusters = {rows: rope_max_active_clusters(rows, d, dtot)
                     for rows in (SLOTS, SLOTS * (SPEC_K + 1))}
    log(f"fused_rope_qkv split arm: at most {rope_clusters} clusters of "
        f"{ROPE_SPLIT_KS} CTAs resident at once by rows "
        f"(cudaOccupancyMaxActiveClusters; {dtot // ROPE_SPLIT_COLS} a "
        f"call)")
    for name, t in timings.items():
        log(f"kernel {name}: {t['ms']:.4f} ms (with host launch "
            f"{t['host_ms']:.4f} ms; plain {t['plain_ms']:.4f} "
            f"ms" + (f", unfused chain {t['unfused_ms']:.4f} ms"
                     if "unfused_ms" in t else "")
            + (f", F.linear of the product alone {t['linear_ms']:.4f} ms"
               if "linear_ms" in t else "")
            + (f"; arms in turns {t['arm_ms']}" if "arm_ms" in t else "")
            + f", bound {t['bound'][0]:.5f} ms by {t['bound'][1]})")
    for name, src, replaces, key in (
            ("fused_rope_qkv", "tpudist_torch/csrc/fused_rope_qkv.cu",
             "tpudist/ops/fused_linear.py:86", "fused_rope_qkv decode"),
            ("lora_delta", "tpudist_torch/csrc/lora_delta.cu",
             "tpudist/ops/fused_linear.py:214", "lora_delta wi decode")):
        t = timings[key]
        rec[name] = dict(route="cuda", source=src, replaces=replaces,
                         max_abs_err=worst[name], ms=t["ms"],
                         plain_ms=t["plain_ms"], library_ms=None,
                         bound=t["bound"])
    rec["lora_delta"]["arm_ms"] = timings["lora_delta wi decode"]["arm_ms"]
    # each arm at its own main-path shape: split and the mma.sync arm at
    # decode, wgmma at prefill
    dec, pre = (timings[f"fused_rope_qkv {k}"] for k in ("decode", "prefill"))
    rec["fused_rope_qkv"]["arm_ms"] = {
        "split": dec["arm_ms"]["split"], "mma": dec["arm_ms"]["mma"],
        "wgmma": pre["arm_ms"]["wgmma"]}
    del flush
    ops.reset_launch_counts()
    return rec, dict(timings=timings, readings=readings,
                     lora_max_active_clusters=clusters,
                     rope_max_active_clusters=rope_clusters,
                     timer_floor_ms=floor)


# ---------------------------------------------------------------------------
# phase 3e: the fused toy-MLP kernel against its plain version


def mlp_weights(torch, kind, dev):
    """``toy``: the toy model's own weights (``create_toy_model(0)``, the
    bench's); ``wide``: five 128-wide layers from a numpy seed, the widest
    shape the JAX kernel takes; a tuple of widths: layers of those widths
    from a numpy seed (the CUDA tests' edge cases)."""
    import numpy as np

    from tpudist_torch.models import create_toy_model

    if kind == "toy":
        return [(w.detach(), b.detach())
                for w, b in create_toy_model(0, device=dev).layers()]
    widths = (128,) * 6 if kind == "wide" else tuple(kind)
    r = np.random.default_rng(3 if kind == "wide" else len(widths))
    return [(torch.from_numpy(r.normal(scale=a ** -0.5, size=(a, b))
                              .astype(np.float32)).to(dev),
             torch.from_numpy(r.normal(scale=0.1, size=b)
                              .astype(np.float32)).to(dev))
            for a, b in zip(widths[:-1], widths[1:])]


def mlp_inputs(torch, kind, batch: int, dev):
    import numpy as np

    weights = mlp_weights(torch, kind, dev)
    x = np.random.default_rng(batch).standard_normal(
        (batch, weights[0][0].shape[0])).astype(np.float32)
    return weights, torch.from_numpy(x).to(dev)


def mlp_agreement(torch, out, ref, weights, x) -> dict:
    """The kernel's output against its plain version and against a float64
    numpy forward, each as the largest difference over the float64
    output's largest magnitude; held to ``MLP_PLAIN_REL`` and
    ``MLP_F64_REL``."""
    import numpy as np

    from tpudist_torch.bench import f64_forward

    r64 = f64_forward(x.cpu().numpy(), [(w.cpu().numpy(), b.cpu().numpy())
                                        for w, b in weights])
    scale = max(float(np.abs(r64).max()), 1e-6)
    o, p = out.cpu().numpy(), ref.cpu().numpy()
    res = dict(max_abs_err=float(np.abs(o - p).max()),
               rel_vs_plain=float(np.abs(o - p).max() / scale),
               rel_vs_f64=float(np.abs(o - r64).max() / scale),
               plain_rel_vs_f64=float(np.abs(p - r64).max() / scale))
    if not (np.isfinite(o).all() and res["rel_vs_plain"] <= MLP_PLAIN_REL
            and res["rel_vs_f64"] <= MLP_F64_REL):
        raise AssertionError(f"fused_mlp disagrees: {res}")
    return res


def mlp_bound(widths, batch: int):
    """Bytes: x and the output once each, the weights once; operations:
    the multiply-adds, 2 a weight a row (bias adds and activations left
    out)."""
    pairs = list(zip(widths[:-1], widths[1:]))
    nbytes = 4 * (batch * (widths[0] + widths[-1])
                  + sum(a * b + b for a, b in pairs))
    flops = 2 * batch * sum(a * b for a, b in pairs)
    return bound(nbytes, flops, H100_F32_FLOPS)


def check_fused_mlp(torch, dev):
    """Phase 3e: the fused MLP kernel against its plain version at
    ``MLP_CASES`` (:func:`mlp_agreement`), each timed as in phase 3 beside
    its bound and the plain chain; the kernels line takes the bench's batch
    4096."""
    import dataclasses

    from tpudist_torch import ops
    from tpudist_torch.ops.fused_mlp import (_mlp_plan, fused_mlp,
                                             mlp_reference, pack_params)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cases, err = {}, 0.0
    with torch.no_grad():
        for name, kind, batch in MLP_CASES:
            weights, x = mlp_inputs(torch, kind, batch, dev)
            packed = pack_params(weights)
            out = fused_mlp(x, packed)
            ref = mlp_reference(x, weights)
            torch.cuda.synchronize()
            agree = mlp_agreement(torch, out, ref, weights, x)
            err = max(err, agree["max_abs_err"])
            cases[name] = dict(
                agree, batch=batch, widths=list(packed.widths),
                plan=dataclasses.asdict(_mlp_plan(packed.widths, batch)),
                ms=time_ms(torch, lambda: fused_mlp(x, packed), flush),
                host_ms=time_ms(torch, lambda: fused_mlp(x, packed), flush,
                                spin=False),
                plain_ms=time_ms(torch, lambda: mlp_reference(x, weights),
                                 flush),
                bound=mlp_bound(packed.widths, batch))
            c = cases[name]
            log(f"kernel fused_mlp {name}: {c['ms']:.4f} ms (with host "
                f"launch {c['host_ms']:.4f} ms; {c['plan']['arm']} arm, "
                f"{c['plan']['rows']} rows a thread, "
                f"{c['plan']['rows_per_cta']} a tile, {c['plan']['blocks']} "
                f"tiles; plain "
                f"{c['plain_ms']:.4f} ms, bound {c['bound'][0]:.7f} ms by "
                f"{c['bound'][1]}); vs plain {c['rel_vs_plain']:.2e}, vs "
                f"f64 {c['rel_vs_f64']:.2e} (plain vs f64 "
                f"{c['plain_rel_vs_f64']:.2e})")
    main = cases["toy b4096"]
    rec = dict(route="cuda", source="tpudist_torch/csrc/fused_mlp.cu",
               replaces="tpudist/ops/fused_mlp.py:64", max_abs_err=err,
               ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
               bound=main["bound"])
    del flush
    ops.reset_launch_counts()
    return {"fused_mlp": rec}, cases


# ---------------------------------------------------------------------------
# phase 4: the main path; phase 5: prompt logits on the card vs the CPU


def serve_main_path(torch, model, gen_seed: int):
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.serve import InferenceServer, ServeConfig

    cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                      prefill_pad=P, decode_block=8, kv_block=BS)
    server = InferenceServer(model, cfg, device="cuda").start()
    rng = np.random.default_rng(gen_seed)
    try:
        warm = server.submit(rng.integers(0, V, size=70), max_new=9)
        if not warm.wait(600) or warm.finish_reason != "length":
            raise AssertionError("warm-up request did not finish")
        torch.cuda.synchronize()
        reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
                 int(rng.integers(16, 65))) for _ in range(16)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [server.submit(p, max_new=n) for p, n in reqs]
        for h in handles:
            if not h.wait(900):
                raise AssertionError("request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        prefill_arms = dict(tc=ops.paged_prefill_attention.launches_tc,
                            cc=ops.paged_prefill_attention.launches_cc)
        decode_tc = ops.paged_attention.launches_tc
        stats = server.stats()
    finally:
        server.close(60)
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{n} tokens")
    if stats["kv"]["blocks_in_use"] != 0:
        raise AssertionError("KV pool did not drain")
    if not all(counts[name] > 0 for name in SERVE_KERNELS):
        raise AssertionError(f"a kernel was not launched on the serving "
                             f"path: {counts}")
    if prefill_arms != dict(tc=counts["paged_prefill"], cc=0):
        raise AssertionError(f"the tensor-core arm did not serve every "
                             f"prefill launch: {prefill_arms} of "
                             f"{counts['paged_prefill']}")
    if decode_tc != counts["paged_attention"]:
        raise AssertionError(f"the split walk served {decode_tc} of the "
                             f"{counts['paged_attention']} decode launches")
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        requests=len(handles), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
        prompt_lens=[len(p) for p, _ in reqs],
        decode=stats["decode"], launches=counts,
        prefill_arm_launches=prefill_arms, decode_tc_launches=decode_tc,
        streams=[h.tokens for h in handles])


def near_tie_gap(torch, model, prompt, got, want, factors=None):
    """Where a greedy stream ``got`` differs from ``want``: the first
    differing position and the top-2 gap of the card's bf16 logits there,
    the common prefix teacher-forced through :func:`prompt_logits`."""
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = list(prompt) + list(want[:j])
    top = prompt_logits(torch, model, seq, factors)[-1].float().topk(2)
    return j, float(top.values[0] - top.values[1])


def hold_greedy_streams(torch, model, prompts, streams, base, lanes,
                        factors=None, names=None):
    """Gate of phases 4c and 4d: each greedy lane in ``lanes`` equals its
    non-speculative stream ``base``, or differs first where the card's top-2
    logits lie within ``NEAR_TIE_GAP`` (the verify computes a row in an
    ``S * (K + 1)``-row pass, so bf16 rounds otherwise than in the ``s =
    1`` decode).  Returns ``(equal lanes, [(lane, position, gap)])``."""
    equal, ties = 0, []
    for i in lanes:
        if streams[i] == base[i]:
            equal += 1
            continue
        f = None if names is None or names[i] is None else factors[names[i]]
        j, gap = near_tie_gap(torch, model, prompts[i], streams[i], base[i],
                              f)
        ties.append((i, j, gap))
        log(f"  lane {i} first differs at token {j}: top-2 logit gap "
            f"{gap:.5f} (bound {NEAR_TIE_GAP})")
        if gap > NEAR_TIE_GAP:
            raise AssertionError(
                f"greedy lane {i} differs from its non-speculative stream "
                f"at token {j} where the top-2 gap {gap:.5f} is no near tie")
    return equal, ties


def serve_spec_path(torch, model, gen_seed: int, base: dict,
                    factors=None) -> dict:
    """Phases 4c and 4d: speculative decoding (``spec=True, spec_k=4``, the
    tied 4-layer draft) on phase 4's server and requests, or with
    ``factors`` on phase 4b's adapter server and traffic.  Phase 4c runs
    ``SPEC_OFF_LANES`` greedy with ``spec=False`` and ``SAMPLED_LANES`` at
    temperature 0.8; phase 4d runs every lane greedy.  Gates: every request
    finishes ``length``; spec blocks ran; ``fused_residual_prep`` launched
    once a spec block; the paged decode kernel once a layer of every
    decode-arm forward (8 a target forward, 4 a draft forward), and with
    adapters ``fused_rope_qkv`` and ``lora_delta`` once / three times a
    layer of every forward; greedy lanes hold their non-speculative stream
    ``base["streams"]`` (:func:`hold_greedy_streams`)."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.serve import InferenceServer, ServeConfig

    on = factors is not None
    rng = np.random.default_rng(gen_seed)
    warm_prompt = None if on else rng.integers(0, V, size=70)
    reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
             int(rng.integers(16, 65))) for _ in range(16)]
    names = ([ADAPTER_NAMES[i % len(ADAPTER_NAMES)] for i in range(16)]
             if on else [None] * 16)
    spec_on = [on or i not in SPEC_OFF_LANES for i in range(16)]
    temps = [0.8 if not on and i in SAMPLED_LANES else 0.0
             for i in range(16)]
    cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                      prefill_pad=P, decode_block=8, kv_block=BS,
                      fused_rope=on, adapters=on, lora_kernel=on, spec=True,
                      spec_k=SPEC_K)
    server = InferenceServer(model, cfg, device="cuda")
    eng = server.engine
    try:
        for name, f in (factors or {}).items():
            server.load_adapter(name, f)
        if not on:  # phase 4's schedule: warm up, then submit all
            server.start()
            warm = server.submit(warm_prompt, max_new=9)
            if not warm.wait(600) or warm.finish_reason != "length":
                raise AssertionError("warm-up request did not finish")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        before = dict(eng.decode_stats(), blocks_spec=eng.n_spec_blocks)
        t0 = time.perf_counter()
        handles = [server.submit(p, max_new=n, temperature=t, seed=i,
                                 spec=sp, adapter=a)
                   for i, ((p, n), t, sp, a) in enumerate(
                       zip(reqs, temps, spec_on, names))]
        if on:  # phase 4b's schedule: all queued, then start
            server.start()
        for h in handles:
            if not h.wait(900):
                raise AssertionError("request timed out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        decode_tc = ops.paged_attention.launches_tc
        rope_arms = {"split": ops.fused_rope_qkv.launches_split,
                     "wgmma": ops.fused_rope_qkv.launches_wgmma}
        stats = server.stats()
    finally:
        server.close(60)
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{n} tokens")
    if stats["kv"]["blocks_in_use"] != 0:
        raise AssertionError("KV pool did not drain")
    if decode_tc != counts["paged_attention"]:
        raise AssertionError(f"the split walk served {decode_tc} of the "
                             f"{counts['paged_attention']} decode launches")
    dec, spec = stats["decode"], stats["spec"]
    tf = dec["forwards"] - before["forwards"]
    df = dec["draft_forwards"] - before["draft_forwards"]
    t_dec = dec["steps"] - before["steps"]
    d_dec = dec["draft_decode_forwards"] - before["draft_decode_forwards"]
    blocks = eng.n_spec_blocks - before["blocks_spec"]
    d_layers = eng.draft_model.n_layers
    if not (blocks > 0 and spec["drafted"] > 0):
        raise AssertionError(f"no speculative block ran: {spec}")
    want = {"fused_residual_prep": blocks,
            "paged_attention": LAYERS * t_dec + d_layers * d_dec}
    if on:
        want["fused_rope_qkv"] = LAYERS * tf + d_layers * df
        want["lora_delta"] = 3 * (LAYERS * tf + d_layers * df)
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(
                f"{name} launched {counts[name]} times, want {n} ({blocks} "
                f"spec blocks, {tf} target / {df} draft forwards, {t_dec} / "
                f"{d_dec} of them on the decode arm)")
    # every decode, draft and verify forward on fused_rope_qkv's split arm,
    # every prefill chunk on its wgmma arm
    want_arms = ({"split": LAYERS * t_dec + d_layers * d_dec,
                  "wgmma": LAYERS * (tf - t_dec) + d_layers * (df - d_dec)}
                 if on else {"split": 0, "wgmma": 0})
    if rope_arms != want_arms:
        raise AssertionError(
            f"fused_rope_qkv's arms served {rope_arms} of "
            f"{counts['fused_rope_qkv']} launches (want {want_arms}: "
            f"{t_dec} / {d_dec} target / draft decode-arm forwards of {tf} "
            f"/ {df})")
    if not all(counts[name] > 0 for name in SERVE_KERNELS):
        raise AssertionError(f"a serving kernel was not launched: {counts}")
    streams = [h.tokens for h in handles]
    greedy = [i for i in range(16) if temps[i] == 0.0]
    equal, ties = hold_greedy_streams(
        torch, model, [p for p, _ in reqs], streams, base["streams"], greedy,
        factors, names)
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        requests=len(handles), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
        acceptance_rate=spec["acceptance_rate"],
        tokens_per_target_pass=spec["accepted_per_pass"],
        spec_blocks=blocks, target_forwards=tf, draft_forwards=df,
        greedy_lanes_equal=f"{equal}/{len(greedy)}", near_ties=ties,
        spec=spec, launches=counts, decode_tc_launches=decode_tc,
        rope_arm_launches=rope_arms, decode=dec,
        base={k: base[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                   "tpot_p50_ms")})


def adapter_factors(torch, model) -> dict:
    """The ``N_ADAPTERS`` seeded factor sets of phases 4b and 5b (CPU
    generators, so every run loads the same adapters)."""
    from tpudist_torch.models.lora import make_adapter_factors

    return {f"a{i}": make_adapter_factors(
        torch.Generator().manual_seed(100 + i), model, RANK)
        for i in range(N_ADAPTERS)}


def cpu_stream(torch, cpu_model, prompt, n: int, name=None, factors=None):
    """One request's greedy stream on the port's CPU f32 path (every
    kernel's plain version), through adapter ``name`` if given."""
    from tpudist_torch.serve import InferenceServer, ServeConfig

    on = name is not None
    cfg = ServeConfig(num_slots=1, queue_limit=4, max_new=64, prefill_pad=P,
                      decode_block=8, kv_block=BS, fused_rope=True,
                      adapters=on, lora_kernel=on)
    server = InferenceServer(cpu_model, cfg, device="cpu")
    try:
        if on:
            server.load_adapter(name, factors)
        h = server.submit(prompt, max_new=n, adapter=name)
        server.start()
        if not h.wait(900):
            raise AssertionError("CPU reference request timed out")
    finally:
        server.close(60)
    return h.tokens


def adapter_lane_ties(torch, model, cpu_model, prompt, n, name, factors,
                      stream):
    """Gate of phase 4b for an adapter lane whose card stream equals its
    base lane's: in f32 on the CPU the adapter stream must differ from the
    base stream, and where the card's one ``stream`` leaves either f32
    stream it must leave it first at a near tie of the card's logits (top-2
    gap within ``NEAR_TIE_GAP``, :func:`hold_greedy_streams`' standard).  On
    random weights a lane can settle into one repeated token, so an adapter
    may first move a greedy choice late, at a gap that bf16 rounding
    crosses.  Returns ``[(stream, position, gap)]``."""
    ref = {None: cpu_stream(torch, cpu_model, prompt, n),
           name: cpu_stream(torch, cpu_model, prompt, n, name, factors)}
    if ref[None] == ref[name]:
        raise AssertionError(f"adapter {name} leaves the stream unchanged "
                             f"on the CPU f32 path too")
    ties = []
    for key, f in ((None, None), (name, factors)):
        if stream == ref[key]:
            continue
        j, gap = near_tie_gap(torch, model, prompt, stream, ref[key], f)
        ties.append((key or "base", j, gap))
        if gap > NEAR_TIE_GAP:
            raise AssertionError(
                f"the card's stream leaves the f32 {key or 'base'} stream at "
                f"token {j} where the top-2 gap {gap:.5f} is no near tie")
    return ties


def serve_adapter_path(torch, model, gen_seed: int, cpu_model) -> dict:
    """Phase 4b: ``InferenceServer`` with ``fused_rope``, ``adapters`` and
    ``lora_kernel`` on, over phase 4's model and geometry; 16 greedy
    requests (prompts 1-300 tokens, 16-64 new tokens) naming
    ``ADAPTER_NAMES`` in turn.  The same requests then run on a server that
    differs only by ``adapters=False`` (each base lane must match it token
    for token, each adapter lane must differ, or be held by
    :func:`adapter_lane_ties` against the CPU f32 path of ``cpu_model``)
    and on phase 4's unfused arm (base-lane agreement reported only: bf16
    rounds in another order).  Every request is queued before its server
    starts, so the three servers run the same schedule."""
    import numpy as np

    from tpudist_torch import ops
    from tpudist_torch.ops import fused_rope_qkv, lora_delta
    from tpudist_torch.serve import InferenceServer, ServeConfig

    rng = np.random.default_rng(gen_seed)
    reqs = [(rng.integers(0, V, size=int(rng.integers(1, 301))),
             int(rng.integers(16, 65))) for _ in range(16)]
    names = [ADAPTER_NAMES[i % len(ADAPTER_NAMES)] for i in range(16)]
    factors = adapter_factors(torch, model)

    def run(fused: bool, adapters: bool):
        cfg = ServeConfig(num_slots=SLOTS, queue_limit=64, max_new=64,
                          prefill_pad=P, decode_block=8, kv_block=BS,
                          fused_rope=fused, adapters=adapters,
                          lora_kernel=adapters)
        server = InferenceServer(model, cfg, device="cuda")
        try:
            if adapters:
                for name, f in factors.items():
                    server.load_adapter(name, f)
            handles = [server.submit(p, max_new=n,
                                     adapter=a if adapters else None)
                       for (p, n), a in zip(reqs, names)]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            fw0 = server.engine.n_forwards
            st0 = server.engine.n_decode_steps
            t0 = time.perf_counter()
            server.start()
            for h in handles:
                if not h.wait(900):
                    raise AssertionError("request timed out")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            cluster = lora_delta.launches_cluster
            rope_arms = {"split": fused_rope_qkv.launches_split,
                         "wgmma": fused_rope_qkv.launches_wgmma}
            forwards = server.engine.n_forwards - fw0
            steps = server.engine.n_decode_steps - st0
            stats = server.stats()
        finally:
            server.close(60)
        for h, (_, n) in zip(handles, reqs):
            if h.finish_reason != "length" or len(h.tokens) != n:
                raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                     f"{len(h.tokens)}/{n} tokens")
        if stats["kv"]["blocks_in_use"] != 0:
            raise AssertionError("KV pool did not drain")
        tokens = sum(len(h.tokens) for h in handles)
        return dict(
            streams=[h.tokens for h in handles], requests=len(handles),
            tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
            ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
            tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
            forwards=forwards, decode_forwards=steps, launches=counts,
            lora_cluster_launches=cluster, rope_arm_launches=rope_arms,
            decode=stats["decode"], adapters=stats["adapters"])

    main = run(fused=True, adapters=True)
    L, fw, c = LAYERS, main["forwards"], main["launches"]
    if c["fused_rope_qkv"] != L * fw or c["lora_delta"] != 3 * L * fw:
        raise AssertionError(
            f"{fw} forwards of {L} layers launched fused_rope_qkv "
            f"{c['fused_rope_qkv']} and lora_delta {c['lora_delta']} times "
            f"(want {L * fw} and {3 * L * fw})")
    # every decode forward on the split arm, every prefill chunk on wgmma
    dec = main["decode_forwards"]
    want = {"split": L * dec, "wgmma": L * (fw - dec)}
    if main["rope_arm_launches"] != want or not 0 < dec < fw:
        raise AssertionError(
            f"fused_rope_qkv's arms served {main['rope_arm_launches']} of "
            f"{c['fused_rope_qkv']} launches over {dec} decode and "
            f"{fw - dec} prefill forwards (want {want})")
    if not all(c[name] > 0 for name in SERVE_KERNELS):
        raise AssertionError(f"a serving kernel was not launched: {c}")
    if not 0 < main["lora_cluster_launches"] < c["lora_delta"]:
        raise AssertionError(
            f"lora_delta's cluster arm served {main['lora_cluster_launches']}"
            f" of {c['lora_delta']} launches: decode must take it, the "
            f"prefill chunks the staged arm")
    base = run(fused=True, adapters=False)
    ties = {}
    for i, name in enumerate(names):
        same = main["streams"][i] == base["streams"][i]
        if name is None and not same:
            raise AssertionError(f"base lane {i} differs from the same "
                                 "request on the engine without adapters")
        if name is not None and same:
            ties[i] = adapter_lane_ties(
                torch, model, cpu_model, reqs[i][0], reqs[i][1], name,
                factors[name], main["streams"][i])
            log(f"  adapter lane {i} ({name}) equals its base stream on the "
                f"card; against the CPU f32 streams: {ties[i]} (bound "
                f"{NEAR_TIE_GAP})")
    unfused = run(fused=False, adapters=False)
    lanes = [i for i, n in enumerate(names) if n is None]
    agree = sum(main["streams"][i] == unfused["streams"][i] for i in lanes)
    first_diff = [next((t for t, (a, b) in enumerate(zip(
        main["streams"][i], unfused["streams"][i])) if a != b), None)
        for i in lanes]
    main.update(prompt_lens=[len(p) for p, _ in reqs], names=names,
                base_lanes_equal_no_adapter_engine=len(lanes),
                adapter_lanes_differ=len(names) - len(lanes) - len(ties),
                adapter_lanes_at_near_ties=ties,
                base_lanes_equal_unfused=f"{agree}/{len(lanes)}",
                first_divergence_vs_unfused=first_diff,
                no_adapter_run={k: base[k] for k in (
                    "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")},
                unfused_run={k: unfused[k] for k in (
                    "tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")})
    return main


def log_spec(what: str, r: dict, base: str, card: str) -> None:
    b = r["base"]
    log(f"{what}: {r['requests']} requests, {r['tokens']} tokens in "
        f"{r['wall_s']:.3f} s = {r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{r['ttft_p50_ms']:.2f} ms, TPOT p50 {r['tpot_p50_ms']:.3f} ms "
        f"({card}); {base} in this run {b['tokens_per_s']:.1f} tokens/s, "
        f"TTFT p50 {b['ttft_p50_ms']:.2f} ms, TPOT p50 "
        f"{b['tpot_p50_ms']:.3f} ms; acceptance {r['acceptance_rate']}, "
        f"{r['tokens_per_target_pass']} tokens per lane and target pass, "
        f"{r['spec_blocks']} spec blocks, {r['target_forwards']} target / "
        f"{r['draft_forwards']} draft forwards; greedy lanes equal to "
        f"{base}: {r['greedy_lanes_equal']}, near ties {r['near_ties']}; "
        f"launches {r['launches']}")


def device_profile(torch, fn, prep):
    """``fn`` timed plain (host clock to a synchronize, after ``prep``) and
    once under ``torch.profiler`` for the device's kernel time; the idle
    share is 1 - kernel time / profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prep()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device kernels only: a user annotation (torch.optim's
    # ``Optimizer.step#Adam.step``) spans kernels that are counted already
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    return dict(
        wall_ms=wall, profiled_wall_ms=prof_wall,
        device_busy_ms=busy if kern else None,
        idle_share=(1 - busy / prof_wall) if kern else None,
        device_events=len(kern),
        top=sorted(by_name.items(), key=lambda kv: -kv[1])[:6])


def log_profile(prof: dict) -> None:
    for name, r in prof.items():
        log(f"profile {name}: wall {r['wall_ms']:.3f} ms (profiled "
            f"{r['profiled_wall_ms']:.3f} ms), device busy "
            f"{r['device_busy_ms']} ms, idle share {r['idle_share']} "
            f"({r['device_events']} device events)")
        for kname, ms in r["top"]:
            log(f"  {ms:9.4f} ms  {kname[:110]}")


def profile_engine(torch, model, factors=None):
    """Where the time goes: one admission prefill (8 lanes x 60 tokens) and
    one K=8 decode block over 8 busy lanes (:func:`device_profile`).  With
    ``factors`` (name → factor set), the adapter path: ``fused_rope``,
    ``adapters`` and ``lora_kernel`` on, lanes naming ``ADAPTER_NAMES``."""
    import numpy as np

    from tpudist_torch.serve import SlotEngine

    on = factors is not None
    eng = SlotEngine(model, num_slots=SLOTS, prefill_pad=P, decode_block=8,
                     kv_block=BS, fused_rope=on, adapters=on,
                     lora_kernel=on, device="cuda")
    for name, f in (factors or {}).items():
        eng.load_adapter(name, f)
    rng = np.random.default_rng(3)

    def clear():
        for s in range(SLOTS):
            if eng.occupied[s]:
                eng.evict(s)

    def admit():
        eng.start_batch([(s, rng.integers(0, V, size=60), 0.0, 0, 200, (),
                          None, ADAPTER_NAMES[s % len(ADAPTER_NAMES)]
                          if on else None) for s in range(SLOTS)])

    admit()  # warm both programs
    eng.decode_block()
    out = {"prefill": device_profile(torch, admit, clear)}
    out["decode_block"] = device_profile(torch, eng.decode_block,
                                         lambda: None)
    clear()
    return out


def profile_spec_block(torch, model) -> dict:
    """Phase 5c: one speculative block (``draft_propose`` of the tied
    4-layer draft + ``spec_verify``, K = 4) over 8 busy lanes at ~60 tokens
    of context under ``torch.profiler`` (:func:`device_profile`), with the
    tokens it emitted."""
    import numpy as np

    from tpudist_torch.serve import SlotEngine

    eng = SlotEngine(model, num_slots=SLOTS, prefill_pad=P, decode_block=8,
                     kv_block=BS, spec_draft=LAYERS // 2, spec_k=SPEC_K,
                     device="cuda")
    rng = np.random.default_rng(3)
    eng.start_batch([(s, rng.integers(0, V, size=60), 0.0, 0, 200)
                     for s in range(SLOTS)])
    eng.spec_decode_block()  # warm
    emitted = []

    def block():
        info, _ = eng.spec_decode_block()
        emitted.append(info["tokens"])

    prof = device_profile(torch, block, lambda: None)
    prof.update(emitted_tokens=emitted[-1], wall_emitted_tokens=emitted[0],
                device_ms_per_token=(prof["device_busy_ms"] / emitted[-1]
                                     if prof["device_busy_ms"] else None),
                wall_ms_per_token=prof["wall_ms"] / emitted[0])
    for s in range(SLOTS):
        eng.evict(s)
    return prof


def prompt_logits(torch, model, prompt, factors=None):
    """All of ``prompt``'s logits through the paged prefill path (two
    chunks: the second walks the first one's committed blocks).  With
    ``factors``, one adapter lane through the fused RoPE+QKV arm."""
    from tpudist_torch.models import PagedKVConfig, lora, make_slot_decode

    dev = model.tok_embed.device
    ads, acfg = None, None
    if factors is not None:
        acfg = lora.AdapterPoolConfig(1, RANK)
        pool = lora.load_factors(lora.init_adapter_pool(model, acfg), 0,
                                 factors)
        ads = lora.pool_collection(pool, torch.zeros(1, dtype=torch.int32,
                                                     device=dev))
    nb = max(16, -(-len(prompt) // BS))
    fns = make_slot_decode(model, 1, P, PagedKVConfig(nb, BS, False),
                           fused_rope=factors is not None, adapters=acfg)
    pkv = fns.init_slots()
    rows = torch.full((1, M), nb, dtype=torch.int32, device=dev)
    rows[0, :nb] = torch.arange(nb, device=dev)
    out = []
    for start in range(0, len(prompt), P):
        chunk = prompt[start:start + P]
        toks = torch.zeros((1, P), dtype=torch.int32, device=dev)
        toks[0, :len(chunk)] = torch.as_tensor(chunk, device=dev)
        pkv, lg = fns.prefill_chunk(
            pkv, rows, torch.tensor([start], dtype=torch.int32, device=dev),
            torch.tensor([len(chunk)], dtype=torch.int32, device=dev), toks,
            torch.ones(1, dtype=torch.bool, device=dev), ads)
        out.append(lg[0, :len(chunk)].float().cpu())
    return torch.cat(out)


# ---------------------------------------------------------------------------
# phases 7-9: the training main path, its profile, gradients vs plain f32


def train_main_path(torch):
    """Phase 7: ``TRAIN_STEPS`` steps of ``tpudist_torch.train`` on the
    training geometry, every kernel count zeroed just before."""
    from tpudist_torch import ops
    from tpudist_torch.train.__main__ import build_training, get_args
    from tpudist_torch.utils.flops import (mfu, transformer_param_count,
                                           transformer_train_flops)

    args = get_args(TRAIN_ARGS + ["--total_iterations", str(TRAIN_STEPS)])
    model, step, next_batch = build_training(args)
    batches = [torch.from_numpy(next_batch()).cuda()
               for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times = [], []
    for tokens in batches:
        t0 = time.perf_counter()
        loss = step(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = ops.launch_counts()
    wgmma = {n: ops.KERNEL_WRAPPERS[n].launches_wgmma for n in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[TRAIN_WARMUP:])
    geom = dict(d_model=args.d_model, n_layers=args.n_layers,
                d_ff=args.d_ff, vocab=args.vocab)
    flops = transformer_train_flops(batch=args.batch_size,
                                    seq_len=args.seq_len, **geom)
    res = dict(
        steps=TRAIN_STEPS, first_loss=losses[0], last_loss=losses[-1],
        last5_mean=statistics.mean(losses[-5:]), losses=losses,
        step_ms_p50=step_s * 1e3, step_ms=[t * 1e3 for t in times],
        tokens_per_s=args.batch_size * args.seq_len / step_s,
        flops_per_step=flops,
        mfu=mfu(flops, step_s, 1, peak_per_chip=H100_BF16_FLOPS),
        params=transformer_param_count(max_len=args.seq_len, **geom),
        peak_mem_gb=peak / 1e9, launches=counts, launches_wgmma=wgmma)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if res["last5_mean"] > losses[0] - 0.1:
        raise AssertionError(
            f"loss did not fall 0.1 nat: first {losses[0]:.4f}, mean of the "
            f"last 5 {res['last5_mean']:.4f}")
    per_step = args.n_layers * TRAIN_STEPS
    for name in TRAIN_KERNELS:
        if counts[name] != per_step:
            raise AssertionError(f"{name} launched {counts[name]} times, not "
                                 f"{per_step} (8 layers x {TRAIN_STEPS})")
    for name, n in wgmma.items():
        if n != per_step:
            raise AssertionError(f"{name} ran {n} of its {per_step} launches "
                                 f"on the wgmma arm")
    return res, step, batches[0]


class PlainCausal:
    """The training attention arm without kernels, for the card's f32 plain
    path: dense causal softmax with K/V broadcast to every q head."""

    def positions(self, batch, seq, device):
        import torch

        return torch.arange(seq, device=device)[None].expand(batch, seq)

    def attend(self, layer, q, k, v):
        from tpudist_torch.models.transformer import attention_reference

        group = q.shape[1] // k.shape[1]
        if group > 1:
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        return attention_reference(q, k, v)


def grad_readings(torch, bf16_ctx=None) -> dict:
    """Loss and gradients at batch 2 of the training geometry, the bf16 path
    (the kernels, or ``bf16_ctx``'s attention) against the f32 plain path,
    same weights (seed 0): the loss's relative difference and the worst
    cosine over the parameters."""
    import numpy as np

    from tpudist_torch.models import create_transformer, lm_loss
    from tpudist_torch.train.__main__ import make_batch

    cfg = dict(vocab=256, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
               max_len=2048)
    tokens = torch.from_numpy(make_batch(np.random.default_rng(5), 2, 2048,
                                         256)).cuda()
    res = {}
    for label, dtype, ctx in (("bf16", torch.bfloat16, bf16_ctx),
                              ("f32_plain", torch.float32, PlainCausal())):
        model = create_transformer(0, device="cuda", dtype=dtype,
                                   param_dtype=torch.float32,
                                   trainable=True, **cfg)
        loss = lm_loss(model(tokens, ctx), tokens)
        loss.backward()
        res[label] = (loss.item(), {n: p.grad.detach().float()
                                    for n, p in model.named_parameters()})
        del model, loss
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = res["bf16"], res["f32_plain"]
    cos = {n: float(torch.nn.functional.cosine_similarity(
        gk[n].flatten(), gp[n].flatten(), dim=0)) for n in gp}
    worst = min(cos, key=cos.get)
    return dict(loss_bf16_kernels=lk, loss_f32_plain=lp,
                loss_rel_diff=abs(lk - lp) / abs(lp), min_cos=cos[worst],
                min_cos_param=worst, params=len(cos))


def grads_agree(out: dict) -> bool:
    return out["loss_rel_diff"] <= LOSS_REL_MAX and \
        out["min_cos"] >= GRAD_COS_MIN


def grad_check(torch):
    """Phase 9: :func:`grad_readings` of the kernels, held to
    ``GRAD_COS_MIN`` and ``LOSS_REL_MAX``."""
    out = grad_readings(torch)
    if not grads_agree(out):
        raise AssertionError(f"bf16 kernel gradients disagree with the f32 "
                             f"plain path: {out}")
    return out


# ---------------------------------------------------------------------------
# phases 10-11: the toy demo.py path and the toy benches


def demo_path(backend: str) -> dict:
    """Phase 10: ``python -m tpudist_torch.examples.demo`` as the reference
    runs it (``--dry_run``, ``DEMO_ARGS``), a subprocess under the torchrun
    contract at world size 1 (so the NCCL group, DDP and the device-group
    loss all-reduce run) in a temporary working directory.  It must exit 0
    and log one row an iteration; both models' losses must start near 3
    and end at most ``DEMO_LOSS_MAX`` (the last row, and the mean of the
    last 16)."""
    import tempfile

    from tpudist_torch.runtime.bootstrap import find_free_port

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo, RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(find_free_port()))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpudist_torch.examples.demo", *DEMO_ARGS,
             "--backend", backend], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the demo ({backend}) exited "
                                 f"{proc.returncode}: "
                                 f"{(proc.stdout + proc.stderr)[-3000:]}")
        path = os.path.join(tmp, "runs", "demo_dp", "metrics.jsonl")
        with open(path) as f:
            rows = [json.loads(line) for line in f]
    names = ("loss/model_X", "loss/model_Y")
    res = dict(backend=backend, wall_s=wall, rows=len(rows),
               first={k: rows[0][k] for k in names},
               last={k: rows[-1][k] for k in names},
               last16_mean={k: statistics.mean(r[k] for r in rows[-16:])
                            for k in names},
               banner=[line for line in proc.stdout.splitlines()
                       if "launch=" in line])
    if len(rows) != DEMO_ITERATIONS:
        raise AssertionError(f"the demo logged {len(rows)} rows, not "
                             f"{DEMO_ITERATIONS}")
    if "launch=torchrun" not in proc.stdout or \
            "backend=nccl" not in proc.stdout:
        raise AssertionError(f"the demo did not run on the NCCL group: "
                             f"{res['banner']}")
    for k in names:
        if not (res["first"][k] >= 2.0 and res["last"][k] <= DEMO_LOSS_MAX
                and res["last16_mean"][k] <= DEMO_LOSS_MAX):
            raise AssertionError(f"the demo ({backend}) did not converge: "
                                 f"{res}")
    return res


def bench_path(torch) -> dict:
    """Phase 11: ``tpudist_torch.bench``'s two benches on the card, every
    kernel count zeroed just before; the fused kernel must launch at least
    once a timed call.  Then one toy step window (256 iterations of the
    scanned step) under ``torch.profiler``."""
    from tpudist_torch import ops
    from tpudist_torch.bench import bench_fused_mlp, bench_toy, toy_setup

    ops.reset_launch_counts()
    toy = bench_toy("cuda")
    fused = bench_fused_mlp(4096, "cuda")
    counts = ops.launch_counts()
    if counts["fused_mlp"] < fused["kernel_calls"]:
        raise AssertionError(f"fused_mlp launched {counts['fused_mlp']} "
                             f"times for {fused['kernel_calls']} timed calls")
    states, chunk_step, x_all, y_all, idx = toy_setup(torch.device("cuda"))
    chunk_step(states, x_all, y_all, idx)  # warm-up
    prof = device_profile(
        torch, lambda: chunk_step(states, x_all, y_all, idx), lambda: None)
    return dict(toy=toy, fused_mlp=fused, launches=counts,
                toy_window_profile=prof)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full result as JSON to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from tpudist_torch import ops
        from tpudist_torch.models import TransformerLM, create_transformer
        from tpudist_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per kernel "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in _build.KERNELS:
        text = _build.library_path(name).with_suffix(".log").read_text() \
            if _build.library_path(name).with_suffix(".log").is_file() else ""
        entry = ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = " " + entry_name(m.group(1))
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {name}{entry}: {line.strip()}")

    rec = check_kernels(torch, dev)
    rec.update(check_residual(torch, dev))
    flash_rec, flash_fwd_bwd = check_flash(torch, dev)
    lin_rec, lin_info = check_fused_linear(torch, dev)
    mlp_rec, mlp_cases = check_fused_mlp(torch, dev)

    cpu_model = create_transformer(0, device="cpu", dtype=torch.float32,
                                   **MODEL)
    model = TransformerLM(dtype=torch.bfloat16, **MODEL)
    model.load_state_dict(cpu_model.state_dict())
    model = model.to(dev).requires_grad_(False)
    t0 = time.perf_counter()
    main_path = serve_main_path(torch, model, gen_seed=7)
    log(f"main path: {main_path['requests']} requests, "
        f"{main_path['tokens']} tokens in {main_path['wall_s']:.3f} s = "
        f"{main_path['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{main_path['ttft_p50_ms']:.2f} ms, TPOT p50 "
        f"{main_path['tpot_p50_ms']:.3f} ms ({card}); launches "
        f"{main_path['launches']}; prefill launches by arm "
        f"{main_path['prefill_arm_launches']}")
    spec_path = serve_spec_path(torch, model, 7, main_path)
    log_spec("spec path (tied 4-layer draft, K 4)", spec_path, "phase 4",
             card)

    t0 = time.perf_counter()
    ad_path = serve_adapter_path(torch, model, gen_seed=7,
                                 cpu_model=cpu_model)
    log(f"adapter path (fused_rope, 4 adapters, rank {RANK}): "
        f"{ad_path['requests']} requests, {ad_path['tokens']} tokens in "
        f"{ad_path['wall_s']:.3f} s = {ad_path['tokens_per_s']:.1f} "
        f"tokens/s, TTFT p50 {ad_path['ttft_p50_ms']:.2f} ms, TPOT p50 "
        f"{ad_path['tpot_p50_ms']:.3f} ms ({card}); {ad_path['forwards']} "
        f"forwards ({ad_path['decode_forwards']} decode), launches "
        f"{ad_path['launches']}, fused_rope_qkv by arm "
        f"{ad_path['rope_arm_launches']}; base lanes equal the "
        f"server without adapters "
        f"({ad_path['base_lanes_equal_no_adapter_engine']}), adapter lanes "
        f"differ ({ad_path['adapter_lanes_differ']}); base "
        f"lanes equal to the unfused arm: "
        f"{ad_path['base_lanes_equal_unfused']} (first divergence "
        f"{ad_path['first_divergence_vs_unfused']}); without adapters "
        f"{ad_path['no_adapter_run']}, unfused {ad_path['unfused_run']}")
    ad_streams = ad_path.pop("streams")
    spec_ad_path = serve_spec_path(torch, model, 7, dict(
        ad_path, streams=ad_streams), adapter_factors(torch, model))
    log_spec("spec adapter path (fused_rope, 4 adapters, tied 4-layer "
             "draft, K 4)", spec_ad_path, "phase 4b", card)

    prof = profile_engine(torch, model)
    prof.update({f"adapter {k}": v for k, v in profile_engine(
        torch, model, adapter_factors(torch, model)).items()})
    prof["spec_block"] = profile_spec_block(torch, model)
    log_profile(prof)
    sb, db = prof["spec_block"], prof["decode_block"]
    log(f"spec block: {sb['emitted_tokens']} tokens emitted, device "
        f"{sb['device_ms_per_token']} ms and wall "
        f"{sb['wall_ms_per_token']:.3f} ms per emitted token; phase 5's "
        f"decode block (64 tokens): device "
        f"{(db['device_busy_ms'] or 0) / 64:.4f} ms and wall "
        f"{db['wall_ms'] / 64:.3f} ms per token")

    import numpy as np

    prompt = np.random.default_rng(11).integers(0, V, size=100)
    ops.reset_launch_counts()
    gpu = prompt_logits(torch, model, prompt)
    with torch.no_grad():
        cpu = prompt_logits(torch, cpu_model, prompt)
    diff = (gpu - cpu).abs()
    rel_rms = float((gpu - cpu).norm() / cpu.norm())
    top1 = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    log(f"prompt logits, card bf16 vs CPU f32: max abs err "
        f"{float(diff.max()):.4f}, rel RMS {rel_rms:.5f}, top-1 agreement "
        f"{top1:.3f} (|logits| max {float(cpu.abs().max()):.3f})")
    # bf16 weights and activations through 8 layers: a few bf16 rounding
    # steps (2**-8 relative each) of a ~1-magnitude logit
    if not (rel_rms <= 0.05 and float(diff.max()) <= 0.25):
        raise AssertionError("card logits disagree with the CPU plain path")
    factors = adapter_factors(torch, cpu_model)["a0"]
    gpu_ad = prompt_logits(torch, model, prompt, factors)
    with torch.no_grad():
        cpu_ad = prompt_logits(torch, cpu_model, prompt, factors)
    ad_diff = (gpu_ad - cpu_ad).abs()
    ad_rel_rms = float((gpu_ad - cpu_ad).norm() / cpu_ad.norm())
    ad_top1 = float((gpu_ad.argmax(-1) == cpu_ad.argmax(-1)).float().mean())
    ad_moved = float((cpu_ad - cpu).norm() / cpu.norm())
    log(f"adapter lane prompt logits (fused RoPE+QKV, LoRA kernel), card "
        f"bf16 vs CPU f32: max abs err {float(ad_diff.max()):.4f}, rel RMS "
        f"{ad_rel_rms:.5f}, top-1 agreement {ad_top1:.3f}; the adapter moves "
        f"the CPU logits by {ad_moved:.4f} rel RMS")
    if not (ad_rel_rms <= 0.05 and float(ad_diff.max()) <= 0.25):
        raise AssertionError("adapter-lane card logits disagree with the "
                             "CPU plain path")
    del model, cpu_model

    train, step, tokens = train_main_path(torch)
    log(f"training main path: {train['steps']} steps, loss "
        f"{train['first_loss']:.4f} -> {train['last_loss']:.4f} (mean of the "
        f"last 5 {train['last5_mean']:.4f}); step p50 "
        f"{train['step_ms_p50']:.2f} ms = {train['tokens_per_s']:.0f} "
        f"tokens/s, MFU {train['mfu']:.4f} of 989 TFLOP/s "
        f"({train['flops_per_step'] / 1e12:.2f} TFLOP/step), peak memory "
        f"{train['peak_mem_gb']:.2f} GB ({card}); launches "
        f"{train['launches']}, on the wgmma arms "
        f"{train['launches_wgmma']}")
    train_prof = {"train_step": device_profile(torch, lambda: step(tokens),
                                               lambda: None)}
    log_profile(train_prof)
    del step
    torch.cuda.empty_cache()
    grads = grad_check(torch)
    log(f"gradients, batch 2, bf16 kernels vs f32 plain on the card: loss "
        f"{grads['loss_bf16_kernels']:.5f} vs {grads['loss_f32_plain']:.5f} "
        f"(rel {grads['loss_rel_diff']:.2e} <= {LOSS_REL_MAX}), min cosine "
        f"{grads['min_cos']:.5f} ({grads['min_cos_param']}, >= "
        f"{GRAD_COS_MIN}) over {grads['params']} parameters")

    demos = [demo_path(backend) for backend in ("ici", "host")]
    for d in demos:
        log(f"toy demo (--backend {d['backend']}, world 1 under the torchrun "
            f"contract, NCCL): {d['rows']} rows in {d['wall_s']:.1f} s of "
            f"process wall; losses {d['first']} -> {d['last']}, mean of "
            f"the last 16 {d['last16_mean']}")
    benches = bench_path(torch)
    toy, fused = benches["toy"], benches["fused_mlp"]
    log(f"bench_toy: {toy['value']:.1f} samples/s/card ({card}); "
        f"bench_fused_mlp (batch 4096): kernel {fused['kernel_fused']:.1f}, "
        f"plain chain {fused['plain_chain']:.1f} samples/s, ratio "
        f"{fused['kernel_over_plain']:.3f}; vs f64 "
        f"{fused['max_rel_err_vs_f64']:.2e} and "
        f"{fused['plain_rel_err_vs_f64']:.2e}; launches "
        f"{benches['launches']['fused_mlp']} for {fused['kernel_calls']} "
        f"timed calls")
    log_profile({"toy_window": benches["toy_window_profile"]})

    kernels = []
    launches = dict(main_path["launches"])
    launches.update({n: train["launches"][n] for n in flash_rec})
    launches.update({n: ad_path["launches"][n] for n in lin_rec})
    launches["fused_residual_prep"] = spec_path["launches"][
        "fused_residual_prep"]
    launches["fused_mlp"] = benches["launches"]["fused_mlp"]
    # the kernels with several arms: each arm's time on the same inputs
    # (the mean of its turns) and its launches on the main path
    mean = statistics.mean
    arms = {
        "paged_attention": (
            {a: mean(t) for a, t in rec["paged_attention"]["arm_ms"].items()},
            {"tc": main_path["decode_tc_launches"],
             "cc": launches["paged_attention"]
             - main_path["decode_tc_launches"]}),
        "paged_prefill": (
            {a: rec["paged_prefill"]["arms"][a]["ms"] for a in ("tc", "cc")},
            main_path["prefill_arm_launches"]),
        "lora_delta": (
            {a: mean(t) for a, t in lin_rec["lora_delta"]["arm_ms"].items()},
            {"cluster": ad_path["lora_cluster_launches"],
             "staged": launches["lora_delta"]
             - ad_path["lora_cluster_launches"]}),
        # split and mma at decode, wgmma at prefill
        "fused_rope_qkv": (
            {a: mean(t)
             for a, t in lin_rec["fused_rope_qkv"]["arm_ms"].items()},
            dict(ad_path["rope_arm_launches"],
                 mma=launches["fused_rope_qkv"]
                 - sum(ad_path["rope_arm_launches"].values())))}
    for name in TRAIN_KERNELS:
        wg = train["launches_wgmma"][name]
        arms[name] = ({"wgmma": mean(flash_rec[name]["arm_ms"]),
                       "mma": mean(flash_rec[name]["replaced_ms"])},
                      {"wgmma": wg, "mma": launches[name] - wg})
    for name, r in (list(rec.items()) + list(flash_rec.items())
                    + list(lin_rec.items()) + list(mlp_rec.items())):
        kernels.append(dict(
            name=name, route=r["route"], source=r["source"],
            replaces=r["replaces"],
            launches=int(launches[name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
        if name in arms:
            kernels[-1]["arms"] = {
                a: dict(ms=ms, launches=int(arms[name][1][a]))
                for a, ms in arms[name][0].items()}
    result = dict(card=card, kernels=kernels, main_path=main_path,
                  adapter_path=dict(ad_path, streams=ad_streams),
                  spec_path=spec_path, spec_adapter_path=spec_ad_path,
                  verify_kernel=rec["paged_attention"]["verify"],
                  fused_linear=lin_info,
                  profile=prof, flash_fwd_bwd=flash_fwd_bwd, train=train,
                  train_profile=train_prof, grads=grads,
                  logits=dict(max_abs_err=float(diff.max()),
                              rel_rms=rel_rms, top1=top1),
                  adapter_logits=dict(max_abs_err=float(ad_diff.max()),
                                      rel_rms=ad_rel_rms, top1=ad_top1,
                                      adapter_moves=ad_moved),
                  fused_mlp_cases=mlp_cases, demos=demos, benches=benches)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
