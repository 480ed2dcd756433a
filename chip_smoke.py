#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``tpudist_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in
order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the serving path from ``tpudist_torch/csrc``
   (one ``nvcc`` per source, all at once);
3. each kernel against its plain PyTorch version at the serving slice's
   shapes (8 slots, dh 128, KV block 16, 128 blocks per lane, window 8,
   chunk 64, vocab 256): bf16 and int8 pools, ragged cursors with partial
   blocks, sentinel table tails, ragged chunk lengths, a sliding window;
   written int8 blocks must be byte-identical.  Each kernel is timed with
   CUDA events (median of 30 after warm-up, L2 flushed between launches)
   beside its plain version, its bound and, where one PyTorch call computes
   the same function, that call;
4. the main path: ``InferenceServer`` on the d1024 / 8-layer / 8-head /
   ff4096 / vocab-256 / max_len-2048 RoPE TransformerLM in bf16 (random
   weights from a seed), 16 greedy requests with prompts of 1-300 tokens
   (chunked prefill) and 16-64 new tokens; every request must finish
   "length" and every kernel's launch count (zeroed just before) must grow;
5. where the time goes: one admission prefill and one decode block of the
   same model under ``torch.profiler`` (device busy time, idle share, the
   heaviest kernels);
6. one prompt's logits through the paged prefill path on the card (bf16,
   kernels) against the port's CPU plain path (f32, same weights).

It prints the kernels' JSON record and the ``nvidia-smi`` line before the
last line, which is the contract line ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without CUDA or outside the repository.
"""

from __future__ import annotations

import argparse
import json
import os
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, n: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events), the
    L2 cache flushed before each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def decode_inputs(torch, dev, gen, pos0, quant, fill, window_cols=W):
    S, n_kv = SLOTS, HEADS
    nb = 1024
    q = torch.randn(S, HEADS, 1, DH, generator=gen, device=dev).bfloat16()
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


def prefill_inputs(torch, dev, gen, pos0, clen, quant):
    from tpudist_torch.models.paged import PagedKVConfig, _Paged

    base = decode_inputs(torch, dev, gen, [p + P for p in pos0], quant,
                         [0] * SLOTS)
    q = torch.randn(SLOTS, HEADS, P, DH, generator=gen, device=dev).bfloat16()
    kn = torch.randn(SLOTS, HEADS, P, DH, generator=gen,
                     device=dev).bfloat16()
    vn = torch.randn(SLOTS, HEADS, P, DH, generator=gen,
                     device=dev).bfloat16()
    pos0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    clen = torch.tensor(clen, dtype=torch.int32, device=dev)

    class _Geom:  # the pool geometry _Paged reads off a model
        n_layers, n_kv, head_dim, max_len = LAYERS, HEADS, DH, M * BS
        dtype = torch.bfloat16

    pg = _Paged(_Geom, SLOTS, PagedKVConfig(1024, BS, quant), dev)
    wtable = pg.write_tables(base[5], pos0, clen, P,
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


def check_kernels(torch, dev):
    from tpudist_torch import ops
    from tpudist_torch.ops.fused_sample import (fused_sample_prep,
                                                fused_sample_reference)
    from tpudist_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)
    from tpudist_torch.ops.paged_prefill import (paged_prefill_attention,
                                                 paged_prefill_reference)

    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rec = {}

    # -- row 1: paged decode attention
    err = 0.0
    cases = [  # pos0 ragged: empty lane, partial blocks, near max_len
        dict(pos0=[0, 1, 17, 100, 255, 364, 1000, 2040], quant=False,
             fill=[0, 3, 7, 1, 0, 5, 2, 0], window=None),
        dict(pos0=[0, 1, 17, 100, 255, 364, 1000, 2040], quant=True,
             fill=[1, 0, 2, 7, 4, 0, 6, 3], window=None),
        dict(pos0=[5, 33, 80, 160, 200, 640, 999, 1500], quant=False,
             fill=[0, 1, 2, 3, 4, 5, 6, 7], window=100),
    ]
    for c in cases:
        args = decode_inputs(torch, dev, gen, c["pos0"], c["quant"],
                             c["fill"])
        for layer in (0, LAYERS - 1):
            out = paged_attention(*args, layer=layer, window=c["window"])
            ref = paged_attention_reference(*args, layer=layer,
                                            window=c["window"])
            torch.cuda.synchronize()
            err = max(err, close_bf16(torch, out, ref,
                                      v_max(args[2], args[4], args[9])))
    # timing at main-path cursors (prompts of 1-300 plus 16-64 new tokens)
    pos0 = [37, 364, 120, 250, 5, 300, 180, 64]
    fill = [3] * SLOTS
    args = decode_inputs(torch, dev, gen, pos0, False, fill)
    live = sum(-(-p // BS) for p in pos0)
    nbytes = (2 * args[0].numel() * 2  # q in, out
              + 2 * live * HEADS * BS * DH * 2  # live K/V blocks
              + live * 4 + SLOTS * 8  # table entries, pos0, fill
              + 2 * args[8].numel() * 2)  # window K/V
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
        bound=bound(nbytes, flops, H100_BF16_FLOPS))

    # -- row 2: paged prefill attention + block writes
    err = 0.0
    cases = [
        dict(pos0=[0, 5, 64, 100, 300, 17, 1000, 0],
             clen=[64, 1, 30, 64, 0, 50, 64, 10], quant=True),
        dict(pos0=[0, 5, 64, 100, 300, 17, 1000, 0],
             clen=[64, 1, 30, 64, 0, 50, 64, 10], quant=False),
    ]
    for c in cases:
        args = prefill_inputs(torch, dev, gen, c["pos0"], c["clen"],
                              c["quant"])
        vmax = v_max(args[4], args[6], args[2])
        for layer in (0, LAYERS - 1):
            out = paged_prefill_attention(*args, layer=layer)
            ref = paged_prefill_reference(*args, layer=layer)
            torch.cuda.synchronize()
            err = max(err, close_bf16(torch, out[0], ref[0], vmax))
            for a, b in zip(out[1:], ref[1:]):
                if not torch.equal(a, b):
                    raise AssertionError(
                        "prefill kernel's written blocks/scales differ from "
                        "the plain version's")
        out = paged_prefill_attention(*args, layer=1, window=40)
        ref = paged_prefill_reference(*args, layer=1, window=40)
        torch.cuda.synchronize()
        err = max(err, close_bf16(torch, out[0], ref[0], vmax))
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
    rec["paged_prefill"] = dict(
        route="cuda", source="tpudist_torch/csrc/paged_prefill.cu",
        replaces="tpudist/ops/paged_prefill.py:189", max_abs_err=err,
        ms=time_ms(torch, lambda: paged_prefill_attention(*args, layer=3),
                   flush),
        plain_ms=time_ms(torch, lambda: paged_prefill_reference(
            *args, layer=3), flush),
        library_ms=time_ms(torch, dense_sdpa(
            torch, args[0], *args[3:8], keep[:, None], args[1], args[2], 3),
            flush),
        bound=bound(nbytes, flops, H100_BF16_FLOPS))

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
    del flush
    ops.reset_launch_counts()
    return rec


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
        stats = server.stats()
    finally:
        server.close(60)
    for h, (_, n) in zip(handles, reqs):
        if h.finish_reason != "length" or len(h.tokens) != n:
            raise AssertionError(f"request {h.id}: {h.finish_reason}, "
                                 f"{len(h.tokens)}/{n} tokens")
    if stats["kv"]["blocks_in_use"] != 0:
        raise AssertionError("KV pool did not drain")
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{counts}")
    tokens = sum(len(h.tokens) for h in handles)
    return dict(
        requests=len(handles), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall,
        ttft_p50_ms=1e3 * statistics.median(h.ttft_s for h in handles),
        tpot_p50_ms=1e3 * statistics.median(h.tpot_s for h in handles),
        prompt_lens=[len(p) for p, _ in reqs],
        decode=stats["decode"], launches=counts)


def profile_engine(torch, model):
    """Where the time goes: one admission prefill (8 lanes x 60 tokens) and
    one K=8 decode block over 8 busy lanes, each timed plain (host clock to
    a synchronize) and once under ``torch.profiler`` for the device's kernel
    time; the idle share is 1 - kernel time / profiled wall time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.serve import SlotEngine

    eng = SlotEngine(model, num_slots=SLOTS, prefill_pad=P, decode_block=8,
                     kv_block=BS, device="cuda")
    rng = np.random.default_rng(3)

    def clear():
        for s in range(SLOTS):
            if eng.occupied[s]:
                eng.evict(s)

    def admit():
        eng.start_batch([(s, rng.integers(0, V, size=60), 0.0, 0, 200)
                         for s in range(SLOTS)])

    def measure(fn, prep):
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
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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

    admit()  # warm both programs
    eng.decode_block()
    out = {"prefill": measure(admit, clear)}
    out["decode_block"] = measure(eng.decode_block, lambda: None)
    clear()
    return out


def prompt_logits(torch, model, prompt):
    """All of ``prompt``'s logits through the paged prefill path (two
    chunks: the second walks the first one's committed blocks)."""
    from tpudist_torch.models import PagedKVConfig, make_slot_decode

    dev = model.tok_embed.device
    fns = make_slot_decode(model, 1, P, PagedKVConfig(16, BS, False))
    pkv = fns.init_slots()
    rows = torch.full((1, M), 16, dtype=torch.int32, device=dev)
    rows[0, :16] = torch.arange(16, device=dev)
    out = []
    for start in range(0, len(prompt), P):
        chunk = prompt[start:start + P]
        toks = torch.zeros((1, P), dtype=torch.int32, device=dev)
        toks[0, :len(chunk)] = torch.as_tensor(chunk, device=dev)
        pkv, lg = fns.prefill_chunk(
            pkv, rows, torch.tensor([start], dtype=torch.int32, device=dev),
            torch.tensor([len(chunk)], dtype=torch.int32, device=dev), toks,
            torch.ones(1, dtype=torch.bool, device=dev))
        out.append(lg[0, :len(chunk)].float().cpu())
    return torch.cat(out)


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
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    rec = check_kernels(torch, dev)

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
        f"{main_path['launches']}")

    prof = profile_engine(torch, model)
    for name, r in prof.items():
        log(f"profile {name}: wall {r['wall_ms']:.3f} ms (profiled "
            f"{r['profiled_wall_ms']:.3f} ms), device busy "
            f"{r['device_busy_ms']} ms, idle share {r['idle_share']} "
            f"({r['device_events']} device events)")
        for kname, ms in r["top"]:
            log(f"  {ms:9.4f} ms  {kname[:110]}")

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

    kernels = []
    for name, r in rec.items():
        kernels.append(dict(
            name=name, route=r["route"], source=r["source"],
            replaces=r["replaces"],
            launches=int(main_path["launches"][name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
    result = dict(card=card, kernels=kernels, main_path=main_path,
                  profile=prof,
                  logits=dict(max_abs_err=float(diff.max()),
                              rel_rms=rel_rms, top1=top1))
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
