#!/usr/bin/env python3
"""How the LM entry point's feed moves its step on one card: the d1024
step of ``chip_smoke.py`` phase 15 (bf16, batch 8 x 2048, remat ``dots``
and then no remat) on the same corpus, fed three ways in turns:

- ``sync``: the synchronous corpus iterator and one host-to-device copy a
  step (``--num_workers 0``, no prefetch);
- ``pool``: the native gather pool (``PrefetchingTokenBatches``) and one
  copy a step;
- ``prefetch``: the pool behind ``prefetch_to_device`` (the entry point's
  own feed).

Each feed runs ``STEPS`` steps a turn, three turns, the order rotating
from turn to turn.  A turn is timed on the host clock between step
launches (the CPU runs ahead of the card) and once in total, ending in a
synchronize; it also reads the caching allocator's segment count and the
prefetch's queue waits (``PrefetchStats``).  Prints one JSON object and the
card's ``nvidia-smi`` line.  Imports no JAX.

  python3 tests/torch_lm_feed.py --out FILE
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STEPS = 20
TURNS = 3
FEEDS = ("sync", "pool", "prefetch")
CONFIGS = {"remat_dots": ["--remat", "--remat_policy", "dots"],
           "no_remat": []}


def run_turn(torch, step, next_batch, stats=None) -> dict:
    """``STEPS`` steps on ``next_batch()``: per-step host ms between
    launches, the total ms ending in a synchronize, new allocator
    segments and the prefetch's consumer wait."""
    seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    wait0 = stats.consumer_wait_s if stats is not None else 0.0
    torch.cuda.synchronize()
    t0 = last = time.perf_counter()
    gaps = []
    for _ in range(STEPS):
        step(next_batch())
        now = time.perf_counter()
        gaps.append((now - last) * 1e3)
        last = now
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    return dict(step_ms=total / STEPS, launch_gaps_ms=gaps,
                gap_p50_ms=statistics.median(gaps), gap_max_ms=max(gaps),
                new_segments=torch.cuda.memory_stats().get(
                    "segment.all.allocated", 0) - seg0,
                consumer_wait_ms=((stats.consumer_wait_s - wait0) * 1e3
                                  if stats is not None else None))


def measure(torch, corpus: str, extra) -> dict:
    import chip_smoke as cs
    from tpudist_torch.data import PrefetchStats, prefetch_to_device
    from tpudist_torch.examples.demo_long_context import open_corpus

    args = cs.lm_args(corpus, *extra, "--num_workers", "2")
    model, step = cs.lm_training(torch, args)
    _, sync_stream, _ = open_corpus(cs.lm_args(corpus, *extra))
    _, pool_stream, _ = open_corpus(args)
    _, pf_stream, _ = open_corpus(args)
    stats = PrefetchStats()
    pf = prefetch_to_device(pf_stream, "cuda", stats=stats)
    nexts = {
        "sync": lambda: torch.from_numpy(next(sync_stream)).cuda(),
        "pool": lambda: torch.from_numpy(next(pool_stream)).cuda(),
        "prefetch": lambda: next(pf)}
    for feed in FEEDS:  # warm-up: 3 steps each
        for _ in range(3):
            step(nexts[feed]())
    out = {feed: [] for feed in FEEDS}
    for turn in range(TURNS):
        order = FEEDS[turn % 3:] + FEEDS[:turn % 3]
        for feed in order:
            out[feed].append(run_turn(torch, step, nexts[feed],
                                      stats if feed == "prefetch" else None))
    pf.close()
    pool_stream.close()
    pf_stream.close()
    del model, step
    torch.cuda.empty_cache()
    return {feed: dict(turns=rows,
                       step_ms=[r["step_ms"] for r in rows],
                       gap_p50_ms=[r["gap_p50_ms"] for r in rows],
                       gap_max_ms=[r["gap_max_ms"] for r in rows],
                       new_segments=[r["new_segments"] for r in rows],
                       consumer_wait_ms=[r["consumer_wait_ms"]
                                         for r in rows])
            for feed, rows in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full result as JSON to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_lm_feed: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpudist_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention", "flash_backward"])
    card = cs.card_line()
    res = dict(card=card, steps=STEPS, turns=TURNS)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = cs.write_chain_corpus(os.path.join(tmp, "chains.npy"))
        for name, extra in CONFIGS.items():
            res[name] = measure(torch, corpus, extra)
            for feed in FEEDS:
                r = res[name][feed]
                cs.log(f"{name} {feed}: step ms {r['step_ms']}, launch gap "
                       f"p50 {r['gap_p50_ms']} max {r['gap_max_ms']}, new "
                       f"segments {r['new_segments']}, consumer wait ms "
                       f"{r['consumer_wait_ms']} ({card})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    print(json.dumps({k: v for k, v in res.items()
                      if k in ("card", "steps", "turns")}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
