#!/usr/bin/env python3
"""The ring's kernel bodies of two trees, in turns, in one process on one
NVIDIA card.

Run from the repository root on the GPU machine::

    python3 tests/torch_ring_parent.py --parent DIR [--rounds R] [--out FILE]

``DIR`` holds another checkout of the repository, for example an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists.  Its ``tpudist_torch/parallel/ring_attention.py`` is loaded beside
this tree's under another module name; both run on this tree's flash
kernels.  At phase 17's shapes (b 2, h 8, s 8192, dh 128, bf16, a
``LocalRing`` of 4 shards of 2048) each tree's causal ring and zigzag ring
run forward and backward on the same inputs, their outputs and q/k/v
gradients compared (max abs difference; autograd may sum a gradient's
parts in another order), then each is timed ``R`` rounds in the
order parent, this tree, this tree, parent: ``chip_smoke.time_ms`` (CUDA
events, median of 10) and the host's clock around one call and a
synchronize (median of 10); then one call of each under
``torch.profiler`` (``chip_smoke.device_profile``: device busy ms, idle
share, kernel count, the top kernels).  Prints one JSON line: per body and
tree the rounds' medians and every round's numbers, the profile, and the
two trees' largest differences.  Not collected by pytest: it needs the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_ring_module(tree: Path):
    """``tree``'s ``ring_attention.py`` as a module of its own (its imports
    resolve to this tree's package, so both run the same kernels)."""
    path = tree / "tpudist_torch" / "parallel" / "ring_attention.py"
    spec = importlib.util.spec_from_file_location("parent_ring_attention",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(parent: Path, rounds: int) -> dict:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from tpudist_torch.ops import _build
    from tpudist_torch.parallel import (LocalRing, ring_attention,
                                        zigzag_indices)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["flash_attention", "flash_backward"])
    trees = {"parent": load_ring_module(parent), "change": ring_attention}
    b, h, s, n = cs.RING_B, cs.RING_H, cs.RING_S, cs.RING_SHARDS
    gen = torch.Generator(device="cuda").manual_seed(1717)
    q, k, v, g = (torch.randn(b, h, s, cs.DH, generator=gen, device="cuda")
                  .bfloat16() for _ in range(4))
    pi = torch.as_tensor(zigzag_indices(s, n), device="cuda").long()
    zq, zk, zv, zg = (t[:, :, pi].contiguous() for t in (q, k, v, g))
    ring = LocalRing(n)
    bodies = {
        "causal": (lambda m: lambda *a: m.ring_attention_shard_flash(
            *a, ring, causal=True), (q, k, v), g),
        "zigzag": (lambda m: lambda *a: m.ring_attention_shard_zigzag_flash(
            *a, ring), (zq, zk, zv), zg)}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = dict(card=cs.card_line(), parent=str(parent), rounds=rounds,
               bodies={})
    for body, (make, ins, cot) in bodies.items():
        leaves = [t.detach().requires_grad_(True) for t in ins]

        def call(m, make=make, leaves=leaves, cot=cot):
            return lambda: torch.autograd.grad(make(m)(*leaves), leaves, cot)

        outs = {t: [make(m)(*leaves).detach()]
                + list(call(m)()) for t, m in trees.items()}
        diff = {name: float((a.float() - c.float()).abs().max())
                for name, a, c in zip(("out", "dq", "dk", "dv"),
                                      outs["parent"], outs["change"])}
        del outs
        runs = {t: dict(event_ms=[], host_ms=[]) for t in trees}
        for _ in range(rounds):
            for t in ("parent", "change", "change", "parent"):
                fn = call(trees[t])
                runs[t]["event_ms"].append(cs.time_ms(torch, fn, flush,
                                                      n=10, warmup=2))
                host = []
                for _ in range(10):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t0) * 1e3)
                runs[t]["host_ms"].append(statistics.median(host))
        res["bodies"][body] = dict(max_abs_diff=diff, trees={
            t: dict(event_ms_median=statistics.median(r["event_ms"]),
                    host_ms_median=statistics.median(r["host_ms"]),
                    profile=cs.device_profile(torch, call(trees[t]),
                                              lambda: None), **r)
            for t, r in runs.items()})
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None, help="write the line here too")
    args = ap.parse_args(argv)
    res = measure(Path(args.parent).resolve(), args.rounds)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
