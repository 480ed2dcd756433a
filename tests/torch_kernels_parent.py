#!/usr/bin/env python3
"""Phases 3c and 3e of ``chip_smoke.py`` and phase 11's ``bench_fused_mlp``
in two trees on one NVIDIA card.

Run from the repository root on the GPU machine::

    python3 tests/torch_kernels_parent.py --parent DIR [--out FILE]

``DIR`` holds another checkout of the repository, for example an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists.  In the order parent, this tree, this tree, parent, a child process
in each tree builds that tree's ``lora_delta``, ``fused_rope_qkv`` and
``fused_mlp`` kernels and runs:

- its own ``chip_smoke.check_fused_linear`` (phase 3c) and
  ``chip_smoke.check_fused_mlp`` (phase 3e): every kernel against its plain
  version, then that tree's timings;
- the same timing table in every tree, from this script (``LORA_SHAPES``,
  ``MLP_SHAPES``): the tree's ``lora_delta`` and ``fused_mlp`` wrappers at
  the main path's shapes (the speculative verify's T 5 included, which an
  older phase 3c may not time), each with ``chip_smoke.time_ms`` (CUDA
  events, median of 30, L2 flushed before each launch);
- ``tpudist_torch.bench.bench_fused_mlp(4096)`` (phase 11's forward bench:
  samples/s of the kernel and of the plain chain, host-paced).

Each child prints one JSON line with the card's ``nvidia-smi`` name and
power limit.  Exits non-zero if a child fails.  Not collected by pytest:
it needs the card and a few minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (label, T, d_in, d_out): 8 slots at rank 8 over an 8-block pool, as phase
# 3c builds them
LORA_SHAPES = (("qkv decode", 1, 1024, 3072), ("wi decode", 1, 1024, 4096),
               ("wo decode", 1, 4096, 1024), ("wi verify", 5, 1024, 4096),
               ("wi prefill", 64, 1024, 4096))
# (label, weights, batch), as phase 3e builds them
MLP_SHAPES = (("toy b256", "toy", 256), ("toy b1000", "toy", 1000),
              ("toy b4096", "toy", 4096), ("toy b1048576", "toy", 1 << 20),
              ("wide 128x5 b4096", "wide", 4096))


def measure() -> dict:
    """The phases and the common timings of the tree in the current
    directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from tpudist_torch.bench import bench_fused_mlp
    from tpudist_torch.ops import _build
    from tpudist_torch.ops.fused_linear import lora_delta
    from tpudist_torch.ops.fused_mlp import fused_mlp, pack_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["lora_delta", "fused_rope_qkv", "fused_mlp"])
    dev = torch.device("cuda")
    lin_rec, lin_info = cs.check_fused_linear(torch, dev)
    mlp_rec, mlp_cases = cs.check_fused_mlp(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(5678)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    common = {}
    for label, T, d_in, d_out in LORA_SHAPES:
        args = cs.lora_inputs(torch, dev, gen, cs.SLOTS, T, d_in, d_out,
                              torch.bfloat16, cs.RANK, cs.LORA_IDS)
        common[f"lora_delta {label}"] = cs.time_ms(
            torch, lambda: lora_delta(*args, layer=3), flush)
    with torch.no_grad():
        for label, kind, batch in MLP_SHAPES:
            weights, x = cs.mlp_inputs(torch, kind, batch, dev)
            packed = pack_params(weights)
            common[f"fused_mlp {label}"] = cs.time_ms(
                torch, lambda: fused_mlp(x, packed), flush)
    del flush
    bench = bench_fused_mlp(4096, "cuda")
    return dict(tree=os.getcwd(), card=cs.card_line(), common_ms=common,
                phase_3c=dict(kernels=lin_rec, timings=lin_info["timings"]),
                phase_3e=dict(kernels=mlp_rec, cases=mlp_cases),
                bench_fused_mlp=bench)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--out", default=None, help="write every line here too")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure()))
        return 0
    if not args.parent:
        ap.error("--parent is required")
    parent = Path(args.parent).resolve()
    lines = []
    for label, tree in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure"],
            cwd=tree, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=str(tree)))
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(run.stdout.strip().splitlines()[-1])
        res["label"] = label
        lines.append(res)
        print(json.dumps(dict(label=label, card=res["card"],
                              common_ms=res["common_ms"],
                              bench_fused_mlp=res["bench_fused_mlp"])),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
