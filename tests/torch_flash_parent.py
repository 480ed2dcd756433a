#!/usr/bin/env python3
"""Phases 3b and 7 of ``chip_smoke.py`` in two trees on one NVIDIA card.

Run from the repository root on the GPU machine::

    python3 tests/torch_flash_parent.py --parent DIR [--out FILE]

``DIR`` holds another checkout of the repository, for example an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists.  In the order parent, this tree, this tree, parent, a child process
in each tree builds that tree's flash kernels and runs its own
``chip_smoke.check_flash`` (phase 3b: the flash kernels against their plain
versions, then timed at b 8, h 8, s 2048, dh 128, causal, bf16) and
``chip_smoke.train_main_path`` (phase 7: 30 steps of the d1024 LM), then
profiles one more step (``chip_smoke.device_profile``, phase 8).  Each
prints one JSON line: every kernel record of phase 3b, the forward +
backward and the backward alone beside SDPA's, the training step's ms,
tokens/s, MFU, peak memory and launches, and the step's device busy time
and idle share (the host's share varies from machine to machine; the
device time does not).  Exits non-zero if a child fails.
Not collected by pytest: it needs the card and a few minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure() -> dict:
    """Phases 3b and 7 of the tree in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from tpudist_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["flash_attention", "flash_backward"])
    rec, fwd_bwd = cs.check_flash(torch, torch.device("cuda"))
    torch.cuda.empty_cache()
    train, step, tokens = cs.train_main_path(torch)
    keep = ("step_ms_p50", "tokens_per_s", "mfu", "peak_mem_gb", "launches",
            "launches_wgmma", "first_loss", "last_loss")
    return dict(tree=os.getcwd(), card=cs.card_line(), kernels=rec,
                fwd_bwd=fwd_bwd,
                train={k: train[k] for k in keep if k in train},
                step_profile=cs.device_profile(torch, lambda: step(tokens),
                                               lambda: None))


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
            cwd=tree, capture_output=True, text=True, timeout=1200,
            env=dict(os.environ, PYTHONPATH=str(tree)))
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(run.stdout.strip().splitlines()[-1])
        res["label"] = label
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
