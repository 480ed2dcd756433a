#!/usr/bin/env python3
"""Planted-fault readings of the sampling and residual preps' checks, on
one NVIDIA card.

Run from the repository root on the GPU machine::

    python3 tests/torch_sample_faults.py [--out FILE]

Builds the checkout's ``fused_sample`` kernel once; then for the sound
kernel and for each fault in ``FAULTS`` copies ``tpudist_torch/``, its
built library and ``chip_smoke.py`` into a fresh temporary directory,
plants the fault there (a textual edit of the copy's kernel source, which
that copy then rebuilds; the checkout is never touched), and runs in a
child process in that copy:

- phase 3's sampling check (``chip_smoke.check_sample``: both arms of
  ``fused_sample_prep`` at ``SAMPLE_CASES`` against the plain version);
- phase 3d (``chip_smoke.check_residual``: both arms of
  ``fused_residual_prep`` at ``RESIDUAL_CASES``).

A phase is caught when its check raises; the line records what it read.
Prints one JSON line per variant (and writes them all to ``--out``).  Exits
non-zero unless the sound kernels pass both phases and each fault fails
every phase listed for it.  Not collected by pytest: it needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = "tpudist_torch/csrc/fused_sample.cu"

# name -> (edits (file, text, replacement), phases that must catch it)
FAULTS = {
    # a cluster round's owner sums every rank's histogram but rank 3's
    "cluster_sum_drops_rank3": ([(
        SRC, "    for (int r = 0; r < C; ++r) {\n"
             "      c += sh.recv_c[r][j];",
        "    for (int r = 0; r < C; ++r) {\n"
        "      if (r == 3) continue;\n"
        "      c += sh.recv_c[r][j];")], ("3",)),
    # the top-p walk stops one bin early: the bin above the right one
    "top_p_walk_one_bin_early": ([(
        SRC, "      st.prefix = pre | ((unsigned)b << shift);\n"
             "      st.above = above + em;",
        "      st.prefix = pre | ((unsigned)min(b + 1, 255) << shift);\n"
        "      st.above = above + em;")], ("3",)),
    # the residual cluster arm takes each CTA's own maxima for the row's
    "residual_max_one_cta": ([(
        SRC, "  mt = part_m[0][0];\n  md = part_m[1][0];\n"
             "  for (int r = 1; r < C; ++r) {\n"
             "    mt = fmaxf(mt, part_m[0][r]);\n"
             "    md = fmaxf(md, part_m[1][r]);\n  }\n",
        "  mt = part_m[0][rank];\n  md = part_m[1][rank];\n")], ("3d",)),
}


def plant(dst: Path, edits) -> None:
    shutil.copytree(ROOT / "tpudist_torch", dst / "tpudist_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "build" / "tpudist_torch",
                    dst / "build" / "tpudist_torch")
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    for rel, text, repl in edits:
        path = dst / rel
        src = path.read_text()
        if src.count(text) != 1:
            raise RuntimeError(f"{rel}: the text to edit is not there once")
        path.write_text(src.replace(text, repl))


def measure(name: str) -> dict:
    """One variant's phases, in the current directory's copy."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from tpudist_torch.ops import _build

    _build.build(["fused_sample"])
    dev = torch.device("cuda")
    out = {"variant": name, "card": cs.card_line(), "caught": [],
           "errors": {}}
    for phase, check in (("3", cs.check_sample), ("3d", cs.check_residual)):
        try:
            check(torch, dev)
        except AssertionError as e:
            out["caught"].append(phase)
            out["errors"][phase] = str(e)[:600]
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write every line here too")
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    sys.path.insert(0, str(ROOT))
    from tpudist_torch.ops import _build

    _build.build(["fused_sample"])
    lines, ok = [], True
    for name, (edits, expect) in [("sound", ([], ()))] + list(FAULTS.items()):
        with tempfile.TemporaryDirectory() as tmp:
            plant(Path(tmp), edits)
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure",
                 name], cwd=tmp, capture_output=True, text=True, timeout=900,
                env=dict(os.environ, PYTHONPATH=tmp))
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(run.stdout.strip().splitlines()[-1])
        res["expected"] = list(expect)
        res["as_expected"] = sorted(res["caught"]) == sorted(expect) \
            if name == "sound" else set(expect) <= set(res["caught"])
        ok &= res["as_expected"]
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
