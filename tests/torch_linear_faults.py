#!/usr/bin/env python3
"""Planted-fault readings of the RoPE+QKV, LoRA and fused-MLP kernels'
checks, on one NVIDIA card.

Run from the repository root on the GPU machine::

    python3 tests/torch_linear_faults.py [--out FILE]

Builds the checkout's kernels once; then for the sound kernels and for
each fault in ``FAULTS`` copies ``tpudist_torch/``, its built libraries
and ``chip_smoke.py`` into a fresh temporary directory, plants the fault
there (a textual edit of the copy's kernel source, which that copy then
rebuilds; the checkout is never touched), and runs in a child process in
that copy:

- phase 3c (``chip_smoke.check_fused_linear``: ``fused_rope_qkv`` and
  ``lora_delta`` against their plain versions at ``LINEAR_BOUNDS``);
- phase 3e (``chip_smoke.check_fused_mlp``: ``fused_mlp`` against its plain
  version and float64 numpy at ``MLP_PLAIN_REL`` / ``MLP_F64_REL``).

A phase is caught when its check raises.  Prints one JSON line per variant
(and writes them all to ``--out``).  Exits non-zero unless the sound
kernels pass both phases and each fault fails every phase listed for it.
Not collected by pytest: it needs the card and a few minutes.
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
ROPE = "tpudist_torch/csrc/fused_rope_qkv.cu"
LORA = "tpudist_torch/csrc/lora_delta.cu"
MLP = "tpudist_torch/csrc/fused_mlp.cu"
KERNELS = ["lora_delta", "fused_rope_qkv", "fused_mlp"]

# name -> (edits (file, text, replacement), phases that must catch it)
FAULTS = {
    # the cluster arm's sum leaves out the partial of the CTA of rank 3
    "lora_cluster_drops_rank3": ([(
        LORA, "    for (int cc = 0; cc < kCluster; ++cc) m += recv[cc][t][j];",
        "    for (int cc = 0; cc < kCluster; ++cc)\n"
        "      if (cc != 3) m += recv[cc][t][j];")], ("3c",)),
    # the register-blocked arm never stores the last of a thread's R rows
    "mlp_skips_last_row_of_thread": ([(
        MLP, "      if (!live[i]) continue;",
        "      if (!live[i] || i == R - 1) continue;")], ("3e",)),
    # fused_rope_qkv's split arm sums the partials of every depth slice but
    # rank 3's
    "rope_split_drops_rank3": ([(
        ROPE, "    for (int k = 1; k < kSplitKS; ++k) {  // in rank order\n",
        "    for (int k = 1; k < kSplitKS; ++k) {  // in rank order\n"
        "      if (k == 3) continue;\n")], ("3c",)),
    # fused_rope_qkv's wgmma arm rotates each pair with the partner of the
    # next accumulator block
    "rope_wgmma_wrong_partner_block": ([(
        ROPE, "    const int ip = i + NB / 2;",
        "    const int ip = (i + NB / 2 + 1) % NB;")], ("3c",)),
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(KERNELS)
    dev = torch.device("cuda")
    out = {"variant": name, "caught": [], "errors": {}}
    for phase, check in (("3c", cs.check_fused_linear),
                         ("3e", cs.check_fused_mlp)):
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

    _build.build(KERNELS)
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
