#!/usr/bin/env python3
"""What each part of the flash forward's wgmma arm is worth, on one card.

Run from the repository root on the GPU machine::

    python3 tests/torch_flash_fwd_variants.py [--out FILE]

For the sound kernel and for each variant in ``VARIANTS``, copies
``tpudist_torch/`` and ``chip_smoke.py`` into a fresh temporary directory,
edits the copy of ``csrc/flash_attention.cu`` there (the checkout is never
touched), and in a child process run in that copy builds its kernels and
times the wgmma forward at phase 3b's main-path shape (b 8, h 8, s 2048,
dh 128, bf16, causal) with ``chip_smoke.time_ms``, twice, beside its max
abs error against the plain version.  The variants take one part of the
design out at a time:

- ``no_turns``: the two consumer warpgroups issue their products without
  taking turns (no named barriers);
- ``no_overlap``: a warpgroup waits for its P·V before its softmax, so the
  softmax no longer runs under its own products;
- ``no_softmax``: no softmax at all (wrong output): the products, loads
  and synchronisation alone;
- ``no_loads``: no softmax and no K/V loads past the ring's first fill
  (wrong output): the products and synchronisation alone.

The sound kernel runs first and last.  Prints one JSON line per run (and
writes them all to ``--out``); exits non-zero if a child fails or the
sound kernel disagrees with the plain version.  Not collected by pytest: it
needs the card.
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
FWD = "tpudist_torch/csrc/flash_attention.cu"
_TURNS = [("if (wg == 0) hw::named_arrive(other, kBoth);", ""),
          ("if (wg == 1) hw::named_arrive(other, kBoth);", ""),
          ("hw::named_sync(mine, kBoth);", ""),
          ("hw::named_arrive(other, kBoth);", "")]
_SOFTMAX = [("      step(t);\n", "")]
# name -> edits (text, replacement), each text present at least once
VARIANTS = {
    "no_turns": _TURNS,
    "no_overlap": [("      hw::wgmma_wait<1>();\n",
                    "      hw::wgmma_wait<0>();\n")],
    "no_softmax": _SOFTMAX,
    "no_loads": _SOFTMAX + [
        ("for (int t = 0; t < n; ++t) {\n        const int st",
         "for (int t = 0; t < min(n, kWgStages); ++t) {\n        const int st"),
        ("(t / kWgStages) & 1)", "0)"),
        ("((t - 1) / kWgStages) & 1)", "0)"),
        ("((n - 1) / kWgStages) & 1)", "0)")],
}


def plant(dst: Path, edits) -> None:
    shutil.copytree(ROOT / "tpudist_torch", dst / "tpudist_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    path = dst / FWD
    src = path.read_text()
    for text, repl in edits:
        if text not in src:
            raise RuntimeError(f"{FWD}: {text!r} is not there")
        src = src.replace(text, repl)
    path.write_text(src)


def measure(name: str) -> dict:
    """One variant's readings, in the current directory's copy."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from tpudist_torch.ops import _build
    from tpudist_torch.ops.flash_attention import (_launch_fwd,
                                                   flash_forward_reference)

    _build.build(["flash_attention"])
    gen = torch.Generator(device="cuda").manual_seed(4321)
    q, k, v = (torch.randn(8, 8, 2048, 128, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    band = (0, None)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out, _ = _launch_fwd("wgmma", q, k, v, band)
    ref, _ = flash_forward_reference(q, k, v, band)
    torch.cuda.synchronize()
    agree = cs.flash_agreement(torch, out, ref, torch.bfloat16, False,
                               float(v.float().abs().max()))
    return dict(variant=name, card=cs.card_line(),
                ms=[cs.time_ms(torch, lambda: _launch_fwd(
                    "wgmma", q, k, v, band), flush) for _ in range(2)],
                max_abs_err=agree["max_abs_err"],
                agrees=agree["elementwise_ok"] and agree["rows_ok"]
                and agree["rms_ok"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write every line here too")
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    lines, ok = [], True
    runs = [("sound", [])] + list(VARIANTS.items()) + [("sound", [])]
    for name, edits in runs:
        with tempfile.TemporaryDirectory() as tmp:
            plant(Path(tmp), edits)
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure",
                 name], cwd=tmp, capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(run.stdout.strip().splitlines()[-1])
        if name == "sound":
            ok &= res["agrees"]
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
