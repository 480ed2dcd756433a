#!/usr/bin/env python3
"""Planted-fault readings of the attention kernels' checks, on one NVIDIA card.

Run from the repository root on the GPU machine::

    python3 tests/torch_flash_faults.py [--out FILE]

For the sound kernels and for each fault in ``FAULTS``, copies
``tpudist_torch/`` and ``chip_smoke.py`` into a fresh temporary directory,
plants the fault there (a textual edit of the copy's kernel source; the
checkout is never touched), and measures in a child process run in that
copy, which builds its own kernels:

- phase 3's paged decode cases (``chip_smoke.decode_readings``: the split
  walk and the CUDA-core walk against the plain version);
- every phase-3b case of ``chip_smoke.py`` (``FLASH_CASES``) through
  ``chip_smoke.flash_case_readings``: for the forward output (and on the
  forward's wgmma arm its f32 output), lse, dq, dk and dv
  ``chip_smoke.flash_agreement`` (worst row, relative RMS, the elementwise
  bound alone and the full check), and on the backward's wgmma arm the dq
  kernel that forms delta itself (delta, its dq, equality with the
  given-delta arm);
- phase 9's comparison (``chip_smoke.grad_readings``: batch 2 of the
  training geometry, bf16 kernels against the f32 plain path), held to
  ``GRAD_COS_MIN`` and ``LOSS_REL_MAX``; for the sound kernels also a bf16
  plain path (dense attention, no kernel), the lower-precision control.

Prints one JSON line per variant (and writes them all to ``--out``).
Exits non-zero unless the sound kernels pass every check and each fault
fails every phase listed for it.  Not collected by pytest: it needs the
card and a few minutes.
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
BWD = "tpudist_torch/csrc/flash_backward.cu"
DEC = "tpudist_torch/csrc/paged_attention.cu"
_PV = "    mma_pt<DN, kBK / 16>(o, s, Vs, LD, lane);"
# the forward's wgmma arm (head dims 64 and 128: the main path's): a step's
# P·V, the last tile's P·V, the epilogue's row
_WPV = "      hw::wgmma_pv<DN, 8>(o, pa, Vs + sp * TK);\n"
_WLAST = ("    hw::named_sync(mine, kBoth);\n"
          "    hw::wgmma_pv<DN, 8>(o, pa, Vs + sp * TK);\n")
_WROW = ("    const int row = qr + g + r * 8;\n"
         "    if (row >= Sq) continue;\n")
# the split walk's merge weight of a partial
_MERGE = "        const float c = exp_row(rd(i, DN * 4 + r), mx);"
# the backward's wgmma arm (head dims 64 and 128: the main path's)
_DSK = "    hw::wgmma_pt<DN>(acc, s, ks);  // dq += bf(ds)·k"
_DV = "    hw::wgmma_pt<DN>(dv, s, dos);  // dv += bf(pᵀ)·do"
_DK = "    hw::wgmma_pt<DN>(dk, dp, qs);  // dk += bf(dsᵀ)·q"
_ROWSUM = "    sum += __shfl_xor_sync(0xffffffffu, sum, 1);"
# zero the second half (32 columns) of the warp's score / ds tile
_HALF = ("      for (int n = NT / 2; n < NT; ++n)\n"
         "        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;\n")

# name -> (edits (file, text, replacement), phases that must catch it)
FAULTS = {
    # 32 keys of one KV tile left out of P·V, in one head's last Q tile (the
    # mma.sync forward: head dims 16 and 32)
    "fwd_half_tile_one_head": ([(FWD, _PV, "    if (j == (first + last) / 2 "
                                 "&& blockIdx.x == 0 && blockIdx.y == 0)\n"
                                 + _HALF + _PV)], ("3b",)),
    # the wgmma forward: half (64 keys) of one P·V step left out, in one
    # head's last Q tile
    "fwd_wgmma_half_pv_one_head": ([(FWD, _WPV, (
        "      if (t == n / 2 && blockIdx.x == 0 && blockIdx.y == 0)\n"
        "        for (int kk = 4; kk < 8; ++kk)\n"
        "          pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;\n")
        + _WPV)], ("3b",)),
    # the wgmma forward: the last KV tile's P·V skipped (its p still in l)
    "fwd_wgmma_skip_last_tile": ([(FWD, _WLAST,
                                   "    hw::named_sync(mine, kBoth);\n")],
                                 ("3b",)),
    # the wgmma forward: one lse row (head 0, row 5) off by log 2
    "fwd_wgmma_lse_row_log2": ([(FWD, _WROW, _WROW + (
        "    if (bh == 0 && row == 5) m[r] += 0.6931472f;\n"))], ("3b",)),
    # the paged decode's split walk: a partial whose row saw no live key
    # (a sliding window past its span) given weight 1 in the merge
    "decode_dead_span_weight_one": ([(DEC, _MERGE, (
        "        const float c = rd(i, DN * 4 + r) <= -5e29f\n"
        "                            ? 1.f\n"
        "                            : exp_row(rd(i, DN * 4 + r), mx);"))],
        ("3",)),
    # the same in dS·K of the dq pass
    "dq_half_tile_one_head": ([(BWD, _DSK, "    if (j == (first + last) / 2 "
                                "&& blockIdx.x == 0 && blockIdx.y == 0)\n"
                                + _HALF + _DSK)], ("3b",)),
    # 32 queries of one (member, Q tile) step of the dk/dv pass left out,
    # in one KV head's first KV tile
    "dkv_half_step_one_head": ([(BWD, _DV, "    if (it == steps / 2 && "
                                 "blockIdx.x == 0 && blockIdx.y == 0)\n"
                                 + _HALF + _DV)], ("3b",)),
    # the diagonal dS·K tile of every Q tile left out
    "dq_skip_diag_all": ([(BWD, _DSK, "    if (j != last)\n  " + _DSK)],
                         ("3b", "9")),
    # the last (member, Q tile) step of every KV tile left out
    "dkv_skip_last_all": ([(BWD, _DV, "    if (it != steps - 1)\n  " + _DV),
                           (BWD, _DK, "    if (it != steps - 1)\n  " + _DK)],
                          ("3b", "9")),
    # dq scaled by 0.97 everywhere (phase 9's cosine cannot see a scale)
    "dq_scaled_097": ([(BWD, "__floats2bfloat162_rn(acc[i][2 * r], "
                        "acc[i][2 * r + 1]);",
                        "__floats2bfloat162_rn(0.97f * acc[i][2 * r], "
                        "0.97f * acc[i][2 * r + 1]);")], ("3b",)),
    # the folded delta sums half of each row (one thread's columns)
    "dq_delta_half_row": ([(BWD, _ROWSUM, "")], ("3b",)),
}


def plant(dst: Path, edits) -> None:
    shutil.copytree(ROOT / "tpudist_torch", dst / "tpudist_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    for rel, text, repl in edits:
        path = dst / rel
        src = path.read_text()
        if src.count(text) != 1:
            raise RuntimeError(f"{rel}: the text to edit is not there once")
        path.write_text(src.replace(text, repl))


def measure(name: str) -> dict:
    """One variant's readings, in the current directory's copy."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from tpudist_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["flash_attention", "flash_backward", "paged_attention"])
    out = {"variant": name}
    out["3"] = cs.decode_readings(
        torch, torch.device("cuda"),
        torch.Generator(device="cuda").manual_seed(1234))
    gen = torch.Generator(device="cuda").manual_seed(4321)
    out["3b"] = {}
    caught_3b = False
    for case in cs.FLASH_CASES:
        row = cs.flash_case_readings(torch, gen, case)
        caught_3b |= not row["ok"]
        out["3b"][case[0]] = row
    torch.cuda.empty_cache()
    out["9"] = cs.grad_readings(torch)
    out["caught"] = [p for p, hit in (("3", not out["3"]["ok"]),
                                      ("3b", caught_3b),
                                      ("9", not cs.grads_agree(out["9"])))
                     if hit]
    if name == "sound":
        out["9_bf16_plain_control"] = cs.grad_readings(torch,
                                                       cs.PlainCausal())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write every line here too")
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    lines, ok = [], True
    for name, (edits, expect) in [("sound", ([], ()))] + list(FAULTS.items()):
        with tempfile.TemporaryDirectory() as tmp:
            plant(Path(tmp), edits)
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure",
                 name], cwd=tmp, capture_output=True, text=True, timeout=900)
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
