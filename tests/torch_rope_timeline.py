#!/usr/bin/env python3
"""Where a launch of ``fused_rope_qkv``'s split and wgmma arms spends its
time, on one card: per-CTA timelines read from the device clock.

Run from the repository root on the GPU machine::

    python3 tests/torch_rope_timeline.py [--out FILE]

Copies ``tpudist_torch/csrc`` into a fresh temporary directory, plants
stamps in the copy of ``fused_rope_qkv.cu`` (thread 0 of every CTA writes
``%globaltimer`` into a device table at each phase boundary; the checkout
is never touched), builds it, and launches it as ``chip_smoke.time_ms``
times a call (the L2 flushed, a ~2 ms spin ahead of the launch) at the
main path's shapes: the split arm at decode (8 slots x T 1) and the
speculative verify's T 5, the wgmma arm at prefill (8 x T 64), d 1024, 8
heads of 128.  For each it prints one JSON line: the call's event time
(``chip_smoke.time_ms`` of the instrumented build, its median of 30) and,
over two launches, each phase boundary's min / median / max over the CTAs
in microseconds since the first CTA started (the device clock advances in
steps of about 0.26 us on the H100):

- split: ``loaded`` (the slice's weight and h rows in shared memory),
  ``staged`` (the product done and the partials in the send slots),
  ``sent`` (the bulk copies issued), ``received`` (every rank's partials
  arrived), ``end``; with the largest load skew inside a cluster;
- wgmma: ``first_tile`` (the first TMA tile arrived), ``mainloop``
  (the products done), ``end``.

The stamps cost a few registers and stores; the phases, not the event
times, are what this script is for.  Exits non-zero if a stamp's anchor
is missing from the source or the instrumented kernel disagrees with the
plain version.  Not collected by pytest: it needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_TABLE = r'''
__device__ unsigned long long tpd_stamps[16384][8];
#define TPD_STAMP(i)                                                      \
  if (threadIdx.x == 0) {                                                 \
    unsigned long long t_;                                                \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)::"memory");      \
    tpd_stamps[blockIdx.y * gridDim.x + blockIdx.x][i] = t_;              \
  }
'''
# (text, replacement): each text must be in the source exactly once
EDITS = [
    ("namespace {\n\nusing tpd_flash::bf16;",
     "namespace {\n" + _TABLE + "\nusing tpd_flash::bf16;"),
    # split arm
    ("  cluster_arrive_relaxed();\n\n  // the slice",
     "  TPD_STAMP(0)\n  cluster_arrive_relaxed();\n\n  // the slice"),
    ("  tpd_flash::cp_wait<0>();\n  __syncthreads();\n  // warp w",
     "  tpd_flash::cp_wait<0>();\n  __syncthreads();\n  TPD_STAMP(1)\n"
     "  // warp w"),
    ('  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
     "  __syncthreads();\n  cluster_wait();\n",
     '  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
     "  __syncthreads();\n  TPD_STAMP(2)\n  cluster_wait();\n"),
    ('    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");\n'
     "  }\n",
     '    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");\n'
     "  }\n  TPD_STAMP(3)\n"),
    ("  hw::mbar_wait(bar, 0);  // every rank's partials have arrived\n",
     "  hw::mbar_wait(bar, 0);  // every rank's partials have arrived\n"
     "  TPD_STAMP(4)\n"),
    ('  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\\n" '
     '::: "memory");\n}',
     '  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\\n" '
     '::: "memory");\n  __syncthreads();\n  TPD_STAMP(5)\n}'),
    # wgmma arm
    ("  const int head = blockIdx.x, m0 = blockIdx.y * kWgRows;\n",
     "  const int head = blockIdx.x, m0 = blockIdx.y * kWgRows;\n"
     "  TPD_STAMP(0)\n"),
    ("    hw::mbar_wait(full + st, (kt / kWgStages) & 1);\n",
     "    hw::mbar_wait(full + st, (kt / kWgStages) & 1);\n"
     "    if (kt == 0) { TPD_STAMP(1) }\n"),
    ("  hw::wgmma_wait<0>();\n  hw::fence_acc(acc);\n\n",
     "  hw::wgmma_wait<0>();\n  hw::fence_acc(acc);\n  TPD_STAMP(2)\n\n"),
    ("                 acc[i][2 * r + 1], acc[ip][2 * r], acc[ip][2 * r + 1]);"
     "\n    }\n  }\n}\n",
     "                 acc[i][2 * r + 1], acc[ip][2 * r], acc[ip][2 * r + 1]);"
     "\n    }\n  }\n  __syncthreads();\n  TPD_STAMP(3)\n}\n"),
]
# (label, T, arm, phase names by stamp index)
CASES = (("decode", 1, "split",
          ("start", "loaded", "staged", "sent", "received", "end")),
         ("verify T 5", 5, "split",
          ("start", "loaded", "staged", "sent", "received", "end")),
         ("prefill", 64, "wgmma", ("start", "first_tile", "mainloop", "end")))


def instrumented(tmp: Path):
    """Build the stamped copy of the kernel; its loaded library."""
    sys.path.insert(0, str(ROOT))
    from tpudist_torch.ops import _build
    from tpudist_torch.ops import fused_linear as fl

    csrc = tmp / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src_path = csrc / "fused_rope_qkv.cu"
    src = src_path.read_text()
    for text, repl in EDITS:
        if src.count(text) != 1:
            raise RuntimeError(f"stamp anchor not in the source once: "
                               f"{text[:60]!r}")
        src = src.replace(text, repl)
    src += ('\nextern "C" int tpd_stamps_copy(void* host, int n) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, tpd_stamps, '
            '(size_t)n * 64);\n}\n')
    src_path.write_text(src)
    lib_path = tmp / "fused_rope_qkv_stamped.so"
    run = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path),
         str(src_path)], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + run.stdout[-3000:]
                           + run.stderr[-3000:])
    lib = ctypes.CDLL(str(lib_path))
    lib.tpd_error_string.argtypes = [ctypes.c_int]
    lib.tpd_error_string.restype = ctypes.c_char_p
    fl._declare_rope(lib)
    lib.tpd_stamps_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpd_stamps_copy.restype = ctypes.c_int
    return lib


def measure(lib) -> list:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpudist_torch.ops import _build
    from tpudist_torch.ops import fused_linear as fl

    _build._libs["fused_rope_qkv"] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    card = cs.card_line()
    lines = []
    for label, T, arm, names in CASES:
        offs = cs.DECODE_OFFS if T < cs.P else cs.PREFILL_OFFS
        args = cs.qkv_inputs(torch, dev, gen, cs.SLOTS, T, cs.HEADS, cs.HEADS,
                             cs.DH, torch.bfloat16, offs)
        kw = dict(n_heads=cs.HEADS, n_kv=cs.HEADS, dh=cs.DH)
        out = fl._launch_rope(arm, *args, **kw)
        ref = fl.fused_rope_qkv_reference(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            cs.linear_close(torch, a, b, "bf16", f"stamped {arm} {label}")
        ms = cs.time_ms(torch, lambda: fl._launch_rope(arm, *args, **kw),
                        flush)
        d, dtot = cs.HEADS * cs.DH, 3 * cs.HEADS * cs.DH
        rows = cs.SLOTS * T
        n = (fl.ROPE_SPLIT_KS * dtot // fl.ROPE_SPLIT_COLS if arm == "split"
             else 3 * cs.HEADS * -(-rows // fl.ROPE_TILE_ROWS))
        phases = []
        for _ in range(2):
            flush.zero_()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            fl._launch_rope(arm, *args, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (n * 8))()
            _build.check(lib, lib.tpd_stamps_copy(buf, n), "stamp copy")
            phases.append(np.array(buf, dtype=np.float64).reshape(n, 8))
        rec = dict(arm=arm, case=label, card=card, ctas=n, event_ms=ms,
                   d=d, rows=rows)
        for rep, a in enumerate(phases):
            t = (a[:, :len(names)] - a[:, 0].min()) / 1e3
            rec[f"launch {rep}"] = {
                name: [round(float(np.min(t[:, i])), 2),
                       round(float(np.median(t[:, i])), 2),
                       round(float(np.max(t[:, i])), 2)]
                for i, name in enumerate(names)}
            if arm == "split":
                loaded = t[:, 1].reshape(-1, fl.ROPE_SPLIT_KS)
                rec[f"launch {rep}"]["cluster_load_skew_max"] = round(
                    float((loaded.max(1) - loaded.min(1)).max()), 2)
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write every line here too")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    with tempfile.TemporaryDirectory() as tmp:
        lines = measure(instrumented(Path(tmp)))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
