#!/usr/bin/env python3
"""``nvcc`` seconds of every kernel source in two trees, on the GPU machine.

Run from the repository root::

    python3 tests/torch_build_seconds.py --parent DIR [--out FILE]

``DIR`` holds another checkout of the repository, for example an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists.  In the order parent, this tree, this tree, parent, a child process
in each tree compiles all of that tree's kernel sources (its
``_build.KERNELS``, with its own ``_build.nvcc_command``) into an empty
temporary directory, one ``nvcc`` per source started together, as
``chip_smoke.py``'s phase 2 builds them, and reports the seconds until
each ``nvcc`` exited (polled every 50 ms) and the wall.  Prints one JSON
object with every turn and the card's ``nvidia-smi`` name and power
limit.  Not collected by pytest: it needs ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = """
import json, subprocess, sys, time
from pathlib import Path
from tpudist_torch.ops import _build
out, nvcc = Path(sys.argv[1]), _build.nvcc_path()
t0 = time.perf_counter()
procs = {name: subprocess.Popen(
    _build.nvcc_command(nvcc, name, out / (name + ".so")),
    stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    for name in _build.KERNELS}
secs = {}
while len(secs) < len(procs):
    for name, proc in procs.items():
        if name not in secs and proc.poll() is not None:
            if proc.returncode != 0:
                sys.exit(name + " failed to build")
            secs[name] = time.perf_counter() - t0
    time.sleep(0.05)
print(json.dumps(dict(seconds=secs, wall=time.perf_counter() - t0)))
"""


def build_tree(root: Path) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([sys.executable, "-c", CHILD, tmp], cwd=root,
                             capture_output=True, text=True, timeout=900,
                             check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line

    trees = {"parent": Path(args.parent).resolve(), "change": ROOT}
    turns = []
    for label in ("parent", "change", "change", "parent"):
        r = build_tree(trees[label])
        turns.append(dict(tree=label, **r))
        print(f"{label}: wall {r['wall']:.1f} s; "
              + ", ".join(f"{k} {v:.1f}" for k, v in r["seconds"].items()),
              flush=True)
    result = dict(card=card_line(), turns=turns)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
