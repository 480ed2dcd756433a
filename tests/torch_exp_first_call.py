"""How often the first ``torch.exp`` of a fresh process reads wrong, with
and without the warm-up of ``torch_cases.settled_torch_cpu``.

Each child process imports what a port test worker imports (JAX on the CPU
and the JAX and port flash modules), sets two intra-op threads as the port
tests do, optionally warms torch's CPU kernels up, then takes ``exp(s −
max)`` of the flash case's ``[2, 2, 64, 128]`` f32 scores
(``tests/test_torch_flash.py``'s ``full`` case) and prints its largest error
against float64.  The parent runs ``--runs`` children per arm, ``--workers``
at a time with the arms interleaved, so both see the same load, and prints
how many children of each arm read an error above 1e-6.

    python tests/torch_exp_first_call.py --runs 150 --workers 6
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child(warm: bool) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import jax  # noqa: F401
    import numpy as np
    import torch

    import tpudist.ops.flash_attention  # noqa: F401
    import tpudist_torch.ops  # noqa: F401
    from torch_cases import settled_torch_cpu

    r = np.random.default_rng(4)
    q = r.normal(size=(2, 2, 128, 64)).astype(np.float32)
    k = r.normal(size=(2, 2, 128, 64)).astype(np.float32)
    if warm:
        ctx = settled_torch_cpu(torch)
    else:
        torch.set_num_threads(min(torch.get_num_threads(), 2))
        ctx = open(os.devnull)
    with ctx:
        s = torch.matmul(torch.from_numpy(q[:, :, :64]),
                         torch.from_numpy(k).transpose(-1, -2)) * 0.125
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
    ref = np.exp((s - m).numpy().astype(np.float64))
    print(float(np.abs(p.numpy() - ref).max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=150)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--child", choices=("warm", "cold"))
    args = ap.parse_args(argv)
    if args.child:
        child(args.child == "warm")
        return 0

    def one(arm: str) -> tuple:
        out = subprocess.run([sys.executable, __file__, "--child", arm],
                             capture_output=True, text=True, timeout=300)
        return arm, float(out.stdout.strip().splitlines()[-1])

    arms = [a for _ in range(args.runs) for a in ("cold", "warm")]
    with ThreadPoolExecutor(args.workers) as pool:
        results = list(pool.map(one, arms))
    for arm in ("cold", "warm"):
        errs = [e for a, e in results if a == arm]
        bad = [e for e in errs if e > 1e-6]
        print(f"{arm}: {len(bad)} of {len(errs)} first calls read an error "
              f"above 1e-6 (worst {max(errs):.3g}, best {min(errs):.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
