"""The shared CLI — a copy of :mod:`tpudist.config` with ``--device``.

Flag parity with the reference's ``argument_parser.py``:

- ``--dataloader {distributed,standard}`` — ``DistributedSampler`` shards or
  the full shuffled dataset on every process.
- ``--backend {ici,host}`` — where the per-iteration metric reduction runs:
  ``ici`` on the device process group (NCCL on the card, gloo on the CPU),
  ``host`` on a second gloo group on the host, the reference's two fabrics.
  ``nccl``/``gloo``/``mpi`` are accepted as aliases (nccl→ici,
  gloo/mpi→host).  Gradients always reduce in DDP on the device group.
- ``--torchrun`` — a no-op: the launch contract is detected from the
  environment.
- ``--use_node_rank``, ``--seed``, ``--num_workers`` (> 0: the native C++
  gather pool), ``--dry_run`` as in the reference; ``--total_iterations``,
  ``--batch_size``, ``--lr`` and the schedule/optimizer flags (adam, adamw,
  adafactor, lion); ``--profile_dir``, ``--checkpoint_dir``,
  ``--checkpoint_every`` and ``--resume`` as in the JAX package.
- ``--device`` — ``cuda`` (default; raises without CUDA) or ``cpu``.
"""

from __future__ import annotations

import argparse

BACKEND_ALIASES = {"nccl": "ici", "gloo": "host", "mpi": "host", "ici": "ici",
                   "host": "host"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tpudist_torch training entry "
                                            "point")
    p.add_argument("--dataloader", choices=["distributed", "standard"],
                   type=str, default="distributed")
    p.add_argument("--backend", choices=sorted(BACKEND_ALIASES),
                   type=str, default="ici",
                   help="metric-reduction fabric: ici (the device group) or "
                        "host (a gloo group); nccl/gloo/mpi accepted as "
                        "migration aliases")
    p.add_argument("--torchrun", action="store_true",
                   help="compat no-op: launch contract is autodetected")
    p.add_argument("--use_node_rank", action="store_true",
                   help="derive global rank as NODE_RANK*TASKS_PER_NODE+"
                        "LOCAL_RANK")
    p.add_argument("--seed", default=None, type=int,
                   help="job-wide seed; when omitted, rank 0 draws one after "
                        "runtime init and broadcasts it (see "
                        "runtime.seeding.resolve_shared_seed)")
    p.add_argument("--num_workers", default=0, type=int,
                   help=">0: background batch assembly on the native "
                        "gather pool; 0: synchronous numpy loader")
    p.add_argument("--dry_run", action="store_true",
                   help="offline metrics (no wandb network/credentials)")
    p.add_argument("--total_iterations", default=1000, type=int)
    p.add_argument("--batch_size", default=256, type=int,
                   help="per-process batch size")
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--lr_schedule",
                   choices=["constant", "cosine", "warmup_cosine"],
                   default="constant",
                   help="learning-rate schedule over --total_iterations")
    p.add_argument("--warmup_steps", default=0, type=int,
                   help="linear warmup steps (warmup_cosine)")
    p.add_argument("--optimizer",
                   choices=["adam", "adamw", "adafactor", "lion"],
                   default="adam",
                   help="optimizer family (adam = the reference's choice)")
    p.add_argument("--grad_clip", default=0.0, type=float,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--weight_decay", default=0.0, type=float,
                   help="decoupled weight decay, masked to weight matrices "
                        "(adamw; with --optimizer adam, >0 upgrades to "
                        "adamw)")
    p.add_argument("--log_every", default=1, type=int)
    p.add_argument("--project", default="tpudist", type=str)
    p.add_argument("--group", default=None, type=str)
    p.add_argument("--profile_dir", default=None, type=str,
                   help="capture a profiler trace into this directory")
    p.add_argument("--checkpoint_dir", default=None, type=str)
    p.add_argument("--checkpoint_every", default=0, type=int)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint_dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (raises without CUDA) or cpu (the plain "
                        "PyTorch path)")
    return p


def get_args(argv=None, parser: argparse.ArgumentParser | None = None
             ) -> argparse.Namespace:
    """Parse and normalize (``--backend`` aliases to ``ici``/``host``).
    ``parser`` lets entry points extend the shared parser.

    ``args.seed`` stays ``None`` when not given: it is resolved job-wide
    after ``runtime.initialize`` by ``resolve_shared_seed(args.seed)``."""
    args = (parser or build_parser()).parse_args(argv)
    args.backend = BACKEND_ALIASES[args.backend]
    return args
