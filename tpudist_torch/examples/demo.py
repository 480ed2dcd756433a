"""The main data-parallel demo — the counterpart of ``examples/demo.py``.

Two independent toy models trained side by side under data parallelism:
each process steps on its shard, DDP averages the gradients on the device
group (NCCL on the card, gloo with ``--device cpu``), and the losses are
logged as global batch-weighted means, reduced on the device group
(``--backend ici``) or on a second gloo group (``--backend host``).  The
launch contract is detected from the environment
(``tpudist_torch.runtime.bootstrap``).

One process on the card::

  python -m tpudist_torch.examples.demo --dry_run

The same under the torchrun contract at world size 1 (the NCCL group, DDP
and the device-group all-reduce then run)::

  RANK=0 WORLD_SIZE=1 MASTER_ADDR=localhost MASTER_PORT=29500 \\
      python -m tpudist_torch.examples.demo --dry_run

Two ranks on the CPU over gloo (one command per rank, ``RANK`` 0 and 1)::

  RANK=0 WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=29500 \\
      python -m tpudist_torch.examples.demo --device cpu --dry_run

Metrics go to ``runs/<group>/metrics.jsonl`` under the working directory.
``--checkpoint_dir DIR --checkpoint_every N`` saves every N iterations and
at the end; ``--resume`` continues from the latest step in DIR;
``--profile_dir DIR`` writes a ``torch.profiler`` trace of the training to
``DIR/process_<rank>/trace.json``.
"""

from __future__ import annotations

from tpudist_torch.config import get_args
from tpudist_torch.examples.common import train_demo
from tpudist_torch.models.transformer import resolve_device
from tpudist_torch.runtime import (describe_runtime, initialize,
                                   per_process_seed, resolve_shared_seed,
                                   shutdown)
from tpudist_torch.runtime.mesh import data_parallel_mesh
from tpudist_torch.utils.record import record


@record
def main(argv=None) -> dict:
    args = get_args(argv)
    device = resolve_device(args.device)
    ctx = initialize(use_node_rank=args.use_node_rank, device=device)
    args.seed = resolve_shared_seed(args.seed)  # job-wide agreement
    mesh = data_parallel_mesh(device=device)
    # per-rank seed offset (demo.py:59-60), for anything rank-local; model
    # init and the global shuffle use the shared base seed
    describe_runtime(ctx, per_process_seed(args.seed), mesh.devices[0])
    losses = train_demo(args, mesh, group="demo_dp")
    print(f"[rank {ctx.process_id}] final losses: {losses}", flush=True)
    # teardown ordering parity (demo.py:130-136,177-178): the metrics
    # logger finished inside run_training, then the process group goes down
    shutdown()
    return losses


if __name__ == "__main__":
    main()
