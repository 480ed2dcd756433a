"""One model split across devices, composed with data parallelism — the
counterpart of ``examples/demo_model_split.py`` (the reference's
``demo_one_model_multi_gpu.py``, SURVEY.md §3, P6).

Each rank owns ``--model_parallel`` devices (default 2, the reference's
two GPUs a process) and places each ToyMLP's layer groups on them, one
group a device (``tpudist_torch.models.split_mlp``); DDP wraps the
several-device module with ``device_ids=None`` and averages the gradients
over the process group.  On CUDA local rank ``r`` takes the distinct
devices ``cuda:r·m … cuda:r·m+m-1`` and the run raises when the host has
fewer; on the CPU every stage is the CPU.

Two GPUs, one process::

  python -m tpudist_torch.examples.demo_model_split --dry_run

The same flags as ``python -m tpudist_torch.examples.demo`` otherwise
(``--device cpu``, the launch contracts, checkpoints, ``--profile_dir``);
metrics go to ``runs/demo_model_split/metrics.jsonl``.
"""

from __future__ import annotations

import torch

from tpudist_torch.config import build_parser
from tpudist_torch.config import get_args as parse_args
from tpudist_torch.examples.common import train_demo
from tpudist_torch.models.transformer import resolve_device
from tpudist_torch.runtime import (describe_runtime, initialize,
                                   per_process_seed, resolve_shared_seed,
                                   shutdown)
from tpudist_torch.runtime.mesh import data_model_mesh
from tpudist_torch.utils.record import record


def get_args(argv=None):
    p = build_parser()
    p.add_argument("--model_parallel", default=2, type=int,
                   help="chips per model replica (reference hardcodes 2, :89)")
    return parse_args(argv, parser=p)


@record
def main(argv=None) -> dict:
    args = get_args(argv)
    device = resolve_device(args.device)
    ctx = initialize(use_node_rank=args.use_node_rank, device=device)
    args.seed = resolve_shared_seed(args.seed)
    mesh = data_model_mesh(args.model_parallel, device=device)
    if device.type == "cuda":
        torch.cuda.set_device(mesh.devices[0])
    describe_runtime(ctx, per_process_seed(args.seed), mesh.devices[0])
    losses = train_demo(args, mesh, group="demo_model_split", split=True)
    print(f"[rank {ctx.process_id}] final losses: {losses}", flush=True)
    shutdown()
    return losses


if __name__ == "__main__":
    main()
