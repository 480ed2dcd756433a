"""Pipeline-parallel LM training — data × stage parallelism with a
selectable schedule, the counterpart of ``examples/demo_pipeline.py``.

The transformer blocks split into ``--stages`` groups (``--chunks`` virtual
chunks a stage under the interleaved schedule) over the ``stage`` mesh
axis, activations hopping stage to stage
(:mod:`tpudist_torch.parallel.pipeline`); the schedule is chosen per run:

- ``--schedule gpipe``        all forwards, then the backwards (O(M) memory)
- ``--schedule 1f1b``         one forward and one backward a tick (O(stages))
- ``--schedule interleaved``  ``--chunks`` virtual chunks a stage; the
                              fill/drain bubble shrinks about ÷chunks

The same synthetic increment-chain task as the other LM demos
(:func:`~tpudist_torch.examples.demo_long_context.make_batch`, the global
batch drawn on every rank from the shared seed, each data row taking its
rows).  The JAX demo's flags, plus ``--device``, and ``--precision``,
``--n_heads``, ``--d_ff``, ``--max_len`` and ``--rope`` for the geometry
the JAX demo leaves at its defaults (4 heads, d_ff 4·d_model, max_len
seq_len, learned positions, f32).  Rows ``{"iteration", "loss"}`` go to
``runs/<group>/metrics.jsonl`` every 50 iterations and at the last.

One process on the CPU (the stages fold onto the device)::

  python -m tpudist_torch.examples.demo_pipeline --device cpu --dry_run \\
      --stages 4 --schedule interleaved --chunks 2 --total_iterations 100

Over gloo (one command per rank, ``RANK`` 0 to 3; four ranks with
``--stages 2`` are data 2 × stage 2)::

  RANK=0 WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=29500 \\
      python -m tpudist_torch.examples.demo_pipeline --device cpu \\
      --dry_run --stages 4 --schedule 1f1b --total_iterations 100

Phase 7's d1024 geometry on one card (the four stages folded onto it)::

  python -m tpudist_torch.examples.demo_pipeline --dry_run --stages 4 \\
      --schedule 1f1b --seq_len 2048 --vocab 256 --d_model 1024 \\
      --n_layers 8 --n_heads 8 --d_ff 4096 --batch_size 8 \\
      --precision bf16 --total_iterations 10
"""

from __future__ import annotations

import numpy as np
import torch

from tpudist_torch.config import build_parser
from tpudist_torch.config import get_args as parse_args
from tpudist_torch.examples.demo_long_context import make_batch
from tpudist_torch.models.transformer import (create_transformer,
                                              resolve_device)
from tpudist_torch.parallel import make_pp_lm_train_step
from tpudist_torch.runtime import (describe_runtime, initialize, rank_print,
                                   resolve_shared_seed, shutdown)
from tpudist_torch.runtime.mesh import MeshConfig, make_mesh
from tpudist_torch.train.optim import build_optimizer
from tpudist_torch.utils import init_metrics, trace
from tpudist_torch.utils.record import record


def get_args(argv=None):
    p = build_parser()
    p.add_argument("--stages", default=4, type=int,
                   help="size of the stage mesh axis (pipeline width)")
    p.add_argument("--schedule", default="1f1b",
                   choices=["gpipe", "1f1b", "interleaved"])
    p.add_argument("--chunks", default=2, type=int,
                   help="virtual chunks per device (interleaved only)")
    p.add_argument("--microbatches", default=None, type=int,
                   help="pipeline microbatches per step (default: stages, "
                        "or 2*stages for interleaved)")
    p.add_argument("--seq_len", default=64, type=int)
    p.add_argument("--vocab", default=64, type=int)
    p.add_argument("--d_model", default=128, type=int)
    p.add_argument("--n_layers", default=8, type=int,
                   help="must divide into stages (x chunks) even groups")
    p.add_argument("--n_heads", default=4, type=int)
    p.add_argument("--d_ff", default=None, type=int,
                   help="FFN width (default: 4 x d_model)")
    p.add_argument("--max_len", default=None, type=int,
                   help="position table length (default: seq_len)")
    p.add_argument("--rope", action="store_true",
                   help="rotary position encoding instead of the learned "
                        "position table")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                   help="bf16 = f32 master weights, bf16 compute")
    p.set_defaults(batch_size=16, total_iterations=300, lr=3e-4)
    return parse_args(argv, parser=p)


def resolve_schedule(args):
    """``(chunks, microbatches)`` of ``args`` with the JAX demo's guards."""
    chunks = args.chunks if args.schedule == "interleaved" else 1
    micro = args.microbatches
    if micro is None:
        micro = args.stages * (2 if args.schedule == "interleaved" else 1)
    total_stages = args.stages * chunks
    if args.n_layers % total_stages:
        raise SystemExit(f"--n_layers {args.n_layers} must divide into "
                         f"{total_stages} (stages x chunks) groups")
    if args.batch_size % micro:
        raise SystemExit(f"--batch_size {args.batch_size} must divide into "
                         f"{micro} microbatches")
    return chunks, micro


def build(args, mesh):
    """``(model, step, next_batch)`` of ``args`` on ``mesh`` (this rank's
    view of the ``(data, stage)`` mesh): the model from ``args.seed``,
    Adam at ``--lr`` (the JAX demo's ``optax.adam``), the pipelined step,
    and the function returning this data row's next batch (numpy)."""
    chunks, micro = resolve_schedule(args)
    model = create_transformer(
        args.seed, device=mesh.devices[0], trainable=True,
        dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        param_dtype=torch.float32, vocab=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        d_ff=args.d_ff or 4 * args.d_model,
        max_len=args.max_len or args.seq_len, rope=args.rope)
    opt, _ = build_optimizer(model.parameters(), args.lr)
    step = make_pp_lm_train_step(
        mesh, model, opt, n_stages=args.stages, num_microbatches=micro,
        schedule=args.schedule, n_chunks=chunks)
    rows, row = mesh.shape["data"], mesh.coords["data"]
    if args.batch_size % rows:
        raise SystemExit(f"--batch_size {args.batch_size} is the global "
                         f"batch: it must divide over {rows} data rows")
    share = args.batch_size // rows
    rng = np.random.default_rng(args.seed)

    def next_batch():
        batch = make_batch(rng, args.batch_size, args.seq_len, args.vocab)
        return batch[row * share:(row + 1) * share]

    return model, step, next_batch


@record
def main(argv=None) -> float:
    """Train; returns the final loss."""
    args = get_args(argv)
    device = resolve_device(args.device)
    ctx = initialize(use_node_rank=args.use_node_rank, device=device)
    args.seed = resolve_shared_seed(args.seed)
    chunks, micro = resolve_schedule(args)
    mesh = make_mesh(MeshConfig(data=-1, stage=args.stages), device=device)
    describe_runtime(ctx, args.seed, mesh.devices[0])
    rank_print(f"mesh={dict(mesh.shape)} schedule={args.schedule}"
               + (f" chunks={chunks}" if chunks > 1 else "")
               + f" microbatches={micro}")
    model, step, next_batch = build(args, mesh)
    metrics = init_metrics(args.project, args.group or "demo_pipeline",
                           dry_run=args.dry_run)
    loss = None
    with trace(args.profile_dir):
        for it in range(args.total_iterations):
            tokens = torch.from_numpy(next_batch()).to(mesh.devices[0])
            loss = step(tokens)
            if it % 50 == 0 or it == args.total_iterations - 1:
                metrics.log({"iteration": it, "loss": float(loss)})
                rank_print(f"iter {it:4d}  loss {float(loss):.4f}")
    final = float(loss) if loss is not None else float("nan")
    metrics.finish()
    rank_print(f"final loss {final:.4f}")
    shutdown()
    return final


if __name__ == "__main__":
    main()
