"""3-D parallel LM training — data × sequence × tensor parallelism on one
mesh, the counterpart of ``examples/demo_3d_parallel.py``.

The token batch splits over ``data``, ring attention rotates K/V over
``seq`` and every block is Megatron-split over ``model``
(:func:`~tpudist_torch.models.transformer.transformer_tp_sharding`, carried
out by :mod:`tpudist_torch.parallel.zero` with
:class:`~tpudist_torch.models.transformer.TPBlock`): each head shard's
attention runs the ring over its own heads.  ``data × seq`` runs over the
process group as :func:`~tpudist_torch.runtime.mesh.data_seq_mesh` lays it
out (one process folds the ``seq`` shards onto its device); ``model`` is
the devices of each rank (folded onto one card where the host has fewer).

The JAX demo's flags, plus ``--device``, and ``--n_heads``, ``--d_ff`` and
``--precision`` for the geometry the JAX demo leaves at the model's
defaults (4 heads, d_ff 512, f32).  Batches are
:func:`~tpudist_torch.examples.demo_long_context.make_batch`'s
increment chains, the global batch drawn on every rank from the shared
seed; metrics go to ``runs/<group>/metrics.jsonl``.

One process on the CPU (data 1 × seq 2 × model 2)::

  python -m tpudist_torch.examples.demo_3d_parallel --device cpu \\
      --dry_run --seq_shards 2 --model_shards 2 --total_iterations 20

The JAX demo's 2 × 2 × 2 mesh over gloo: four ranks (data 2 × seq 2),
each holding a model axis of 2 (one command per rank, ``RANK`` 0 to 3)::

  RANK=0 WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=29500 \\
      python -m tpudist_torch.examples.demo_3d_parallel --device cpu \\
      --dry_run --seq_shards 2 --model_shards 2 --total_iterations 20

The d1024 geometry on one card (seq 4 × model 2 folded onto it)::

  python -m tpudist_torch.examples.demo_3d_parallel --dry_run \\
      --seq_len 8192 --d_model 1024 --n_layers 8 --n_heads 8 --d_ff 4096 \\
      --vocab 256 --batch_size 2 --precision bf16 --seq_shards 4 \\
      --model_shards 2 --total_iterations 10
"""

from __future__ import annotations

import numpy as np
import torch

from tpudist_torch.config import build_parser
from tpudist_torch.config import get_args as parse_args
from tpudist_torch.examples.demo_long_context import make_batch
from tpudist_torch.models.transformer import (RingCausal,
                                              create_transformer, lm_loss,
                                              resolve_device,
                                              transformer_tp_sharding)
from tpudist_torch.runtime import (describe_runtime, initialize, rank_print,
                                   resolve_shared_seed, shutdown)
from tpudist_torch.runtime.mesh import MeshConfig, make_mesh, model_devices
from tpudist_torch.train.lm import make_lm_train_step
from tpudist_torch.train.optim import build_optimizer_from_args
from tpudist_torch.utils import init_metrics, trace
from tpudist_torch.utils.record import record


def get_args(argv=None):
    p = build_parser()
    p.add_argument("--seq_len", default=256, type=int)
    p.add_argument("--seq_shards", default=2, type=int)
    p.add_argument("--model_shards", default=2, type=int)
    p.add_argument("--vocab", default=64, type=int)
    p.add_argument("--d_model", default=128, type=int)
    p.add_argument("--n_layers", default=2, type=int)
    p.add_argument("--n_heads", default=4, type=int)
    p.add_argument("--d_ff", default=512, type=int)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                   help="bf16 = f32 master weights, bf16 compute")
    p.set_defaults(batch_size=8, total_iterations=300, lr=3e-4)
    return parse_args(argv, parser=p)


def build(args, mesh):
    """``(model, step, next_batch)`` of ``args`` on ``mesh`` (this rank's
    view of the 3-D mesh): the model from ``args.seed`` under the Megatron
    layout, the train step with the ring's attention context when the
    ``seq`` axis has more than one place, and the function returning this
    rank's next batch (numpy: its data row's rows, then its shards of the
    tokens and their targets on the ring)."""
    from tpudist_torch.parallel import SeqLayout, make_ring_attention

    dev = mesh.devices[0]
    model = create_transformer(
        args.seed, device=dev, trainable=True,
        dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        param_dtype=torch.float32, vocab=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        max_len=args.seq_len)
    opt, sched = build_optimizer_from_args(args, model.parameters())
    ctx, loss_fn, place = None, lm_loss, (lambda batch: batch)
    if mesh.shape["seq"] > 1:
        layout = SeqLayout(mesh.ring, args.seq_len)
        ctx = RingCausal(False, make_ring_attention(mesh.ring, causal=True),
                         layout.positions)
        loss_fn, place = layout.loss, layout.place
    step = make_lm_train_step(
        model, opt, scheduler=sched, ctx=ctx, loss_fn=loss_fn,
        state_sharding=transformer_tp_sharding(mesh, model, opt))
    rows, row = mesh.shape["data"], mesh.coords["data"]
    if args.batch_size % rows:
        raise SystemExit(f"--batch_size {args.batch_size} is the global "
                         f"batch: it must divide over {rows} data rows")
    share = args.batch_size // rows
    rng = np.random.default_rng(args.seed)

    def next_batch():
        batch = make_batch(rng, args.batch_size, args.seq_len, args.vocab)
        return place(batch[row * share:(row + 1) * share])

    return model, step, next_batch


def build_mesh(args, device):
    """The ``(data, seq, model)`` mesh of ``args`` over this job."""
    return make_mesh(MeshConfig(data=-1, seq=args.seq_shards,
                                model=args.model_shards),
                     devices=model_devices(args.model_shards, device),
                     device=device)


def _to_device(batch, device):
    if isinstance(batch, tuple):
        return tuple(torch.from_numpy(a).to(device) for a in batch)
    return torch.from_numpy(batch).to(device)


@record
def main(argv=None) -> float:
    """Train; returns the final loss."""
    args = get_args(argv)
    device = resolve_device(args.device)
    ctx = initialize(use_node_rank=args.use_node_rank, device=device)
    args.seed = resolve_shared_seed(args.seed)
    mesh = build_mesh(args, device)
    describe_runtime(ctx, args.seed, mesh.devices[0])
    rank_print(f"mesh={dict(mesh.shape)}")
    model, step, next_batch = build(args, mesh)
    logger = init_metrics(args.project, args.group or "demo_3d_parallel",
                          dry_run=args.dry_run)
    loss = None
    with trace(args.profile_dir):
        for it in range(args.total_iterations):
            loss = step(_to_device(next_batch(), mesh.devices[0]))
            if it % args.log_every == 0:
                logger.log({"loss/lm": float(loss), "iteration": it})
                rank_print(f"iteration {it}: loss/lm {float(loss):.4f}")
    final = float(loss) if loss is not None else float("nan")
    logger.finish()
    rank_print(f"final lm loss: {final:.4f}")
    shutdown()
    return final


if __name__ == "__main__":
    main()
