"""The high-level Trainer facade — the counterpart of
``examples/demo_trainer.py`` (the reference's
``demo_pytorch_lightning.py``, SURVEY.md §3.4).

The user module holds two toy models, per-model Adam optimizers and an
MSE loss; the Trainer owns the loop, devices, logging, checkpoints and
teardown.  The reference's Lightning shape (1000 steps, batch 128,
precision 32, ``demo_pytorch_lightning.py:48,50,58``) is the default;
``--precision bf16`` computes in bf16 over f32 masters.  The parser is the
JAX demo's; ``--strategy fsdp|zero1|pp`` (the LM module under sharded or
pipelined layouts) raises: ROADMAP A6 item 6b and A6c.

  python -m tpudist_torch.examples.demo_trainer --dry_run

Metrics go to ``runs/demo_trainer/metrics.jsonl``; ``--checkpoint_dir``,
``--checkpoint_every``, ``--resume`` and ``--profile_dir`` as in
``python -m tpudist_torch.examples.demo``.
"""

from __future__ import annotations

import functools

from tpudist_torch.comm.collectives import MetricBackend
from tpudist_torch.config import build_parser
from tpudist_torch.config import get_args as parse_args
from tpudist_torch.examples.common import build_loader, check_not_ported
from tpudist_torch.models.toy_mlp import create_toy_model
from tpudist_torch.models.transformer import resolve_device
from tpudist_torch.runtime import initialize, resolve_shared_seed
from tpudist_torch.trainer import Trainer, TrainerModule
from tpudist_torch.train.optim import build_optimizer
from tpudist_torch.utils import record, trace


class ToyTrainerModule(TrainerModule):
    """Two models + two Adams, the ``LitToyModel`` analog
    (``demo_pytorch_lightning.py:16-40``)."""

    def configure_models(self, generator):
        return {"model_X": create_toy_model(generator, device="cpu"),
                "model_Y": create_toy_model(generator, device="cpu")}

    def configure_optimizers(self):
        adam = functools.partial(build_optimizer, lr=1e-3)
        return {"model_X": adam, "model_Y": adam}


def get_args(argv=None):
    p = build_parser()
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                   help="bf16 = fp32 master weights, bf16 compute "
                        "(the Lightning precision= analog)")
    p.add_argument("--strategy", default="dp",
                   choices=["dp", "dp_model", "fsdp", "zero1", "pp"],
                   help="the Lightning strategy= analog, opened to the "
                        "full layout set (fsdp/zero1/pp run the LM module)")
    p.add_argument("--stages", default=2, type=int,
                   help="pipeline stage count (strategy=pp)")
    p.add_argument("--pp_schedule", default="1f1b",
                   choices=["gpipe", "1f1b", "interleaved"])
    p.add_argument("--seq_len", default=32, type=int)
    p.add_argument("--vocab", default=32, type=int)
    p.add_argument("--d_model", default=64, type=int)
    p.add_argument("--n_layers", default=4, type=int)
    p.set_defaults(batch_size=128)  # lightning variant: batch 128 (:50)
    return parse_args(argv, parser=p)


@record
def main(argv=None) -> dict:
    args = get_args(argv)
    check_not_ported(args)
    if args.strategy in ("fsdp", "zero1", "pp"):
        raise NotImplementedError(
            f"--strategy {args.strategy} trains the LM module (the "
            "Trainer's LM path, ROADMAP queue A item 6b) under a sharded or "
            "pipelined layout (item A6c): not ported yet")
    device = resolve_device(args.device)
    # initialize() is idempotent — Trainer.fit will reuse this context; the
    # seed must be agreed job-wide before the loader's shard plan is built.
    initialize(use_node_rank=args.use_node_rank, device=device)
    args.seed = resolve_shared_seed(args.seed)
    trainer = Trainer(
        max_steps=args.total_iterations,
        strategy=args.strategy,
        precision=args.precision,
        pipeline_stages=args.stages,
        pp_schedule=args.pp_schedule,
        log_every=args.log_every,
        metric_backend=MetricBackend(args.backend),
        project=args.project,
        group=args.group or "demo_trainer",
        dry_run=args.dry_run,
        seed=args.seed,
        use_node_rank=args.use_node_rank,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        device=args.device,
    )
    loader = build_loader(args, seed=args.seed)
    with trace(args.profile_dir):
        losses = trainer.fit(ToyTrainerModule(), loader)
    loader.close()
    print(f"final losses: {losses}", flush=True)
    trainer.teardown()
    return losses


if __name__ == "__main__":
    main()
