"""The high-level Trainer facade — the counterpart of
``examples/demo_trainer.py`` (the reference's
``demo_pytorch_lightning.py``, SURVEY.md §3.4).

The user module holds two toy models, per-model Adam optimizers and an
MSE loss; the Trainer owns the loop, devices, logging, checkpoints and
teardown.  The reference's Lightning shape (1000 steps, batch 128,
precision 32, ``demo_pytorch_lightning.py:48,50,58``) is the default;
``--precision bf16`` computes in bf16 over f32 masters.  The parser is the
JAX demo's; ``--strategy fsdp|zero1|pp`` trains the LM module
(:class:`ChainLMModule` on :class:`ChainLoader`'s increment chains) under
the sharded layouts — ZeRO-3 and ZeRO-1 over the ``data`` axis
(:mod:`tpudist_torch.parallel.zero`) — or pipelined over ``--stages``
stages with ``--pp_schedule`` (:mod:`tpudist_torch.parallel.pipeline_lm`;
fp32 only, as in JAX).  The LM module also trains under
``Trainer(strategy='dp')``.

  python -m tpudist_torch.examples.demo_trainer --dry_run

Metrics go to ``runs/demo_trainer/metrics.jsonl``; ``--checkpoint_dir``,
``--checkpoint_every``, ``--resume`` and ``--profile_dir`` as in
``python -m tpudist_torch.examples.demo``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpudist_torch.comm.collectives import MetricBackend
from tpudist_torch.config import build_parser
from tpudist_torch.config import get_args as parse_args
from tpudist_torch.examples.common import build_loader
from tpudist_torch.models.toy_mlp import create_toy_model
from tpudist_torch.models.transformer import (create_transformer,
                                              resolve_device)
from tpudist_torch.runtime import initialize, resolve_shared_seed
from tpudist_torch.trainer import LMTrainerModule, Trainer, TrainerModule
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


class ChainLMModule(LMTrainerModule):
    """Small TransformerLM on the increment-chain task — the module the
    transformer strategies drive through the facade (2 heads, d_ff 4 x
    d_model, max_len the sequence)."""

    def __init__(self, args):
        self.args = args

    def configure_lm(self, generator):
        a = self.args
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
        return create_transformer(
            seed, device="cpu", trainable=True, vocab=a.vocab,
            d_model=a.d_model, n_layers=a.n_layers, n_heads=2,
            d_ff=4 * a.d_model, max_len=a.seq_len)

    def configure_optimizers(self):
        return functools.partial(build_optimizer, lr=self.args.lr)


class ChainLoader:
    """Deterministic increment-chain token batches (``set_epoch`` reshuffles
    the chain starts — the ``DistributedSampler`` semantics); the same on
    every rank."""

    def __init__(self, *, batch, seq, vocab, batches_per_epoch=16, seed=0):
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.n, self.seed, self.epoch = batches_per_epoch, seed, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        for _ in range(self.n):
            start = rng.integers(0, self.vocab, size=(self.batch, 1))
            ramp = np.arange(self.seq, dtype=np.int64)[None, :]
            yield ((start + ramp) % self.vocab).astype(np.int32)


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
    if args.strategy in ("fsdp", "zero1", "pp"):
        # the transformer strategies: the LM module on the chain task
        module = ChainLMModule(args)
        loader = ChainLoader(batch=args.batch_size, seq=args.seq_len,
                             vocab=args.vocab, seed=args.seed)
    else:
        module = ToyTrainerModule()
        loader = build_loader(args, seed=args.seed)
    with trace(args.profile_dir):
        losses = trainer.fit(module, loader)
    if hasattr(loader, "close"):
        loader.close()
    print(f"final losses: {losses}", flush=True)
    trainer.teardown()
    return losses


if __name__ == "__main__":
    main()
