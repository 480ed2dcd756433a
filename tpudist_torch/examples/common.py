"""Shared setup of the port's example entry points — the counterpart of
``examples/common.py`` (the reference's demos share
``toy_model_and_data.py`` and ``argument_parser.py`` the same way)."""

from __future__ import annotations

import torch

from tpudist_torch.comm.collectives import MetricBackend
from tpudist_torch.data import ShardPlan, make_loader, make_toy_data
from tpudist_torch.models.toy_mlp import create_toy_model
from tpudist_torch.runtime.bootstrap import process_count, process_index
from tpudist_torch.train import (TrainLoopConfig, build_optimizer_from_args,
                                 init_model_states,
                                 make_multi_model_train_step,
                                 make_scanned_train_step)
from tpudist_torch.utils import init_metrics


def build_two_models(seed: int, device) -> dict:
    """Two independent ToyMLPs trained side by side (``demo.py:22-23``),
    drawn one after the other from one generator seeded with the *base*
    seed, so every process holds the same weights without a broadcast."""
    gen = torch.Generator().manual_seed(seed)
    return {"model_X": create_toy_model(gen, device=device),
            "model_Y": create_toy_model(gen, device=device)}


def build_loader(args, *, seed: int):
    data = make_toy_data(seed=seed)  # same dataset on every process
    plan = ShardPlan(num_samples=len(data), num_shards=process_count(),
                     shard_id=process_index(), shuffle=True, seed=seed,
                     mode=args.dataloader)
    return make_loader(data, args.batch_size, plan,
                       num_workers=args.num_workers)


def build_training(args, device):
    """Models, optimizers (Adam at ``--lr``, ``demo.py:80-81``, plus the
    shared schedule flags), the per-step and scanned steps, the loader and
    the loop config."""
    models = build_two_models(args.seed, device)
    states = init_model_states(
        models, lambda params: build_optimizer_from_args(args, params))
    backend = MetricBackend(args.backend)
    step = make_multi_model_train_step(metric_backend=backend)
    # the device-cached variant: the toy dataset always fits on the card,
    # and run_training takes it when the shard shape allows
    chunk_step = make_scanned_train_step(metric_backend=backend)
    loader = build_loader(args, seed=args.seed)
    loop_cfg = TrainLoopConfig(total_iterations=args.total_iterations,
                               log_every=args.log_every,
                               metric_backend=backend)
    return states, step, loader, loop_cfg, chunk_step


def build_logger(args, default_group: str):
    return init_metrics(project=args.project,
                        group=args.group or default_group,
                        dry_run=args.dry_run)


def check_not_ported(args) -> None:
    """Raise on the shared CLI's flags whose parts are not ported yet."""
    if args.checkpoint_dir or args.checkpoint_every or args.resume:
        raise NotImplementedError(
            "--checkpoint_dir / --checkpoint_every / --resume: the "
            "checkpoint manager is not ported yet (it needs a torch format "
            "of its own): ROADMAP queue A, item 9")
    if args.profile_dir:
        raise NotImplementedError(
            "--profile_dir is not ported yet: ROADMAP queue A, item 7b")
