"""Shared setup of the port's example entry points — the counterpart of
``examples/common.py`` (the reference's demos share
``toy_model_and_data.py`` and ``argument_parser.py`` the same way)."""

from __future__ import annotations

from typing import Optional

import torch

from tpudist_torch.comm.collectives import MetricBackend
from tpudist_torch.data import ShardPlan, make_loader, make_toy_data
from tpudist_torch.models.split_mlp import split_toy_model
from tpudist_torch.models.toy_mlp import create_toy_model
from tpudist_torch.runtime.bootstrap import process_count, process_index
from tpudist_torch.runtime.mesh import Mesh
from tpudist_torch.runtime.rank_logging import rank_print
from tpudist_torch.train import (TrainLoopConfig, build_optimizer_from_args,
                                 init_model_states,
                                 make_multi_model_train_step,
                                 make_scanned_train_step, run_training)
from tpudist_torch.utils import StageTimer, init_metrics, trace


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


def build_training(args, mesh: Mesh, *, split: bool = False):
    """Models, optimizers (Adam at ``--lr``, ``demo.py:80-81``, plus the
    shared schedule flags), the per-step and scanned steps, the loader and
    the loop config.  The models sit on the mesh's replica device, or with
    ``split`` in layer groups over its replica devices
    (``split_toy_model``)."""
    if split:
        models = {k: split_toy_model(m, mesh.devices)
                  for k, m in build_two_models(args.seed, "cpu").items()}
    else:
        models = build_two_models(args.seed, mesh.devices[0])
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


def build_checkpointing(args, states):
    """Checkpoint manager + resume position from the shared CLI contract
    (``--checkpoint_dir/--checkpoint_every/--resume``; dir defaults to the
    reference's ``${scratch_dir}/${exp_name}/checkpoints`` when env-set).

    Returns ``(ckpt_manager_or_None, states, start_iteration)``."""
    from tpudist_torch.checkpoint import (resolve_checkpoint_location,
                                          setup_checkpointing)

    try:
        directory = resolve_checkpoint_location(
            args.checkpoint_dir, save_every=args.checkpoint_every,
            resume=args.resume)
    except ValueError as e:
        raise SystemExit(str(e))
    if directory is None:
        return None, states, 0
    return setup_checkpointing(states, directory,
                               save_every=args.checkpoint_every,
                               resume=args.resume, seed=args.seed)


def train_demo(args, mesh: Mesh, *, group: Optional[str],
               split: bool = False) -> dict:
    """The toy demos' shared body (``examples/demo.py:48-70``): build the
    training under a stage timer, resume from ``--checkpoint_dir`` when
    asked, and train under the ``--profile_dir`` trace; the final losses.
    ``group`` is the metrics group (``--group`` wins); ``None`` logs to
    stdout only (no metrics logger)."""
    stages = StageTimer()
    with stages.phase("build_training"):
        states, step, loader, loop_cfg, chunk_step = build_training(
            args, mesh, split=split)
    logger = build_logger(args, group) if group is not None else None
    with stages.phase("setup_checkpointing"):
        ckpt, states, start = build_checkpointing(args, states)
    rank_print(f"stages: {stages.emit()}")
    with trace(args.profile_dir):
        states, losses = run_training(
            states, step, loader, mesh, logger, loop_cfg, chunk_step,
            ckpt=ckpt, start_iteration=start)
    loader.close()
    if ckpt is not None:
        ckpt.close()
    return losses
