"""High-level Trainer facade — the counterpart of
:mod:`tpudist.trainer.trainer`, parity with PyTorch Lightning as the
reference uses it (``demo_pytorch_lightning.py``, SURVEY.md §3.4).

The reference's ``LitToyModel`` holds two models (``:16-25``), sums their
MSE losses in ``training_step`` (``:27-33``) and returns one Adam per model
from ``configure_optimizers`` (``:35-40``); ``pl.Trainer(gpus, num_nodes,
strategy='ddp', precision=32)`` owns the loop, device placement and
distributed wiring (``:57-60``).  Here the user supplies a
:class:`TrainerModule` (models, optimizers, loss) and the :class:`Trainer`
owns the runtime, the mesh, the steps, logging, checkpoints and teardown.
``strategy``:

- ``'dp'``       the ``data`` mesh, a full replica a rank under DDP
  (≅ ``strategy='ddp'``);
- ``'dp_model'`` the ``('data', 'model')`` mesh: each rank owns
  ``model_parallel`` devices and :meth:`TrainerModule.place_model` puts
  the model on them (by default whole on the first);
- ``'fsdp'``     the ``data`` mesh, parameters and optimizer state
  sharded over it (ZeRO-3, :func:`tpudist_torch.parallel.fsdp_sharding`,
  leaves under ``shard_min_size`` elements replicated);
- ``'zero1'``    the ``data`` mesh, parameters replicated and the
  optimizer state sharded (:func:`tpudist_torch.parallel.zero1_sharding`);
- ``'pp'``       the ``('data', 'stage')`` mesh: the LM's blocks split
  over ``pipeline_stages`` stages (:func:`tpudist_torch.parallel.
  make_pp_lm_train_step`, schedule ``pp_schedule``, ``pp_chunks`` chunks a
  stage when interleaved, ``microbatches`` a step); an
  :class:`LMTrainerModule` only, fp32 only, as in JAX;
- ``'auto'`` is not ported yet (A8, ``plan/``).

Under ``'fsdp'`` and ``'zero1'`` :mod:`tpudist_torch.parallel.zero`
carries the layout out in place of DDP; checkpoints hold the whole,
gathered state (a run saved under one strategy resumes under another), and
``final_states`` holds the models with their whole weights.

An :class:`LMTrainerModule` (one transformer, token batches) trains under
``'dp'``, ``'fsdp'``, ``'zero1'`` and ``'pp'`` through the LM step
(:func:`tpudist_torch.train.lm.make_lm_train_step`), with checkpoints and
resume by skipping batches.

Both paths carry the JAX facade's SIGTERM preemption save: with a
checkpoint directory, a SIGTERM ends the fit at the next boundary with a
forced save stamped ``preempted`` and :attr:`Trainer.preempted` set (rerun
with ``resume=True`` to continue), and both record into the telemetry
session (:mod:`tpudist_torch.telemetry`).  The LM loop also takes the toy
loop's ``TPUDIST_FAULT`` step seam (after each step, so ``sigterm@step:K``
stops it at step ``K``) and its hang watchdog (``TPUDIST_WATCHDOG_S``).
Its ``step`` span of a logged step (every step at ``log_every=1``) ends
when the loss that the row fetches is ready, so it reads the card's time
of the step, not the dispatch of its kernels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from tpudist_torch.comm.collectives import MetricBackend
from tpudist_torch.runtime.bootstrap import initialize, shutdown
from tpudist_torch.runtime.mesh import data_model_mesh, data_parallel_mesh
from tpudist_torch.runtime.seeding import resolve_shared_seed
from tpudist_torch.train.loop import (TrainLoopConfig, _make_pbar,
                                      finalize_run, run_training)
from tpudist_torch.train.optim import build_optimizer
from tpudist_torch.train.step import (ModelState, init_model_states,
                                      make_multi_model_train_step,
                                      make_scanned_train_step, mse_loss)
from tpudist_torch.utils.metrics import init_metrics

_SHARDED = ("fsdp", "zero1")


def _cast_floats(x, dtype):
    """Cast a float tensor; integer inputs (token ids) pass through."""
    return x.to(dtype) if torch.is_floating_point(x) else x


class BF16Apply(nn.Module):
    """Mixed precision as the JAX facade's ``_bf16_apply``: f32 master
    weights, bf16 compute — the parameters and float inputs are cast to
    bf16 at apply time and the output back to f32, so the gradients reach
    the f32 masters through the casts.  Not ``torch.autocast``, whose
    per-op policy computes something else.  ``compute_dtype`` tells a
    sharded step (:mod:`tpudist_torch.parallel.zero`) to apply the same
    casts itself."""

    compute_dtype = torch.bfloat16

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {n: _cast_floats(p, torch.bfloat16)
                  for n, p in self.module.named_parameters()}
        out = functional_call(self.module, params,
                              (_cast_floats(x, torch.bfloat16),))
        return _cast_floats(out, torch.float32)


class TrainerModule:
    """Subclass and override; the Lightning-``LightningModule`` analog."""

    def configure_models(self, generator: torch.Generator
                         ) -> Dict[str, nn.Module]:
        """Return name → ``nn.Module``, drawn from ``generator``.  Called
        once on every process with a generator seeded by the job's seed
        (replicated init without broadcast)."""
        raise NotImplementedError

    def configure_optimizers(self):
        """Return one optimizer factory ``params -> (optimizer, scheduler
        or None)``, or a per-model dict of them — the
        ``configure_optimizers`` returning a list of Adams analog
        (``demo_pytorch_lightning.py:35-40``);
        :func:`tpudist_torch.train.build_optimizer` builds one with a
        schedule."""
        return functools.partial(build_optimizer, lr=1e-3)

    def loss(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Per-model loss, logged per model (the reference's
        ``training_step`` sums loss_X + loss_Y, ``:27-33``)."""
        return mse_loss(pred, target)

    def place_model(self, mesh, model: nn.Module) -> nn.Module:
        """Where a model lives under ``strategy='dp_model'`` (and ``'dp'``):
        by default whole on the replica's first device, as the JAX facade
        replicates when its ``state_sharding`` hook returns ``None``; a
        module may split it over ``mesh.devices``
        (:func:`tpudist_torch.models.split_mlp.split_toy_model`)."""
        return model.to(mesh.devices[0])


class LMTrainerModule(TrainerModule):
    """Trainer module for the LM family: ONE language model from
    :meth:`configure_lm`; the loader passed to ``fit`` yields ``[batch,
    seq]`` int32 token arrays (re-iterated per epoch; an optional
    ``set_epoch(e)`` hook gets the ``DistributedSampler.set_epoch`` call,
    ``demo.py:96-98``).  Under several ranks each yielded batch is the
    global batch, the same on every rank, and each rank trains on its
    contiguous rows."""

    def configure_lm(self, generator: torch.Generator) -> nn.Module:
        """Return the ``nn.Module`` (e.g. a :func:`tpudist_torch.models.
        create_transformer`), drawn from ``generator``; called once on every
        process with the same seed (replicated init)."""
        raise NotImplementedError

    def configure_optimizers(self):
        """One optimizer factory ``params -> (optimizer, scheduler or
        None)`` (the LM path has a single model, so a per-model dict is
        refused)."""
        return functools.partial(build_optimizer, lr=1e-3)

    def loss(self, logits: torch.Tensor, tokens: torch.Tensor
             ) -> torch.Tensor:
        """Next-token loss of ``model(tokens) -> logits``."""
        from tpudist_torch.models.transformer import lm_loss

        return lm_loss(logits, tokens)


@dataclasses.dataclass
class Trainer:
    max_steps: int = 1000  # demo_pytorch_lightning.py:48 (1000 steps)
    # 'dp' | 'dp_model' | 'fsdp' | 'zero1' | 'pp' (ported) | 'auto' (A8,
    # plan/)
    strategy: str = "dp"
    model_parallel: int = 2
    # fsdp/zero1: leaves under this many elements stay replicated (the
    # gather overhead beats the memory win for small tensors)
    shard_min_size: int = 1024
    # pp: stage-axis size, schedule ('gpipe' | '1f1b' | 'interleaved'),
    # virtual chunks a stage (interleaved only), microbatches a step
    # (default stages, or 2*stages for interleaved)
    pipeline_stages: int = 2
    pp_schedule: str = "1f1b"
    pp_chunks: int = 2
    microbatches: Optional[int] = None
    precision: str = "fp32"  # 'fp32' (reference precision=32) | 'bf16'
    log_every: int = 1
    metric_backend: MetricBackend = MetricBackend.ICI
    project: str = "tpudist"
    group: Optional[str] = None
    dry_run: bool = False
    seed: Optional[int] = 0  # None → rank-0 draw broadcast job-wide
    use_node_rank: bool = False
    progress_bar: bool = True
    # Checkpointing (the demos' --checkpoint_dir/--checkpoint_every/--resume
    # contract, reference dir layout job_submitter.sh:157-159): a directory
    # enables periodic saves; resume=True restores the latest step and
    # continues the loop from its saved iteration.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    device: str = "cuda"  # 'cuda' (raises without CUDA) or 'cpu'
    #: set by :meth:`fit`: True when a SIGTERM ended the fit early with a
    #: preemption save (the fit is incomplete); a plain attribute, as in
    #: JAX, not a field
    preempted = False

    def _check_ported(self, module) -> None:
        if self.strategy == "auto":
            raise NotImplementedError(
                "strategy='auto' (the measurement-driven planner, plan/) is "
                "not ported yet: ROADMAP queue A, item A8")
        if self.strategy not in ("dp", "dp_model", "pp") + _SHARDED:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"unknown precision {self.precision!r}")

    def fit(self, module: TrainerModule, loader) -> Dict[str, float]:
        """Own the whole run: init runtime, build mesh + steps, train,
        save.  Returns the final per-model losses; the trained states are
        on ``self.final_states``."""
        from tpudist_torch.checkpoint import (resolve_checkpoint_location,
                                              setup_checkpointing)
        from tpudist_torch.models.transformer import resolve_device

        # Resolve (and validate resume config) before any runtime side
        # effects — same env-contract resolution as the plain demos.
        ckpt_dir = resolve_checkpoint_location(
            self.checkpoint_dir, save_every=self.checkpoint_every,
            resume=self.resume,
        )
        self._check_ported(module)
        device = resolve_device(self.device)
        initialize(use_node_rank=self.use_node_rank, device=device)
        seed = resolve_shared_seed(self.seed)
        if isinstance(module, LMTrainerModule):
            return self._fit_lm(module, loader, ckpt_dir, seed, device)
        if self.strategy == "pp":
            raise ValueError(
                "strategy='pp' needs an LMTrainerModule (transformer "
                "blocks shard over pipeline stages; the multi-model toy "
                "contract has no block stack)")
        if self.strategy == "dp_model":
            mesh = data_model_mesh(self.model_parallel, device=device)
        else:
            mesh = data_parallel_mesh(device=device)

        models = module.configure_models(torch.Generator().manual_seed(seed))
        models = {k: module.place_model(mesh, m) for k, m in models.items()}
        tx = module.configure_optimizers()
        wrap = BF16Apply if self.precision == "bf16" else None
        states = {}
        for name, model in models.items():
            factory = tx[name] if isinstance(tx, dict) else tx
            if self.strategy in _SHARDED:
                states[name] = self._sharded_state(mesh, model, factory,
                                                   wrap)
            else:
                states.update(init_model_states({name: model}, factory,
                                                wrap=wrap))
        step = make_multi_model_train_step(
            module.loss, metric_backend=self.metric_backend)
        chunk_step = make_scanned_train_step(
            module.loss, metric_backend=self.metric_backend)

        ckpt = None
        start_iteration = 0
        if ckpt_dir is not None:
            ckpt, states, start_iteration = setup_checkpointing(
                states, ckpt_dir, save_every=self.checkpoint_every,
                resume=self.resume, seed=seed)
        logger = init_metrics(project=self.project,
                              group=self.group or "trainer",
                              dry_run=self.dry_run)
        cfg = TrainLoopConfig(total_iterations=self.max_steps,
                              log_every=self.log_every,
                              metric_backend=self.metric_backend,
                              progress_bar=self.progress_bar)
        try:
            states, losses = run_training(
                states, step, loader, mesh, logger, cfg, chunk_step,
                ckpt=ckpt, start_iteration=start_iteration)
        finally:
            if ckpt is not None:
                ckpt.close()
        self.final_states = self._whole(states)
        self._note_preempted()
        return losses

    def _note_preempted(self) -> None:
        """A SIGTERM-preempted run checkpointed and exited EARLY — the
        caller must not mistake it for a completed fit."""
        from tpudist_torch.runtime import preemption
        from tpudist_torch.runtime.rank_logging import rank_print

        self.preempted = preemption.last_run_preempted()
        if self.preempted:
            rank_print("[trainer] preempted: checkpoint saved, fit "
                       "incomplete — rerun with resume=True to continue")

    def _sharded_state(self, mesh, model, factory, wrap) -> ModelState:
        """A toy model's state under ``fsdp``/``zero1``: the optimizer built
        over the whole model, then the layout carried out
        (:func:`tpudist_torch.parallel.zero.shard_state`); the state's
        model and optimizer are the runtime's whole views, its replica the
        runtime."""
        from tpudist_torch.parallel import shard_state

        opt, sched = factory(model.parameters())
        rt = shard_state(model, opt, self._layout(mesh, model, opt),
                         cast=getattr(wrap, "compute_dtype", None))
        return ModelState(rt.model_view, rt, rt.optimizer, sched)

    def _layout(self, mesh, model, opt):
        from tpudist_torch.parallel import fsdp_sharding, zero1_sharding

        rule = fsdp_sharding if self.strategy == "fsdp" else zero1_sharding
        return rule(mesh, model, opt, min_size=self.shard_min_size)

    @staticmethod
    def _whole(states):
        """``states`` with every sharded model put back whole (the
        runtime's gathered weights), for the consumers of full weights."""
        from tpudist_torch.parallel import ShardedRuntime

        from tpudist_torch.parallel import PipelineRuntime

        out = {}
        for name, st in states.items():
            if isinstance(st.replica, (ShardedRuntime, PipelineRuntime)):
                model = st.replica.materialize()
                st = ModelState(model, model, st.optimizer, st.scheduler)
            out[name] = st
        return out

    def _fit_lm(self, module: LMTrainerModule, loader, ckpt_dir, seed,
                device) -> Dict[str, Optional[float]]:
        """The LM-family fit (JAX ``_fit_lm``): one transformer under DDP,
        a sharded layout or the pipeline, the LM step, a token-batch
        loader."""
        from tpudist_torch.checkpoint import setup_checkpointing
        from tpudist_torch.runtime.mesh import MeshConfig, make_mesh
        from tpudist_torch.train.lm import make_lm_train_step

        if self.strategy not in ("dp", "pp") + _SHARDED:
            raise ValueError(
                f"strategy {self.strategy!r} not supported for "
                "LMTrainerModule (use dp/fsdp/zero1/pp; dp_model is the "
                "toy split-MLP layout)")
        if self.strategy == "pp":
            mesh = make_mesh(MeshConfig(data=-1, stage=self.pipeline_stages),
                             device=device)
        else:
            mesh = data_parallel_mesh(device=device)
        model = module.configure_lm(
            torch.Generator().manual_seed(seed)).to(mesh.devices[0])
        tx = module.configure_optimizers()
        if isinstance(tx, dict):
            raise ValueError("LMTrainerModule.configure_optimizers must "
                             "return one optimizer factory (single model)")
        opt, sched = tx(model.parameters())
        if self.strategy == "pp":
            step = self._pp_step(mesh, model, opt, sched)
        else:
            layout = (self._layout(mesh, model, opt)
                      if self.strategy in _SHARDED else None)
            step = make_lm_train_step(
                model, opt, scheduler=sched, loss_fn=module.loss,
                wrap=BF16Apply if self.precision == "bf16" else None,
                state_sharding=layout)
        states = {"lm": ModelState(
            model if step.runtime is None else step.runtime.model_view,
            step.runtime if self.strategy == "pp" else step.replica,
            step.optimizer, sched)}
        ckpt = None
        start_iteration = 0
        if ckpt_dir is not None:
            ckpt, states, start_iteration = setup_checkpointing(
                states, ckpt_dir, save_every=self.checkpoint_every,
                resume=self.resume, seed=seed)
        logger = init_metrics(project=self.project,
                              group=self.group or "trainer",
                              dry_run=self.dry_run)
        try:
            losses = self._run_lm_loop(states, step, loader, mesh, logger,
                                       ckpt, start_iteration)
        finally:
            if ckpt is not None:
                ckpt.close()
        self.final_states = self._whole(states)
        self._note_preempted()
        return losses

    def _pp_step(self, mesh, model, opt, sched):
        """The pipelined LM step of the ``pp`` fields (JAX ``_fit_lm``'s
        ``pp`` branch, with its bf16 refusal)."""
        from tpudist_torch.parallel import make_pp_lm_train_step

        if self.precision == "bf16":
            raise ValueError(
                "strategy='pp' does not support precision='bf16' yet: "
                "the pipeline schedules own their step construction "
                "(tpudist.parallel.pipeline_lm) and the facade's "
                "apply-time cast does not reach it — requesting it "
                "must not silently train fp32")
        interleaved = self.pp_schedule == "interleaved"
        chunks = self.pp_chunks if interleaved else 1
        micro = self.microbatches or self.pipeline_stages * (
            2 if interleaved else 1)
        return make_pp_lm_train_step(
            mesh, model, opt, n_stages=self.pipeline_stages,
            num_microbatches=micro, schedule=self.pp_schedule,
            n_chunks=chunks, scheduler=sched)

    def _run_lm_loop(self, states, step, loader, mesh, logger, ckpt,
                     start_iteration):
        """The token-batch loop (JAX ``_run_lm_loop``): epochs of the
        loader with ``set_epoch``, a resume skipping the saved epoch's
        consumed batches, one ``loss/lm`` row every ``log_every`` steps,
        checkpoints, the preemption check after every step, then the
        shared teardown (:func:`finalize_run`) inside the preemption
        bracket, so a second signal during the forced save finds the
        handler still installed."""
        import time

        import numpy as np

        from tpudist_torch import telemetry
        from tpudist_torch.runtime import faults
        from tpudist_torch.train.loop import (_data_wait_iter,
                                              _preemption_check, after_step,
                                              preemption_scope, save_point,
                                              start_run)

        # each data row trains on its rows (every stage of a pipelined
        # row on the same ones)
        world, rank = mesh.shape["data"], mesh.coords["data"]
        batches = len(loader) if hasattr(loader, "__len__") else None
        if batches is None and start_iteration:
            # without __len__ the epoch boundary of the resume point is
            # unknown: the skip would replay or exhaust the wrong epoch
            raise ValueError(
                f"resume at iteration {start_iteration} requires a sized "
                "loader: the LM loop derives the epoch boundary from "
                "len(loader), which this loader does not provide — wrap it "
                "with a __len__ (e.g. a list or tpudist_torch.data loader) "
                "or restart without resume")
        epoch = start_iteration // batches if batches else 0
        skip = start_iteration - epoch * (batches or 0)
        iteration = start_iteration
        loss = None
        preempted = False
        dev = mesh.devices[0]
        cfg = TrainLoopConfig(total_iterations=self.max_steps,
                              progress_bar=self.progress_bar)
        owns, wd = start_run(cfg, name="lm_loop")
        tele = telemetry.active()
        first_step = True  # the first step builds the kernels: own span
        pbar = _make_pbar(cfg, initial=start_iteration)
        with preemption_scope(ckpt is not None):
            if wd is not None:
                wd.start()
            try:
                while iteration < self.max_steps and not preempted:
                    if hasattr(loader, "set_epoch"):
                        loader.set_epoch(epoch)
                    it = iter(loader)
                    for _ in range(skip):
                        next(it, None)
                    skip = 0
                    advanced = False
                    for tokens in _data_wait_iter(it, tele):
                        advanced = True
                        if iteration >= self.max_steps:
                            break
                        tokens = np.asarray(tokens, dtype=np.int32)
                        if tokens.shape[0] % world:
                            raise ValueError(
                                f"the global batch of {tokens.shape[0]} "
                                f"rows does not divide over {world} data "
                                "rows")
                        share = tokens.shape[0] // world
                        t0 = time.monotonic() if tele is not None else None
                        loss = step(torch.from_numpy(
                            tokens[rank * share:(rank + 1) * share]).to(dev))
                        iteration += 1
                        logged = iteration % max(1, self.log_every) == 0
                        # a logged step's span waits for the loss its row
                        # fetches anyway, so it reads the card's time
                        after_step(tele, wd, t0, first_step, loss,
                                   sync=logged)
                        first_step = False
                        faults.inject_step(iteration)  # after step K
                        # the step's loss is already the global mean:
                        # there is no per-rank value left for a host
                        # reduction to merge
                        if logged:
                            logger.log({"loss/lm": float(loss)},
                                       commit=True)
                        if pbar is not None:
                            pbar.update(1)
                        if ckpt is not None:
                            save_point(ckpt, wd, iteration, states,
                                       {"iteration": iteration,
                                        "epoch": epoch})
                            if (iteration < self.max_steps
                                    and _preemption_check()):
                                preempted = True
                                break
                    if not advanced:
                        raise ValueError("LM loader yielded no batches")
                    if not preempted:
                        epoch += 1
                if pbar is not None:
                    pbar.close()
                finalize_run(states, iteration=iteration, epoch=epoch,
                             ckpt=ckpt, logger=logger, preempted=preempted,
                             own_telemetry=owns)
            finally:
                if wd is not None:
                    wd.stop()
        return {"lm": float(loss) if loss is not None else None}

    @staticmethod
    def teardown():
        shutdown()
