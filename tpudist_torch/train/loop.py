"""The training loop of the toy path — the counterpart of
:mod:`tpudist.train.loop`.

Shape parity with ``training_demo`` (``demo.py:75-137``): a fixed iteration
budget spread over epochs, per-epoch ``set_epoch`` reshuffle
(``demo.py:96-98``), two models stepped per iteration, rank-0 tqdm
(``demo.py:91-92``), per-iteration global batch-weighted loss logging
(``demo.py:113-121``), and the teardown ordering — metrics finished
*before* the end barrier (``demo.py:130-136``).

As in the JAX loop the step returns device scalars and the host fetches
them once per ``sync_every`` iterations, in one transfer, keeping one log
row per iteration; with :attr:`MetricBackend.HOST` the fetched per-rank
losses are reduced on the host group then.  Two paths, chosen as the JAX
loop chooses (:func:`run_training`): a per-step loop over the loader, and
the device-cached path, where the dataset sits on the device and one call
of the scanned step runs a window of iterations from an uploaded index
window.  Both save through a checkpoint manager on its cadence and resume
from a saved iteration, with the JAX loop's semantics.

The runtime seams are the JAX loop's too: a SIGTERM (the preemption
handler, :mod:`tpudist_torch.runtime.preemption`) ends the run at the next
sync boundary with a forced save stamped ``preempted``; the hang watchdog
(``TPUDIST_WATCHDOG_S``) is petted after every step or window; the
``TPUDIST_FAULT`` grammar injects at every step; and the telemetry session
records ``compile``/``step``/``data_wait``/``metric_flush`` spans and the
train gauges.  CUDA runs ahead of the host, so a ``step`` span here
measures the dispatch of the step's kernels, plus whatever wait the
launch queue imposed; the first step (``compile``) blocks on its result,
and the ``metric_flush`` span absorbs the device time the dispatch ran
ahead of.  :func:`after_step` and :func:`save_point` are the step
bracket these loops and the Trainer's LM loop share.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpudist_torch import telemetry
from tpudist_torch.comm.collectives import (MetricBackend, barrier,
                                            host_allreduce_sum)
from tpudist_torch.data.loader import ShardedLoader, shard_batch
from tpudist_torch.data.sharding import epoch_indices
from tpudist_torch.runtime.bootstrap import process_index
from tpudist_torch.runtime.mesh import Mesh
from tpudist_torch.train.step import ModelState
from tpudist_torch.utils.metrics import MetricsLogger

#: the metric name of a model's loss in a log row is this prefix + its name
METRIC_PREFIX = "loss/"


@dataclasses.dataclass
class TrainLoopConfig:
    total_iterations: int = 1000  # demo.py:88
    log_every: int = 1
    metric_backend: MetricBackend = MetricBackend.ICI
    progress_bar: bool = True
    # Device→host syncs are batched: losses are fetched (and, for the HOST
    # backend, reduced across processes) once per ``sync_every`` iterations;
    # log rows stay per iteration.  On the device-cached path it is also
    # the window length of one scanned-step call.
    sync_every: int = 256
    # Device-cached path: opt-out plus a device-memory cap on the dataset,
    # which every process holds whole.
    device_cache: bool = True
    device_cache_max_bytes: int = 256 * 1024 * 1024
    # Preemption-safe shutdown: when a SIGTERM arrived and a checkpoint
    # manager is active, save at the next sync boundary (all processes
    # agree on it over the host group) and return early.
    preempt_save: bool = True
    # Hang watchdog (tpudist_torch.runtime.watchdog): exit 124 with every
    # thread's stack in the crash record when no iteration or window
    # completes within this deadline.  None = TPUDIST_WATCHDOG_S (unset =
    # off); the first deadline gets 10x slack for the first step's build.
    watchdog_timeout_s: Optional[float] = None


def _preemption_check() -> bool:
    from tpudist_torch.runtime import preemption

    return preemption.check_all()


@contextlib.contextmanager
def preemption_scope(enabled: bool):
    """Per-run preemption bracket, shared by every training loop (the
    per-step and device-cached paths here, the Trainer's LM loop): clear
    the sticky per-run record unconditionally — a later run without
    checkpointing must not inherit an earlier run's preempted status —
    install the SIGTERM handler when ``enabled``, and ALWAYS restore the
    process-wide handler on exit (a library must not leave one behind)."""
    from tpudist_torch.runtime import preemption

    preemption.clear_last_run_preempted()
    installed = False
    if enabled:
        # Off the main thread install() degrades to a warned no-op (False).
        installed = preemption.install()
    try:
        yield
    finally:
        if installed:
            preemption.reset()


def finalize_run(states, *, iteration, epoch, ckpt, logger, flush=None,
                 preempted: bool = False,
                 own_telemetry: bool = True) -> None:
    """The run-teardown ordering CONTRACT (shared by every loop; parity
    with ``demo.py:130-136`` — metrics finish before the end barrier):

    1. final checkpoint save — forced on preemption, because the boundary
       may coincide with a cadence save whose meta lacks the stamp;
    2. sticky preempted note (survives the handler reset in
       :func:`preemption_scope`);
    3. queued metric rows flushed (``flush``), then ``logger.finish()``;
    4. the end-of-training barrier;
    5. the telemetry session finished — rank 0 merges every rank's and
       generation's JSONL into ``report.json``/``report.md`` — but ONLY
       when this loop started the session (``own_telemetry``)."""
    if ckpt is not None:
        ckpt.save(iteration, states,
                  {"iteration": iteration, "epoch": epoch,
                   **({"preempted": True} if preempted else {})},
                  force=preempted)
        ckpt.wait_until_finished()
    if preempted:
        from tpudist_torch.runtime import preemption

        preemption.note_run_preempted()
    if flush is not None:
        flush()
    if logger is not None:
        logger.finish()
    barrier("end_of_training")
    if own_telemetry:
        telemetry.finish()


def _data_wait_iter(source, tele):
    """Yield from ``source``, recording each blocking ``next()`` as a
    ``data_wait`` span — the consumer-side stall the goodput report's
    ``data`` component measures.  Plain passthrough when disarmed.

    Uses the stack-pushing ``span()`` form on purpose: a source that
    records its own ``data_wait`` leaves (the prefetcher) then nests under
    this span instead of double-counting the same stall."""
    if tele is None:
        yield from source
        return
    it = iter(source)
    while True:
        try:
            with tele.span("data_wait"):
                item = next(it)
        except StopIteration:
            return
        yield item


def block_until_ready(tree) -> None:
    """Wait for the device work behind every tensor of ``tree`` (a tensor,
    or dicts/lists/tuples of them): the first step's ``compile`` span
    measures the work, not its asynchronous dispatch."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            block_until_ready(t)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        torch.cuda.synchronize(tree.device)


def after_step(tele, wd, t0, first: bool, out, *, sync: bool = False,
               tags=None) -> None:
    """Close one step (or window) of a loop: its ``compile`` span when it
    is the first, blocked on ``out`` so that the span measures the build
    and not the dispatch; else its ``step`` span, blocked on ``out`` only
    with ``sync`` (where the caller fetches ``out`` next anyway).  Then
    pet the watchdog: after the step, so that the first pet lands past the
    first step's build, which the first deadline's slack covers."""
    if tele is not None:
        if first or sync:
            block_until_ready(out)
        tele.record_span("compile" if first else "step", t0,
                         time.monotonic() - t0, tags)
    if wd is not None:
        wd.pet()


def save_point(ckpt, wd, iteration: int, states, meta: dict) -> None:
    """The checkpoint cadence after a step, then a pet: a save making I/O
    progress is not a hang."""
    ckpt.maybe_save(iteration, states, meta)
    if wd is not None:
        wd.pet()


def start_run(config: TrainLoopConfig, *, name: str = "train_loop"):
    """The run's start-up, shared by every loop: the fault grammar armed
    from ``TPUDIST_FAULT``, the telemetry session started (``owns`` says
    whether this loop started it, and so finishes it), the scrape
    endpoint started (``TPUDIST_METRICS_PORT``), and the watchdog built
    (not started; None when off).  Returns ``(owns, watchdog)``."""
    from tpudist_torch.runtime import faults, watchdog
    from tpudist_torch.telemetry import statusz

    faults.arm_from_env()
    # a pre-existing session belongs to the caller: record into it, never
    # finish it
    owns = telemetry.active() is None
    telemetry.ensure_started()
    statusz.ensure_started()
    wd = watchdog.from_config(
        config.watchdog_timeout_s, name=name,
        first_deadline_s=(config.watchdog_timeout_s or
                          watchdog.timeout_from_env() or 0.0) * 10)
    return owns, wd


def _make_pbar(config: TrainLoopConfig, initial: int = 0):
    if not config.progress_bar or process_index() != 0:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=config.total_iterations, desc="train", initial=initial)


def _host_means(vals: np.ndarray, batch_sizes: np.ndarray) -> np.ndarray:
    """Global batch-weighted means ``Σ v·bs / Σ bs`` over the host group of
    per-rank means ``vals [rows, keys]`` with ``batch_sizes [rows]``."""
    weights = np.repeat(batch_sizes.astype(np.float64)[:, None],
                        vals.shape[1], axis=1)
    num, den = host_allreduce_sum((vals.astype(np.float64) * weights,
                                   weights))
    return num / den


def _fetch(config: TrainLoopConfig, keys, rows, batch_sizes) -> np.ndarray:
    """One device→host transfer of ``rows`` (each a ``[keys]`` or ``[keys,
    K]`` tensor), as ``[iterations, keys]`` global means."""
    vals = torch.cat([r.reshape(len(keys), -1) for r in rows],
                     dim=1).T.double().cpu().numpy()
    if config.metric_backend == MetricBackend.HOST:
        vals = _host_means(vals, np.asarray(batch_sizes))
    return vals


class _DeferredMetrics:
    """Collects per-iteration device losses; flushes them to the logger in
    batches — one blocking transfer per ``sync_every`` steps."""

    def __init__(self, logger, config: TrainLoopConfig):
        self.logger = logger
        self.config = config
        self._pending = []  # (iteration, batch_size, {name: device scalar})

    def add(self, iteration: int, batch_size: int, losses) -> None:
        self._pending.append((iteration, batch_size, losses))
        if len(self._pending) >= max(1, self.config.sync_every):
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        keys = sorted(pending[0][2])
        # one transfer for the whole window; the blocking fetch (which
        # absorbs the device time the dispatch ran ahead of) is its own
        # span so it never reads as idle
        with telemetry.span("metric_flush", rows=len(pending)):
            vals = _fetch(self.config, keys,
                          [torch.stack([p[2][k] for k in keys])
                           for p in pending],
                          [p[1] for p in pending])
        for row in vals:
            self.logger.log({f"{METRIC_PREFIX}{k}": float(v)
                             for k, v in zip(keys, row)}, commit=True)
        # live gauges, once per flush window
        from tpudist_torch.telemetry import metrics

        metrics.set_train_gauges(pending[-1][0], dict(zip(keys,
                                                          map(float,
                                                              vals[-1]))))


def _placement(device):
    """The devices of a batch's inputs and targets: a :class:`Mesh`'s
    replica takes its inputs on its first device and its targets on its
    last (a split model's last stage computes the loss)."""
    if isinstance(device, Mesh):
        return device.devices[0], device.devices[-1]
    return device, device


def _final_losses(config, last, batch_size) -> dict:
    """The last iteration's global means from its device losses (``{}``
    when the run took no step, a resume at the budget)."""
    if last is None:
        return {}
    keys = sorted(last)
    final = _fetch(config, keys, [torch.stack([last[k] for k in keys])],
                   [batch_size])[-1]
    return dict(zip(keys, map(float, final)))


def run_training(states: Dict[str, ModelState], step_fn: Callable,
                 loader: ShardedLoader, device,
                 logger: Optional[MetricsLogger] = None,
                 config: Optional[TrainLoopConfig] = None,
                 chunk_step_fn: Optional[Callable] = None, *,
                 ckpt=None, start_iteration: int = 0):
    """Run to the iteration budget; returns ``(states, final_losses)``
    (the last iteration's global means).

    ``device`` is the process's device, or a
    :class:`~tpudist_torch.runtime.mesh.Mesh` whose replica devices take
    the inputs (first) and the targets (last).  ``ckpt`` (a
    :class:`tpudist_torch.checkpoint.CheckpointManager`) saves on its
    ``save_every`` cadence and once at the end; ``start_iteration`` (from
    the restored meta) resumes: whole epochs are skipped arithmetically
    and the partial epoch by index, so the data continue exactly where the
    saved run left off (``set_epoch`` semantics, ``demo.py:96-98``).

    ``chunk_step_fn`` (from :func:`make_scanned_train_step`) switches to the
    device-cached path when the loader's plan allows it (``distributed``
    mode, whole batches per shard, the dataset under
    ``device_cache_max_bytes``): the dataset is copied to ``device`` once,
    ``sync_every`` iterations run as one call, and only the int64 index
    windows cross to the device.  Numerics and log rows equal the per-step
    path's."""
    config = config or TrainLoopConfig()
    if len(loader) == 0:
        raise ValueError("the loader yields no batch for this process")
    owns, wd = start_run(config)
    with preemption_scope(config.preempt_save and ckpt is not None):
        if wd is not None:
            wd.start()
        try:
            if (chunk_step_fn is not None
                    and config.device_cache
                    and loader.plan.mode == "distributed"
                    and loader.plan.samples_per_shard % loader.batch_size
                    == 0
                    and loader.dataset.x.nbytes + loader.dataset.y.nbytes
                    <= config.device_cache_max_bytes):
                return _run_scanned(states, chunk_step_fn, loader, device,
                                    logger, config, ckpt, start_iteration,
                                    wd, owns)
            return _run_per_step(states, step_fn, loader, device, logger,
                                 config, ckpt, start_iteration, wd, owns)
        finally:
            if wd is not None:
                wd.stop()


def _run_per_step(states, step_fn, loader, device, logger, config, ckpt,
                  start_iteration, wd, own_telemetry):
    """The per-step loop over the loader (see :func:`run_training`)."""
    from tpudist_torch.runtime import faults

    x_dev, y_dev = _placement(device)
    pbar = _make_pbar(config, initial=start_iteration)
    deferred = _DeferredMetrics(logger, config) if logger is not None \
        else None
    batches_per_epoch = len(loader)
    epoch = start_iteration // batches_per_epoch
    iteration = epoch * batches_per_epoch
    skip = start_iteration - iteration
    last, bs = None, loader.batch_size  # the last step's losses and batch
    tele = telemetry.active()
    first_step = True  # the first step builds the kernels: its own span
    preempted = False
    while iteration < config.total_iterations and not preempted:
        loader.set_epoch(epoch)
        iteration += skip
        for x, y in _data_wait_iter(loader.iter_from(skip), tele):
            if iteration >= config.total_iterations:
                break
            faults.inject_step(iteration)  # chaos: kill/sigterm@step
            bs = x.shape[0]
            t0 = time.monotonic() if tele is not None else None
            states, losses = step_fn(states, *shard_batch((x,), x_dev),
                                     *shard_batch((y,), y_dev))
            after_step(tele, wd, t0, first_step, losses)
            first_step = False
            last = losses
            if deferred is not None and iteration % config.log_every == 0:
                deferred.add(iteration, bs, losses)
            iteration += 1
            if ckpt is not None:
                save_point(ckpt, wd, iteration, states,
                           {"iteration": iteration, "epoch": epoch})
            if (config.preempt_save and ckpt is not None
                    and iteration < config.total_iterations
                    and iteration % max(1, config.sync_every) == 0
                    and _preemption_check()):
                preempted = True
                break
            if pbar is not None:
                pbar.update(1)
        skip = 0
        if not preempted:  # the preempted break leaves the epoch open
            epoch += 1
    if pbar is not None:
        pbar.close()
    finalize_run(states, iteration=iteration, epoch=epoch, ckpt=ckpt,
                 logger=logger,
                 flush=deferred.flush if deferred is not None else None,
                 preempted=preempted, own_telemetry=own_telemetry)
    return states, _final_losses(config, last, bs)


def _run_scanned(states, chunk_step_fn, loader, device, logger, config,
                 ckpt, start_iteration, wd=None, own_telemetry=True):
    """The device-cached loop (see :func:`run_training`).

    The per-epoch global permutation is derived on the host as the
    per-step path derives it: global batch ``t`` of epoch ``e`` is the
    concatenation of every shard's ``t``-th batch, so the scanned step's
    rank ``r`` takes exactly its shard's batch from each index row."""
    from tpudist_torch.runtime import faults

    plan = loader.plan
    B = loader.batch_size
    x_dev, y_dev = _placement(device)
    x_all = torch.from_numpy(loader.dataset.x).to(x_dev)
    y_all = torch.from_numpy(loader.dataset.y).to(y_dev)
    shard_plans = [dataclasses.replace(plan, shard_id=i)
                   for i in range(plan.num_shards)]
    batches_per_epoch = plan.samples_per_shard // B

    def global_batches(epoch):
        per_shard = [epoch_indices(p, epoch) for p in shard_plans]
        for t in range(batches_per_epoch):
            yield np.concatenate([s[t * B:(t + 1) * B] for s in per_shard])

    pbar = _make_pbar(config, initial=start_iteration)
    total = config.total_iterations
    save_every = ckpt.config.save_every if ckpt is not None else 0
    iteration = start_iteration
    epoch, batch_in_epoch = divmod(start_iteration, batches_per_epoch)
    gen = None
    pending = []  # (first iteration, {name: [K] device losses})
    last = None
    tele = telemetry.active()
    first_window = True  # the first window builds the kernels
    preempted = False
    while iteration < total:
        faults.inject_step(iteration)  # chaos: kill/sigterm at window edges
        # a window ends at the sync cadence, a save boundary or the budget
        k = min(max(1, config.sync_every), total - iteration)
        if save_every > 0:
            k = min(k, save_every - iteration % save_every)
        t0 = time.monotonic() if tele is not None else None
        idx_rows = []
        while len(idx_rows) < k:
            if gen is None:
                gen = global_batches(epoch)
                for _ in range(batch_in_epoch):
                    next(gen)
                batch_in_epoch = 0
            for row in gen:
                idx_rows.append(row)
                if len(idx_rows) == k:
                    break
            else:
                gen = None
                epoch += 1
        if tele is not None:
            # the host's index-window assembly is this path's data stall
            tele.record_span("data_wait", t0, time.monotonic() - t0)
            t0 = time.monotonic()
        idx = torch.from_numpy(np.stack(idx_rows).astype(np.int64)).to(x_dev)
        states, losses = chunk_step_fn(states, x_all, y_all, idx)
        after_step(tele, wd, t0, first_window, losses,
                   tags={"steps": len(idx_rows)})
        first_window = False
        last = losses
        if logger is not None:
            pending.append((iteration, losses))
            if len(pending) * k >= config.sync_every:
                _flush_scanned(pending, B, logger, config)
                pending = []
        iteration += len(idx_rows)
        if ckpt is not None:
            save_point(ckpt, wd, iteration, states,
                       {"iteration": iteration, "epoch": epoch})
        if pbar is not None:
            pbar.update(len(idx_rows))
        # window edges are this path's all-process preemption boundaries;
        # a signal during the FINAL window is not a preemption
        if (config.preempt_save and ckpt is not None
                and iteration < total and _preemption_check()):
            preempted = True
            break
    if pbar is not None:
        pbar.close()
    finalize_run(states, iteration=iteration, epoch=epoch, ckpt=ckpt,
                 logger=logger,
                 flush=(lambda: _flush_scanned(pending, B, logger, config))
                 if logger is not None else None,
                 preempted=preempted, own_telemetry=own_telemetry)
    return states, _final_losses(
        config, None if last is None else {k: v[-1] for k, v in last.items()},
        B)


def _flush_scanned(pending, batch_size, logger, config):
    """Fetch queued ``[K]`` loss windows in one transfer and log one row per
    iteration (every ``log_every``-th)."""
    if not pending:
        return
    keys = sorted(pending[0][1])
    windows = [torch.stack([w[k] for k in keys]) for _, w in pending]
    its = [first + j for (first, _), w in zip(pending, windows)
           for j in range(w.shape[1])]
    with telemetry.span("metric_flush", rows=len(pending)):
        vals = _fetch(config, keys, windows, [batch_size] * len(its))
    for it, row in zip(its, vals):
        if it % config.log_every == 0:
            logger.log({f"{METRIC_PREFIX}{k}": float(v)
                        for k, v in zip(keys, row)}, commit=True)
    # live gauges, once per flush (the twin of _DeferredMetrics.flush)
    from tpudist_torch.telemetry import metrics

    metrics.set_train_gauges(its[-1], dict(zip(keys, map(float, vals[-1]))))
