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
from a saved iteration, with the JAX loop's semantics (the SIGTERM
preemption save of the JAX loop belongs to ROADMAP A8 and is not here).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

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


def finalize_run(states, *, iteration, epoch, ckpt, logger,
                 flush=None) -> None:
    """The run-teardown ordering (``demo.py:130-136``): the final
    checkpoint save (drained), queued metric rows flushed,
    ``logger.finish()``, then the end-of-training barrier."""
    if ckpt is not None:
        ckpt.save(iteration, states, {"iteration": iteration,
                                      "epoch": epoch})
        ckpt.wait_until_finished()
    if flush is not None:
        flush()
    if logger is not None:
        logger.finish()
    barrier("end_of_training")


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
        vals = _fetch(self.config, keys,
                      [torch.stack([p[2][k] for k in keys]) for p in pending],
                      [p[1] for p in pending])
        for row in vals:
            self.logger.log({f"{METRIC_PREFIX}{k}": float(v)
                             for k, v in zip(keys, row)}, commit=True)


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
    if (chunk_step_fn is not None
            and config.device_cache
            and loader.plan.mode == "distributed"
            and loader.plan.samples_per_shard % loader.batch_size == 0
            and loader.dataset.x.nbytes + loader.dataset.y.nbytes
            <= config.device_cache_max_bytes):
        return _run_scanned(states, chunk_step_fn, loader, device, logger,
                            config, ckpt, start_iteration)
    x_dev, y_dev = _placement(device)
    pbar = _make_pbar(config, initial=start_iteration)
    deferred = _DeferredMetrics(logger, config) if logger is not None \
        else None
    batches_per_epoch = len(loader)
    epoch = start_iteration // batches_per_epoch
    iteration = epoch * batches_per_epoch
    skip = start_iteration - iteration
    last, bs = None, loader.batch_size  # the last step's losses and batch
    while iteration < config.total_iterations:
        loader.set_epoch(epoch)
        iteration += skip
        for x, y in loader.iter_from(skip):
            if iteration >= config.total_iterations:
                break
            bs = x.shape[0]
            states, losses = step_fn(states, *shard_batch((x,), x_dev),
                                     *shard_batch((y,), y_dev))
            last = losses
            if deferred is not None and iteration % config.log_every == 0:
                deferred.add(iteration, bs, losses)
            iteration += 1
            if ckpt is not None:
                ckpt.maybe_save(iteration, states,
                                {"iteration": iteration, "epoch": epoch})
            if pbar is not None:
                pbar.update(1)
        skip = 0
        epoch += 1
    if pbar is not None:
        pbar.close()
    finalize_run(states, iteration=iteration, epoch=epoch, ckpt=ckpt,
                 logger=logger,
                 flush=deferred.flush if deferred is not None else None)
    return states, _final_losses(config, last, bs)


def _run_scanned(states, chunk_step_fn, loader, device, logger, config,
                 ckpt, start_iteration):
    """The device-cached loop (see :func:`run_training`).

    The per-epoch global permutation is derived on the host as the
    per-step path derives it: global batch ``t`` of epoch ``e`` is the
    concatenation of every shard's ``t``-th batch, so the scanned step's
    rank ``r`` takes exactly its shard's batch from each index row."""
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
    while iteration < total:
        # a window ends at the sync cadence, a save boundary or the budget
        k = min(max(1, config.sync_every), total - iteration)
        if save_every > 0:
            k = min(k, save_every - iteration % save_every)
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
        idx = torch.from_numpy(np.stack(idx_rows).astype(np.int64)).to(x_dev)
        states, losses = chunk_step_fn(states, x_all, y_all, idx)
        last = losses
        if logger is not None:
            pending.append((iteration, losses))
            if len(pending) * k >= config.sync_every:
                _flush_scanned(pending, B, logger, config)
                pending = []
        iteration += len(idx_rows)
        if ckpt is not None:
            ckpt.maybe_save(iteration, states,
                            {"iteration": iteration, "epoch": epoch})
        if pbar is not None:
            pbar.update(len(idx_rows))
    if pbar is not None:
        pbar.close()
    finalize_run(states, iteration=iteration, epoch=epoch, ckpt=ckpt,
                 logger=logger,
                 flush=(lambda: _flush_scanned(pending, B, logger, config))
                 if logger is not None else None)
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
    vals = _fetch(config, keys, windows, [batch_size] * len(its))
    for it, row in zip(its, vals):
        if it % config.log_every == 0:
            logger.log({f"{METRIC_PREFIX}{k}": float(v)
                        for k, v in zip(keys, row)}, commit=True)
