"""The data-parallel train step of the toy path — the counterpart of
:mod:`tpudist.train.step`.

The body of the reference's hot loop (``demo.py:95-129``): forward,
backward and optimizer step for **two independent models per iteration**
(``model_X``/``model_Y``, ``demo.py:100-111``), under data parallelism.
Where the JAX step is one program whose compiler inserts the gradient
all-reduce, here each model is wrapped in ``DistributedDataParallel`` when a
process group is up, as the reference does (``demo.py:70-72``): each rank
steps on its own shard and DDP averages the gradients on the device group.
DDP's average of per-rank mean gradients is the gradient of the global
mean only for equal per-rank batches, which the loader gives (the JAX
package assumes the same, ``demo.py:113``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from tpudist_torch.comm.collectives import MetricBackend, psum_tree


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean-squared error (``nn.MSELoss`` in the reference, ``demo.py:80``)."""
    return torch.mean(torch.square(pred - target))


@dataclasses.dataclass
class ModelState:
    """One model's training state: the module, the replica the step calls
    (its ``DistributedDataParallel`` wrapper when a process group is up,
    else the module) and its optimizer with its optional scheduler."""

    model: nn.Module
    replica: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None


def ddp_device_ids(model: nn.Module):
    """DDP's ``device_ids`` for ``model``: its one CUDA device, or ``None``
    for a CPU module and for one whose parameters span several devices
    (``demo_one_model_multi_gpu.py:96-98``)."""
    devs = {p.device for p in model.parameters()}
    if len(devs) == 1:
        (dev,) = devs
        if dev.type == "cuda":
            return [dev]
    return None


def init_model_states(models: Mapping[str, nn.Module], tx: Callable, *,
                      wrap: Optional[Callable[[nn.Module], nn.Module]] = None
                      ) -> Dict[str, ModelState]:
    """``models`` maps name → module; ``tx(params) -> (optimizer,
    scheduler or None)`` builds each model's optimizer (e.g. ``lambda p:
    build_optimizer_from_args(args, p)``).  ``wrap(module)``, when given,
    is what the step calls in place of the module (a cast around it, whose
    parameters are the module's).  Wraps each replica in DDP when
    ``torch.distributed`` is initialized."""
    import torch.distributed as dist

    states = {}
    for name, model in models.items():
        replica = wrap(model) if wrap is not None else model
        if dist.is_initialized():
            replica = nn.parallel.DistributedDataParallel(
                replica, device_ids=ddp_device_ids(model))
        opt, sched = tx(model.parameters())
        states[name] = ModelState(model, replica, opt, sched)
    return states


def _update(state: ModelState, loss_fn: Callable, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """One forward, backward and optimizer step; the detached loss."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.replica(x), y)
    loss.backward()
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    return loss.detach()


def _global_means(local: Dict[str, torch.Tensor], batch_size: int,
                  backend: MetricBackend) -> Dict[str, torch.Tensor]:
    """The global batch-weighted means ``Σ loss·bs / Σ bs`` of the local
    losses, all-reduced on the device group (queued on the device, no host
    sync); the local losses as they are with ``HOST`` (the loop reduces
    them on the host group) or without a process group."""
    import torch.distributed as dist

    if backend != MetricBackend.ICI or not dist.is_initialized():
        return local
    names = list(local)
    num = torch.stack([local[n] for n in names]) * batch_size
    buf = torch.stack([num, torch.full_like(num, batch_size)])
    psum_tree([buf])
    means = buf[0] / buf[1]
    return {n: means[i] for i, n in enumerate(names)}


def make_multi_model_train_step(loss_fn: Callable = mse_loss, *,
                                metric_backend: MetricBackend =
                                MetricBackend.ICI):
    """``step(states, x, y) -> (states, losses)``: one update of every model
    on this rank's batch (states updated in place); ``losses`` maps name →
    a device scalar, the global batch-weighted mean on the device group
    with ``ICI`` (the reference's cross-rank loss average,
    ``demo.py:114-121``), this rank's mean with ``HOST``."""

    def step(states: Dict[str, ModelState], x: torch.Tensor,
             y: torch.Tensor):
        local = {name: _update(st, loss_fn, x, y)
                 for name, st in states.items()}
        return states, _global_means(local, x.shape[0], metric_backend)

    return step


def make_scanned_train_step(loss_fn: Callable = mse_loss, *,
                            metric_backend: MetricBackend =
                            MetricBackend.ICI):
    """The device-cached variant of the step, for datasets held on the
    device: ``chunk_step(states, x_all, y_all, idx) -> (states, losses)``
    with ``idx [K, global_batch]`` int64 on the device — K consecutive
    iterations' global batch indices, rank ``r`` of ``n`` taking columns
    ``[r·B, (r+1)·B)``, ``B = global_batch / n`` (its shard's batch in the
    global layout of ``train.loop``).  ``losses`` maps name → a ``[K]``
    tensor, reduced once a window as the per-step path reduces each step,
    so the host fetches it once.  The updates are those of the per-step
    path on the same batches, bit for bit."""
    from tpudist_torch.runtime.bootstrap import process_count, process_index

    def chunk_step(states: Dict[str, ModelState], x_all: torch.Tensor,
                   y_all: torch.Tensor, idx: torch.Tensor):
        n, r = process_count(), process_index()
        if idx.dim() != 2 or idx.shape[1] % n:
            raise ValueError(f"idx must be [K, global_batch] with the batch "
                             f"a multiple of {n} ranks, got "
                             f"{tuple(idx.shape)}")
        b = idx.shape[1] // n
        mine = idx[:, r * b:(r + 1) * b]
        # a split model takes its inputs on its first device and its
        # targets on its last: each is gathered where it lies
        mx, my = mine.to(x_all.device), mine.to(y_all.device)
        rows = {name: [] for name in states}
        for t in range(idx.shape[0]):
            xb, yb = x_all[mx[t]], y_all[my[t]]
            for name, st in states.items():
                rows[name].append(_update(st, loss_fn, xb, yb))
        local = {name: torch.stack(v) for name, v in rows.items()}
        return states, _global_means(local, b, metric_backend)

    return chunk_step
