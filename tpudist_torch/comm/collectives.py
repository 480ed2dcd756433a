"""Dual-fabric collectives — the counterpart of
:mod:`tpudist.comm.collectives`.

The reference runs two fabrics in one job: the device backend (NCCL) for
DDP's gradient all-reduce, and a second gloo group on the host used only to
all-reduce scalar losses for logging (``demo.py:84,114-121``).  The port
keeps both:

- **device group** — the default ``torch.distributed`` group (NCCL on the
  card, gloo on the CPU): DDP's gradient buckets, and with
  :attr:`MetricBackend.ICI` the train step's loss all-reduce, queued on the
  device without a host sync (:func:`psum_tree` / :func:`pmean_tree`);
- **host group** — the gloo group of ``runtime.initialize``
  (:func:`tpudist_torch.runtime.host_group`): with
  :attr:`MetricBackend.HOST` the loop reduces the fetched per-rank losses
  here (:func:`host_allreduce_sum`), in float64, under the
  ``TPUDIST_HOST_TIMEOUT_S`` deadline.
"""

from __future__ import annotations

import enum
import queue
import threading
from typing import Any, Callable, List, Mapping, Optional

import numpy as np
import torch

from tpudist_torch.runtime.bootstrap import host_group, process_count


class MetricBackend(str, enum.Enum):
    ICI = "ici"    # reduce on the device group inside the step (NCCL)
    HOST = "host"  # reduce on the host gloo group (the reference's Gloo)


class HostFabricTimeout(TimeoutError):
    """A host-fabric collective exceeded its deadline: a peer that died
    unnoticed would otherwise wedge every other process forever."""


_TIMEOUT_ENV = "TPUDIST_HOST_TIMEOUT_S"


def _default_host_timeout() -> Optional[float]:
    from tpudist_torch.utils.envutil import env_positive_float

    return env_positive_float(_TIMEOUT_ENV)


class _DeadlineWorker:
    """One long-lived daemon thread running deadline-guarded host ops in
    order.  A worker whose op wedged past its deadline is abandoned (the
    caller installs a fresh one)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._run,
                                   name="tpudist-host-fabric", daemon=True)
        self._t.start()

    def _run(self):
        while True:
            fn, result, done = self._q.get()
            try:
                result["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in caller
                result["error"] = e
            finally:
                done.set()

    def submit(self, fn):
        result: dict = {}
        done = threading.Event()
        self._q.put((fn, result, done))
        return result, done


_deadline_worker: Optional[_DeadlineWorker] = None
_deadline_lock = threading.Lock()


def _with_deadline(fn: Callable[[], Any], timeout_s: Optional[float],
                   what: str) -> Any:
    """Run ``fn`` under an optional deadline (explicit argument >
    ``TPUDIST_HOST_TIMEOUT_S`` > none).  On expiry the caller gets
    :class:`HostFabricTimeout` and the wedged op stays with the abandoned
    daemon worker; ops queue in order on one worker.

    Every host-fabric op routes through here, so this is also the ONE
    telemetry seam for the ``host_collective`` span (the goodput report's
    ``comm`` component)."""
    from tpudist_torch import telemetry

    with telemetry.span("host_collective", op=what):
        return _with_deadline_inner(fn, timeout_s, what)


def _with_deadline_inner(fn: Callable[[], Any], timeout_s: Optional[float],
                         what: str) -> Any:
    global _deadline_worker
    if timeout_s is None:
        timeout_s = _default_host_timeout()
    if timeout_s is None:
        return fn()
    with _deadline_lock:
        if _deadline_worker is None:
            _deadline_worker = _DeadlineWorker()
        worker = _deadline_worker
    result, done = worker.submit(fn)
    if not done.wait(timeout_s):
        with _deadline_lock:
            if _deadline_worker is worker:  # wedged: next op gets a fresh one
                _deadline_worker = None
        raise HostFabricTimeout(
            f"host-fabric op '{what}' exceeded its {timeout_s:.1f}s "
            f"deadline (wedged peer or dead coordinator?)")
    if "error" in result:
        raise result["error"]
    return result.get("value")


def psum_tree(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum every tensor in place over ``group`` (the device group by
    default); identity without a process group."""
    import torch.distributed as dist

    if dist.is_initialized():
        for t in tensors:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return tensors


def pmean_tree(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Average every tensor in place over ``group`` (DDP averages, so this
    is the drop-in)."""
    import torch.distributed as dist

    psum_tree(tensors, group)
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    for t in tensors:
        t.div_(n)
    return tensors


def _leaves(x) -> list:
    if isinstance(x, Mapping):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [np.asarray(x, dtype=np.float64)]


def _rebuild(x, it):
    if isinstance(x, Mapping):
        return {k: _rebuild(x[k], it) for k in sorted(x)}
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, it) for v in x)
    return next(it)


def host_allreduce_sum(x: Any, *, timeout_s: Optional[float] = None) -> Any:
    """Sum the leaves of ``x`` (numbers or arrays, in nested tuples, lists
    and dicts) across processes on the host group, in float64; identity (as
    float64 numpy) in a single process.  ``timeout_s`` (or
    ``TPUDIST_HOST_TIMEOUT_S``) bounds the wait."""

    from tpudist_torch.runtime import faults

    def op():
        faults.inject_host()
        leaves = _leaves(x)
        if process_count() == 1:
            return _rebuild(x, iter(leaves))
        import torch.distributed as dist

        flat = torch.from_numpy(np.concatenate([a.ravel() for a in leaves]))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=host_group())
        out, off = [], 0
        for a in leaves:
            out.append(flat[off:off + a.size].numpy().reshape(a.shape))
            off += a.size
        return _rebuild(x, iter(out))

    return _with_deadline(op, timeout_s, "host_allreduce_sum")


def cross_process_mean_scalar(value, weight: float) -> float:
    """Weighted mean of a scalar across processes: Σ(value·weight)/Σ(weight)."""
    num, den = host_allreduce_sum((np.float64(value) * weight,
                                   np.float64(weight)))
    return float(num / den)


def batch_weighted_loss_mean(losses: Mapping[str, Any], batch_size: int,
                             backend: MetricBackend = MetricBackend.HOST
                             ) -> dict:
    """The reference's logging-loss semantics (``demo.py:113-121``): each
    rank contributes ``loss × batch_size``; the sum over ranks is divided by
    ``batch_size × world_size``.  With ``backend=ICI`` the losses are
    already global means (reduced in the step on the device group), so this
    is a device→host fetch only."""
    local = {k: float(v) for k, v in losses.items()}
    if backend == MetricBackend.ICI:
        return local
    return {k: cross_process_mean_scalar(v, batch_size)
            for k, v in local.items()}


def barrier(name: str = "tpudist_barrier", *,
            timeout_s: Optional[float] = None) -> None:
    """Cross-process barrier on the host group (``dist.barrier()``,
    ``demo.py:177``); ``timeout_s`` (or ``TPUDIST_HOST_TIMEOUT_S``) bounds
    the wait."""
    from tpudist_torch.runtime import faults

    def op():
        faults.inject_host()
        if process_count() == 1:
            return
        import torch.distributed as dist

        dist.barrier(group=host_group())

    _with_deadline(op, timeout_s, f"barrier[{name}]")
