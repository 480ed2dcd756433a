"""Device prefetch: overlap the host→device copy of batch k+1 with step k —
the counterpart of :mod:`tpudist.data.prefetch`.

A background thread drains the (possibly blocking) host iterator into a
bounded queue; on CUDA it also stages each batch in a pinned host buffer.
The consumer issues each copy ``non_blocking`` on a side CUDA stream and
records an event after it; when a batch is yielded, the compute stream waits
on that event and the device tensor is ``record_stream``-ed on the compute
stream (so the caching allocator never hands its memory out while a step
still reads it).  A pinned buffer goes back to the pool only once its copy
event has completed, so a reused buffer is never overwritten before its copy
landed.  Up to ``depth`` copies are in flight ahead of the consumer.

Order-preserving, exhausts the source once, re-raises the source's
exception at the matching position (after the batches before it).  As in
the JAX package the consumer's waits are counted on :class:`PrefetchStats`,
recorded as ``data_wait`` telemetry spans, and published as one
``prefetch_stats`` event when the stream ends or is abandoned.

Usage::

    for tokens in prefetch_to_device(loader, "cuda"):
        loss = step(tokens)
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


@dataclasses.dataclass
class PrefetchStats:
    """Producer/consumer wait accounting for one prefetch stream.

    ``producer_wait_s``: time the drain thread spent blocked on a full host
    queue (the step is the bottleneck; harmless).  ``consumer_wait_s``: time
    the consumer spent blocked on an empty queue (the data source is the
    bottleneck: a real data stall)."""

    producer_wait_s: float = 0.0
    consumer_wait_s: float = 0.0
    batches: int = 0


def _leaves(item):
    """``item``'s arrays or tensors, flattened, and a function rebuilding
    the item's structure (a tuple or list of leaves, or one leaf)."""
    if isinstance(item, (tuple, list)):
        kind = type(item)
        return list(item), lambda leaves: kind(leaves)
    return [item], lambda leaves: leaves[0]


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


class _PinnedPool:
    """Pinned host buffers by ``(shape, dtype)``, at most ``cap`` of each.
    A buffer handed to a copy comes back only after the copy's event has
    completed."""

    def __init__(self, cap: int, stop: threading.Event):
        self.cap = cap
        self.stop = stop
        self.free = collections.defaultdict(list)
        self.count = collections.Counter()
        self.releasing = collections.deque()  # (event, key, buffer)
        self.cond = threading.Condition()

    def _reclaim(self) -> None:
        """Move the buffers whose copies have landed to the free lists
        (under the lock)."""
        while self.releasing and self.releasing[0][0].query():
            _, key, buf = self.releasing.popleft()
            self.free[key].append(buf)

    def take(self, src: torch.Tensor) -> Optional[torch.Tensor]:
        """A pinned buffer shaped as ``src``: a free one, a new one under
        the cap, else the oldest one in flight once its copy has landed
        (``None`` when the stream is being abandoned)."""
        key = (tuple(src.shape), src.dtype)
        while True:
            with self.cond:
                self._reclaim()
                if self.free[key]:
                    return self.free[key].pop()
                if self.count[key] < self.cap:
                    self.count[key] += 1
                    return torch.empty(src.shape, dtype=src.dtype,
                                       pin_memory=True)
                if not self.releasing:
                    if self.stop.is_set():
                        return None
                    self.cond.wait(timeout=0.1)
                    continue
                oldest = self.releasing.popleft()
            # wait for the oldest copy outside the lock, so the consumer
            # can keep handing buffers back meanwhile
            ev, k, buf = oldest
            ev.synchronize()
            with self.cond:
                self.free[k].append(buf)

    def give_back(self, event, buf: torch.Tensor) -> None:
        with self.cond:
            self.releasing.append((event, (tuple(buf.shape), buf.dtype), buf))
            self.cond.notify()


class DevicePrefetcher:
    """The iterator :func:`prefetch_to_device` returns; :meth:`close`
    abandons the stream and joins the drain thread.  ``stream`` is the side
    CUDA stream the copies run on (``None`` off CUDA)."""

    def __init__(self, gen: Iterator, thread: threading.Thread,
                 stop: threading.Event, stats: PrefetchStats, stream=None):
        self._gen = gen
        self._thread = thread
        self._stop = stop
        self.stats = stats
        self.stream = stream

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self) -> None:
        self._gen.close()
        self._stop.set()
        self._thread.join()


def prefetch_to_device(source: Iterable, device=None, *, depth: int = 2,
                       host_buffer: int = 2,
                       stats: Optional[PrefetchStats] = None
                       ) -> DevicePrefetcher:
    """Yield each batch of ``source`` (a numpy array or tensor, or a tuple
    or list of them) as tensors on ``device``, keeping up to ``depth``
    copies in flight ahead of the consumer.

    ``host_buffer``: how many raw batches the drain thread may pull ahead
    (bounds host memory for fast sources).  ``stats``: a caller-owned
    :class:`PrefetchStats` accumulating the queue waits (always measured;
    the object just exposes them)."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if host_buffer < 1:
        # queue.Queue(0) would mean unbounded: the opposite of the bound
        raise ValueError(f"host_buffer must be >= 1, got {host_buffer}")
    device = torch.device(device if device is not None else "cpu")
    cuda = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=host_buffer)
    stop = threading.Event()
    stats = stats if stats is not None else PrefetchStats()
    pool = _PinnedPool(host_buffer + depth + 2, stop) if cuda else None

    def put(item) -> bool:
        t0 = time.monotonic()
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            pass
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                stats.producer_wait_s += time.monotonic() - t0
                return True
            except queue.Full:
                continue
        stats.producer_wait_s += time.monotonic() - t0
        return False

    def stage(item):
        """The host batch as tensors; on CUDA each leaf copied into a pinned
        buffer (``None`` when the stream was abandoned meanwhile)."""
        leaves, build = _leaves(item)
        host = [_as_tensor(a) for a in leaves]
        if not cuda:
            return build(host)
        pinned = []
        for t in host:
            buf = pool.take(t)
            if buf is None:
                return None
            buf.copy_(t)
            pinned.append(buf)
        return build(pinned)

    def drain():
        try:
            for item in source:
                if stop.is_set():
                    return
                staged = stage(item)
                if staged is None or not put(staged):
                    return  # the consumer abandoned the stream
        except BaseException as e:  # re-raised at the consumer's position
            put((_SENTINEL, e))
            return
        put((_SENTINEL, None))

    thread = threading.Thread(target=drain, daemon=True,
                              name="tpudist-torch-prefetch")
    thread.start()
    side = torch.cuda.Stream(device) if cuda else None

    def copy(item):
        """Issue ``item``'s copy: ``(device batch, its tensors, the copy's
        event or None)``."""
        leaves, build = _leaves(item)
        if not cuda:
            return build([t.to(device) for t in leaves]), (), None
        with torch.cuda.stream(side):
            out = [t.to(device, non_blocking=True) for t in leaves]
        ev = torch.cuda.Event()
        ev.record(side)
        for buf in leaves:
            pool.give_back(ev, buf)
        return build(out), out, ev

    def ready(entry):
        """The batch for the consumer: the compute stream waits on its copy
        and owns its memory from here."""
        batch, out, ev = entry
        if ev is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(ev)
            for t in out:
                t.record_stream(compute)
        return batch

    def copies() -> Iterator:
        from tpudist_torch import telemetry

        while True:
            tele = telemetry.active()
            t0 = time.monotonic()
            item = q.get()
            wait = time.monotonic() - t0
            stats.consumer_wait_s += wait
            if tele is not None:
                # the consumer-side stall IS the data stall (nested under
                # a caller's own data_wait span when one wraps this)
                tele.record_span("data_wait", t0, wait)
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            stats.batches += 1
            yield copy(item)

    def gen():
        buf: collections.deque = collections.deque()
        it = copies()
        err: Optional[BaseException] = None
        try:
            while True:
                try:
                    entry = next(it)
                except StopIteration:
                    break
                except BaseException as e:
                    # the batches before the failure first, then the error
                    err = e
                    break
                buf.append(entry)
                if len(buf) > depth:
                    yield ready(buf.popleft())
            while buf:
                yield ready(buf.popleft())
            if err is not None:
                raise err
        finally:
            # release the drain thread: its bounded put polls this flag
            stop.set()
            # from the finally: the common exit is a loop breaking at its
            # budget with the source still live, and the totals must reach
            # the report on that path too
            from tpudist_torch import telemetry

            telemetry.event(
                "prefetch_stats",
                producer_wait_s=round(stats.producer_wait_s, 6),
                consumer_wait_s=round(stats.consumer_wait_s, 6),
                batches=stats.batches,
            )

    return DevicePrefetcher(gen(), thread, stop, stats, side)
