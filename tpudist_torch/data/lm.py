"""Tokenized-corpus data path for the LM family — a numpy-only copy of
:mod:`tpudist.data.lm` (batch-for-batch identical by seed, shard and epoch).

The corpus is one flat token stream on disk (``.npy`` of any integer dtype,
or a raw little-endian binary of ``dtype``), memory-mapped; a sample is a
``seq_len``-token window at stride ``seq_len`` (:func:`lm_loss` shifts
internally, so the window is both inputs and targets); window order comes
from :class:`ShardPlan`.  With ``num_workers > 0`` the windows are
assembled on the native C++ gather pool (:class:`PrefetchingTokenBatches`),
batch for batch the same stream.
"""

from __future__ import annotations

import collections
import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np

from tpudist_torch.data.sharding import ShardPlan, epoch_indices


def open_token_stream(path: Union[str, Path],
                      dtype: Optional[str] = None) -> np.ndarray:
    """Memory-map a 1-D token stream: ``.npy`` files carry their own dtype;
    anything else is a raw binary stream of ``dtype`` (default
    ``uint16``)."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path, mmap_mode="r")
        if arr.ndim != 1:
            raise ValueError(
                f"{path}: expected a 1-D token stream, got {arr.shape}")
        return arr
    return np.memmap(path, dtype=np.dtype(dtype or "uint16"), mode="r")


@dataclasses.dataclass(frozen=True)
class TokenWindows:
    """Window addressing over a token stream: sample i covers
    ``[i·seq_len, (i+1)·seq_len)``."""

    tokens: np.ndarray
    seq_len: int

    def __post_init__(self):
        if len(self.tokens) < self.seq_len:
            raise ValueError(
                f"stream of {len(self.tokens)} tokens is shorter than one "
                f"window ({self.seq_len})")

    def __len__(self) -> int:
        return len(self.tokens) // self.seq_len

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """``[len(idx), seq_len]`` int32 batch of windows."""
        starts = idx.astype(np.int64) * self.seq_len
        offsets = np.arange(self.seq_len, dtype=np.int64)
        return np.asarray(self.tokens[starts[:, None] + offsets[None, :]],
                          dtype=np.int32)


def lm_batches(windows: TokenWindows, plan: ShardPlan, batch_size: int, *,
               start_epoch: int = 0) -> Iterator[np.ndarray]:
    """Endless stream of ``[batch_size, seq_len]`` int32 batches: epoch e's
    window order is ``epoch_indices(plan, e)``, consumed in ``batch_size``
    chunks with the ragged tail dropped."""
    if plan.samples_per_shard < batch_size:
        raise ValueError(
            f"shard holds {plan.samples_per_shard} windows — fewer than one "
            f"batch of {batch_size}; the stream would never yield (shrink "
            "batch_size/seq_len or grow the corpus)")

    def gen():
        epoch = start_epoch
        while True:
            idx = epoch_indices(plan, epoch)
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                yield windows.gather(idx[i : i + batch_size])
            epoch += 1

    return gen()


class PrefetchingTokenBatches:
    """Endless ``[batch, seq_len]`` int32 stream, batch for batch the
    stream of :func:`lm_batches`, with window assembly on the native gather
    pool (:mod:`tpudist_torch.data.native_loader`): the memmap page faults
    and the batch copies run on worker threads ``prefetch_depth`` batches
    ahead of the training loop.  Yielded arrays are fresh copies (the int32
    conversion), so a ring slot's reuse never aliases a batch the consumer
    still holds."""

    def __init__(self, windows: TokenWindows, plan: ShardPlan,
                 batch_size: int, *, num_workers: int = 2,
                 prefetch_depth: int = 4, start_epoch: int = 0):
        from tpudist_torch.data.native_loader import GatherPool

        if plan.samples_per_shard < batch_size:
            raise ValueError(
                f"shard holds {plan.samples_per_shard} windows — fewer than "
                f"one batch of {batch_size}; the stream would never yield "
                "(shrink batch_size/seq_len or grow the corpus)")
        n, seq = len(windows), windows.seq_len
        self._rows = windows.tokens[:n * seq].reshape(n, seq)
        if not self._rows.flags.c_contiguous:
            self._rows = np.ascontiguousarray(self._rows)
        self._plan = plan
        self._batch = batch_size
        self._slots = [np.empty((batch_size, seq), windows.tokens.dtype)
                       for _ in range(prefetch_depth + 1)]
        self._depth = prefetch_depth
        self._pool = GatherPool(num_workers)
        self._gen = self._run(start_epoch)

    def _selections(self, start_epoch: int):
        epoch = start_epoch
        while True:
            idx = epoch_indices(self._plan, epoch).astype(np.int64)
            for i in range(0, len(idx) - self._batch + 1, self._batch):
                yield idx[i:i + self._batch]
            epoch += 1

    def _run(self, start_epoch: int):
        sels = self._selections(start_epoch)
        inflight: collections.deque = collections.deque()
        slot_i = 0

        def submit():
            nonlocal slot_i
            sel = next(sels)
            slot = self._slots[slot_i % len(self._slots)]
            slot_i += 1
            # the pool holds raw pointers into sel and slot: the deque keeps
            # both referenced until the job is waited for
            inflight.append((self._pool.submit(self._rows, sel, slot), sel,
                             slot))

        try:
            for _ in range(self._depth):
                submit()
            while True:
                job, _sel, slot = inflight.popleft()
                self._pool.wait(job)
                out = slot.astype(np.int32)  # a fresh copy per yield
                submit()
                yield out
        finally:
            # an abandoned stream drains before the slots can be freed
            while inflight:
                self._pool.wait(inflight.popleft()[0])

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return next(self._gen)

    def close(self) -> None:
        """Drain the in-flight jobs and join the pool's workers."""
        self._gen.close()
        self._pool.close()


def make_lm_loader(path: Union[str, Path], *, seq_len: int, batch_size: int,
                   num_shards: int = 1, shard_id: int = 0, seed: int = 0,
                   dtype: Optional[str] = None, mode: str = "distributed",
                   eval_fraction: float = 0.0, num_workers: int = 0):
    """One-call corpus loader: ``(windows, train_iterator, eval_indices)``;
    ``batch_size`` is per shard.  ``eval_fraction`` > 0 holds out the corpus
    tail (the last fraction of windows) from the training stream.
    ``num_workers`` > 0 assembles batches on the native gather pool
    (:class:`PrefetchingTokenBatches`; ``close()`` joins its workers), or
    falls back to the synchronous iterator where the pool cannot be built;
    the batch stream is the same either way."""
    if not 0.0 <= eval_fraction < 1.0:
        raise ValueError(f"eval_fraction {eval_fraction} must be in [0, 1)")
    windows = TokenWindows(open_token_stream(path, dtype), seq_len)
    n = len(windows)
    n_eval = int(n * eval_fraction)
    n_train = n - n_eval
    if n_train < 1:
        raise ValueError("eval_fraction leaves no training windows")
    plan = ShardPlan(num_samples=n_train, num_shards=num_shards,
                     shard_id=shard_id, seed=seed, mode=mode)
    eval_idx = np.arange(n_train, n, dtype=np.int64)
    if num_workers > 0:
        from tpudist_torch.data.native_loader import native_available

        if native_available():
            return windows, PrefetchingTokenBatches(
                windows, plan, batch_size, num_workers=num_workers), eval_idx
    return windows, lm_batches(windows, plan, batch_size), eval_idx
