"""Host-side batching and device placement — the counterpart of
:mod:`tpudist.data.loader`.

:class:`ShardedLoader` yields this process's numpy batches in the order
:mod:`tpudist_torch.data.sharding` gives (a seeded permutation per epoch,
``DistributedSampler`` semantics); :func:`shard_batch` copies a batch to the
process's device.  With one process per device there is no global array to
assemble: each rank steps on its own shard and DDP reduces the gradients.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from tpudist_torch.data.sharding import ShardPlan, epoch_indices
from tpudist_torch.data.toy import ToyData


class ShardedLoader:
    """Iterates per-process batches of a numpy-backed dataset.

    ``set_epoch`` re-derives the shuffle (``sampler.set_epoch``).  The
    per-process batch size is fixed; the trailing partial batch is dropped
    only if ``plan.drop_last``."""

    def __init__(self, dataset: ToyData, batch_size: int, plan: ShardPlan):
        self.dataset = dataset
        self.batch_size = batch_size
        self.plan = plan
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = self.plan.samples_per_shard
        if self.plan.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, skip_batches: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Iterate the epoch starting ``skip_batches`` in (an index-level
        skip: nothing is gathered for the skipped prefix)."""
        idx = epoch_indices(self.plan, self._epoch)
        for start in range(skip_batches * self.batch_size, len(idx),
                           self.batch_size):
            sel = idx[start:start + self.batch_size]
            if len(sel) < self.batch_size and self.plan.drop_last:
                return
            yield self.dataset.x[sel], self.dataset.y[sel]

    def close(self) -> None:
        """Nothing to release: the loader is synchronous."""


def make_loader(dataset: ToyData, batch_size: int, plan: ShardPlan, *,
                num_workers: int = 0, prefetch_depth: int = 4
                ) -> ShardedLoader:
    """The loader of the shared CLI's ``--num_workers``: 0 is the
    synchronous numpy loader, > 0 the native gather pool's
    :class:`~tpudist_torch.data.native_loader.PrefetchingLoader` (the
    synchronous loader where no ``g++`` can build it: the flag is a
    performance hint)."""
    from tpudist_torch.data import native_loader

    if num_workers > 0 and native_loader.native_available():
        return native_loader.PrefetchingLoader(
            dataset, batch_size, plan, num_workers=num_workers,
            prefetch_depth=prefetch_depth)
    return ShardedLoader(dataset, batch_size, plan)


def shard_batch(batch, device) -> Tuple[torch.Tensor, ...]:
    """Copy a per-process host batch (a tuple of numpy arrays) to
    ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in batch)
