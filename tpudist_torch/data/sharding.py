"""Deterministic per-epoch index sharding — a numpy-only copy of
:mod:`tpudist.data.sharding`.

``torch.utils.data.DistributedSampler`` semantics: a global permutation
seeded by ``seed + epoch``, padded by wrap-around so every shard gets an
equal count, then strided assignment ``indices[shard::num_shards]``.  The
``standard`` mode gives every process the full (shuffled) dataset.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    num_samples: int
    num_shards: int
    shard_id: int
    shuffle: bool = True
    seed: int = 0
    mode: str = "distributed"  # 'distributed' | 'standard'
    drop_last: bool = False

    def __post_init__(self):
        if self.mode not in ("distributed", "standard"):
            raise ValueError(f"unknown dataloader mode {self.mode!r}")
        if not (0 <= self.shard_id < self.num_shards):
            raise ValueError("shard_id out of range")

    @property
    def samples_per_shard(self) -> int:
        if self.mode == "standard":
            return self.num_samples
        if self.drop_last:
            return self.num_samples // self.num_shards
        return math.ceil(self.num_samples / self.num_shards)


def epoch_indices(plan: ShardPlan, epoch: int) -> np.ndarray:
    """Indices this shard owns for ``epoch`` (deterministic across hosts)."""
    if plan.shuffle:
        rng = np.random.default_rng(plan.seed + epoch)
        order = rng.permutation(plan.num_samples)
    else:
        order = np.arange(plan.num_samples)
    if plan.mode == "standard":
        return order
    total = plan.samples_per_shard * plan.num_shards
    if total > plan.num_samples:
        # wrap-around padding, exactly DistributedSampler's scheme
        order = np.concatenate([order, order[: total - plan.num_samples]])
    else:
        order = order[:total]
    return order[plan.shard_id :: plan.num_shards]
