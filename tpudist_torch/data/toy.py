"""The toy regression workload — a copy of :mod:`tpudist.data.toy`.

512 samples; each input is a scalar ``v ~ N(0,1)`` duplicated to 2 dims;
each target is ``0.5·ε + v²`` with ``ε ~ N(0,1)``, drawn from an explicitly
seeded numpy generator, so every process builds the same dataset.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ToyData:
    x: np.ndarray  # (n, 2) float32
    y: np.ndarray  # (n, 1) float32

    def __len__(self) -> int:
        return self.x.shape[0]

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]


def make_toy_data(n: int = 512, seed: int = 0) -> ToyData:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n).astype(np.float32)
    x = np.stack([v, v], axis=1)
    eps = rng.standard_normal(n).astype(np.float32)
    y = (0.5 * eps + v**2)[:, None].astype(np.float32)
    return ToyData(x=x, y=y)
