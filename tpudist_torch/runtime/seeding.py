"""Seeding discipline — the counterpart of :mod:`tpudist.runtime.seeding`.

The reference adds the rank to the user seed (``config.seed +=
dist.get_rank()``, ``demo.py:59-60``) and draws a random seed when none is
given (``argument_parser.py:18``).  Model init uses the *base* seed on every
process, so replicated parameters agree without a broadcast; anything
rank-local uses :func:`per_process_seed` or a :func:`fold_in_process`
generator.
"""

from __future__ import annotations

import secrets
from typing import Optional

import numpy as np
import torch

from tpudist_torch.runtime.bootstrap import (host_group, process_count,
                                             process_index)


def draw_seed() -> int:
    """Random 32-bit seed (``random.randint(0, 2**32-1)`` in
    ``argument_parser.py:18``)."""
    return secrets.randbits(32)


def resolve_shared_seed(seed: Optional[int]) -> int:
    """One seed the whole job agrees on: ``seed`` when given, else rank 0
    draws one and broadcasts it over the host group.  Call after
    ``runtime.initialize``."""
    if seed is not None:
        return seed
    if process_count() == 1:
        return draw_seed()
    import torch.distributed as dist

    t = torch.tensor([draw_seed()], dtype=torch.int64)
    dist.broadcast(t, src=0, group=host_group())
    return int(t.item())


def per_process_seed(base_seed: Optional[int],
                     process_id: Optional[int] = None) -> int:
    """``base_seed + rank`` (``demo.py:59-60``)."""
    if base_seed is None:
        base_seed = draw_seed()
    if process_id is None:
        process_id = process_index()
    return base_seed + process_id


def fold_in_process(seed: int, process_id: Optional[int] = None
                    ) -> torch.Generator:
    """A ``torch.Generator`` seeded from ``seed`` and the process index — the
    counterpart of folding the process index into a JAX key: distinct
    streams per process, the same stream for the same (seed, process)."""
    if process_id is None:
        process_id = process_index()
    mixed = np.random.SeedSequence([seed, process_id]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))
