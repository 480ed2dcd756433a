"""Parallelism beyond plain data parallelism — the counterpart of
:mod:`tpudist.parallel`, one slice at a time.

- :mod:`ring_attention` — sequence (context) parallelism over the ``seq``
  mesh axis: ring attention on the flash kernels, the plain carry body,
  the zigzag causal-balanced layout, and :class:`SeqLayout`, the data
  path's side of the ring;
- :mod:`ring` — the ring's hop: :class:`ProcessGroupRing` (one shard a
  rank over ``torch.distributed``) and :class:`LocalRing` (every shard on
  one process's device).

FSDP, tensor and pipeline parallelism, MoE and the collective matmuls are
not ported yet: ROADMAP queue A, item A6c.
"""

from tpudist_torch.parallel.ring import LocalRing, ProcessGroupRing
from tpudist_torch.parallel.ring_attention import (
    SeqLayout, attention_reference, make_ring_attention, make_zigzag_lm_loss,
    make_zigzag_ring_attention, ring_attention_shard,
    ring_attention_shard_flash, ring_attention_shard_zigzag,
    ring_attention_shard_zigzag_flash, zigzag_indices)

__all__ = ["LocalRing", "ProcessGroupRing", "SeqLayout",
           "attention_reference", "make_ring_attention",
           "make_zigzag_lm_loss", "make_zigzag_ring_attention",
           "ring_attention_shard", "ring_attention_shard_flash",
           "ring_attention_shard_zigzag",
           "ring_attention_shard_zigzag_flash", "zigzag_indices"]
