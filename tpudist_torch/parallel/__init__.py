"""Parallelism beyond plain data parallelism — the counterpart of
:mod:`tpudist.parallel`, one slice at a time.

- :mod:`ring_attention` — sequence (context) parallelism over the ``seq``
  mesh axis: ring attention on the flash kernels, the plain carry body,
  the zigzag causal-balanced layout, and :class:`SeqLayout`, the data
  path's side of the ring;
- :mod:`ring` — the ring's hop: :class:`ProcessGroupRing` (one shard a
  rank over ``torch.distributed``) and :class:`LocalRing` (every shard on
  one process's device);
- :mod:`fsdp` — sharded state as a layout: the ZeRO-3 (FSDP) and ZeRO-1
  rules over the ``data`` axis, :func:`merge_shardings` and
  :func:`state_bytes_per_device`;
- :mod:`zero` — the runtime that carries a layout out around the train
  step (gathers, reduce-scatters, the optimizer over the shards);
- :mod:`tensor_parallel` — the Megatron column/row MLP pair over the
  ``model`` axis, with its overlapped twin (the whole transformer's split
  is :func:`tpudist_torch.models.transformer.transformer_tp_sharding`);
- :mod:`overlap` — the collective matmuls: all-gathers and reduce-scatters
  decomposed into hops pipelined against the matmuls (``ag_matmul``,
  ``matmul_rs``, the ``TPUDIST_OVERLAP`` knob), which the overlapped TP
  MLP and the overlapped FSDP MLP run;
- :mod:`moe` — top-k routed experts over the ``model`` axis, with the
  balance loss.

Pipeline parallelism is not ported yet: ROADMAP queue A, item A6c.
"""

from tpudist_torch.parallel.fsdp import (Layout, fsdp_sharding,
                                         merge_shardings, overlap_fsdp_mlp,
                                         state_bytes_per_device,
                                         zero1_sharding)
from tpudist_torch.parallel.moe import MoEStats, make_moe, moe_shard
from tpudist_torch.parallel.overlap import (OVERLAP_MODES, OVERLAP_SCOPE,
                                            ag_matmul, matmul_rs,
                                            overlap_mode)
from tpudist_torch.parallel.ring import LocalRing, ProcessGroupRing
from tpudist_torch.parallel.ring_attention import (
    SeqLayout, attention_reference, make_ring_attention, make_zigzag_lm_loss,
    make_zigzag_ring_attention, ring_attention_shard,
    ring_attention_shard_flash, ring_attention_shard_zigzag,
    ring_attention_shard_zigzag_flash, zigzag_indices)
from tpudist_torch.parallel.tensor_parallel import (column_spec,
                                                    init_mlp_params,
                                                    make_tp_mlp,
                                                    mlp_param_sharding,
                                                    row_spec,
                                                    shard_mlp_params,
                                                    tp_mlp_overlap_shard,
                                                    tp_mlp_shard)
from tpudist_torch.parallel.zero import ShardedRuntime, shard_state

__all__ = ["Layout", "LocalRing", "MoEStats", "OVERLAP_MODES",
           "OVERLAP_SCOPE", "ProcessGroupRing", "SeqLayout",
           "ShardedRuntime", "ag_matmul", "attention_reference",
           "column_spec", "fsdp_sharding", "init_mlp_params", "make_moe",
           "make_ring_attention", "make_tp_mlp", "make_zigzag_lm_loss",
           "make_zigzag_ring_attention", "matmul_rs", "merge_shardings",
           "mlp_param_sharding", "moe_shard", "overlap_fsdp_mlp",
           "overlap_mode", "ring_attention_shard",
           "ring_attention_shard_flash", "ring_attention_shard_zigzag",
           "ring_attention_shard_zigzag_flash", "row_spec",
           "shard_mlp_params", "shard_state", "state_bytes_per_device",
           "tp_mlp_overlap_shard", "tp_mlp_shard", "zero1_sharding",
           "zigzag_indices"]
