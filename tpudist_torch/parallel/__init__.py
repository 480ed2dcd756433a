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
  balance loss;
- :mod:`pipeline`, :mod:`pipeline_interleaved`, :mod:`pipeline_lm` —
  pipeline parallelism over the ``stage`` axis: GPipe, 1F1B and the
  interleaved virtual-stage 1F1B, their hops, and the pipelined LM's
  layouts, apply and train step.
"""

from tpudist_torch.parallel.fsdp import (Layout, fsdp_sharding,
                                         merge_shardings, overlap_fsdp_mlp,
                                         state_bytes_per_device,
                                         zero1_sharding)
from tpudist_torch.parallel.moe import MoEStats, make_moe, moe_shard
from tpudist_torch.parallel.overlap import (OVERLAP_MODES, OVERLAP_SCOPE,
                                            ag_matmul, matmul_rs,
                                            overlap_mode)
from tpudist_torch.parallel.pipeline import (make_pipeline,
                                             pipeline_1f1b_shard,
                                             pipeline_shard)
from tpudist_torch.parallel.pipeline_interleaved import (
    deinterleave_block_params, interleave_block_params, interleaved_schedule,
    pipeline_interleaved_shard)
from tpudist_torch.parallel.pipeline_lm import (
    PipelineLayout, PipelineRuntime, make_pp_lm_apply, make_pp_lm_train_step,
    pp_state_sharding, stack_block_params, stack_block_params_interleaved,
    unstack_block_params)
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
           "OVERLAP_SCOPE", "PipelineLayout", "PipelineRuntime",
           "ProcessGroupRing", "SeqLayout", "ShardedRuntime", "ag_matmul",
           "attention_reference", "column_spec",
           "deinterleave_block_params", "fsdp_sharding", "init_mlp_params",
           "interleave_block_params", "interleaved_schedule", "make_moe",
           "make_pipeline", "make_pp_lm_apply", "make_pp_lm_train_step",
           "make_ring_attention", "make_tp_mlp", "make_zigzag_lm_loss",
           "make_zigzag_ring_attention", "matmul_rs", "merge_shardings",
           "mlp_param_sharding", "moe_shard", "overlap_fsdp_mlp",
           "overlap_mode", "pipeline_1f1b_shard",
           "pipeline_interleaved_shard", "pipeline_shard",
           "pp_state_sharding", "ring_attention_shard",
           "ring_attention_shard_flash", "ring_attention_shard_zigzag",
           "ring_attention_shard_zigzag_flash", "row_spec",
           "shard_mlp_params", "shard_state", "stack_block_params",
           "stack_block_params_interleaved", "state_bytes_per_device",
           "tp_mlp_overlap_shard", "tp_mlp_shard", "unstack_block_params",
           "zero1_sharding", "zigzag_indices"]
