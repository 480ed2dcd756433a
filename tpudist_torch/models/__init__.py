"""The port's model family: :class:`TransformerLM` (with its MoE FFN) and
its LM losses and tied draft, its paged and dense KV storage, the adapter pool and the
slot-decode programs of the serving engine; and the toy MLP of the
``demo.py`` path."""

from tpudist_torch.models.convert import (adapter_factors_from_jax,
                                          params_from_flax,
                                          toy_params_from_flax)
from tpudist_torch.models.generate import (CacheFullError, DenseKV,
                                           PlacedDenseKV, SlotDecode,
                                           SlotState,
                                           filter_logits, generate,
                                           make_slot_decode,
                                           sample_logits, spec_accept)
from tpudist_torch.models.paged import PagedKV, PagedKVConfig, PlacedKV
from tpudist_torch.models.transformer import (MoEFFN, PlacedLM,
                                              TransformerLM,
                                              create_transformer,
                                              dense_moe_reference, lm_loss,
                                              lm_loss_with_targets,
                                              moe_expert_fn, resolve_device,
                                              rope_rotate, sown_stats,
                                              tied_draft)
from tpudist_torch.models.toy_mlp import ToyMLP, create_toy_model

__all__ = [
    "CacheFullError", "DenseKV", "MoEFFN", "PagedKV", "PagedKVConfig",
    "PlacedDenseKV", "PlacedKV", "PlacedLM", "SlotDecode", "SlotState", "ToyMLP", "TransformerLM",
    "adapter_factors_from_jax", "create_toy_model", "create_transformer",
    "dense_moe_reference", "filter_logits", "generate", "lm_loss",
    "lm_loss_with_targets", "make_slot_decode", "moe_expert_fn",
    "params_from_flax", "resolve_device", "rope_rotate", "sample_logits",
    "sown_stats", "spec_accept", "tied_draft", "toy_params_from_flax",
]
