"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper launches its CUDA kernel for CUDA tensors (building it from
``tpudist_torch/csrc`` at first use) and runs its plain PyTorch version for
CPU tensors; each counts its kernel launches in a ``launches`` attribute.
"""

from tpudist_torch.ops.flash_attention import (FlashAttention,
                                               flash_attention,
                                               flash_attention_with_lse,
                                               flash_backward_dkv,
                                               flash_backward_dq,
                                               flash_backward_dq_delta,
                                               flash_backward_reference,
                                               flash_forward,
                                               flash_forward_reference)
from tpudist_torch.ops.fused_mlp import (PackedMLP, fused_mlp,
                                         mlp_reference, pack_params,
                                         unpack_params)
from tpudist_torch.ops.fused_linear import (fused_rope_qkv,
                                            fused_rope_qkv_reference,
                                            lora_delta, lora_delta_reference)
from tpudist_torch.ops.fused_sample import (fused_residual_prep,
                                            fused_residual_reference,
                                            fused_sample_prep,
                                            fused_sample_reference)
from tpudist_torch.ops.paged_attention import (paged_attention,
                                               paged_attention_reference)
from tpudist_torch.ops.paged_prefill import (paged_prefill_attention,
                                             paged_prefill_reference)

#: every kernel wrapper of the port (serving, training, adapter-serving,
#: speculative-decoding and toy-MLP slices), by kernel name
KERNEL_WRAPPERS = {
    "paged_attention": paged_attention,
    "paged_prefill": paged_prefill_attention,
    "fused_sample": fused_sample_prep,
    "flash_forward": flash_forward,
    "flash_backward_dq": flash_backward_dq,
    "flash_backward_dkv": flash_backward_dkv,
    "fused_rope_qkv": fused_rope_qkv,
    "lora_delta": lora_delta,
    "fused_residual_prep": fused_residual_prep,
    "fused_mlp": fused_mlp,
}


def launch_counts() -> dict:
    """``kernel name → launches`` since the last
    :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` (and the per-arm counts: the paged
    prefill's ``launches_tc`` / ``launches_cc``, the paged decode's
    ``launches_tc``, the flash kernels' ``launches_wgmma``, the LoRA
    kernel's ``launches_cluster``, the RoPE+QKV kernel's
    ``launches_split`` / ``launches_wgmma``)."""
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    paged_prefill_attention.launches_tc = 0
    paged_prefill_attention.launches_cc = 0
    paged_attention.launches_tc = 0
    flash_forward.launches_wgmma = 0
    flash_backward_dq.launches_wgmma = 0
    flash_backward_dkv.launches_wgmma = 0
    lora_delta.launches_cluster = 0
    fused_rope_qkv.launches_split = 0
    fused_rope_qkv.launches_wgmma = 0


__all__ = [
    "FlashAttention", "KERNEL_WRAPPERS", "PackedMLP", "flash_attention",
    "flash_attention_with_lse", "flash_backward_dkv", "flash_backward_dq",
    "flash_backward_dq_delta", "flash_backward_reference", "flash_forward", "flash_forward_reference",
    "fused_mlp", "fused_residual_prep", "fused_residual_reference", "fused_rope_qkv",
    "fused_rope_qkv_reference", "fused_sample_prep",
    "fused_sample_reference", "lora_delta", "lora_delta_reference",
    "launch_counts", "mlp_reference", "pack_params", "paged_attention", "paged_attention_reference",
    "paged_prefill_attention", "paged_prefill_reference",
    "reset_launch_counts", "unpack_params",
]
