"""Analytic FLOPs accounting and MFU — the counting of
:mod:`tpudist.utils.flops` with the peak table of the port's card.

Conventions: one multiply-add = 2 FLOPs; backward = 2x forward; causal
attention does half the score/value work of full attention; embeddings,
norms and softmax are omitted (model FLOPs).
"""

from __future__ import annotations

from typing import Optional

# Dense bf16 tensor-core peak and HBM rate per card, keyed by a substring of
# torch.cuda.get_device_name (NVIDIA's H100 SXM data sheet).
PEAK_BF16_FLOPS = {"H100": 989e12}
HBM_BYTES_PER_S = {"H100": 3.35e12}


def _lookup(table: dict, device_name: Optional[str]) -> Optional[float]:
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def chip_peak_flops(device_name: Optional[str] = None) -> Optional[float]:
    """bf16 peak FLOP/s of the card (default: CUDA device 0); None when the
    card is unknown or there is none."""
    return _lookup(PEAK_BF16_FLOPS, device_name)


def chip_hbm_bytes_per_s(device_name: Optional[str] = None) -> Optional[float]:
    """HBM bytes/s of the card (default: CUDA device 0); None if unknown."""
    return _lookup(HBM_BYTES_PER_S, device_name)


def attention_live_pairs(seq_len: int, *, causal: bool = True,
                         window=None) -> float:
    """Number of attended (q, k) pairs: causal s(s+1)/2; sliding window W:
    each token attends min(q+1, W) keys; dense s²."""
    s = seq_len
    if not causal:
        if window is not None:
            raise ValueError("window requires causal=True")
        return float(s * s)
    if window is None or window >= s:
        return s * (s + 1) / 2.0
    w = max(int(window), 1)
    return w * (w + 1) / 2.0 + (s - w) * float(w)


def transformer_train_flops(*, batch: int, seq_len: int, d_model: int,
                            n_layers: int, d_ff: int, vocab: int,
                            causal: bool = True, window=None,
                            fwd_only: bool = False) -> float:
    """Analytic matmul FLOPs of one TransformerLM train step: per block
    qkv ``6·b·s·d²`` + proj ``2·b·s·d²`` + attention ``4·pairs·d`` + FFN
    ``4·b·s·d·f``; head ``2·b·s·d·V``; train = 3x forward."""
    b, s, d, f, v = batch, seq_len, d_model, d_ff, vocab
    attn = 4.0 * b * attention_live_pairs(s, causal=causal, window=window) * d
    per_block = 8 * b * s * d * d + attn + 4 * b * s * d * f
    fwd = n_layers * per_block + 2 * b * s * d * v
    return fwd if fwd_only else 3.0 * fwd


def transformer_param_count(*, d_model: int, n_layers: int, d_ff: int,
                            vocab: int, max_len: int) -> int:
    """Parameter count of the TransformerLM shapes (qkv + proj = 4d², FFN
    2·d·ff per block; embed + untied head 2·V·d; positions max_len·d);
    norm scales omitted."""
    per_layer = 4 * d_model * d_model + 2 * d_model * d_ff
    return n_layers * per_layer + 2 * vocab * d_model + max_len * d_model


def mfu(flops_per_step: float, step_seconds: float, n_chips: int,
        peak_per_chip: Optional[float] = None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1]; None when the peak is unknown."""
    if peak_per_chip is None:
        peak_per_chip = chip_peak_flops()
    if not peak_per_chip or step_seconds <= 0:
        return None
    return flops_per_step / step_seconds / (n_chips * peak_per_chip)
