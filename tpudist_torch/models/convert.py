"""Weights and adapter factors from the JAX package.

:func:`toy_params_from_flax` does the same for the toy MLP.

:func:`params_from_flax` maps a ``tpudist.models.TransformerLM`` param tree
(nested dicts of numpy arrays, with or without the top ``"params"`` level)
onto the state dict of :class:`tpudist_torch.models.TransformerLM`.  flax
``Dense`` kernels are ``[in, out]``; the port's linear weights are
``[out, in]``; an MoE block's ``moe`` subtree (``router [d, E]``, ``w [E,
d, f]``, ``wo [E, f, d]``) carries across as it is.  The tensors are f32, flax's master dtype: a model built with
``param_dtype=float32`` (training) loads them without a cast, so the same
weights start both frameworks; a model whose parameters live in its compute
dtype (serving) gets them rounded to nearest even by ``load_state_dict`` —
the cast flax applies to its f32 masters at apply."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tpudist_torch.models.lora import FACTOR_KEYS


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict (f32 tensors) from a flax param tree."""
    p = tree.get("params", tree)

    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a))

    out = {"tok_embed": t(p["tok_embed"]["embedding"]),
           "ln_f": t(p["LayerNorm_0"]["scale"]),
           "head": t(p["head"]["kernel"], transpose=True)}
    if "pos_embed" in p:
        out["pos_embed"] = t(p["pos_embed"]["embedding"])
    i = 0
    while f"block_{i}" in p:
        blk = p[f"block_{i}"]
        pre = f"blocks.{i}."
        out[pre + "ln1"] = t(blk["LayerNorm_0"]["scale"])
        out[pre + "ln2"] = t(blk["LayerNorm_1"]["scale"])
        ffn = ("wi", "wo") if "moe" not in blk else ()
        for name in ("qkv", "proj") + ffn:
            out[pre + name] = t(blk[name]["kernel"], transpose=True)
        for name in ("router", "w", "wo") if not ffn else ():
            # the MoE stacks keep the JAX layout
            out[pre + "moe." + name] = t(blk["moe"][name])
        i += 1
    return out


def adapter_factors_from_jax(factors: Mapping) -> Dict[str, torch.Tensor]:
    """The port's adapter factors (f32 tensors) from a JAX factor dict
    (``tpudist.models.lora.make_adapter_factors``: numpy or JAX arrays
    ``a_* [L, d_in, r]``, ``b_* [L, r, d_out]``).  The layouts agree — the
    qkv output columns are q | k | v in both packages, the order of the
    port's ``[out, in]`` qkv weight rows — so the arrays carry over as they
    are."""
    missing = [k for k in FACTOR_KEYS if k not in factors]
    if missing:
        raise ValueError(f"adapter factors missing {missing}")
    return {k: torch.from_numpy(np.array(np.asarray(factors[k]),
                                         dtype=np.float32))
            for k in FACTOR_KEYS}


def toy_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`tpudist_torch.models.toy_mlp.ToyMLP` (f32
    tensors) from a ``tpudist.models.ToyMLP`` param tree (nested dicts of
    numpy arrays, with or without the top ``"params"`` level).  Both keep
    the kernels ``[in, out]``, so the arrays carry over as they are."""
    p = tree.get("params", tree)
    return {f"{layer}.{name}": torch.from_numpy(
        np.array(np.asarray(p[layer][name]), dtype=np.float32))
        for layer in p for name in ("kernel", "bias")}
