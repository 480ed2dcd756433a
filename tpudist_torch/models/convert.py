"""Weights from the JAX package's flax parameter tree.

:func:`params_from_flax` maps a ``tpudist.models.TransformerLM`` param tree
(nested dicts of numpy arrays, with or without the top ``"params"`` level)
onto the state dict of :class:`tpudist_torch.models.TransformerLM`.  flax
``Dense`` kernels are ``[in, out]``; the port's linear weights are
``[out, in]``.  The tensors are f32, flax's master dtype: a model built with
``param_dtype=float32`` (training) loads them without a cast, so the same
weights start both frameworks; a model whose parameters live in its compute
dtype (serving) gets them rounded to nearest even by ``load_state_dict`` —
the cast flax applies to its f32 masters at apply."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
        for name in ("qkv", "proj", "wi", "wo"):
            out[pre + name] = t(blk[name]["kernel"], transpose=True)
        i += 1
    return out
