"""The toy MLP, PyTorch edition — the counterpart of
:mod:`tpudist.models.toy_mlp`.

Dense 2→10→10→10→10→1 with LeakyReLU (negative slope 0.01) between all but
the last layer.  The layers are initialised as flax's ``nn.Dense`` is, not
as ``nn.Linear``: ``lecun_normal`` kernels (a normal truncated to two
standard deviations, scaled to variance ``1 / fan_in``) and zero biases, so
the port trains the same model family as the JAX package.  Kernels are
stored in the JAX layout ``[d_in, d_out]``, so :func:`ToyMLP.layers` feeds
:func:`tpudist_torch.ops.fused_mlp.pack_params` directly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
from torch import nn

from tpudist_torch.ops.fused_mlp import mlp_reference

#: flax's ``variance_scaling`` truncated-normal correction: the standard
#: deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t [fan_in, fan_out]`` in place as flax's ``lecun_normal()``
    does: a normal truncated to [-2, 2] standard deviations, of variance
    ``1 / fan_in`` after truncation."""
    std = (1.0 / t.shape[0]) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2 * std,
                                     b=2 * std, generator=generator)


class Dense(nn.Module):
    """``x @ kernel + bias`` with ``kernel [d_in, d_out]`` (flax's layout)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))


class ToyMLP(nn.Module):
    """``dense_0 … dense_{n-1}`` as in the flax module's parameter tree."""

    def __init__(self, features: Sequence[int] = (10, 10, 10, 10, 1),
                 input_dim: int = 2):
        super().__init__()
        self.n_layers = len(features)
        widths = [input_dim, *features]
        for i in range(self.n_layers):
            setattr(self, f"dense_{i}", Dense(widths[i], widths[i + 1]))

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The ``[(kernel, bias), ...]`` list of the module's own
        parameters."""
        return [(d.kernel, d.bias) for d in
                (getattr(self, f"dense_{i}") for i in range(self.n_layers))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_reference(x, self.layers())


def create_toy_model(seed: Union[int, torch.Generator], input_dim: int = 2,
                     *, device="cuda") -> ToyMLP:
    """A ToyMLP initialised from ``seed`` (an int, or a ``torch.Generator``
    the draws advance), on ``device``.  The draws run on the CPU, so every
    process and device given the same seed holds the same weights — the
    replicated init of :func:`tpudist.models.create_toy_model`; DDP's
    broadcast from rank 0 then changes nothing."""
    from tpudist_torch.models.transformer import resolve_device

    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    model = ToyMLP(input_dim=input_dim)
    for kernel, _ in model.layers():
        lecun_normal_(kernel.data, gen)
    return model.to(device)
