"""One toy model split across several devices — the counterpart of
:mod:`tpudist.models.split_mlp`, in PyTorch's idiom, which is the
reference's own (``demo_one_model_multi_gpu.py:17-42``).

The JAX package shards each weight matrix over the ``model`` mesh axis and
lets XLA insert the activation transfers.  Here the ToyMLP's layers go in
contiguous groups, one group a device (5 layers over 2 devices: 3 + 2, the
earlier groups larger), and ``forward`` moves the activation to the next
group's device.  The arithmetic is the unsplit model's, layer by layer, so
the losses equal it; DDP wraps the module with ``device_ids=None``
(``:96-98``) when its parameters span more than one device.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from tpudist_torch.models.toy_mlp import ToyMLP
from tpudist_torch.ops.fused_mlp import leaky_relu, mlp_reference


def stage_sizes(n_layers: int, n_stages: int) -> List[int]:
    """Contiguous group sizes of ``n_layers`` over ``n_stages``, the
    earlier groups one larger where they do not divide."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(f"cannot split {n_layers} layers over {n_stages} "
                         "devices")
    base, extra = divmod(n_layers, n_stages)
    return [base + (i < extra) for i in range(n_stages)]


class SplitToyMLP(ToyMLP):
    """A :class:`ToyMLP` whose layer groups live on ``devices``, one group
    a device.  Its parameter names are ToyMLP's, so its state dict is
    ToyMLP's (``toy_params_from_flax`` loads into it; ``load_state_dict``
    copies each tensor to its layer's device)."""

    def __init__(self, devices: Sequence, features=(10, 10, 10, 10, 1),
                 input_dim: int = 2):
        super().__init__(features, input_dim)
        self.devices = tuple(torch.device(d) for d in devices)
        self.stages = []  # [(device, [layer index, ...]), ...]
        first = 0
        for dev, n in zip(self.devices,
                          stage_sizes(self.n_layers, len(self.devices))):
            idx = list(range(first, first + n))
            for i in idx:
                getattr(self, f"dense_{i}").to(dev)
            self.stages.append((dev, idx))
            first += n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = self.layers()
        h = x
        for s, (dev, idx) in enumerate(self.stages):
            h = mlp_reference(h.to(dev), [layers[i] for i in idx])
            if s + 1 < len(self.stages):
                h = leaky_relu(h)
        return h


def split_toy_model(model: ToyMLP, devices: Sequence) -> SplitToyMLP:
    """``model``'s weights in a :class:`SplitToyMLP` over ``devices``."""
    shapes = [kernel.shape for kernel, _ in model.layers()]
    split = SplitToyMLP(devices, features=[s[1] for s in shapes],
                        input_dim=shapes[0][0])
    split.load_state_dict(model.state_dict())
    return split
