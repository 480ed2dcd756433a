"""tpudist_torch — the PyTorch/CUDA port of tpudist.

The JAX package ``tpudist`` is the reference; this package mirrors its
layout (``tpudist/X.py`` → ``tpudist_torch/X.py``), imports nothing of it,
and runs its hand-written Hopper kernels (``csrc/``) on CUDA tensors and
their plain PyTorch versions on CPU tensors.  Ported so far: the serving
path with the paged decode, paged prefill and fused sampling kernels
(``python -m tpudist_torch.serve``).
"""
