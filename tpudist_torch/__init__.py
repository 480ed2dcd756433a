"""tpudist_torch — the PyTorch/CUDA port of tpudist.

The JAX package ``tpudist`` is the reference; this package mirrors its
layout (``tpudist/X.py`` → ``tpudist_torch/X.py``), imports nothing of it,
and runs its hand-written Hopper kernels (``csrc/``) on CUDA tensors and
their plain PyTorch versions on CPU tensors.  Entry points: serving
(``python -m tpudist_torch.serve``), LM training (``python -m
tpudist_torch.train``), the toy data-parallel demo (``python -m
tpudist_torch.examples.demo``) and its bench (``python -m
tpudist_torch.bench``).
"""

from tpudist_torch.version import __version__  # noqa: F401
