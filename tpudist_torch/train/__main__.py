"""LM training in one command: ``python -m tpudist_torch.train``.

The single-process spelling of :mod:`tpudist_torch.examples.
demo_long_context` (one parser, one main): the same flags, the same
training, evaluation and ``--generate``; launched under a contract
(torchrun, SLURM, ``OMPI_*``) it trains data-parallel as the demo does.
The GPU path is the default (``--device cuda``, which raises without
CUDA); ``--device cpu`` runs the plain PyTorch path, e.g. a tiny smoke
run::

  python -m tpudist_torch.train --device cpu --dry_run --seq_len 64 \\
      --d_model 64 --n_layers 2 --n_heads 4 --d_ff 128 --total_iterations 20

The d1024 geometry on one H100::

  python -m tpudist_torch.train --dry_run --seq_len 2048 --d_model 1024 \\
      --n_layers 8 --n_heads 8 --d_ff 4096 --vocab 256 --batch_size 8 \\
      --precision bf16 --total_iterations 30
"""

from __future__ import annotations

import sys

from tpudist_torch.examples.demo_long_context import (build_training,
                                                       get_args, main,
                                                       make_batch)

__all__ = ["build_training", "get_args", "main", "make_batch"]

if __name__ == "__main__":
    main(sys.argv[1:])
