"""High-level Trainer facade (Lightning-equivalent, parity with
``demo_pytorch_lightning.py``) — the counterpart of
:mod:`tpudist.trainer`."""

from tpudist_torch.trainer.trainer import (BF16Apply, LMTrainerModule,
                                           Trainer, TrainerModule)

__all__ = ["BF16Apply", "LMTrainerModule", "Trainer", "TrainerModule"]
