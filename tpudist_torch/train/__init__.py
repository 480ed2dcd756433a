"""The port's LM training path: optimizers with learning-rate schedules and
the train/eval steps (``python -m tpudist_torch.train``)."""

from tpudist_torch.train.lm import make_lm_eval_step, make_lm_train_step
from tpudist_torch.train.optim import (OPTIMIZERS, SCHEDULES,
                                       build_optimizer, build_schedule)

__all__ = ["OPTIMIZERS", "SCHEDULES", "build_optimizer", "build_schedule",
           "make_lm_eval_step", "make_lm_train_step"]
