"""The port's training paths: the LM train/eval steps
(``python -m tpudist_torch.train``), the toy ``demo.py`` path's
data-parallel steps and loop, and the optimizers with learning-rate
schedules."""

from tpudist_torch.train.lm import (chunk_token_sharding,
                                   fsdp_overlap_mlp_fn, make_lm_eval_step,
                                   make_lm_train_step,
                                   make_scanned_lm_train_step)
from tpudist_torch.train.loop import TrainLoopConfig, run_training
from tpudist_torch.train.optim import (OPTIMIZERS, SCHEDULES,
                                       build_optimizer,
                                       build_optimizer_from_args,
                                       build_schedule)
from tpudist_torch.train.step import (ModelState, init_model_states,
                                      make_multi_model_train_step,
                                      make_scanned_train_step, mse_loss)

__all__ = ["ModelState", "OPTIMIZERS", "SCHEDULES", "TrainLoopConfig",
           "build_optimizer", "build_optimizer_from_args", "build_schedule",
           "chunk_token_sharding", "fsdp_overlap_mlp_fn",
           "init_model_states", "make_lm_eval_step", "make_lm_train_step",
           "make_scanned_lm_train_step",
           "make_multi_model_train_step", "make_scanned_train_step",
           "mse_loss", "run_training"]
