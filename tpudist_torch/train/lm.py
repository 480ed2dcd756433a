"""LM train and eval steps for the Transformer family — the single-device
counterpart of :mod:`tpudist.train.lm`.

No mesh: one process, one device.  ``grad_reduce_dtype``, ``state_sharding``,
the MoE ``aux`` outputs and the scanned step belong to the ``parallel/``
slice (ROADMAP queue A, item 6c).
"""

from __future__ import annotations

from typing import Callable

import torch

from tpudist_torch.models.transformer import lm_loss


def make_lm_train_step(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, *, scheduler=None,
                       accum_steps: int = 1,
                       loss_fn: Callable = lm_loss) -> Callable:
    """``step(tokens [batch, seq]) -> loss``: forward, backward, one
    optimizer update (and one scheduler step).

    ``accum_steps`` > 1 splits the batch into that many microbatches, sums
    their gradients and scales the sum (and the reported loss) by
    ``1 / accum_steps`` before the update, as the JAX step's ``lax.scan``
    does; the batch must divide evenly.  The loss comes back as a detached
    0-d tensor on the model's device (no host sync)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters (build it "
                         "with create_transformer(..., trainable=True))")

    def step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = loss_fn(model(tokens), tokens)
            loss.backward()
            loss = loss.detach()
        else:
            b = tokens.shape[0]
            if b % accum_steps:
                raise ValueError(
                    f"batch {b} must divide into {accum_steps} accum steps")
            loss = 0.0
            for chunk in tokens.reshape(accum_steps, b // accum_steps,
                                        *tokens.shape[1:]):
                part = loss_fn(model(chunk), chunk)
                part.backward()
                loss = loss + part.detach()
            scale = 1.0 / accum_steps
            loss = loss * scale
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss

    return step


def make_lm_eval_step(model: torch.nn.Module, *,
                      loss_fn: Callable = lm_loss) -> Callable:
    """``eval_step(tokens) -> loss`` without gradients."""

    def eval_step(tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return loss_fn(model(tokens), tokens)

    return eval_step
