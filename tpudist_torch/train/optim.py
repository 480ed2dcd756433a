"""Optimizer construction with learning-rate schedules — the counterpart of
:mod:`tpudist.train.optim`.

The schedules reproduce optax's formulas; Adam and AdamW are PyTorch's own
(the update ``m̂ / (√v̂ + ε)`` with ε 1e-8 equals optax's, and AdamW's
decoupled decay ``p ← p − lr·wd·p`` equals optax's ``adamw``), decayed only
where ``ndim > 1`` as the JAX mask does; ``grad_clip`` is a global-norm clip
with optax's ``clip_by_global_norm`` formula, applied in a step pre-hook so
the optimizer clips itself as ``optax.chain(clip, opt)`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch

SCHEDULES = ("constant", "cosine", "warmup_cosine")
OPTIMIZERS = ("adam", "adamw", "adafactor", "lion")


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def sched(count: int) -> float:
        c = min(float(count), float(decay_steps))
        cos = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cos + alpha)

    return sched


def build_schedule(lr: float, *, schedule: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 1000,
                   min_lr_ratio: float = 0.1) -> Union[float, Callable]:
    """The learning rate (``constant``) or a ``step -> lr`` function, step
    counting optimizer updates from 0:

    - ``cosine``: cosine decay from ``lr`` to ``lr·min_lr_ratio`` over
      ``total_steps``;
    - ``warmup_cosine``: linear 0 → ``lr`` over ``warmup_steps``, then the
      cosine decay over the remainder (optax's
      ``warmup_cosine_decay_schedule``)."""
    if schedule == "constant":
        return lr
    if schedule == "cosine":
        return _cosine(lr, max(total_steps, 1), min_lr_ratio)
    if schedule == "warmup_cosine":
        decay_steps = max(total_steps, warmup_steps + 1)
        end = lr * min_lr_ratio
        cos = _cosine(lr, decay_steps - warmup_steps,
                      0.0 if lr == 0.0 else end / lr)

        def sched(count: int) -> float:
            if count < warmup_steps:
                return lr * min(count, warmup_steps) / warmup_steps
            return cos(count - warmup_steps)

        return sched
    raise ValueError(f"unknown lr schedule {schedule!r}; pick from "
                     f"{SCHEDULES}")


def clip_grad_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Rescale the gradients in place when their global L2 norm exceeds
    ``max_norm`` (optax: ``g · max_norm / norm``, untouched below it).
    Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


def build_optimizer(params, lr: float, *, optimizer: str = "adam",
                    schedule: str = "constant", warmup_steps: int = 0,
                    total_steps: int = 1000, min_lr_ratio: float = 0.1,
                    grad_clip: float = 0.0, weight_decay: float = 0.0
                    ) -> Tuple[torch.optim.Optimizer,
                               Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """``(optimizer, scheduler)`` over ``params`` (an iterable of tensors or
    ``(name, tensor)`` pairs); ``scheduler`` is None for a constant lr and
    is stepped once per optimizer update otherwise.

    ``adam`` (``weight_decay > 0`` upgrades it to ``adamw``, as in the JAX
    package), ``adamw`` with decay on ``ndim > 1`` tensors only; ``adafactor``
    and ``lion`` are not ported and raise."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; pick from "
                         f"{OPTIMIZERS}")
    if optimizer in ("adafactor", "lion"):
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet: ROADMAP queue A, "
            "item 6e")
    params = [p[1] if isinstance(p, tuple) else p for p in params]
    if optimizer == "adam" and weight_decay > 0:
        optimizer = "adamw"
    if optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        groups = [
            {"params": [p for p in params if p.dim() > 1],
             "weight_decay": weight_decay},
            {"params": [p for p in params if p.dim() <= 1],
             "weight_decay": 0.0},
        ]
        opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)
    if grad_clip > 0:
        def clip(optim, args, kwargs):
            clip_grad_global_norm_(
                [p for g in optim.param_groups for p in g["params"]],
                grad_clip)

        opt.register_step_pre_hook(clip)
    sched = build_schedule(lr, schedule=schedule, warmup_steps=warmup_steps,
                           total_steps=total_steps,
                           min_lr_ratio=min_lr_ratio)
    if not callable(sched):
        return opt, None
    # LambdaLR scales each group's initial lr by the factor: an initial lr
    # of 1 makes the factor the scheduled value itself (sched(0) from here)
    for g in opt.param_groups:
        g["lr"] = 1.0
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)


def build_optimizer_from_args(args, params):
    """The shared-CLI spelling (``--lr/--optimizer/--lr_schedule/
    --warmup_steps/--total_iterations/--grad_clip/--weight_decay``) of
    :func:`build_optimizer` over ``params``: ``(optimizer, scheduler)``."""
    return build_optimizer(
        params, args.lr, optimizer=getattr(args, "optimizer", "adam"),
        schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        total_steps=args.total_iterations,
        grad_clip=getattr(args, "grad_clip", 0.0),
        weight_decay=getattr(args, "weight_decay", 0.0))
