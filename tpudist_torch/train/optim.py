"""Optimizer construction with learning-rate schedules — the counterpart of
:mod:`tpudist.train.optim`.

The schedules reproduce optax's formulas; Adam and AdamW are PyTorch's own
(the update ``m̂ / (√v̂ + ε)`` with ε 1e-8 equals optax's, and AdamW's
decoupled decay ``p ← p − lr·wd·p`` equals optax's ``adamw``), decayed only
where ``ndim > 1`` as the JAX mask does.  :class:`Adafactor` and
:class:`Lion` are written here from optax's own chains (``optax.adafactor``
and ``optax.lion`` at the JAX package's settings), with no library
optimizer.  ``grad_clip`` is a global-norm clip with optax's
``clip_by_global_norm`` formula, applied in a step pre-hook so the optimizer
clips itself as ``optax.chain(clip, opt)`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
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


def decay_mask(p: torch.Tensor) -> bool:
    """The JAX package's weight-decay mask: weight matrices only
    (``ndim > 1``), never LayerNorm scales or biases."""
    return p.dim() > 1


def _factored_dims(shape, min_dim: int) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the second-largest and the largest axis
    (in ``np.argsort`` order) when the second-largest is at least
    ``min_dim``, else ``None``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _safe_rms(x: torch.Tensor, min_rms: float) -> torch.Tensor:
    """``max(sqrt(mean(x²)), min_rms)`` (optax ``safe_root_mean_squares``)."""
    rms = torch.sqrt(torch.mean(x * x))
    return torch.where(rms <= min_rms, torch.full_like(rms, min_rms), rms)


# optax.adafactor's defaults, as the JAX package builds it
FACTOR_MIN_DIM = 128
FACTOR_DECAY_RATE = 0.8
FACTOR_CLIP = 1.0
FACTOR_EPS = 1e-30
PARAM_SCALE_MIN = 1e-3
# optax.lion's defaults
LION_B1, LION_B2 = 0.9, 0.99


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` at its defaults, step by step in f32:

    1. factored second moments (``scale_by_factored_rms``): decay
       ``β₂(t) = 1 − (t+1)^−0.8`` taken in f32; a tensor whose two largest
       axes are both at least 128 keeps a row and a column mean of
       ``g² + 1e-30``, any other tensor the full ``g² + 1e-30``;
    2. the update's own RMS clipped to 1;
    3. scaled by the learning rate, then by the parameter's RMS (at least
       1e-3);
    4. ``+ weight_decay_rate · p`` on weight matrices (:func:`decay_mask`);
    5. subtracted from the parameter.

    No momentum, as the JAX package builds it."""

    def __init__(self, params, lr: float = 1e-3, *,
                 weight_decay_rate: float = 0.0):
        super().__init__(params, dict(lr=lr))
        self.weight_decay_rate = weight_decay_rate

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                self._update(p, p.grad.float(), lr)
        return loss

    def _update(self, p: torch.Tensor, g: torch.Tensor, lr: float) -> None:
        st = self.state[p]
        dims = _factored_dims(tuple(p.shape), FACTOR_MIN_DIM)
        if not st:
            st["step"] = torch.zeros((), dtype=torch.int64)
            if dims is None:
                st["v"] = torch.zeros_like(p, dtype=torch.float32)
            else:
                d1, d0 = dims
                st["v_row"] = torch.zeros(
                    [n for i, n in enumerate(p.shape) if i != d0],
                    dtype=torch.float32, device=p.device)
                st["v_col"] = torch.zeros(
                    [n for i, n in enumerate(p.shape) if i != d1],
                    dtype=torch.float32, device=p.device)
        t = torch.tensor(float(int(st["step"]) + 1), dtype=torch.float32,
                         device=p.device)
        decay = 1.0 - t ** (-FACTOR_DECAY_RATE)
        g_sqr = g * g + FACTOR_EPS
        if dims is None:
            st["v"] = decay * st["v"] + (1.0 - decay) * g_sqr
            u = g * st["v"] ** -0.5
        else:
            d1, d0 = dims
            st["v_row"] = (decay * st["v_row"]
                           + (1.0 - decay) * g_sqr.mean(dim=d0))
            st["v_col"] = (decay * st["v_col"]
                           + (1.0 - decay) * g_sqr.mean(dim=d1))
            rd1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = st["v_row"].mean(dim=rd1, keepdim=True)
            row_factor = (st["v_row"] / row_col_mean) ** -0.5
            col_factor = st["v_col"] ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        st["step"] += 1
        u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / FACTOR_CLIP,
                            min=1.0)
        u = lr * u
        u = u * _safe_rms(p.float(), PARAM_SCALE_MIN)
        if self.weight_decay_rate and decay_mask(p):
            u = u + self.weight_decay_rate * p
        p.add_(-1 * u)


class Lion(torch.optim.Optimizer):
    """``optax.lion`` at ``b1 = 0.9, b2 = 0.99``: the update
    ``sign((1 − b1)·g + b1·m)``, the momentum ``m ← (1 − b2)·g + b2·m``,
    ``+ weight_decay · p`` on weight matrices (:func:`decay_mask`), then
    scaled by ``−lr``."""

    def __init__(self, params, lr: float = 1e-4, *,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr))
        self.weight_decay = weight_decay

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                mu = st["mu"]
                u = torch.sign((1.0 - LION_B1) * g + LION_B1 * mu)
                st["mu"] = (1.0 - LION_B2) * g + LION_B2 * mu
                if decay_mask(p):
                    u = u + self.weight_decay * p
                p.add_(-lr * u)
        return loss


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
    package), ``adamw`` with decay on ``ndim > 1`` tensors only,
    :class:`Adafactor` (``weight_decay`` as its ``weight_decay_rate``) and
    :class:`Lion`, both decaying ``ndim > 1`` tensors only."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; pick from "
                         f"{OPTIMIZERS}")
    params = [p[1] if isinstance(p, tuple) else p for p in params]
    if optimizer == "adam" and weight_decay > 0:
        optimizer = "adamw"
    if optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "adafactor":
        opt = Adafactor(params, lr=lr, weight_decay_rate=weight_decay)
    elif optimizer == "lion":
        opt = Lion(params, lr=lr, weight_decay=weight_decay)
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
