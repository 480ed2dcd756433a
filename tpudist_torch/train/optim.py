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


def _leaf_of(p):
    """The :class:`~tpudist_torch.parallel.zero.LeafShard` a piece of a
    sharded leaf carries; a plain tensor is the one piece of its own leaf
    (no split dimension, no process axis)."""
    info = getattr(p, "_tpudist_leaf", None)
    if info is None:
        from tpudist_torch.parallel.zero import LeafShard

        info = LeafShard(tuple(p.shape), None, None, f"id{id(p)}")
    return info


def clip_grad_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Rescale the gradients in place when their global L2 norm exceeds
    ``max_norm`` (optax: ``g · max_norm / norm``, untouched below it).
    Returns the norm.

    A piece of a leaf sharded over a process group
    (:class:`tpudist_torch.parallel.zero.LeafShard`) adds its squares to a
    sum all-reduced over that group; every other tensor — a replicated
    one, a tensor-parallel piece (the pieces of a leaf split it) — counts
    once, here.  A pipeline stage's block parameter held by one rank of
    the stage subgroup (``_tpudist_stage_axis``, :mod:`tpudist_torch.
    parallel.pipeline_lm`) adds its squares to a sum all-reduced over that
    subgroup, so the replicated embedding and head count once."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return torch.zeros(())
    dev = params[0].grad.device
    total, axes = 0.0, {}
    for p in params:
        part = (p.grad.float() ** 2).sum().to(dev)
        ax = getattr(p, "_tpudist_stage_axis", None) or _leaf_of(p).axis
        if ax is None or ax.size == 1:
            total = total + part
        else:
            axes[id(ax)] = (ax, axes.get(id(ax), (ax, 0.0))[1] + part)
    for ax, part in axes.values():
        total = total + ax.all_reduce(part)
    norm = torch.sqrt(total)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for p in params:
        p.grad.mul_(factor.to(p.grad.device, p.grad.dtype))
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

    No momentum, as the JAX package builds it.

    A leaf may arrive in pieces (:class:`tpudist_torch.parallel.zero.
    LeafShard`: FSDP/ZeRO-1 shards over the data group, tensor-parallel
    pieces in this process).  The pieces of one leaf step together: the
    factored axes are those of the whole leaf, a mean along the split
    dimension and the two RMS values are sums over the pieces and the
    process group, and each piece keeps its own slice of a statistic that
    runs along the split dimension — the numbers of the whole leaf."""

    def __init__(self, params, lr: float = 1e-3, *,
                 weight_decay_rate: float = 0.0):
        super().__init__(params, dict(lr=lr))
        self.weight_decay_rate = weight_decay_rate

    @staticmethod
    def slot_shapes(full_shape, local_shape) -> dict:
        """The shapes of a piece's ``v_row``, ``v_col`` and ``v`` (only the
        slots it keeps) for a leaf of ``full_shape``."""
        dims = _factored_dims(tuple(full_shape), FACTOR_MIN_DIM)
        if dims is None:
            return {"v": tuple(local_shape)}
        d1, d0 = dims
        return {"v_row": tuple(n for i, n in enumerate(local_shape)
                               if i != d0),
                "v_col": tuple(n for i, n in enumerate(local_shape)
                               if i != d1)}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = group["lr"]
            leaves = {}
            for p in group["params"]:
                if p.grad is not None:
                    leaves.setdefault(_leaf_of(p).key, []).append(p)
            for pieces in leaves.values():
                self._update(pieces, lr)
        return loss

    def _init_state(self, p: torch.Tensor, full_shape) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.int64)
            for k, shape in self.slot_shapes(full_shape, p.shape).items():
                st[k] = torch.zeros(shape, dtype=torch.float32,
                                    device=p.device)
        return st

    def _update(self, pieces, lr: float) -> None:
        """One update of a leaf from its pieces (the class doc; a plain
        tensor is one piece)."""
        info = _leaf_of(pieces[0])
        full, s = tuple(info.full_shape), info.dim
        numel = float(math.prod(full))
        dims = _factored_dims(full, FACTOR_MIN_DIM)
        sts = [self._init_state(p, full) for p in pieces]
        gs = [p.grad.float() for p in pieces]
        t = torch.tensor(float(int(sts[0]["step"]) + 1), dtype=torch.float32)
        decay = 1.0 - t ** (-FACTOR_DECAY_RATE)

        def mean_over(xs, dim, keepdim=False):
            """Each piece's mean of the whole leaf along ``dim``."""
            if dim != s:
                return [x.mean(dim=dim, keepdim=keepdim) for x in xs]
            return [x / full[dim] for x in info.total(
                [x.sum(dim=dim, keepdim=keepdim) for x in xs])]

        g_sqr = [g * g + FACTOR_EPS for g in gs]
        us = []
        if dims is None:
            for st, g, q in zip(sts, gs, g_sqr):
                dk = decay.to(g.device)
                st["v"] = dk * st["v"] + (1.0 - dk) * q
                us.append(g * st["v"] ** -0.5)
        else:
            d1, d0 = dims
            rd1 = d1 - 1 if d1 > d0 else d1
            vrs, vcs = mean_over(g_sqr, d0), mean_over(g_sqr, d1)
            for st, vr, vc in zip(sts, vrs, vcs):
                dk = decay.to(vr.device)
                st["v_row"] = dk * st["v_row"] + (1.0 - dk) * vr
                st["v_col"] = dk * st["v_col"] + (1.0 - dk) * vc
            # v_row runs along the split dimension when it is d1
            rows = [st["v_row"] for st in sts]
            if s == d1:
                rcm = [x / full[d1] for x in info.total(
                    [r.sum(dim=rd1, keepdim=True) for r in rows])]
            else:
                rcm = [r.mean(dim=rd1, keepdim=True) for r in rows]
            for st, g, r, m in zip(sts, gs, rows, rcm):
                row_factor = (r / m) ** -0.5
                col_factor = st["v_col"] ** -0.5
                us.append(g * row_factor.unsqueeze(d0)
                          * col_factor.unsqueeze(d1))
        for st in sts:
            st["step"] += 1
        sq = info.total([(u * u).sum() for u in us])
        us = [u / torch.clamp(torch.sqrt(q / numel) / FACTOR_CLIP, min=1.0)
              for u, q in zip(us, sq)]
        psq = info.total([(p.float() ** 2).sum() for p in pieces])
        for p, u, q in zip(pieces, us, psq):
            rms = torch.sqrt(q / numel)
            rms = torch.where(rms <= PARAM_SCALE_MIN,
                              torch.full_like(rms, PARAM_SCALE_MIN), rms)
            u = lr * u * rms
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
    # the step counters the JAX package's optax chain keeps: the optimizer's
    # and, under a schedule, scale_by_schedule's (parallel/fsdp.py counts
    # them for state_bytes_per_device)
    opt.jax_counters = 1 + (schedule != "constant")
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
