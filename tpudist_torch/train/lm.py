"""LM train and eval steps for the Transformer family — the counterpart of
:mod:`tpudist.train.lm` on a data-parallel mesh.

Where the JAX step is one program over the ``data`` axis whose compiler
inserts the gradient all-reduce, here each process holds a full replica and,
when a process group is up, the model is wrapped in
``DistributedDataParallel`` (as the toy step, :mod:`tpudist_torch.train.
step`): each rank steps on its own equal share of the global batch, DDP
averages the gradients on the device group, and the reported loss is the
global mean (an all-reduce average of the per-rank means), as the JAX
step's is.

Sequence parallelism (``ctx``, a :class:`~tpudist_torch.models.transformer.
RingCausal` over a ring of :mod:`tpudist_torch.parallel`): each rank holds
its data row's rows and its shards of their tokens, a batch is the pair
``(tokens, targets)`` of :meth:`~tpudist_torch.parallel.SeqLayout.place`
and the loss :meth:`~tpudist_torch.parallel.SeqLayout.loss`, each rank's
share counted against the global number of targets, so that DDP's average
over every rank is the gradient of the global mean and :func:`_global_mean`
reports the global batch's loss.

``state_sharding`` (a :class:`~tpudist_torch.parallel.fsdp.Layout`: FSDP,
ZeRO-1, tensor parallelism or a merge of them) replaces DDP with the
runtime of :mod:`tpudist_torch.parallel.zero`, which carries the plan out
around the same forward and backward: the reported loss and the update are
replicated data parallelism's.  ``grad_reduce_dtype`` narrows the gradient
mean to that dtype, as the JAX package's compressed step does (sum at the
narrow dtype, divide, cast back to f32).

``aux`` returns the MoE layers' routing statistics beside the loss
(averaged over layers, as the JAX step's ``_collect_aux``), and
``moe_balance_weight`` adds that multiple of their balance loss to the
loss the step differentiates, never to the one it reports.
:func:`make_scanned_lm_train_step` runs ``K`` steps a call.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from tpudist_torch.models.transformer import lm_loss, sown_stats

#: the MoE statistics ``aux`` returns, by the JAX step's names
AUX_NAMES = ("moe_dropped_fraction", "moe_expert_load", "moe_balance_loss")


def _global_mean(loss: torch.Tensor) -> torch.Tensor:
    """The mean of every rank's ``loss`` (equal per-rank batches make it
    the global batch's mean), all-reduced on the device group and queued
    on the device; ``loss`` itself without a process group."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return loss
    buf = loss.detach().clone()
    dist.all_reduce(buf)
    return buf / dist.get_world_size()


def _split(batch):
    """``(tokens, targets)`` of a batch: a ``(tokens, targets)`` pair, or
    a token batch that is its own loss target (``lm_loss``'s form)."""
    if isinstance(batch, (tuple, list)):
        return batch[0], batch[1]
    return batch, batch


def _forward_loss(replica, batch, ctx, loss_fn):
    tokens, targets = _split(batch)
    logits = replica(tokens) if ctx is None else replica(tokens, ctx)
    return loss_fn(logits, targets)


def _collect_aux(sown) -> dict:
    """The JAX step's ``_collect_aux``: each statistic of the sown
    :class:`~tpudist_torch.parallel.MoEStats` averaged over the layers
    (empty when nothing was sown)."""
    if not sown:
        return {}
    return {name: torch.stack([st[i] for st in sown]).mean(0)
            for i, name in enumerate(AUX_NAMES)}


def _compressed_mean_(params, dtype) -> None:
    """The JAX compressed step's ``pmean(g.astype(dtype))`` then f32: every
    gradient cast to ``dtype``, summed over the process group at that dtype
    (one flat all-reduce), divided by the world size there, and cast back —
    rounded to ``dtype`` also at world size 1, as JAX's are."""
    import torch.distributed as dist

    live = [p for p in params if p.grad is not None]
    if not live:
        return
    flat = torch.cat([p.grad.reshape(-1).to(dtype) for p in live])
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(flat)
        flat.div_(dist.get_world_size())
    off = 0
    for p in live:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view(p.grad.shape).to(p.grad.dtype))
        off += n


def _check_compressed(grad_reduce_dtype, state_sharding, aux, accum_steps,
                      ctx) -> None:
    """The JAX package's refusals for ``grad_reduce_dtype``."""
    if grad_reduce_dtype is None:
        return
    if state_sharding is not None or aux or accum_steps != 1:
        raise ValueError(
            "grad_reduce_dtype requires the pure-DP step (replicated "
            "state; no aux/moe_balance_weight/accum_steps)")
    if ctx is not None:
        raise ValueError("grad_reduce_dtype supports data-only meshes; axes "
                         "['seq'] have size > 1")


def make_lm_train_step(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, *, scheduler=None,
                       accum_steps: int = 1,
                       loss_fn: Callable = lm_loss,
                       wrap: Optional[Callable] = None, ctx=None,
                       grad_reduce_dtype=None, state_sharding=None,
                       aux: bool = False,
                       moe_balance_weight: float = 0.0) -> Callable:
    """``step(tokens [batch, seq]) -> loss``: forward, backward, one
    optimizer update (and one scheduler step) on this rank's rows.  With
    ``ctx`` (an attention context the model is called with, the ring's)
    the batch may be a ``(tokens, targets)`` pair, and ``loss_fn`` takes
    the targets.

    The step calls ``model`` — or ``wrap(model)``, a module whose
    parameters are the model's (the Trainer's bf16 cast) — wrapped in
    ``DistributedDataParallel`` when a process group is up (``step.replica``
    is what it calls).  The returned loss is the global mean over the
    process group.

    ``accum_steps`` > 1 splits the batch into that many microbatches, sums
    their gradients and scales the sum (and the reported loss) by
    ``1 / accum_steps`` before the update, as the JAX step's ``lax.scan``
    does; the batch must divide evenly.  The microbatches before the last
    run under DDP's ``no_sync()``, so there is one gradient all-reduce per
    update.  The loss comes back as a detached 0-d tensor on the model's
    device (no host sync).

    ``state_sharding`` — a layout of ``model`` and ``optimizer``
    (:func:`~tpudist_torch.parallel.fsdp_sharding`,
    :func:`~tpudist_torch.parallel.zero1_sharding`,
    :func:`~tpudist_torch.models.transformer.transformer_tp_sharding`,
    :func:`~tpudist_torch.parallel.merge_shardings`) whose mesh carries the
    process groups — shards the state before the first step
    (:func:`tpudist_torch.parallel.zero.shard_state`): ``step.runtime`` is
    the runtime, ``step.replica`` what the step calls, ``step.optimizer``
    the optimizer over the shards as checkpoints see it.  ``wrap`` may then
    only be a cast with a ``compute_dtype`` (the Trainer's ``BF16Apply``).
    ``grad_reduce_dtype`` (e.g. ``torch.bfloat16``) reduces the gradients
    at that dtype (:func:`_compressed_mean_`) with the JAX step's refusals.

    ``aux`` makes the step return ``(loss, aux)``: ``aux`` holds the MoE
    layers' ``moe_dropped_fraction``, ``moe_expert_load [n_experts]`` and
    ``moe_balance_loss``, each a mean over the layers (detached; empty for
    a model without MoE layers).  ``moe_balance_weight > 0`` adds that
    multiple of the mean balance loss to the loss the backward runs from
    (router load balancing trains also without ``aux``); the returned loss
    stays the plain LM loss."""
    import torch.distributed as dist

    need_inters = aux or moe_balance_weight > 0.0
    _check_compressed(grad_reduce_dtype, state_sharding, need_inters,
                      accum_steps, ctx)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters (build it "
                         "with create_transformer(..., trainable=True))")
    runtime = None
    if state_sharding is not None:
        from tpudist_torch.parallel.zero import shard_state

        cast = getattr(wrap, "compute_dtype", None)
        if wrap is not None and cast is None:
            raise ValueError("under state_sharding, wrap must be a cast "
                             "with a compute_dtype (BF16Apply)")
        runtime = shard_state(model, optimizer, state_sharding, cast=cast)
        replica, opt = runtime, runtime.optimizer
        params = runtime.grad_tensors()
    else:
        replica, opt = (wrap(model) if wrap is not None else model), \
            optimizer
        if dist.is_initialized() and grad_reduce_dtype is None:
            from tpudist_torch.train.step import ddp_device_ids

            replica = torch.nn.parallel.DistributedDataParallel(
                replica, device_ids=ddp_device_ids(model))
    no_sync = getattr(replica, "no_sync", contextlib.nullcontext)

    def run(batch):
        """``(lm loss, aux)`` of one (micro)batch, its backward done."""
        if not need_inters:
            loss = _forward_loss(replica, batch, ctx, loss_fn)
            loss.backward()
            return loss.detach(), {}
        with sown_stats(model) as sown:
            loss = _forward_loss(replica, batch, ctx, loss_fn)
        total = loss
        if moe_balance_weight > 0.0 and sown:
            total = total + moe_balance_weight * torch.stack(
                [st.balance_loss for st in sown]).mean()
        total.backward()
        return loss.detach(), {k: v.detach()
                               for k, v in _collect_aux(sown).items()}

    def step(tokens: torch.Tensor):
        opt.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss, collected = run(tokens)
        else:
            parts = _split(tokens)
            b = parts[0].shape[0]
            if b % accum_steps:
                raise ValueError(
                    f"batch {b} must divide into {accum_steps} accum steps")
            loss, collected = 0.0, {}
            chunks = list(zip(*(t.reshape(accum_steps, b // accum_steps,
                                          *t.shape[1:]) for t in parts)))
            for i, chunk in enumerate(chunks):
                last = i == accum_steps - 1
                with (contextlib.nullcontext() if last else no_sync()):
                    part, got = run(chunk)
                loss = loss + part
                collected = {k: collected.get(k, 0.0) + v
                             for k, v in got.items()}
            scale = 1.0 / accum_steps
            loss = loss * scale
            collected = {k: v * scale for k, v in collected.items()}
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        if grad_reduce_dtype is not None:
            _compressed_mean_(params, grad_reduce_dtype)
        opt.step()
        if scheduler is not None:
            scheduler.step()
        if aux:
            return _global_mean(loss), collected
        return _global_mean(loss)

    step.replica, step.runtime, step.optimizer = replica, runtime, opt
    return step


def fsdp_overlap_mlp_fn(mesh, *, axis_name: str = "data",
                        overlap: Optional[str] = None):
    """The ``TPUDIST_OVERLAP``-driven overlapped FSDP MLP for
    ``create_transformer(mlp_fn=...)`` (or ``model.mlp_fn = ...``), or
    ``None`` when off (:func:`tpudist_torch.parallel.overlap_fsdp_mlp`).
    Under ``make_lm_train_step(state_sharding=fsdp_sharding(mesh, ...))``
    the runtime then hands each block its ``wi``/``wo`` pieces instead of
    gathering them."""
    from tpudist_torch.parallel.fsdp import overlap_fsdp_mlp

    return overlap_fsdp_mlp(mesh, axis_name=axis_name, overlap=overlap)


def chunk_token_sharding(mesh) -> tuple:
    """The spec of a ``[K, batch, seq]`` token window: the iteration axis
    whole, the batch over ``data`` and the tokens over ``seq`` where the
    mesh has them (each rank steps on its rows and its shard of them)."""
    names = getattr(mesh, "axis_names", ())
    return (None, "data" if "data" in names else None,
            "seq" if "seq" in names else None)


def make_scanned_lm_train_step(model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer, *,
                               loss_fn: Callable = lm_loss, scheduler=None,
                               ctx=None, state_sharding=None,
                               wrap: Optional[Callable] = None) -> Callable:
    """``chunk_step(tokens [K, batch, seq]) -> losses (K,)``: ``K``
    optimizer steps a call, one a window row, with the per-step losses
    kept (the JAX ``make_scanned_lm_train_step``, whose ``lax.scan``
    amortises dispatch; here the steps run one after another on the
    device queue, and the losses are the ``K`` plain steps' bit for bit).
    A ``(tokens, targets)`` pair of ``[K, ...]`` windows goes with ``ctx``
    (the ring's).  The plain step's extras (MoE aux, accumulation, the
    compressed reduce) are out of scope, as in JAX."""
    step = make_lm_train_step(model, optimizer, scheduler=scheduler,
                              loss_fn=loss_fn, wrap=wrap, ctx=ctx,
                              state_sharding=state_sharding)

    def chunk_step(tokens_chunk) -> torch.Tensor:
        rows = (list(zip(*tokens_chunk)) if isinstance(
            tokens_chunk, (tuple, list)) else list(tokens_chunk))
        return torch.stack([step(r) for r in rows])

    chunk_step.replica, chunk_step.runtime = step.replica, step.runtime
    chunk_step.optimizer = step.optimizer
    return chunk_step


def make_lm_eval_step(model: torch.nn.Module, *,
                      loss_fn: Callable = lm_loss, ctx=None,
                      params_sharding=None) -> Callable:
    """``eval_step(tokens) -> loss`` without gradients, on this rank's
    batch (the entry point evaluates the same held-out batches on every
    rank).  With ``ctx`` (the ring's) the batch may be a ``(tokens,
    targets)`` pair and each rank holds a share of the loss: the global
    mean over the process group is returned, as the train step's.
    ``params_sharding`` is the layout the train step keeps, as its runtime
    (``step.runtime``): the forward gathers the shards it needs, as the
    JAX eval step runs under the train step's ``params_sharding``."""
    forward = model if params_sharding is None else params_sharding

    def eval_step(tokens) -> torch.Tensor:
        with torch.no_grad():
            loss = _forward_loss(forward, tokens, ctx, loss_fn)
        return loss if ctx is None else _global_mean(loss)

    return eval_step
