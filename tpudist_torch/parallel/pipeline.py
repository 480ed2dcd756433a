"""Pipeline parallelism: microbatched schedules over the ``stage`` mesh axis —
the counterpart of :mod:`tpudist.parallel.pipeline`.

The JAX package runs a schedule as one ``lax.scan`` of ticks inside a
``shard_map``: at every tick each stage applies its stage function to the
activation it holds and ``lax.ppermute`` moves activations one stage on
(and, in 1F1B, cotangents one stage back).  Here a schedule is a Python
loop over the same ticks, over the places of the stage axis this process
holds (``stages``, the mesh's stage chain, a ring of :mod:`tpudist_torch.
parallel.ring`):

- a :class:`~tpudist_torch.parallel.LocalRing` — a job of one process:
  every stage folds onto the rank's device and each tick runs every
  stage's units in stage order, so each stage makes the launches, in the
  order, that its rank would make;
- a :class:`~tpudist_torch.parallel.ProcessGroupRing` — one stage a rank
  of the stage subgroup.

**The hop.**  A hop hands a tensor to the next stage (or back to the
previous one): over a subgroup it is ``_post_exchange`` of
:mod:`tpudist_torch.parallel.ring` (``batch_isend_irecv``, NCCL on cards,
gloo on the CPU), one-sided where the chain ends; in a folded job the
tensor moves to the next stage's device.  JAX permutes on every tick, live
or dead, and masks what a dead unit produced.  Here a dead unit computes
and launches nothing, so it has nothing to send: **both sides of every hop
read the same static table of live units** — a stage sends at tick ``t``
exactly when the unit that produced the tensor is live, and its neighbour
posts the receive exactly when that same unit is live, computed from the
same formula (GPipe, 1F1B) or the same ``[T, D]`` table
(:mod:`~tpudist_torch.parallel.pipeline_interleaved`).  A send therefore
never lacks its receive, and no rank waits on a hop its neighbour skipped.

**GPipe** (:func:`pipeline_shard`) runs every microbatch's forward with its
graph kept, then the backwards in a fixed order (the reverse of the
forward ticks, the cotangents hopping back), inside one autograd function.
Leaving the backward to autograd would let it run the ``M`` microbatch
backwards in any order, and across processes each receive blocks until its
neighbour sends: a different order on two ranks deadlocks.  The fixed
order is the same function and keeps GPipe's O(M) memory.

**1F1B** (:func:`pipeline_1f1b_shard`) interleaves a forward and a backward
unit every tick; the backward recomputes the stage forward from the saved
stage input (``detach().requires_grad_()`` then ``torch.autograd.grad``,
what JAX's ``jax.vjp(stage_fn, p, a_saved)`` does), the inputs held in a
ring of depth ``2S−1`` indexed ``m mod (2S−1)``.

The stage parameters of a place are a pytree of tensors (dicts, lists,
tuples) or an ``nn.Module``; their gradients are taken with respect to
its leaves that require grad (a module's parameters), and come back in the
same structure (a module's as a list in ``parameters()`` order).

The JAX module's ``head_grad_branches`` and ``_collectives_in_jaxpr`` check
a jaxpr so that a ``lax.cond`` whose predicate varies per device cannot
hold a collective; here the head is plain code that runs only where the
last stage is, so there is nothing to check.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree

from tpudist_torch.parallel.ring import _post_exchange

__all__ = ["StageFn", "make_pipeline", "pipeline_1f1b_shard",
           "pipeline_shard"]

# StageFn: (stage_params, activation [micro_batch, ...]) -> activation
StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _leaves(params) -> List[torch.Tensor]:
    """The tensors of one place's stage parameters that gradients are
    taken with respect to."""
    if isinstance(params, nn.Module):
        return [p for p in params.parameters() if p.requires_grad]
    return [t for t in pytree.tree_leaves(params)
            if torch.is_tensor(t) and t.requires_grad]


def _like(params, grads: List[torch.Tensor]):
    """``grads`` (one a leaf of :func:`_leaves`) in ``params``'
    structure."""
    if isinstance(params, nn.Module):
        return list(grads)
    flat, spec = pytree.tree_flatten(params)
    it = iter(grads)
    return pytree.tree_unflatten(
        [next(it) if torch.is_tensor(t) and t.requires_grad else None
         for t in flat], spec)


def _add(acc: Optional[List[torch.Tensor]], grads, leaves):
    """``acc`` plus one unit's leaf gradients, summed in place into
    accumulators of the schedule's own (a gradient may alias the
    cotangent it came from)."""
    if acc is None:
        return [torch.zeros_like(t) if g is None else g.clone()
                for g, t in zip(grads, leaves)]
    for a, g in zip(acc, grads):
        if g is not None:
            a.add_(g)
    return acc


def _vjp(stage_fn: StageFn, params, a_saved: torch.Tensor,
         cot: torch.Tensor, out: Optional[torch.Tensor] = None,
         a: Optional[torch.Tensor] = None):
    """``(dparams, da)`` of ``stage_fn(params, a_saved)`` at ``cot``: the
    forward recomputed from the saved input, or ``out`` of the leaf ``a``
    when the forward's graph was kept."""
    leaves = _leaves(params)
    if out is None:
        a = a_saved.detach().requires_grad_()
        with torch.enable_grad():
            out = stage_fn(params, a)
    grads = torch.autograd.grad(out, [a] + leaves, cot, allow_unused=True)
    da = torch.zeros_like(a) if grads[0] is None else grads[0]
    return list(grads[1:]), da


def hop(stages, sends: Dict[int, torch.Tensor], receivers: Iterable[int],
        step: int, like: torch.Tensor) -> Dict[int, torch.Tensor]:
    """One hop along the stage axis: place ``p`` of ``sends`` hands its
    tensor to place ``(p + step) % size``, and each place of ``receivers``
    (places of this process) takes the one of ``(p - step) % size``.  The
    caller builds both from the same static table (the module doc); a
    folded axis moves the tensor onto the receiving place's device."""
    n = stages.size
    receivers = list(receivers)
    if stages.processes == 1:
        out = {}
        for r in receivers:
            t = sends[(r - step) % n]
            dev = stages.devices[r] if stages.devices is not None else None
            out[r] = t if dev is None else t.to(dev)
        return out
    me = stages.index
    t = sends.get(me)
    live = me in receivers
    buf, reqs = _post_exchange(
        None if t is None else t.contiguous(),
        stages.rank_at(step) if t is not None else None,
        stages.rank_at(-step) if live else None, stages.group, like=like)
    for req in reqs:
        req.wait()
    return {me: buf} if live else {}


def _is_last(stages) -> bool:
    return stages.size - 1 in stages.indices


class _GPipeRun:
    """One GPipe call's state between its forward and its backward."""

    def __init__(self, stage_params, stage_fn, stages, remat: bool):
        self.params = dict(zip(stages.indices, stage_params))
        self.stage_fn, self.stages, self.remat = stage_fn, stages, remat
        self.saved: Dict[tuple, tuple] = {}

    def forward(self, xm: torch.Tensor) -> torch.Tensor:
        stages, S = self.stages, self.stages.size
        M = xm.shape[0]
        outputs = torch.zeros_like(xm)
        state: Dict[int, torch.Tensor] = {}
        for t in range(M + S - 1):
            sends = {}
            for s in stages.indices:
                m = t - s
                if not 0 <= m < M:
                    continue  # a dead unit: nothing to compute or send
                a_in = xm[m] if s == 0 else state.pop(s)
                if self.remat:
                    with torch.no_grad():
                        out = self.stage_fn(self.params[s], a_in)
                    self.saved[(s, m)] = (a_in.detach(), None, None)
                else:
                    a = a_in.detach().requires_grad_()
                    with torch.enable_grad():
                        out = self.stage_fn(self.params[s], a)
                    self.saved[(s, m)] = (a_in.detach(), a, out)
                if s == S - 1:
                    outputs[m] = out.detach()
                else:
                    sends[s] = out.detach()
            state.update(hop(stages, sends, [
                s for s in stages.indices if s > 0 and 0 <= t - s + 1 < M],
                1, xm[0]))
        return outputs

    def backward(self, g: torch.Tensor):
        """The backwards in the reverse of the forward's tick order:
        ``(dx, grads)``, ``dx`` on stage 0's place (``None`` elsewhere),
        ``grads`` one list of leaf gradients a place."""
        stages, S = self.stages, self.stages.size
        M = g.shape[0]
        dx = torch.zeros_like(g) if 0 in stages.indices else None
        acc: Dict[int, Optional[List[torch.Tensor]]] = {
            s: None for s in stages.indices}
        cots: Dict[int, torch.Tensor] = {}
        for t in reversed(range(M + S - 1)):
            sends = {}
            for s in stages.indices:
                m = t - s
                if not 0 <= m < M:
                    continue
                cot = g[m] if s == S - 1 else cots.pop(s)
                a_saved, a, out = self.saved.pop((s, m))
                dp, da = _vjp(self.stage_fn, self.params[s], a_saved, cot,
                              out, a)
                acc[s] = _add(acc[s], dp, _leaves(self.params[s]))
                if s == 0:
                    dx[m] = da
                else:
                    sends[s] = da
            cots.update(hop(stages, sends, [
                s for s in stages.indices
                if s < S - 1 and 0 <= t - s - 1 < M], -1, g[0]))
        grads = [acc[s] if acc[s] is not None else
                 [torch.zeros_like(p) for p in _leaves(self.params[s])]
                 for s in stages.indices]
        return dx, grads


class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one autograd node over the input and every
    stage leaf of this process: its backward runs the microbatches'
    backwards in the fixed order of :meth:`_GPipeRun.backward`."""

    @staticmethod
    def forward(ctx, run: _GPipeRun, xm, *leaves):
        ctx.run = run
        return run.forward(xm)

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.run.backward(g.contiguous())
        flat = [t for place in grads for t in place]
        return (None, dx if ctx.needs_input_grad[1] else None, *flat)


def pipeline_shard(stage_params: Sequence, x_microbatches: torch.Tensor, *,
                   stage_fn: StageFn, stages,
                   remat: bool = False) -> torch.Tensor:
    """The GPipe body over this process's places of ``stages`` (the mesh's
    stage chain): ``stage_params`` holds one entry a place, in
    ``stages.indices`` order; ``x_microbatches [num_micro, micro_size,
    ...]`` is read on stage 0 (elsewhere only its shape and dtype).

    Returns ``[num_micro, micro_size, ...]`` — valid where the LAST stage
    is, zeros elsewhere (:func:`make_pipeline` hands it on to every
    stage).  Differentiable: the backward runs every microbatch's backward
    in a fixed order (the module doc) and gives the stage leaves and
    ``x_microbatches`` their gradients.  ``remat`` keeps only each unit's
    input and recomputes its forward in the backward (``jax.checkpoint``
    of the stage function)."""
    if len(stage_params) != len(stages.indices):
        raise ValueError(f"{len(stage_params)} stage params for the "
                         f"{len(stages.indices)} places of this process")
    run = _GPipeRun(stage_params, stage_fn, stages, remat)
    leaves = [t for p in stage_params for t in _leaves(p)]
    return _GPipe.apply(run, x_microbatches, *leaves)


def _data_mean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor's mean over the ``data`` group (one flat all-reduce);
    unchanged without a group of more than one rank."""
    import torch.distributed as dist

    if group is None or not dist.is_initialized():
        return tensors
    size = dist.get_world_size(group)
    if size == 1 or not tensors:
        return tensors
    return [t / size for t in _all_reduce(tensors, group)]


def _all_reduce(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The sums of ``tensors`` over ``group``, one flat all-reduce."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def _stage_sum(tensors: List[torch.Tensor], stages) -> List[torch.Tensor]:
    """The sums over the stage subgroup (``psum`` over the stage axis): a
    folded axis holds every stage already."""
    if stages.processes == 1:
        return tensors
    return _all_reduce(tensors, stages.group)


def _head(loss_fn, out_params, act: torch.Tensor, aux):
    """``(loss, d_out_params (a list a leaf), d_act)`` of ``loss_fn``."""
    flat, spec = pytree.tree_flatten(out_params)
    det = [t.detach().requires_grad_() if torch.is_tensor(t) else t
           for t in flat]
    a = act.detach().requires_grad_()
    with torch.enable_grad():
        loss = loss_fn(pytree.tree_unflatten(det, spec), a, aux)
    leaves = [t for t in det if torch.is_tensor(t)]
    grads = torch.autograd.grad(loss, leaves + [a], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves + [a])]
    return loss.detach().float(), grads[:-1], grads[-1]


def _out_tree(out_params, flat_grads):
    flat, spec = pytree.tree_flatten(out_params)
    it = iter(flat_grads)
    return pytree.tree_unflatten(
        [next(it) if torch.is_tensor(t) else None for t in flat], spec)


def _finish(loss_acc, og_acc, out_params, stages, data_group):
    """The loss and head-gradient sums over the stage axis, then their
    means over ``data``."""
    leaves = [t for t in pytree.tree_leaves(out_params) if torch.is_tensor(t)]
    og = og_acc if og_acc is not None else [torch.zeros_like(t)
                                            for t in leaves]
    summed = _stage_sum([loss_acc] + og, stages)
    summed = _data_mean(summed, data_group)
    return summed[0], _out_tree(out_params, summed[1:])


def pipeline_1f1b_shard(stage_params: Sequence, out_params,
                        x_microbatches: torch.Tensor, aux_microbatches, *,
                        stage_fn: StageFn, loss_fn, stages,
                        data_group=None):
    """The 1F1B schedule over this process's places of ``stages``: forward
    AND backward in one tick loop, per-stage recompute and an O(S) ring of
    stage inputs (the JAX ``pipeline_1f1b_shard``'s timeline):

    - forward of micro ``m`` on stage ``s`` at tick ``t = s + m``;
    - the last stage computes the microbatch loss and its cotangent the
      tick its forward lands (``loss_fn(out_params, act, aux) ->
      scalar``) and backwards it the same tick;
    - backward of micro ``m`` on stage ``s`` at tick ``2(S−1) − s + m``;
    - ``M + 2(S−1)`` ticks; stage inputs in a ring of depth ``2S − 1``,
      slot ``m mod (2S−1)``.

    ``x_microbatches [M, micro, ...]`` is read on stage 0 (elsewhere only
    its shape and dtype), ``aux_microbatches [M, ...]`` on the last stage.

    Returns ``(loss_sum, stage_grads, out_grads, dx_microbatches)``,
    UNNORMALISED sums over this shard's microbatches (the caller divides by
    ``M``): ``loss_sum`` and ``out_grads`` summed over the stage axis (the
    JAX ``psum``), ``stage_grads`` one gradient tree a place of this
    process (the structure of its ``stage_params``), and with
    ``data_group`` (the ``data`` axis's process group) all three averaged
    over it.  ``dx_microbatches`` is the cotangent of ``x_microbatches``
    where stage 0 is, ``None`` elsewhere: not summed over the stage axis as
    JAX's is, since the caller's embedding gradient — a smaller tensor —
    can be summed instead."""
    S = stages.size
    places = list(stages.indices)
    if len(stage_params) != len(places):
        raise ValueError(f"{len(stage_params)} stage params for the "
                         f"{len(places)} places of this process")
    params = dict(zip(places, stage_params))
    last = S - 1
    M = x_microbatches.shape[0]
    depth = 2 * S - 1
    like = x_microbatches[0]
    dev = like.device
    ring: Dict[int, List[Optional[torch.Tensor]]] = {
        s: [None] * depth for s in places}
    act: Dict[int, torch.Tensor] = {}
    cots: Dict[int, torch.Tensor] = {}
    dx = torch.zeros_like(x_microbatches) if 0 in places else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    og_acc = None
    sg: Dict[int, Optional[List[torch.Tensor]]] = {s: None for s in places}
    for t in range(M + 2 * (S - 1)):
        fsends, bsends, d_act = {}, {}, None
        for s in places:
            m = t - s
            if 0 <= m < M:
                a_in = x_microbatches[m] if s == 0 else act.pop(s)
                ring[s][m % depth] = a_in
                with torch.no_grad():
                    a_out = stage_fn(params[s], a_in)
                if s == last:
                    loss, d_og, d_act = _head(loss_fn, out_params, a_out,
                                              aux_microbatches[m])
                    loss_acc = loss_acc + loss.to(dev)
                    og_acc = d_og if og_acc is None else [
                        a + g for a, g in zip(og_acc, d_og)]
                else:
                    fsends[s] = a_out
            mb = t - 2 * (S - 1) + s
            if 0 <= mb < M:
                cot = d_act if s == last else cots.pop(s)
                a_saved = ring[s][mb % depth]
                ring[s][mb % depth] = None
                dp, da = _vjp(stage_fn, params[s], a_saved, cot)
                sg[s] = _add(sg[s], dp, _leaves(params[s]))
                if s == 0:
                    dx[mb] = da
                else:
                    bsends[s] = da
        act.update(hop(stages, fsends, [
            s for s in places if s > 0 and 0 <= t - s + 1 < M], 1, like))
        cots.update(hop(stages, bsends, [
            s for s in places
            if s < last and 0 <= t - 2 * (S - 1) + s + 1 < M], -1, like))
    loss_sum, og = _finish(loss_acc, og_acc, out_params, stages, data_group)
    grads = []
    for s in places:
        g = sg[s] if sg[s] is not None else [
            torch.zeros_like(p) for p in _leaves(params[s])]
        grads.append(_like(params[s], _data_mean(g, data_group)))
    return loss_sum, grads, og, dx


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every place of the stage axis (the JAX
    global view's ``out[-1]``): a broadcast over the subgroup.  Every rank
    then computes the same downstream value, of which the global view has
    one copy: the backward keeps the last stage's cotangent and gives the
    others none."""

    @staticmethod
    def forward(ctx, t, stages):
        import torch.distributed as dist

        ctx.last = _is_last(stages)
        out = t.detach().clone().contiguous()
        dist.broadcast(out, src=stages.ranks[-1], group=stages.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def from_last_stage(t: torch.Tensor, stages) -> torch.Tensor:
    """``t`` of the last stage, on every place of ``stages``."""
    if stages.processes == 1:
        return t
    return _FromLast.apply(t, stages)


def make_pipeline(mesh, stage_fn: StageFn, *, num_microbatches: int = 4,
                  remat: bool = False):
    """The global-view pipeline: ``fn(stage_params, x)`` with
    ``stage_params`` a pytree whose leaves carry a leading ``[n_stages,
    ...]`` stage axis (the whole stack; each process takes its stages'
    slices) and ``x [batch, ...]`` split into ``num_microbatches`` equal
    microbatches (the batch must divide evenly).  Returns ``[batch, ...]``
    on every process, differentiable into the stack and ``x``.  ``mesh``
    is the port's mesh (its ``stages``) or the stage chain itself."""
    stages = getattr(mesh, "stages", None) or mesh

    def fn(stage_params, x: torch.Tensor) -> torch.Tensor:
        m = num_microbatches
        if x.shape[0] % m:
            raise ValueError(f"batch {x.shape[0]} must divide into {m} "
                             "microbatches")
        xm = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        places = [pytree.tree_map(lambda a, s=s: a[s], stage_params)
                  for s in stages.indices]
        out = pipeline_shard(places, xm, stage_fn=stage_fn, stages=stages,
                             remat=remat)
        out = from_last_stage(out, stages)
        return out.reshape((x.shape[0],) + tuple(out.shape[2:]))

    return fn
