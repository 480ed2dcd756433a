"""Pipeline-parallel TransformerLM — the counterpart of
:mod:`tpudist.parallel.pipeline_lm`: the schedules of
:mod:`tpudist_torch.parallel.pipeline` and :mod:`~tpudist_torch.parallel.
pipeline_interleaved` applied to the LM's block stack, composed with data
parallelism on a ``(data, stage)`` mesh.

Placement: the token/position embeddings and the final norm/head are
replicated on every stage (a sliver of the FLOPs), and the ``N`` blocks
split into ``n_stages`` (× ``n_chunks``) contiguous groups.  A layout
(:func:`pp_state_sharding`, a :class:`PipelineLayout`) says which stage and
chunk owns which of ``model.blocks``; the JAX package stacks them instead,
and :func:`stack_block_params` / :func:`unstack_block_params` /
:func:`stack_block_params_interleaved` give that stacked form of a state
dict for interop.  Stage 0 embeds, the last stage runs the head, and only
they hold those gradients: the embedding's from stage 0's input cotangent,
the head's from the last stage's losses.  Each is summed over the stage
subgroup and averaged over ``data``, one flat all-reduce each way, so every
rank ends the step with the same replicated gradients and the same
update: the replicas stay bit-equal.  The reported loss is the same on
every rank.

Across processes (:class:`PipelineRuntime`) a rank keeps only its stages'
blocks (the others' storage is freed), and checkpoints see whole state
dicts in the unpipelined model's keys (every stage's blocks gathered over
the stage subgroup), so a ``pp`` checkpoint resumes under ``dp`` and back.
A global-norm clip (``build_optimizer(grad_clip=...)``) sums the blocks'
squares over the stage subgroup and counts the replicated embedding and
head once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from tpudist_torch.parallel.pipeline import (_data_mean, _leaves,
                                             _stage_sum, from_last_stage,
                                             pipeline_1f1b_shard,
                                             pipeline_shard)
from tpudist_torch.runtime.mesh import AXIS_DATA, AXIS_STAGE

__all__ = ["PipelineLayout", "PipelineRuntime", "make_pp_lm_apply",
           "make_pp_lm_train_step", "pp_state_sharding",
           "stack_block_params", "stack_block_params_interleaved",
           "unstack_block_params"]

SCHEDULES = ("gpipe", "1f1b", "interleaved")


def _block_of(key: str) -> Optional[int]:
    """The block index of a state-dict (or optimizer-leaf) key of a block
    parameter, ``None`` for the embeddings, norm and head."""
    parts = key.replace("/", ".").split(".")
    if "blocks" not in parts:
        return None
    return int(parts[parts.index("blocks") + 1])


def _block_names(params: Mapping[str, torch.Tensor]):
    n = 0
    while f"blocks.{n}.ln1" in params:
        n += 1
    names = [k[len("blocks.0."):] for k in params if k.startswith("blocks.0.")]
    return n, names


def stack_block_params(params: Mapping[str, torch.Tensor], n_stages: int):
    """A whole state dict (the port's :class:`~tpudist_torch.models.
    TransformerLM` keys) → the pipeline layout: ``{"blocks": {name:
    [n_stages, layers_per_stage, ...]}, "rest": {...}}``, ``rest`` holding
    the embeddings, final norm and head unchanged."""
    n_layers, names = _block_names(params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} blocks do not split into {n_stages} "
                         "stages")
    per = n_layers // n_stages
    stacked = {name: torch.stack([params[f"blocks.{i}.{name}"]
                                  for i in range(n_layers)]).reshape(
        (n_stages, per) + tuple(params[f"blocks.0.{name}"].shape))
        for name in names}
    rest = {k: v for k, v in params.items() if _block_of(k) is None}
    return {"blocks": stacked, "rest": rest}


def unstack_block_params(pp_params) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_block_params` (checkpoint/parity interop)."""
    stacked = pp_params["blocks"]
    shape = next(iter(stacked.values())).shape
    n_stages, per = shape[0], shape[1]
    out = dict(pp_params["rest"])
    for s in range(n_stages):
        for j in range(per):
            for name, a in stacked.items():
                out[f"blocks.{s * per + j}.{name}"] = a[s, j]
    return out


def stack_block_params_interleaved(params: Mapping[str, torch.Tensor],
                                   n_dev: int, n_chunks: int):
    """A whole state dict → the interleaved pipeline layout: blocks stacked
    to ``n_dev·n_chunks`` virtual stages, then depth-strided so device
    ``d`` holds global stages ``{c·n_dev + d}`` (:func:`~tpudist_torch.
    parallel.pipeline_interleaved.interleave_block_params`).  For interop
    with the contiguous layout, apply ``deinterleave_block_params`` to
    ``blocks`` before :func:`unstack_block_params`."""
    from tpudist_torch.parallel.pipeline_interleaved import (
        interleave_block_params)

    pp = stack_block_params(params, n_dev * n_chunks)
    return {"blocks": interleave_block_params(pp["blocks"], n_dev),
            "rest": pp["rest"]}


@dataclasses.dataclass(frozen=True)
class PipelineLayout:
    """Which stage and chunk owns which block: global stage ``g = c·S + s``
    (chunk ``c`` of device ``s``) holds blocks ``[g·per, (g+1)·per)`` with
    ``per = n_layers / (S·V)`` — :func:`stack_block_params` at ``V`` 1,
    :func:`stack_block_params_interleaved` above.  ``specs`` maps each
    parameter (and optimizer slot, ``opt/<param>/<slot>``) to its
    partition: ``(stage,)`` for a block's, ``()`` replicated."""

    mesh: object
    n_stages: int
    n_chunks: int
    n_layers: int
    specs: Dict[str, tuple]

    def blocks_of(self, stage: int, chunk: int = 0) -> range:
        per = self.n_layers // (self.n_stages * self.n_chunks)
        g = chunk * self.n_stages + stage
        return range(g * per, (g + 1) * per)


def pp_state_sharding(mesh, model: nn.Module, optimizer=None, *,
                      n_chunks: int = 1,
                      axis_name: str = AXIS_STAGE) -> PipelineLayout:
    """The pipeline layout of ``model`` (and its optimizer's state) over
    the mesh's ``stage`` axis: every block leaf stage-partitioned, the
    embeddings, norm, head and the optimizer's counters replicated — the
    JAX ``pp_state_sharding``'s rule."""
    from tpudist_torch.parallel.fsdp import optimizer_leaves, param_leaves

    n_stages = int(getattr(mesh, "shape", mesh).get(axis_name, 1))
    n_layers = len(model.blocks)
    if n_layers % (n_stages * n_chunks):
        raise ValueError(f"{n_layers} blocks do not split into "
                         f"{n_stages * n_chunks} stages")
    leaves = param_leaves(model)
    if optimizer is not None:
        leaves.update(optimizer_leaves(model, optimizer))
    specs = {k: ((axis_name,) if _block_of(k) is not None and len(shape)
                 else ()) for k, (shape, _, _) in leaves.items()}
    return PipelineLayout(mesh, n_stages, n_chunks, n_layers, specs)


def _stage_fn(ctx):
    """The stage function of the pipelined LM: a stage's (or chunk's)
    blocks in order, in the model's training arm (its RoPE, sliding
    window, GQA and compute dtype)."""

    def stage_fn(blocks: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        for blk in blocks:
            x = blk(x, ctx)
        return x

    return stage_fn


def _lm_pipeline_parts(model: nn.Module, layout: PipelineLayout, places):
    """``(chunks, stage_fn)``: each place's chunks of ``model.blocks`` (one
    ``ModuleList`` a chunk) and the stage function — one construction point
    so the GPipe apply and the schedules' step cannot drift."""
    chunks = {s: [nn.ModuleList([model.blocks[i]
                                 for i in layout.blocks_of(s, c)])
                  for c in range(layout.n_chunks)] for s in places}
    return chunks, _stage_fn(model.train_context())


def _check_stages(mesh, n_stages: int):
    stages = getattr(mesh, "stages", None)
    if stages is None or stages.size != n_stages:
        have = 1 if stages is None else stages.size
        raise ValueError(f"n_stages={n_stages} but the mesh's stage axis "
                         f"has {have} places (make_mesh(MeshConfig("
                         f"stage={n_stages})))")
    return stages


def make_pp_lm_apply(mesh, model: nn.Module, *, n_stages: int,
                     num_microbatches: int = 4, remat: bool = False):
    """``apply(tokens [batch, seq]) -> logits`` with the block stack
    pipelined (GPipe, :func:`~tpudist_torch.parallel.pipeline.
    pipeline_shard`) over the mesh's stage axis, the embedding and head
    replicated: the logits of this rank's rows (each data row passes its
    own) on every stage, differentiable."""
    stages = _check_stages(mesh, n_stages)
    layout = pp_state_sharding(mesh, model)
    places = list(stages.indices)
    chunks, stage_fn = _lm_pipeline_parts(model, layout, places)

    def apply(tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        m = num_microbatches
        if b % m:
            raise ValueError(f"batch {b} must divide into {m} microbatches")
        shape = (m, b // m, s, model.d_model)
        if 0 in places:
            xm = model.embed(tokens).reshape(shape)
        else:
            xm = torch.empty(shape, dtype=model.dtype,
                             device=model.tok_embed.device)
        out = pipeline_shard([chunks[p][0] for p in places], xm,
                             stage_fn=stage_fn, stages=stages, remat=remat)
        out = from_last_stage(out, stages)
        return model.logits(out.reshape(b, s, model.d_model))

    return apply


class PipelineRuntime:
    """A model, its optimizer and a :class:`PipelineLayout` on this rank:
    its places' chunks of ``model.blocks``; across processes the other
    stages' blocks freed and the clip's stage axis marked on its own
    (the module doc).  :attr:`model_view` and :attr:`optimizer` are what
    checkpoints see: whole state dicts (every rank must call them: they
    gather)."""

    def __init__(self, model: nn.Module, optimizer, layout: PipelineLayout):
        stages = _check_stages(layout.mesh, layout.n_stages)
        if any(optimizer.state.get(p) for g in optimizer.param_groups
               for p in g["params"]):
            raise ValueError("lay the pipeline out before the optimizer's "
                             "first step: its state is not empty")
        self.model, self.layout = model, layout
        self.stages = stages
        self.places = list(stages.indices)
        self.chunks, self.stage_fn = _lm_pipeline_parts(model, layout,
                                                        self.places)
        self.owned = {i for s in self.places for c in range(layout.n_chunks)
                      for i in layout.blocks_of(s, c)}
        names_of = {id(p): n for n, p in model.named_parameters()}
        self._opt_names = [names_of[id(p)] for g in optimizer.param_groups
                           for p in g["params"]]
        if stages.processes > 1:
            from tpudist_torch.parallel.zero import _Axis

            # the stage subgroup's all-reduce, read off a block parameter by
            # the global-norm clip (train/optim.py)
            axis = _Axis(stages.group)
            for name, p in model.named_parameters():
                if not self.keeps(name):
                    p.data = p.data.new_empty(0)
                elif _block_of(name) is not None:
                    p._tpudist_stage_axis = axis
        self.model_view = _PipeModelView(self)
        self.optimizer = _PipeOptimizer(optimizer, self)

    def keeps(self, name: str) -> bool:
        """Whether this rank holds parameter ``name`` (a replicated one, or
        a block of its stages)."""
        blk = _block_of(name)
        return blk is None or blk in self.owned

    def _gather(self, mine: dict) -> dict:
        """Every stage's ``mine`` merged (an ``all_gather_object`` over the
        stage subgroup); ``mine`` itself in a folded job."""
        if self.stages.processes == 1:
            return mine
        import torch.distributed as dist

        got = [None] * self.stages.size
        dist.all_gather_object(got, mine, group=self.stages.group)
        out = {}
        for part in got:
            out.update(part)
        return out

    def materialize(self) -> nn.Module:
        """The model with every block's weights (gathered from their
        stages): for the consumers of full weights after a run."""
        whole = self.model_view.state_dict()
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if p.numel() == 0 and name in whole:
                    p.data = whole[name].to(p.device).clone()
        return self.model


class _PipeModelView:
    """The model as checkpoints see it: whole tensors under the model's own
    keys."""

    def __init__(self, runtime: PipelineRuntime):
        self.runtime = runtime

    def state_dict(self) -> Dict[str, torch.Tensor]:
        rt = self.runtime
        sd = rt.model.state_dict()
        if rt.stages.processes == 1:
            return sd
        mine = {k: v.detach().cpu() for k, v in sd.items()
                if _block_of(k) is not None and rt.keeps(k)}
        dev = rt.model.tok_embed.device
        sd.update({k: v.to(dev) for k, v in rt._gather(mine).items()})
        return sd

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        rt = self.runtime
        cur = rt.model.state_dict()
        rt.model.load_state_dict({k: v if rt.keeps(k) else cur[k]
                                  for k, v in sd.items()})


class _PipeOptimizer:
    """The optimizer as checkpoints see it: its
    ``state_dict`` holds every parameter's state (the other stages'
    gathered), and ``load_state_dict`` keeps this rank's."""

    def __init__(self, inner, runtime: PipelineRuntime):
        self.inner, self.runtime = inner, runtime

    def state_dict(self) -> dict:
        rt = self.runtime
        sd = self.inner.state_dict()
        if rt.stages.processes == 1:
            return sd
        names = rt._opt_names
        mine = {i: {k: (v.detach().cpu() if torch.is_tensor(v) else v)
                    for k, v in st.items()}
                for i, st in sd["state"].items()
                if _block_of(names[i]) is not None}
        state = dict(sd["state"])
        dev = rt.model.tok_embed.device
        for i, st in rt._gather(mine).items():
            state[i] = {k: (v.to(dev) if torch.is_tensor(v) and v.dim()
                            else v) for k, v in st.items()}
        return {"state": {i: state[i] for i in sorted(state)},
                "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        rt = self.runtime
        names = rt._opt_names
        self.inner.load_state_dict({
            "state": {i: st for i, st in sd["state"].items()
                      if rt.keeps(names[int(i)])},
            "param_groups": sd["param_groups"]})


def _set_grads(params: List[torch.Tensor], grads: List[torch.Tensor]):
    for p, g in zip(params, grads):
        p.grad = g.to(p.dtype)


def make_pp_lm_train_step(mesh, model: nn.Module, optimizer, *,
                          n_stages: int, num_microbatches: int = 4,
                          schedule: str = "1f1b", n_chunks: int = 1,
                          data_axis: Optional[str] = AXIS_DATA,
                          scheduler=None, state_sharding=None):
    """``step(tokens [batch, seq]) -> loss``: one pipelined LM training
    step on this rank's rows (the same rows on every stage of a data row),
    the update of every parameter this rank holds, and the global mean loss
    (the same on every rank).

    ``schedule='gpipe'``: all microbatch forwards, then the backwards in a
    fixed order (:func:`~tpudist_torch.parallel.pipeline.pipeline_shard`);
    peak activation memory grows with ``num_microbatches``.
    ``schedule='1f1b'``: one forward and one backward a tick
    (:func:`~tpudist_torch.parallel.pipeline.pipeline_1f1b_shard`), stage
    inputs held in a ring of ``2·n_stages − 1``: memory constant in the
    microbatch count.  ``schedule='interleaved'``: ``n_chunks``
    depth-strided chunks a stage (:mod:`~tpudist_torch.parallel.
    pipeline_interleaved`); ``num_microbatches`` must be a multiple of
    ``n_stages``.  MoE blocks run under GPipe only (without their balance
    loss), as in JAX.

    ``optimizer`` (and ``scheduler``) were built over ``model.parameters()``
    and have not stepped; ``state_sharding`` is a :func:`pp_state_sharding`
    layout (by default made here).  ``step.runtime`` is the
    :class:`PipelineRuntime`, ``step.optimizer`` its optimizer view."""
    from tpudist_torch.models.transformer import lm_loss
    from tpudist_torch.parallel.pipeline_interleaved import (
        interleaved_schedule, pipeline_interleaved_shard)

    if schedule not in SCHEDULES:
        raise ValueError(
            f"schedule must be gpipe|1f1b|interleaved, got {schedule!r}")
    if n_chunks != 1 and schedule != "interleaved":
        raise ValueError(
            f"n_chunks={n_chunks} requires schedule='interleaved'")
    if schedule != "gpipe" and getattr(model, "n_experts", 0) > 0:
        raise ValueError(f"schedule={schedule!r} does not support MoE blocks")
    _check_stages(mesh, n_stages)
    layout = state_sharding or pp_state_sharding(mesh, model, optimizer,
                                                 n_chunks=n_chunks)
    if layout.n_chunks != n_chunks:
        raise ValueError(
            f"stage_params carry {layout.n_chunks} chunks per device but "
            f"the schedule was built for n_chunks={n_chunks} — stack with "
            f"stack_block_params_interleaved(params, n_dev, n_chunks)")
    m = num_microbatches
    sched = (interleaved_schedule(n_stages, n_chunks, m)
             if schedule == "interleaved" else None)
    rt = PipelineRuntime(model, optimizer, layout)
    stages, places = rt.stages, rt.places
    first, last = 0 in places, n_stages - 1 in places
    data_group = (getattr(mesh, "data_group", None)
                  if data_axis and mesh.shape.get(data_axis, 1) > 1
                  else None)
    ctx = model.train_context()
    head_params = {"ln_f": model.ln_f, "head": model.head}
    embed_params = [model.tok_embed] + (
        [model.pos_embed] if model.pos_embed is not None else [])

    def micro_loss(hp, act, toks):
        return lm_loss(model.logits(act, hp["ln_f"], hp["head"]), toks)

    def reduce_replicated(params, extra=()):
        """The replicated gradients (``None``: this stage has none) summed
        over the stage axis and averaged over ``data``."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params] + list(extra)
        return _data_mean(_stage_sum(grads, stages), data_group)

    def step(tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        b, s = tokens.shape
        if b % m:
            raise ValueError(f"batch {b} must divide into {m} microbatches")
        shape = (m, b // m, s, model.d_model)
        dev = model.tok_embed.device
        x = model.embed(tokens, ctx) if first else None
        xm = (x.reshape(shape) if first else
              torch.empty(shape, dtype=model.dtype, device=dev))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if schedule == "gpipe":
            out = pipeline_shard([rt.chunks[p][0] for p in places], xm,
                                 stage_fn=rt.stage_fn, stages=stages)
            if last:
                loss = lm_loss(model.logits(out.reshape(b, s, -1)), tokens)
                loss.backward()
                loss = loss.detach().float()
            else:
                out.backward(torch.zeros_like(out))
                loss = zero
            rep = embed_params + [model.ln_f, model.head]
            got = reduce_replicated(rep, [loss])
            _set_grads(rep, got[:-1])
            loss = got[-1]
            own = [p for p in model.parameters()
                   if p.grad is not None and p.numel()
                   and all(p is not q for q in rep)]
            _set_grads(own, _data_mean([p.grad for p in own], data_group))
        else:
            tm = tokens.reshape(m, b // m, s)
            if schedule == "1f1b":
                loss_sum, sg, og, dx = pipeline_1f1b_shard(
                    [rt.chunks[p][0] for p in places], head_params,
                    xm.detach(), tm, stage_fn=rt.stage_fn,
                    loss_fn=micro_loss, stages=stages,
                    data_group=data_group)
                sg = [[g] for g in sg]
            else:
                loss_sum, sg, og, dx = pipeline_interleaved_shard(
                    [rt.chunks[p] for p in places], head_params,
                    xm.detach(), tm, stage_fn=rt.stage_fn,
                    loss_fn=micro_loss, schedule=sched, stages=stages,
                    data_group=data_group)
            loss = loss_sum / m
            for name, p in head_params.items():
                p.grad = (og[name] / m).to(p.dtype)
            for p_, per in zip(places, sg):
                for chunk, grads in zip(rt.chunks[p_], per):
                    _set_grads(_leaves(chunk), [g / m for g in grads])
            if first:
                x.backward(dx.reshape(b, s, -1) / m)
            _set_grads(embed_params, reduce_replicated(embed_params))
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss

    step.runtime, step.optimizer = rt, rt.optimizer
    return step
