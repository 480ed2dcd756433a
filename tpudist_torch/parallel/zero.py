"""The runtime that carries a :class:`~tpudist_torch.parallel.fsdp.Layout`
out around the train step — what the JAX package's SPMD partitioner does
for ``make_lm_train_step(state_sharding=...)``.

Each parameter of the plan takes one of four forms:

- ``dp`` — replicated: the module's own tensor, its gradient all-reduced
  over every rank (what DDP does);
- ``zero3`` — sharded over the ``data`` axis (FSDP): this rank keeps its
  shard (``1/n`` of the leaf along the plan's dimension) and the module's
  tensor is freed.  The parameters live in units — each of the model's
  ``blocks`` one unit, the embeddings, final norm and head the root unit —
  and a unit's shards are all-gathered in one collective, in the dtype the
  module computes with, before its forward.  A block releases the storage
  of its gathered tensors after its forward (the graph saved those very
  tensors, or views of them), refills it before its backward
  (:class:`_UnitFn`), and reduce-scatters their gradients to the shards
  after it; the root keeps its tensors for the head and reduce-scatters
  once (:class:`_GatherFn`).  A block whose FFN is the overlapped FSDP
  MLP (``mlp_fn``, :func:`~tpudist_torch.parallel.overlap_fsdp_mlp`)
  keeps its ``wi``/``wo`` out of the gather: the forward hands the block
  this rank's pieces, which the ``mlp_fn``'s hop chains consume, and their
  gradients come out of the chains' backward already summed over the
  ``data`` group, so they are not reduce-scattered (the ``1/n`` of the
  average below still applies);
- ``zero1`` — the parameter replicated, its optimizer state sharded: the
  gradient is reduce-scattered to this rank's slice, the optimizer updates
  the slice, and one all-gather a step writes the updated slices back;
- ``tp`` — split over the ``model`` devices of this rank
  (:class:`~tpudist_torch.models.transformer.TPBlock`, the Megatron block):
  the pieces are the optimizer's, their gradients all-reduced over the
  ranks like ``dp``.

Gradients are averaged over every rank of the process group: the
reduce-scatter sums over the ``data`` group, an all-reduce over the ring's
``seq`` group adds the other shards of the sequence, and all are divided by
the world size, as DDP divides.  The optimizer the caller built over the
model's parameters is re-pointed at the pieces (its param groups, hooks and
scheduler stay); each piece carries a :class:`LeafShard` that the
sharding-aware optimizers and the global-norm clip read
(:mod:`tpudist_torch.train.optim`).

:attr:`ShardedRuntime.model_view` and :attr:`ShardedRuntime.optimizer` are
what checkpoints and the trainer see: their ``state_dict`` is the full,
gathered state a replicated run holds (same keys, same order), and their
``load_state_dict`` takes such a state, so a checkpoint saved under one
layout and world size resumes under any other.  Every rank must call the
``state_dict``s: they gather.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

__all__ = ["LeafShard", "ShardedRuntime", "shard_state"]


class _Axis:
    """A process group's collectives (``group`` None: the default group),
    all of them copies in a job without one."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        live = dist.is_initialized()
        self.size = dist.get_world_size(group) if live else 1
        self.rank = dist.get_rank(group) if live else 0

    def all_gather(self, flat: torch.Tensor) -> torch.Tensor:
        """``[size, numel]``: every rank's ``flat``, in rank order."""
        import torch.distributed as dist

        if self.size == 1:
            return flat.reshape(1, -1).clone()
        out = flat.new_empty(self.size * flat.numel())
        dist.all_gather_into_tensor(out, flat.contiguous(), group=self.group)
        return out.view(self.size, -1)

    def reduce_scatter(self, stack: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of row ``rank`` of ``stack [size,
        numel]``."""
        import torch.distributed as dist

        if self.size == 1:
            return stack[0].clone()
        out = stack.new_empty(stack.shape[1])
        dist.reduce_scatter_tensor(out, stack.contiguous().view(-1),
                                   group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """What a piece of a leaf knows of the whole: the leaf's full shape,
    the dimension it is split along (``None``: the piece is the whole
    leaf), the process axis the split spans (``None``: the pieces are all
    in this process, the TP form) and the key the pieces of one leaf
    share."""

    full_shape: tuple
    dim: Optional[int]
    axis: Optional[_Axis]
    key: str

    def total(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of ``parts`` (one a local piece) over the pieces and the
        process axis, one copy a piece on its device."""
        out = parts[0].clone() if len(parts) == 1 else sum(
            p.to(parts[0].device) for p in parts)
        if self.axis is not None:
            self.axis.all_reduce(out)
        return [out.to(p.device) for p in parts]


def _split_shape(shape, dim: int, n: int) -> tuple:
    return tuple(shape[:dim]) + (n, shape[dim] // n) + tuple(shape[dim + 1:])


def _stack_rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` cut into ``n`` equal slices along ``dim``, one row each:
    ``[n, numel / n]``."""
    return t.reshape(_split_shape(t.shape, dim, n)).movedim(dim, 0).reshape(
        n, -1)


def _from_rows(rows: torch.Tensor, local_shape, dim: int) -> torch.Tensor:
    """The inverse of :func:`_stack_rows`: ``n`` slices laid end to end
    along ``dim``, as a tensor of its own."""
    n = rows.shape[0]
    full = list(local_shape)
    full[dim] *= n
    return rows.reshape(n, *local_shape).movedim(0, dim).reshape(
        full).contiguous()


class _Unit:
    """The ``zero3`` parameters of one module (a block, or the root), each
    sharded along its own dimension over one axis; gathered and
    reduce-scattered together, one collective each way.

    Each shard is gathered in the dtype its module computes with (its
    ``chain``: the runtime's ``cast``, then the module's ``dtype`` for the
    weights it lists in ``cast_weights``), so the gathered tensor is the
    one the graph saves — no cast copy of it outlives :meth:`free` — and
    the gather moves bf16 under bf16 compute.  A gradient goes back down
    the chain to the shard's dtype before the reduce-scatter, the casts'
    own backward."""

    def __init__(self, runtime, names: List[str], dims: List[int],
                 shapes: List[tuple], shards: List[nn.Parameter],
                 chains: List[tuple], local: List[bool]):
        self.runtime = runtime
        self.names, self.dims, self.shapes = names, dims, shapes
        self.shards, self.chains = shards, chains
        #: indices of the shards gathered, and of those handed to the
        #: block as this rank's pieces (the overlapped MLP's wi/wo)
        self.gathered = [i for i, lc in enumerate(local) if not lc]
        self.local = [i for i, lc in enumerate(local) if lc]

    def cast(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """``t`` down shard ``i``'s chain of dtypes."""
        for dt in self.chains[i]:
            t = t.to(dt)
        return t

    def params(self, fulls, pieces) -> Dict[str, torch.Tensor]:
        """``{name: tensor}`` of the gathered tensors ``fulls`` and the
        local ``pieces`` (cast down their chains) for the block's call."""
        out = dict(zip([self.names[i] for i in self.gathered], fulls))
        out.update((self.names[i], self.cast(i, p))
                   for i, p in zip(self.local, pieces))
        return out

    def gather(self, shards, into: Optional[List[torch.Tensor]] = None):
        """The whole tensors of the gathered shards (``self.gathered`` of
        ``shards``), or refilled into ``into``."""
        if not self.gathered:
            return [] if into is None else into
        axis = self.runtime.data
        self.runtime.counts["gathers"] += 1
        parts = [self.cast(i, shards[i].detach()).reshape(-1)
                 for i in self.gathered]
        # one collective over the bytes, whatever the dtypes
        flat = torch.cat([t.view(torch.uint8) for t in parts])
        self.runtime.counts["gather_bytes"] += flat.numel() * axis.size
        rows = axis.all_gather(flat)
        fulls, off = [], 0
        for i, (t, j) in enumerate(zip(parts, self.gathered)):
            s, d = shards[j], self.dims[j]
            k = t.numel() * t.element_size()
            # a storage of its own, which free() can release
            full = _from_rows(rows[:, off:off + k].clone().view(t.dtype),
                              s.shape, d)
            off += k
            if into is None:
                fulls.append(full)
            else:
                # refill the storage the graph's saved views still point at
                # (through .data, so the saved version stays valid)
                into[i].untyped_storage().resize_(
                    full.untyped_storage().nbytes())
                into[i].data.copy_(full)
        return fulls if into is None else into

    def reduce_scatter(self, grads) -> List[torch.Tensor]:
        """The shards' gradients from those of the gathered tensors
        (``self.gathered`` order)."""
        if not self.gathered:
            return []
        axis = self.runtime.data
        self.runtime.counts["reduce_scatters"] += 1
        down = []
        for g, j in zip(grads, self.gathered):
            for dt in reversed(self.chains[j][:-1]):
                g = g.to(dt)
            down.append(g.to(self.shards[j].dtype))
        stack = torch.cat([_stack_rows(g, self.dims[j], axis.size)
                           for g, j in zip(down, self.gathered)], dim=1)
        flat = axis.reduce_scatter(stack)
        out, off = [], 0
        for j in self.gathered:
            s = self.shards[j]
            out.append(flat[off:off + s.numel()].view(s.shape))
            off += s.numel()
        return out

    @staticmethod
    def free(fulls) -> None:
        """Release the gathered tensors' storage — the memory of every view
        the graph saved of them — keeping their shapes for the re-gather."""
        for f in fulls:
            f.untyped_storage().resize_(0)


class _GatherFn(torch.autograd.Function):
    """The root unit: its shards gathered in the forward, the gradients of
    the gathered tensors reduce-scattered to the shards in the backward."""

    @staticmethod
    def forward(ctx, unit, *shards):
        ctx.unit = unit
        return tuple(unit.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        grads = [torch.zeros(s, dtype=unit.shards[i].dtype,
                             device=unit.shards[i].device)
                 if g is None else g
                 for i, (g, s) in enumerate(zip(grads, unit.shapes))]
        return (None, *unit.reduce_scatter(grads))


class _UnitFn(torch.autograd.Function):
    """One block under ZeRO-3: gather, run, free in the forward (the
    block's own graph kept inside, over the gathered tensors and the local
    pieces); gather into the same storage, back-propagate through that
    graph, reduce-scatter the gathered tensors' gradients and free in the
    backward.  ``run(params, x) -> (y, extras)``: ``extras`` are tensors of
    the inner graph the caller differentiates too (the MoE balance loss),
    returned after ``y``."""

    @staticmethod
    def forward(ctx, unit, run, x, *shards):
        fulls = unit.gather(shards)
        for f in fulls:
            f.requires_grad_(True)
        with torch.enable_grad():
            xin = x.detach().requires_grad_(x.requires_grad)
            pieces = [shards[i].detach().requires_grad_(
                shards[i].requires_grad) for i in unit.local]
            y, extras = run(unit.params(fulls, pieces), xin)
        unit.free(fulls)
        ctx.unit, ctx.fulls, ctx.pieces = unit, fulls, pieces
        ctx.xin, ctx.y, ctx.extras = xin, y, list(extras)
        ctx.save_for_backward(*shards)
        return (y.detach(), *[e.detach() for e in extras])

    @staticmethod
    def backward(ctx, gy, *gextras):
        unit, fulls = ctx.unit, ctx.fulls
        unit.gather(ctx.saved_tensors, into=fulls)
        pairs = [(e, g) for e, g in zip(ctx.extras, gextras)
                 if g is not None and e.requires_grad]
        torch.autograd.backward([ctx.y] + [e for e, _ in pairs],
                                [gy] + [g for _, g in pairs])
        grads = [torch.zeros(unit.shapes[j], dtype=f.dtype, device=f.device)
                 if f.grad is None else f.grad
                 for f, j in zip(fulls, unit.gathered)]
        out = [None] * len(unit.shards)
        for j, g in zip(unit.gathered, unit.reduce_scatter(grads)):
            out[j] = g
        # the local pieces' gradients are already summed over the group
        for j, p in zip(unit.local, ctx.pieces):
            out[j] = torch.zeros_like(p) if p.grad is None else p.grad
        for f in fulls:
            f.grad = None
        unit.free(fulls)
        gx = ctx.xin.grad
        ctx.y = ctx.fulls = ctx.xin = ctx.pieces = ctx.extras = None
        return (None, None, gx, *out)


def _groups_of(optimizer, names_of: Dict[int, str]) -> List[List[str]]:
    return [[names_of[id(p)] for p in g["params"]]
            for g in optimizer.param_groups]


class ShardedRuntime:
    """A model, its optimizer and a layout, carried out on this rank (the
    module doc).  Call it as the model: ``runtime(tokens, ctx)``."""

    def __init__(self, model: nn.Module, optimizer, layout, *,
                 cast: Optional[torch.dtype] = None):
        import torch.distributed as dist

        from tpudist_torch.parallel.ring import ProcessGroupRing

        mesh = layout.mesh
        self.model, self.layout, self.cast = model, layout, cast
        self.counts = {"gathers": 0, "reduce_scatters": 0, "all_reduces": 0,
                       "all_gathers": 0, "gather_bytes": 0}
        self.data = _Axis(getattr(mesh, "data_group", None))
        ring = getattr(mesh, "ring", None)
        self.seq = (_Axis(ring.group) if isinstance(ring, ProcessGroupRing)
                    else None)
        self.world = _Axis(None)
        want = layout.axis_sizes.get("data", 1)
        if want != self.data.size:
            raise ValueError(f"the layout's data axis is {want} but this "
                             f"rank's data group holds {self.data.size}")
        if any(len(g["params"]) and optimizer.state.get(p)
               for g in optimizer.param_groups for p in g["params"]):
            raise ValueError("shard the state before the optimizer's first "
                             "step: its state is not empty")
        names_of = {id(p): n for n, p in model.named_parameters()}
        self._group_names = _groups_of(optimizer, names_of)
        self._order = [n for g in self._group_names for n in g]
        self._shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.modes = self._modes(model, layout)
        if any(m == "tp" for m, _ in self.modes.values()):
            self._to_tensor_parallel(mesh, layout)
        self.pieces: Dict[str, List[torch.Tensor]] = {}
        self._dense: List[torch.Tensor] = []       # dp and tp pieces
        self._zero1: List[tuple] = []              # (param, shard, dim)
        self._units: Dict[int, _Unit] = {}
        self.root: Optional[_Unit] = None
        self._build(model)
        self.optimizer = ShardedOptimizer(optimizer, self)
        for g, names in zip(optimizer.param_groups, self._group_names):
            g["params"] = [t for n in names for t in self.pieces[n]]
        self.model_view = _ModelView(self)

    # -- the plan ----------------------------------------------------------

    @staticmethod
    def _modes(model, layout) -> Dict[str, tuple]:
        """``{name: (mode, dim)}`` from the layout's parameter and
        optimizer leaves (the module doc's four forms)."""
        from tpudist_torch.parallel.fsdp import _leaf_spec

        opt = layout.opt_state
        modes = {}
        for name, p in model.named_parameters():
            leaf = layout.leaves.get(name)
            if leaf is None:
                raise ValueError(f"the layout has no leaf {name!r}: it was "
                                 "made for another model")
            dim, axis = leaf.split()
            if axis == "data":
                modes[name] = ("zero3", dim)
            elif axis == "model":
                modes[name] = ("tp", dim)
            elif axis is not None:
                raise ValueError(f"{name}: parameters split over the "
                                 f"{axis!r} axis are not supported")
            elif any(k.startswith(f"opt/{name}/") and v.split()[1] == "data"
                     for k, v in opt.items()):
                jshape = leaf.jax_shape
                jspec = _leaf_spec(jshape, layout.axis_sizes["data"], "data",
                                   1)
                if leaf.transposed:
                    jspec = tuple(reversed(jspec))
                d = next(i for i, a in enumerate(jspec) if a is not None)
                modes[name] = ("zero1", d)
            else:
                modes[name] = ("dp", None)
        return modes

    def _to_tensor_parallel(self, mesh, layout) -> None:
        from tpudist_torch.models.transformer import TPBlock

        m = layout.axis_sizes.get("model", 1)
        devices = tuple(getattr(mesh, "devices", ()))
        if len(devices) != m:
            raise ValueError(f"a model axis of {m} needs {m} devices a rank, "
                             f"the mesh gives {len(devices)}")
        name_of = {id(p): n for n, p in self.model.named_parameters()}
        blocks, placed = getattr(self.model, "blocks", ()), set()
        for i, blk in enumerate(blocks):
            names = {w: name_of.get(id(blk.get_parameter(w)))
                     for w in TPBlock.split_of(blk)}
            tp = [self.modes.get(n, ("", None))[0] == "tp"
                  for n in names.values()]
            if not any(tp):
                continue
            if not all(tp) or any(self.modes[n][1] != TPBlock.split_dim(w)
                                  for w, n in names.items()):
                raise ValueError(f"block {i}: the model axis splits all of "
                                 "qkv and wi by rows and proj and wo by "
                                 "columns (TPBlock.SPLIT; an MoE block's "
                                 "expert stacks by experts, MOE_SPLIT), or "
                                 "none")
            placed.update(names.values())
            blocks[i] = TPBlock(blk, devices)
        stray = [n for n, (m, _) in self.modes.items()
                 if m == "tp" and n not in placed]
        if stray:
            raise ValueError(f"{stray}: the model axis splits a block's qkv, "
                             "proj, wi and wo or expert stacks "
                             "(transformer_tp_sharding), nothing else")

    def _build(self, model) -> None:
        data = self.data
        # a block's parameters form its unit, everything else the root's
        owner_of = {id(p): (blk, n) for blk in getattr(model, "blocks", ())
                    for n, p in blk.named_parameters()}
        units: Dict[int, list] = {}
        params = dict(model.named_parameters())
        for name in self._order:
            mode, dim = self.modes[name]
            if mode == "tp":
                parts = name.split(".")
                tpb = model.get_submodule(".".join(parts[:2]))
                leaf = ".".join(parts[2:])
                pieces = tpb.pieces(leaf)
                for t in pieces:
                    t._tpudist_leaf = LeafShard(self._shapes[name],
                                                tpb.split_dim(leaf), None,
                                                name)
                self.pieces[name] = pieces
                self._dense.extend(pieces)
                continue
            p = params[name]
            if mode == "dp":
                self.pieces[name] = [p]
                self._dense.append(p)
                continue
            if p.shape[dim] % data.size:
                raise ValueError(f"{name} {tuple(p.shape)}: dimension {dim} "
                                 f"does not divide over {data.size} ranks")
            piece = p.detach().chunk(data.size, dim)[data.rank].clone()
            shard = nn.Parameter(piece, requires_grad=p.requires_grad)
            shard._tpudist_leaf = LeafShard(tuple(p.shape), dim, data, name)
            self.pieces[name] = [shard]
            if mode == "zero1":
                self._zero1.append((p, shard, dim))
                continue
            module, rel = owner_of.get(id(p), (model, name))
            units.setdefault(id(module), [module]).append(
                (rel, dim, tuple(p.shape), shard, self._chain(module, rel),
                 self._local(module, rel, dim)))
            p.data = p.data.new_empty(0)
        for module, *rows in units.values():
            unit = _Unit(self, *map(list, zip(*rows)))
            if module is model:
                self.root = unit
            else:
                self._units[id(module)] = unit
        if self._units and not hasattr(model, "block_fn"):
            raise ValueError("ZeRO-3 blocks need a model with a block_fn "
                             "seam (TransformerLM)")

    def _local(self, module, name: str, dim: int) -> bool:
        """Whether ZeRO-3 parameter ``name`` of ``module`` stays this
        rank's piece in the forward: ``wi``/``wo`` of a block whose FFN is
        the overlapped FSDP MLP, which must then split them along ``d_ff``
        over this runtime's ``data`` group."""
        fn = getattr(module, "mlp_fn", None)
        if fn is None or name not in ("wi", "wo"):
            return False
        want = {"wi": 0, "wo": 1}[name]
        if dim != want:
            raise ValueError(f"the overlapped FSDP MLP takes {name} split "
                             f"along d_ff (dimension {want} of the port's "
                             f"weight), the layout splits dimension {dim}")
        if fn.ring.size != self.data.size:
            raise ValueError(f"the overlapped FSDP MLP's ring has "
                             f"{fn.ring.size} places, the data group "
                             f"{self.data.size}")
        return True

    def _chain(self, module, name: str) -> tuple:
        """The dtypes parameter ``name`` of ``module`` passes through on
        its way to the computation (:class:`_Unit`)."""
        chain = () if self.cast is None else (self.cast,)
        if name in getattr(module, "cast_weights", ()):
            chain += (module.dtype,)
        return chain

    # -- the step ------------------------------------------------------------

    def grad_tensors(self) -> List[torch.Tensor]:
        """Every tensor that holds a gradient before :meth:`reduce_grads`:
        the dense tensors, the ZeRO-1 parameters (whole) and the ZeRO-3
        shards."""
        out = list(self._dense) + [p for p, _, _ in self._zero1]
        for unit in self._all_units():
            out.extend(unit.shards)
        return out

    def _all_units(self) -> List[_Unit]:
        return ([self.root] if self.root is not None else []) + list(
            self._units.values())

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        if self.cast is None or not torch.is_floating_point(t):
            return t
        return t.to(self.cast)

    def __call__(self, tokens, ctx=None):
        from torch.func import functional_call

        model = self.model
        tokens = self._cast(tokens)
        args = (tokens,) if ctx is None else (tokens, ctx)
        params = {}
        if self.root is not None:
            if torch.is_grad_enabled():
                fulls = _GatherFn.apply(self.root, *self.root.shards)
            else:
                fulls = self.root.gather(self.root.shards)
            params.update(zip(self.root.names, fulls))
        if self.cast is not None:
            # the gathered tensors come in the compute dtype, and a unit
            # casts its block's other parameters itself
            in_units = {id(p) for blk in getattr(model, "blocks", ())
                        if id(blk) in self._units for p in blk.parameters()}
            for name, p in model.named_parameters():
                if name not in params and id(p) not in in_units:
                    params[name] = self._cast(p)
        if self._units:
            model.block_fn = self._run_block
        try:
            out = functional_call(model, params, args) if params else \
                model(*args)
        finally:
            if self._units:
                model.block_fn = None
        return out.float() if self.cast is not None else out

    def _run_block(self, block, x, ctx, remat: bool, policy: str):
        from tpudist_torch.models.transformer import rematerialized

        unit = self._units.get(id(block))
        if unit is None:
            return (rematerialized(block, x, ctx, policy) if remat
                    else block(x, ctx))

        sow = getattr(block, "sow", None)
        start = 0 if sow is None else len(sow)

        def run(p, xin):
            from torch.func import functional_call

            if self.cast is not None:
                for n, t in block.named_parameters():
                    if n not in p:
                        p[n] = self._cast(t)

            def fn(h):
                return functional_call(block, p, (h, ctx))

            if remat:
                from torch.utils.checkpoint import checkpoint

                from tpudist_torch.models.transformer import _remat_context

                cfn = _remat_context(policy)
                kw = {} if cfn is None else {"context_fn": cfn}
                y = checkpoint(fn, xin, use_reentrant=False, **kw)
            else:
                y = fn(xin)
            # the balance losses this forward sowed: differentiated
            # through the block's inner graph
            sown = [] if sow is None else sow[start:]
            return y, [st.balance_loss for st in sown]

        if not torch.is_grad_enabled():
            fulls = unit.gather(unit.shards)
            y, _ = run(unit.params(fulls, [unit.shards[i].detach()
                                           for i in unit.local]), x)
            unit.free(fulls)
            return y
        y, *extras = _UnitFn.apply(unit, run, x, *unit.shards)
        for i, bal in enumerate(extras):
            sow[start + i] = sow[start + i]._replace(balance_loss=bal)
        return y

    def zero_grad(self) -> None:
        for t in self.grad_tensors():
            t.grad = None
        for _, shard, _ in self._zero1:
            shard.grad = None

    def reduce_grads(self) -> None:
        """Average every gradient over the ranks (the module doc), onto the
        tensors the optimizer holds."""
        world = self.world.size
        dense = [t for t in self._dense if t.requires_grad]
        if dense and world > 1:
            flat = torch.cat([(t.grad if t.grad is not None
                               else torch.zeros_like(t)).reshape(-1)
                              for t in dense])
            self.counts["all_reduces"] += 1
            self.world.all_reduce(flat)
            off = 0
            for t in dense:
                t.grad = flat[off:off + t.numel()].view(t.shape).clone()
                off += t.numel()
        if self._zero1:
            n = self.data.size
            stack = torch.cat([
                _stack_rows(p.grad if p.grad is not None
                            else torch.zeros_like(p), d, n)
                for p, _, d in self._zero1], dim=1)
            self.counts["reduce_scatters"] += 1
            flat = self.data.reduce_scatter(stack)
            off = 0
            for p, shard, _ in self._zero1:
                shard.grad = flat[off:off + shard.numel()].view(
                    shard.shape).clone()
                off += shard.numel()
                p.grad = None
        sharded = [s for s in ([sh for _, sh, _ in self._zero1]
                               + [s for u in self._all_units()
                                  for s in u.shards])
                   if s.grad is not None]
        if self.seq is not None and sharded:
            flat = torch.cat([s.grad.reshape(-1) for s in sharded])
            self.counts["all_reduces"] += 1
            self.seq.all_reduce(flat)
            off = 0
            for s in sharded:
                s.grad = flat[off:off + s.numel()].view(s.shape).clone()
                off += s.numel()
        if world > 1:
            for t in dense + sharded:
                if t.grad is not None:
                    t.grad.div_(world)

    def after_step(self) -> None:
        """ZeRO-1: one all-gather of the updated slices into the whole
        parameters."""
        if not self._zero1:
            return
        self.counts["all_gathers"] += 1
        flat = torch.cat([s.detach().reshape(-1) for _, s, _ in self._zero1])
        rows = self.data.all_gather(flat)
        off = 0
        with torch.no_grad():
            for p, s, d in self._zero1:
                k = s.numel()
                p.copy_(_from_rows(rows[:, off:off + k], s.shape, d))
                off += k

    # -- whole tensors -------------------------------------------------------

    def _whole(self, name: str, parts: List[torch.Tensor],
               full_shape) -> torch.Tensor:
        """The whole leaf-shaped tensor of one leaf's ``parts`` (one a
        piece): gathered over the data axis, assembled from the TP pieces,
        or the part itself when it is already whole."""
        mode, _ = self.modes[name]
        part = parts[0]
        if mode == "dp" or tuple(part.shape) == tuple(full_shape):
            return part
        dim = next(i for i, (a, b) in enumerate(zip(part.shape, full_shape))
                   if a != b)
        if mode == "tp":
            blk, leaf = name.rsplit(".", 1)
            tpb = self.model.get_submodule(blk)
            return tpb.assemble(leaf, parts, dim)
        rows = self.data.all_gather(part.detach().reshape(-1))
        return _from_rows(rows, part.shape, dim)

    def _slices(self, name: str, whole: torch.Tensor,
                local_shapes) -> List[torch.Tensor]:
        """The inverse of :meth:`_whole`: this rank's parts of ``whole``."""
        mode, _ = self.modes[name]
        shape = tuple(local_shapes[0])
        if mode == "dp" or tuple(whole.shape) == shape:
            return [whole for _ in local_shapes]
        dim = next(i for i, (a, b) in enumerate(zip(shape, whole.shape))
                   if a != b)
        if mode == "tp":
            blk, leaf = name.rsplit(".", 1)
            return self.model.get_submodule(blk).slice(leaf, whole, dim)
        return [whole.chunk(self.data.size, dim)[self.data.rank]]

    def full_param(self, name: str) -> torch.Tensor:
        mode, _ = self.modes[name]
        if mode in ("dp", "zero1"):
            return self.model.get_parameter(name).detach()
        return self._whole(name, [t.detach() for t in self.pieces[name]],
                           self._shapes[name])

    def materialize(self) -> nn.Module:
        """Write the whole parameters back into the model (ZeRO-3 tensors
        gathered, TP blocks put back as plain blocks) and return it: for
        the consumers of full weights (``generate``).  The runtime is spent
        afterwards."""
        from tpudist_torch.models.transformer import TPBlock

        fulls = {n: self.full_param(n) for n in self._order}
        blocks = getattr(self.model, "blocks", ())
        for i, blk in enumerate(blocks):
            if isinstance(blk, TPBlock):
                blocks[i] = blk.to_block()
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if name in fulls:
                    p.data = fulls[name].clone()
        return self.model


class _ModelView:
    """The model as checkpoints see it: whole tensors under the model's own
    keys."""

    def __init__(self, runtime: ShardedRuntime):
        self.runtime = runtime

    def state_dict(self) -> Dict[str, torch.Tensor]:
        rt = self.runtime
        sd = rt.model.state_dict()
        for name, (mode, _) in rt.modes.items():
            if mode == "zero3":
                sd[name] = rt.full_param(name)
        return {k: sd[k] for k in _ordered_keys(rt, sd)}

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        rt = self.runtime
        plain = {}
        for k, v in sd.items():
            mode = rt.modes.get(k, ("dp", None))[0]
            if mode == "zero3":
                shard = rt.pieces[k][0]
                with torch.no_grad():
                    shard.copy_(rt._slices(k, v, [shard.shape])[0])
            else:
                plain[k] = v
        missing = [k for k, (m, _) in rt.modes.items()
                   if m != "zero3" and k not in plain]
        if missing:
            raise KeyError(f"the state dict misses {missing}")
        rt.model.load_state_dict(plain, strict=False)
        with torch.no_grad():
            for p, shard, d in rt._zero1:
                shard.copy_(p.detach().chunk(rt.data.size, d)[rt.data.rank])


def _ordered_keys(rt, sd) -> List[str]:
    keys = [k for k in rt._shapes if k in sd]
    return keys + [k for k in sd if k not in rt._shapes]


def _state_shapes(optimizer, full_shape, local_shape) -> Dict[str, tuple]:
    """The shape of each optimizer slot of a piece of shape ``local_shape``
    of a leaf of ``full_shape``."""
    from tpudist_torch.train.optim import Adafactor

    if isinstance(optimizer, Adafactor):
        return Adafactor.slot_shapes(full_shape, local_shape)
    return {}


class ShardedOptimizer:
    """The re-pointed optimizer as the step and checkpoints see it:
    ``step`` reduces the gradients, steps the optimizer over the pieces and
    gathers the ZeRO-1 slices; ``state_dict`` is the replicated run's (the
    module doc)."""

    def __init__(self, inner, runtime: ShardedRuntime):
        self.inner = inner
        self.runtime = runtime

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.runtime.zero_grad()
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        self.runtime.reduce_grads()
        out = (self.inner.step() if closure is None
               else self.inner.step(closure))
        self.runtime.after_step()
        return out

    def state_dict(self) -> dict:
        rt, inner = self.runtime, self.inner
        state, groups, idx = {}, [], 0
        for g, names in zip(inner.param_groups, rt._group_names):
            ids = []
            for name in names:
                parts = [inner.state.get(t, {}) for t in rt.pieces[name]]
                if parts[0]:
                    full = rt._shapes[name]
                    local = tuple(rt.pieces[name][0].shape)
                    shapes = _state_shapes(inner, full, local)
                    whole = {}
                    for key, v in parts[0].items():
                        if not torch.is_tensor(v) or v.dim() == 0:
                            whole[key] = v
                            continue
                        want = shapes.get(key, full)
                        vals = [st[key] for st in parts]
                        whole[key] = rt._whole(name, vals, want) \
                            if tuple(v.shape) != tuple(want) else v
                    state[idx] = whole
                ids.append(idx)
                idx += 1
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": ids})
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, sd: dict) -> None:
        rt, inner = self.runtime, self.inner
        names = [n for g in rt._group_names for n in g]
        if len(sd["param_groups"]) != len(inner.param_groups):
            raise ValueError("the saved optimizer has another param group "
                             "structure")
        for g, saved in zip(inner.param_groups, sd["param_groups"]):
            for k, v in saved.items():
                if k != "params":
                    g[k] = v
        inner.state.clear()
        for idx, st in sd["state"].items():
            name = names[int(idx)]
            pieces = rt.pieces[name]
            local = [tuple(t.shape) for t in pieces]
            shapes = [_state_shapes(inner, rt._shapes[name], s) for s in local]
            per = [dict() for _ in pieces]
            for key, v in st.items():
                if not torch.is_tensor(v) or v.dim() == 0:
                    # scalars (the step counters) stay where torch keeps them
                    for i in range(len(pieces)):
                        per[i][key] = v.clone() if torch.is_tensor(v) else v
                    continue
                parts = rt._slices(name, v, [s.get(key, loc) for s, loc
                                             in zip(shapes, local)])
                for i, t in enumerate(pieces):
                    per[i][key] = parts[i].to(t.device).clone()
            for t, d in zip(pieces, per):
                inner.state[t] = d


def shard_state(model: nn.Module, optimizer, layout, *,
                cast: Optional[torch.dtype] = None) -> ShardedRuntime:
    """Carry ``layout`` out over ``model`` and ``optimizer`` (built over the
    model's parameters, not stepped yet): the :class:`ShardedRuntime`.
    ``cast`` (e.g. ``torch.bfloat16``) computes in that dtype over f32
    masters, parameters cast where they are used and the output cast back
    to f32, as the Trainer's ``BF16Apply``."""
    return ShardedRuntime(model, optimizer, layout, cast=cast)
