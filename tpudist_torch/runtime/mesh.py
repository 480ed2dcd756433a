"""Named parallel axes over the process group — the counterpart of
:mod:`tpudist.runtime.mesh`.

The JAX package builds one global ``jax.sharding.Mesh`` over every device
of the job and names its axes.  In PyTorch the same axes are the process
group and the devices a process owns, the reference's own shape
(``demo.py:66``, ``demo_one_model_multi_gpu.py:89-98``):

- ``data`` — the process group: one model replica a rank, DDP averaging
  the gradients over it, or the group a sharded state (FSDP, ZeRO-1:
  :mod:`tpudist_torch.parallel.zero`) is sharded over;
- ``model`` — the devices one rank owns: its replica's layer groups placed
  one group a device (:mod:`tpudist_torch.models.split_mlp`), or the shards
  of tensor parallelism, one a device (:class:`~tpudist_torch.models.
  transformer.TPBlock`; on one card they fold onto it);
- ``seq`` — sequence parallelism (:mod:`tpudist_torch.parallel`): over a
  process group the ranks lay out as the JAX axis order puts them, ``data``
  outermost and then ``seq`` (rank ``d·N + s``), and each data row's ``N``
  ranks form one seq subgroup, its ring (:class:`~tpudist_torch.parallel.
  ProcessGroupRing`); in a job of one process the ``N`` shards fold onto
  the rank's one device (:class:`~tpudist_torch.parallel.LocalRing`), as
  ``model`` stages may repeat a device;
- ``seq`` beside ``model`` (3-D parallelism): ``data × seq`` over the
  process group as above, ``model`` over the devices of each rank, in the
  JAX axis order ``(data, seq, model)``;
- ``stage`` (pipeline parallelism, :mod:`tpudist_torch.parallel.
  pipeline`): over a process group the ranks lay out in the JAX axis order
  ``(data, stage, seq, model)`` — rank ``(d·S + s)·N + q`` for data row
  ``d``, stage ``s`` of ``S`` and seq place ``q`` of ``N``, ``model`` the
  devices of each rank — and the ``S`` ranks of each ``(d, q)`` form one
  stage subgroup, the pipeline's chain (a :class:`~tpudist_torch.parallel.
  ProcessGroupRing`); in a job of one process the ``S`` stages fold onto
  the rank's device (a :class:`~tpudist_torch.parallel.LocalRing`), as the
  ``seq`` shards do;
- the hybrid mesh (:func:`make_hybrid_mesh`, the JAX package's DCN ×
  ICI mesh): a JAX process is a node here and a JAX device a rank, so the
  granule is the node.  ``data`` is the axis between nodes and every
  ``stage``/``seq`` subgroup stays inside one node: rank coordinates are
  laid out node by node, whatever order the launcher numbered the ranks
  in.

:class:`MeshConfig` is copied from the JAX package and pinned equal to it.
A :class:`Mesh` is a plain record of the axes, this rank's coordinates on
the ``data`` (and ``seq``) axes, the devices of its replica and its ring.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tpudist_torch.runtime.bootstrap import (host_group, local_rank,
                                             local_world_size, process_count,
                                             process_index)

AXIS_DATA = "data"
AXIS_STAGE = "stage"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
ALL_AXES = (AXIS_DATA, AXIS_STAGE, AXIS_SEQ, AXIS_MODEL)

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; ``-1`` means "absorb all remaining devices"."""

    data: int = -1
    stage: int = 1
    seq: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = {"data": self.data, "stage": self.stage, "seq": self.seq, "model": self.model}
        unknown = [k for k, v in sizes.items() if v == -1]
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if unknown:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[unknown[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} does not cover {n_devices} devices"
            )
        return MeshConfig(**sizes)

    def axis_sizes(self) -> dict:
        return {"data": self.data, "stage": self.stage, "seq": self.seq, "model": self.model}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axes of a run as one rank sees them: ``shape`` maps each axis
    name to its size, ``coords`` holds this rank's place on the ``data``
    axis (the process group) and, when they span ranks, on ``stage`` and
    ``seq``; ``devices`` are the devices of this rank's model replica, one
    a ``model`` coordinate (repeats allowed); ``ring`` is the ``seq`` axis's
    ring (``None`` without one); ``data_group`` the process group of this
    rank's ``data`` axis (``None``: the default group, which it is unless a
    ``stage`` or ``seq`` axis spans ranks); ``stages`` the ``stage`` axis's
    chain, a ring of its places (``None`` without a ``stage`` axis)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    devices: Tuple[torch.device, ...]
    ring: object = dataclasses.field(default=None, compare=False)
    data_group: object = dataclasses.field(default=None, compare=False)
    stages: object = dataclasses.field(default=None, compare=False)


def replica_devices(local_rank: int, model_size: int,
                    device_count: int) -> Tuple[torch.device, ...]:
    """The ``model_size`` distinct CUDA devices of the rank ``local_rank``
    on its host, ``cuda:local_rank*model_size + i``; raises when the host
    has fewer.  No index is taken modulo the count, so two ranks never
    share a device (SURVEY appendix: ``demo_one_model_multi_gpu.py:90-91``
    does, and collides)."""
    if model_size < 1:
        raise ValueError(f"model axis must be at least 1, got {model_size}")
    first = local_rank * model_size
    if first + model_size > device_count:
        raise ValueError(
            f"local rank {local_rank} needs devices {first}.."
            f"{first + model_size - 1} for a model axis of {model_size}, "
            f"but the host has {device_count}")
    return tuple(torch.device("cuda", first + i) for i in range(model_size))


def _devices(model_size: int, devices, device) -> Tuple[torch.device, ...]:
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) != model_size:
            raise ValueError(
                f"{len(devices)} devices given for a model axis of "
                f"{model_size}: a rank holds one replica's devices")
        return devices
    device = torch.device(device)
    if device.type == "cuda":
        return replica_devices(local_rank(), model_size,
                               torch.cuda.device_count())
    return (device,) * model_size


def _order(order: Optional[Sequence[int]], world: int) -> List[int]:
    """The ranks in mesh order (``order[p]`` the rank at row-major position
    ``p`` of the axes over the process group); the launcher's numbering
    when None."""
    if order is None:
        return list(range(world))
    order = [int(r) for r in order]
    if sorted(order) != list(range(world)):
        raise ValueError(f"a rank order must hold each of the {world} ranks "
                         f"once, got {order}")
    return order


def data_parallel_mesh(devices: Optional[Sequence] = None, *,
                       device="cuda",
                       order: Optional[Sequence[int]] = None) -> Mesh:
    """The 1-D ``data`` mesh over the process group — the DDP default
    (SURVEY.md §2.4).  The rank's device is ``devices[0]`` when given,
    else ``cuda:local_rank`` (``demo.py:66``) or the CPU.  ``order``
    (:func:`make_hybrid_mesh`) puts the ranks on the axis in another order
    than their numbers."""
    devs = _devices(1, devices, device)
    pos = _order(order, process_count()).index(process_index())
    return Mesh((AXIS_DATA,), {AXIS_DATA: process_count()},
                {AXIS_DATA: pos}, devs)


def data_model_mesh(model_size: int = 2,
                    devices: Optional[Sequence] = None, *,
                    device="cuda",
                    order: Optional[Sequence[int]] = None) -> Mesh:
    """The 2-D ``('data', 'model')`` mesh of the one-model-several-devices
    demo (``demo_one_model_multi_gpu.py``'s two GPUs a process): ``data``
    is the process group, ``model`` the ``model_size`` devices this rank
    owns.  ``devices`` (this rank's replica, taken as given, repeats
    allowed) or, on CUDA, :func:`replica_devices` for the local rank; on
    the CPU every stage is the CPU.  ``order`` as for
    :func:`data_parallel_mesh`."""
    devs = _devices(model_size, devices, device)
    pos = _order(order, process_count()).index(process_index())
    return Mesh((AXIS_DATA, AXIS_MODEL),
                {AXIS_DATA: process_count(), AXIS_MODEL: model_size},
                {AXIS_DATA: pos}, devs)


def model_devices(model_size: int, device="cuda") -> Tuple[torch.device,
                                                           ...]:
    """This rank's devices for a ``model`` axis of ``model_size``: on CUDA
    :func:`replica_devices` when the host has that many cards a local
    rank, else the rank's own card ``model_size`` times (the places fold
    onto it, each making its own launches); on the CPU the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        first = local_rank() * model_size
        if first + model_size <= torch.cuda.device_count():
            return replica_devices(local_rank(), model_size,
                                   torch.cuda.device_count())
        return (torch.device("cuda", local_rank()),) * model_size
    return (device,) * model_size


def data_seq_mesh(seq: int, devices: Optional[Sequence] = None, *,
                  device="cuda", model: int = 1,
                  order: Optional[Sequence[int]] = None) -> Mesh:
    """The ``('data', 'seq')`` mesh of the long-context demo, or with
    ``model > 1`` the 3-D ``('data', 'seq', 'model')`` one, ``model`` the
    devices of each rank (``devices``, or :func:`_devices`).  Over a
    process group of ``W`` ranks (``W`` a multiple of ``seq``): ``data`` is
    ``W / seq`` rows, rank ``d·seq + s`` the ``s``-th place of row ``d``'s
    ring, each row's ranks one subgroup (``dist.new_group``, made by every
    rank for every row, in order).  In a job of one process the ``seq``
    shards fold onto the rank's device (a :class:`LocalRing`)."""
    from tpudist_torch.parallel.ring import LocalRing, ProcessGroupRing

    if seq < 1:
        raise ValueError(f"seq axis must be at least 1, got {seq}")
    devs = _devices(model, devices, device)
    world = process_count()
    names = (AXIS_DATA, AXIS_SEQ) + ((AXIS_MODEL,) if model > 1 else ())
    extra = {AXIS_MODEL: model} if model > 1 else {}
    if world == 1:
        return Mesh(names, {AXIS_DATA: 1, AXIS_SEQ: seq, **extra},
                    {AXIS_DATA: 0}, devs, LocalRing(seq))
    if world % seq:
        raise ValueError(f"a seq axis of {seq} does not divide the "
                         f"{world} ranks of the process group")
    import torch.distributed as dist

    order, rows = _order(order, world), world // seq
    row_ranks = [order[d * seq:(d + 1) * seq] for d in range(rows)]
    groups = [dist.new_group(ranks=r) for r in row_ranks]
    cols = [dist.new_group(ranks=order[s::seq]) for s in range(seq)]
    d, s = divmod(order.index(process_index()), seq)
    ring = ProcessGroupRing(groups[d], row_ranks[d], s)
    return Mesh(names, {AXIS_DATA: rows, AXIS_SEQ: seq, **extra},
                {AXIS_DATA: d, AXIS_SEQ: s}, devs, ring, cols[s])


def data_stage_mesh(stage: int, devices: Optional[Sequence] = None, *,
                    device="cuda", seq: int = 1, model: int = 1,
                    order: Optional[Sequence[int]] = None) -> Mesh:
    """The ``('data', 'stage')`` mesh of the pipeline demo, with ``seq``
    and ``model`` beside it when above 1, in the JAX order ``(data, stage,
    seq, model)``.  Over a process group of ``W`` ranks (``W`` a multiple
    of ``stage·seq``): ``data`` is ``W / (stage·seq)`` rows, rank ``(d·
    stage + s)·seq + q`` holds stage ``s`` and seq place ``q`` of row
    ``d``; the stage subgroups (one a ``(d, q)``), then the seq subgroups
    (one a ``(d, s)``), then the data subgroups (one a ``(s, q)``) are made
    by every rank, in that order.  In a job of one process the stages (and
    seq shards) fold onto the rank's first device.  ``order``
    (:func:`make_hybrid_mesh`): the place ``(d·stage + s)·seq + q`` is rank
    ``order[(d·stage + s)·seq + q]`` instead."""
    from tpudist_torch.parallel.ring import LocalRing, ProcessGroupRing

    for name, n in (("stage", stage), ("seq", seq)):
        if n < 1:
            raise ValueError(f"{name} axis must be at least 1, got {n}")
    devs = _devices(model, devices, device)
    world = process_count()
    names = ((AXIS_DATA, AXIS_STAGE) + ((AXIS_SEQ,) if seq > 1 else ())
             + ((AXIS_MODEL,) if model > 1 else ()))
    extra = {**({AXIS_SEQ: seq} if seq > 1 else {}),
             **({AXIS_MODEL: model} if model > 1 else {})}
    if world == 1:
        return Mesh(names, {AXIS_DATA: 1, AXIS_STAGE: stage, **extra},
                    {AXIS_DATA: 0}, devs,
                    LocalRing(seq) if seq > 1 else None,
                    stages=LocalRing(stage, (devs[0],) * stage))
    if world % (stage * seq):
        raise ValueError(f"a stage axis of {stage} and a seq axis of {seq} "
                         f"cannot be laid out over the {world} ranks of "
                         f"the process group: their product must divide "
                         f"it (the stages and seq shards fold only in a "
                         f"job of one process)")
    import torch.distributed as dist

    rows = world // (stage * seq)
    order = _order(order, world)

    def rank(d, s, q):
        return order[(d * stage + s) * seq + q]

    stage_groups = {(d, q): dist.new_group(
        ranks=[rank(d, s, q) for s in range(stage)])
        for d in range(rows) for q in range(seq)}
    seq_groups = {(d, s): dist.new_group(
        ranks=[rank(d, s, q) for q in range(seq)])
        for d in range(rows) for s in range(stage)} if seq > 1 else {}
    data_groups = {(s, q): dist.new_group(
        ranks=[rank(d, s, q) for d in range(rows)])
        for s in range(stage) for q in range(seq)}
    r = order.index(process_index())
    d, s, q = r // (stage * seq), (r // seq) % stage, r % seq
    stages = ProcessGroupRing(stage_groups[(d, q)],
                              [rank(d, i, q) for i in range(stage)], s)
    ring = (ProcessGroupRing(seq_groups[(d, s)],
                             [rank(d, s, i) for i in range(seq)], q)
            if seq > 1 else None)
    coords = {AXIS_DATA: d, AXIS_STAGE: s, **({AXIS_SEQ: q} if seq > 1
                                              else {})}
    return Mesh(names, {AXIS_DATA: rows, AXIS_STAGE: stage, **extra},
                coords, devs, ring, data_groups[(s, q)], stages)


def make_mesh(config: Optional[MeshConfig] = None, *,
              devices: Optional[Sequence] = None, device="cuda",
              order: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh from a :class:`MeshConfig` over this job's devices
    (``model`` a rank, ``data`` the process group, ``stage`` and ``seq``
    over the process group or folded onto a one-process job's device): the
    meshes above.  ``order`` lays the ranks out in another order than their
    numbers (:func:`make_hybrid_mesh`)."""
    config = config or MeshConfig()
    if config.model == -1:
        raise ValueError("the model axis needs a size: a rank owns the "
                         "devices of one replica")
    if config.seq == -1:
        raise ValueError("the seq axis needs a size: it is the ring's "
                         "length")
    if config.stage == -1:
        # the axis absorbs the ranks the others leave (one in a job of one
        # process, whose devices are the ranks' own)
        config = config.resolve(process_count() * config.model)
    if config.stage != 1:
        world = process_count()
        config.resolve((world if world > 1 else config.stage * config.seq)
                       * config.model)
        return data_stage_mesh(config.stage, devices, device=device,
                               seq=config.seq, model=config.model,
                               order=order)
    if config.seq != 1:
        world = process_count()
        config.resolve((world if world > 1 else config.seq) * config.model)
        return data_seq_mesh(config.seq, devices, device=device,
                             model=config.model, order=order)
    config.resolve(process_count() * config.model)
    if config.model == 1:
        return data_parallel_mesh(devices, device=device, order=order)
    return data_model_mesh(config.model, devices, device=device,
                           order=order)


def node_name() -> str:
    """The name of the node this process runs on: ``TPUDIST_NODE_NAME``
    when set (containers whose host name does not name the machine), else
    the host name."""
    return os.environ.get("TPUDIST_NODE_NAME", "").strip() or \
        socket.gethostname()


def job_nodes() -> List[List[int]]:
    """The ranks of each node of the job, each node's ranks ascending and
    the nodes in the order of their lowest rank.  The launch contract's
    ``local_world_size`` says how many ranks a node holds; an all-gather of
    :func:`node_name` says which, and the two must agree."""
    world = process_count()
    if world == 1:
        return [[0]]
    import torch.distributed as dist

    names: list = [None] * world
    dist.all_gather_object(names, node_name(), group=host_group())
    by_name: Dict[str, List[int]] = {}
    for r, name in enumerate(names):
        by_name.setdefault(name, []).append(r)
    nodes = sorted(by_name.values(), key=lambda ranks: ranks[0])
    per = local_world_size()
    if world % per or len(nodes) != world // per or any(
            len(ranks) != per for ranks in nodes):
        raise ValueError(
            f"the launch contract puts {per} ranks on each node of a "
            f"{world}-rank job, but the ranks' node names group them "
            f"{[len(ranks) for ranks in nodes]}")
    return nodes


def make_hybrid_mesh(config: Optional[MeshConfig] = None, *,
                     force_granules: Optional[int] = None,
                     devices: Optional[Sequence] = None,
                     device="cuda") -> Mesh:
    """Multi-node mesh with DCN/ICI-aware rank placement — the JAX
    package's ``make_hybrid_mesh``, a JAX process read as a node and a JAX
    device as a rank.

    Between nodes the fabric is an order of magnitude slower than inside
    one, so the ``data`` axis (one gradient all-reduce a step) spans the
    nodes and ``stage``/``seq`` (activations every layer) stay inside a
    node; ``model`` is the devices of one rank, inside its node already.
    The nodes come from :func:`job_nodes`; the ranks are laid out node by
    node (the data axis's outer positions iterate the nodes, each node's
    ranks fill its block in rank order), so a launcher that numbers ranks
    across nodes still gets every ``stage``/``seq`` subgroup on one node.
    The ``data`` axis must divide by the node count (JAX's refusal, its
    text).  A job on one node falls back to :func:`make_mesh`.

    ``force_granules=k`` is the one-node validation path: ``k`` contiguous
    blocks of ranks stand in for nodes (the same layout as on ``k`` real
    nodes numbered in order).  It raises when the job spans more than one
    node, as JAX's does over several processes."""
    config = (config or MeshConfig())
    if config.model == -1:
        raise ValueError("the model axis needs a size: a rank owns the "
                         "devices of one replica")
    world = process_count()
    config = (config.resolve(world * config.model) if world > 1 else
              dataclasses.replace(config, data=max(config.data, 1)))
    nodes = job_nodes()
    if force_granules is not None and len(nodes) > 1:
        raise ValueError(
            "force_granules is the single-node validation path; this job "
            f"spans {len(nodes)} nodes — real granules are detected from "
            "the nodes' names")
    if len(nodes) == 1 and force_granules is None:
        return make_mesh(config, devices=devices, device=device)
    n_granules = force_granules if force_granules is not None \
        else len(nodes)
    sizes = config.axis_sizes()
    if sizes["data"] % n_granules != 0:
        raise ValueError(
            f"hybrid mesh: data axis {sizes['data']} not divisible by "
            f"{n_granules} DCN granules (the data axis is the DCN axis)"
        )
    if force_granules is not None:
        if world % n_granules != 0:
            raise ValueError(
                f"{world} ranks not divisible into {n_granules} granules")
        per = world // n_granules
        nodes = [list(range(i * per, (i + 1) * per))
                 for i in range(n_granules)]
    order = [r for ranks in nodes for r in ranks]
    return make_mesh(config, devices=devices, device=device, order=order)
