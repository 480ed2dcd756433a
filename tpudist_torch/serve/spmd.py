"""The serving mesh of the slot engine — the counterpart of
:mod:`tpudist.serve.spmd`.

The JAX engine runs its four compiled programs over a ``jax.sharding.Mesh``
and lets the partitioner split them.  Here a mesh is ``data × model``
*places* of this process (:class:`ServeMesh`): each ``model`` place holds
its slice of the split weights and of the KV storage and makes its own
kernel launches on it, and the slot programs run the model's serving
forward over the places (:class:`~tpudist_torch.models.transformer.
PlacedLM`).  A host with fewer cards than places folds them onto its one
card, as :func:`~tpudist_torch.runtime.mesh.model_devices` folds tensor
parallelism.

Axes (either may be 1):

- ``model`` — tensor parallelism.  Attention splits by whole kv heads:
  each place owns ``n_kv / M`` kv heads, their query heads and their
  q/k/v columns of ``qkv``, and the KV pool's (or dense arena's) slice of
  those heads.  ``wi`` and ``head`` split their output columns; ``wo`` too
  when the overlapped MLP runs.  ``proj``, the embeddings and the norms
  stay whole.
- ``data`` — slot parallelism: the dense arena's slots split over it.  The
  paged pool has no slot axis, so ``data`` is a no-op there, as in JAX.

**The byte-identity invariant** is JAX's: only output and batch dimensions
split, never a contraction or a normalised reduction, so a split moves
data and sums nothing anew.  JAX splits the ``qkv`` columns evenly, a
layout its partitioner can reassemble; cut so, place 0 would hold all of
``q`` and part of ``k``, and the head split and the rotation could not run
where the columns are.  The port cuts by heads instead: every column is the
same dot product either way.  Where ``M`` does not divide a split's
extent (``n_kv``, ``d_ff``, the vocab) the piece stays whole and runs once,
as :func:`_axis_or_none` replicates.

The layout functions return plain records: for each tensor, the
:class:`Split` s of its dimensions (an empty tuple: whole on every place).
:func:`serve_overlap_mlp_fn` is the overlapped TP MLP over the ported
:func:`~tpudist_torch.parallel.overlap.ag_matmul`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from tpudist_torch.runtime.mesh import AXIS_DATA, AXIS_MODEL, model_devices


@dataclasses.dataclass(frozen=True)
class ServeMeshConfig:
    """Declarative serving-mesh geometry (AMP-style: a future planner
    searches these fields, it does not rewrite engine code).

    ``shape``: ``"DxM"`` (data × model) or a bare ``"M"`` (pure TP,
    data = 1).  ``"1"``/``"1x1"``/empty mean no mesh (single device).
    """

    shape: str = "1"
    tp_overlap: Optional[str] = None  # None: knob decides; "off"/"ring"/...

    @property
    def dims(self) -> tuple:
        s = (self.shape or "1").strip().lower().replace("×", "x")
        parts = [p for p in s.split("x") if p]
        try:
            nums = [int(p) for p in parts]
        except ValueError:
            raise ValueError(
                f"serve mesh shape must be 'DxM' or 'M', got {self.shape!r}")
        if len(nums) == 1:
            nums = [1, nums[0]]
        if len(nums) != 2 or any(n < 1 for n in nums):
            raise ValueError(
                f"serve mesh shape must be 'DxM' or 'M', got {self.shape!r}")
        return tuple(nums)

    @property
    def n_devices(self) -> int:
        d, m = self.dims
        return d * m

    @property
    def enabled(self) -> bool:
        return self.n_devices > 1

    @classmethod
    def from_env(cls) -> "ServeMeshConfig":
        shape = os.environ.get("TPUDIST_SERVE_MESH", "").strip() or "1"
        overlap = os.environ.get("TPUDIST_SERVE_TP_OVERLAP", "").strip()
        return cls(shape=shape, tp_overlap=overlap or None)


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """``data × model`` places of this process: ``devices`` holds each
    ``model`` place's device (repeats allowed: folded places share a card
    and each makes its own launches); a ``data`` row's places are those of
    the ``model`` axis, over its slice of the slots."""

    data: int
    model: int
    devices: Tuple[torch.device, ...]
    axis_names = (AXIS_DATA, AXIS_MODEL)

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS_DATA: self.data, AXIS_MODEL: self.model}


def build_serve_mesh(cfg: ServeMeshConfig, device="cuda"
                     ) -> Optional[ServeMesh]:
    """The :class:`ServeMesh` of ``cfg`` on this process's devices, or
    ``None`` when the config is 1x1.  The ``model`` places take
    :func:`~tpudist_torch.runtime.mesh.model_devices`: a card each where
    the host has them, else all folded onto the rank's card (or the CPU).
    So JAX's "needs N devices" refusal does not apply: a mesh larger than
    the host folds."""
    if not cfg.enabled:
        return None
    d, m = cfg.dims
    return ServeMesh(d, m, tuple(model_devices(m, device)))


class Split(NamedTuple):
    """Dimension ``dim`` of a tensor splits over mesh axis ``axis`` into
    ``places`` slices: contiguous and even (``how="even"``), or by whole kv
    heads with each place's q, k and v columns (``how="heads"``)."""

    axis: str
    dim: int
    places: int
    how: str = "even"


def _axis_or_none(mesh, axis: str, dim_size: int):
    """``axis`` if the mesh has it, its size > 1, and it divides
    ``dim_size`` — else ``None`` (replicate).  Splitting an indivisible
    dim would leave places of unequal work; replicating it is merely less
    parallel."""
    if axis not in mesh.axis_names:
        return None
    n = mesh.shape[axis]
    if n <= 1 or dim_size % n:
        return None
    return axis


def _split(mesh, axis: str, dim: int, size: int, how: str = "even"):
    a = _axis_or_none(mesh, axis, size)
    return () if a is None else (Split(a, dim, mesh.shape[a], how),)


def serve_param_sharding(mesh, model, *, overlap: bool = False
                         ) -> Dict[str, tuple]:
    """``{parameter name: splits}`` of ``model`` (a
    :class:`~tpudist_torch.models.TransformerLM`) under the byte-identity
    invariant: ``qkv`` by whole kv heads (rows of the ``[out, in]``
    weight; whole where ``model`` does not divide ``n_kv``), ``wi`` and
    ``head`` by output rows, ``wo`` too only when the overlapped MLP
    consumes it (the plain path would leave a d-split residual feeding
    LayerNorm, a split normalised reduction); ``proj``, the embeddings and
    the norms whole."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "qkv":
            out[name] = _split(mesh, AXIS_MODEL, 0, int(model.n_kv), "heads")
        elif leaf in ("wi", "head") or (leaf == "wo" and overlap):
            out[name] = _split(mesh, AXIS_MODEL, 0, int(p.shape[0]))
        else:
            out[name] = ()
    return out


def serve_spec_param_sharding(mesh, draft) -> Dict[str, tuple]:
    """Serving layout of a loaded speculative draft: the target's column
    rule where the draft's widths allow it, everything else whole (a tied
    draft shares the target's places and never reaches this function).
    The draft's KV follows :func:`serve_cache_sharding` /
    :func:`serve_paged_sharding`, as the target's."""
    return serve_param_sharding(mesh, draft, overlap=False)


def serve_cache_sharding(mesh, cache) -> Dict[str, tuple]:
    """Splits of a dense slot cache (``DenseKV``: ``k``/``v`` ``[L, S,
    n_kv, max_len, dh]``): slots over ``data``, kv heads over ``model``;
    the cursors whole."""
    splits = (_split(mesh, AXIS_DATA, 1, int(cache.k.shape[1]))
              + _split(mesh, AXIS_MODEL, 2, int(cache.k.shape[2])))
    return {"k": splits, "v": splits, "cursor": ()}


def serve_paged_sharding(mesh, pkv) -> Dict[str, tuple]:
    """Splits of a paged pool (``PagedKV``): the pools ``[L, nb, n_kv, bs,
    dh]`` and their scales ``[L, nb, n_kv]`` over ``model`` by kv heads;
    block ids stay global (the host allocator is topology-oblivious), so
    the table and the cursors are whole."""
    heads = _split(mesh, AXIS_MODEL, 2, int(pkv.pool_k.shape[2]))
    return {"pool_k": heads, "pool_v": heads, "scale_k": heads,
            "scale_v": heads, "table": (), "cursor": ()}


def serve_adapter_sharding(mesh, apool, model) -> Dict[str, tuple]:
    """Splits of an adapter pool (``AdapterPool``) for ``model``: the B
    factors whose output columns follow a split weight (``b_qkv`` by
    ``qkv``'s kv heads, ``b_wi`` by ``wi``'s rows) split their last
    dimension over ``model``; the rank-r A factors and ``b_wo`` (its output
    feeds the whole residual, like ``proj``) stay whole."""
    return {
        "a_qkv": (), "a_wi": (), "a_wo": (), "b_wo": (),
        "b_qkv": _split(mesh, AXIS_MODEL, 3, int(model.n_kv), "heads"),
        "b_wi": _split(mesh, AXIS_MODEL, 3, int(apool.b_wi.shape[-1]))}


def serve_state_sharding(mesh, state) -> Dict[str, tuple]:
    """``SlotState`` stays whole: a handful of ``[S]`` vectors the host's
    admission and budget logic reads the same on every place."""
    return {name: () for name in state._fields}


def resolve_serve_overlap(cfg: ServeMeshConfig) -> str:
    """The TP-overlap mode for a serving mesh: the config's explicit
    ``tp_overlap`` wins; otherwise ``TPUDIST_SERVE_TP_OVERLAP`` falls
    back to the shared ``TPUDIST_OVERLAP`` knob.  Same forgiving parse
    as :func:`tpudist_torch.parallel.overlap.overlap_mode`."""
    from tpudist_torch.parallel.overlap import overlap_mode

    v = cfg.tp_overlap
    if v is None:
        v = os.environ.get("TPUDIST_SERVE_TP_OVERLAP", "").strip() or None
    if v is not None:
        v = v.strip().lower()
        return v if v in ("ring", "bidir") else "off"
    return overlap_mode(None)


def serve_overlap_mlp_fn(mesh, *, axis_name: str = AXIS_MODEL,
                         mode: str = "ring"):
    """The overlapped TP decode/prefill MLP: ``mlp_fn(wi, wo, x)`` with
    ``wi``/``wo`` lists of the places' column shards in the JAX layout
    (``wi [d, ff/M]``, ``wo [ff, d/M]``) and ``x [b, s, d]`` whole.

    Both FFN products run :func:`~tpudist_torch.parallel.overlap.
    ag_matmul` with ``gather="rhs"`` over the ``model`` ring (a
    :class:`~tpudist_torch.parallel.LocalRing` over the places' devices):
    each hop moves one weight chunk to the next place, under
    ``OVERLAP_SCOPE``, while the previous chunk's product runs.  Column
    gathers assemble disjoint output chunks, so each place's result is the
    dense MLP's bit for bit; every place computes it, as every device does
    under JAX's ``shard_map``, and the first place's is returned.

    Returns ``None`` when ``mode`` is off or the mesh has no model axis
    above 1, so call sites keep the plain path by default."""
    import torch.nn.functional as F

    from tpudist_torch.parallel.overlap import ag_matmul
    from tpudist_torch.parallel.ring import LocalRing

    if mode not in ("ring", "bidir"):
        return None
    if axis_name not in mesh.axis_names or mesh.shape[axis_name] <= 1:
        return None
    ring = LocalRing(mesh.shape[axis_name], devices=mesh.devices)

    def mlp_fn(wi, wo, x):
        b, s, d = x.shape
        t = x.reshape(b * s, d)
        xs = [t.to(dev) for dev in ring.devices]
        h = ag_matmul(xs, wi, axis=ring, mode=mode, gather="rhs")
        h = [F.gelu(p, approximate="tanh") for p in h]
        y = ag_matmul(h, wo, axis=ring, mode=mode, gather="rhs")
        return y[0].to(x.device).reshape(b, s, d).to(x.dtype)

    mlp_fn.overlap = mode
    mlp_fn.axis_name = axis_name
    return mlp_fn


def sharded_param_bytes(model, shardings) -> dict:
    """Accounting for ``spmd_stats``: total parameter bytes, the bytes that
    split, and the per-place resident estimate (JAX's sums over the
    port's parameters, which are the JAX model's)."""
    total = sharded = per_dev = 0
    for name, p in model.named_parameters():
        b = p.numel() * p.element_size()
        total += b
        splits = shardings.get(name, ())
        if splits:
            sharded += b
            n = 1
            for s in splits:
                n *= s.places
            per_dev += b // n
        else:
            per_dev += b
    return {"param_bytes_total": total, "param_bytes_sharded": sharded,
            "param_bytes_per_device": per_dev}


def place_model(mesh: ServeMesh, model, shardings: Dict[str, tuple],
                mlp_fn=None):
    """The model's serving forward over ``mesh``'s ``model`` places
    (:class:`~tpudist_torch.models.transformer.PlacedLM`), each split
    weight cut as ``shardings`` says (:func:`serve_param_sharding`)."""
    from tpudist_torch.models.transformer import PlacedLM

    def places(leaf: str) -> int:
        for name, splits in shardings.items():
            if name.rsplit(".", 1)[-1] == leaf:
                return splits[0].places if splits else 1
        return 1

    return PlacedLM(model, mesh.devices, attn_places=places("qkv"),
                    wi_places=places("wi"), head_places=places("head"),
                    wo_places=places("wo"), mlp_fn=mlp_fn)


def place_adapter_pool(mesh: ServeMesh, apool, model):
    """``apool`` (an ``AdapterPool``) over ``mesh``'s ``model`` places as
    :func:`serve_adapter_sharding` lays it out (a
    :class:`~tpudist_torch.models.lora.PlacedAdapterPool`)."""
    from tpudist_torch.models.lora import place_adapter_pool as place
    from tpudist_torch.models.transformer import even_rows, qkv_place_rows

    lay = serve_adapter_sharding(mesh, apool, model)
    cols = {"b_qkv": None, "b_wi": None}
    if lay["b_qkv"]:
        cols["b_qkv"] = qkv_place_rows(
            int(model.d_model), int(model.n_heads), int(model.n_kv),
            int(model.head_dim), lay["b_qkv"][0].places)
    if lay["b_wi"]:
        cols["b_wi"] = even_rows(int(apool.b_wi.shape[-1]),
                                 lay["b_wi"][0].places)
    return place(apool, cols, mesh.devices)
