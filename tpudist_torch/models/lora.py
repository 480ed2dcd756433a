"""Paged multi-LoRA adapter pool: the device half of per-tenant adapters.

The PyTorch counterpart of :mod:`tpudist.models.lora`.  One base model
serves many tenants' rank-r LoRA fine-tunes:

- **storage** is a pool of ``num_blocks`` adapter blocks shared by all
  layers (:class:`AdapterPool`: six f32 tensors on the engine's device —
  A/B factors for the ``qkv``, ``wi`` and ``wo`` projections, ``a_*``
  ``[L, num_blocks, d_in, r]`` and ``b_*`` ``[L, num_blocks, r, d_out]``;
  one block id holds one adapter's whole factor set);
- **indirection** is a per-slot ``adapter_id`` in
  :class:`~tpudist_torch.models.generate.SlotState` (sentinel
  ``num_blocks`` = base-only).  Every forward hands the FULL pools plus the
  per-slot ``ids`` to the blocks (:func:`pool_collection`), and the LoRA
  gather-matmul kernel (:func:`tpudist_torch.ops.lora_delta`) reads each
  slot's own factor block inside the kernel;
- **the base-only contract**: a sentinel id clamps into a real block, but
  the per-slot ``on`` mask selects the UNMODIFIED base projection output —
  ``where(on, y + Δ, y)``, a select, not an add — so a base-only lane is
  bit for bit the base model;
- **loading** writes one block in place (:func:`load_factors`), and freed
  blocks are zeroed (:func:`zero_block`): no tenant's fine-tune leaks into
  a later lane.  The JAX package swaps immutable arrays; the port writes
  the pool in place, and only ever a block no live lane is bound to.

The JAX package has two collection forms, pre-gathered factors
(:func:`gather_collection`) and the pool form (:func:`pool_collection`);
both compute the same function and its suite pins their streams identical.
The port's kernel programs always take the pool form, so an engine built
with ``lora_kernel=False`` runs the same kernel path as ``lora_kernel=True``
there; the dense and gather programs take the pre-gathered factors, whose
delta is two batched products in plain tensor ops on every device, as the
JAX package's XLA product on those programs is.
The host half — name → block id, refcounts, LRU eviction of cold adapters
— is :mod:`tpudist_torch.serve.adapters`.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

#: factor-pair keys, in the order the Block seam consumes them
FACTOR_KEYS = ("a_qkv", "b_qkv", "a_wi", "b_wi", "a_wo", "b_wo")


class AdapterPoolConfig(NamedTuple):
    """Static geometry of an adapter pool: ``num_blocks`` resident adapters
    (also the sentinel id) and the LoRA ``rank`` shared by every pair."""

    num_blocks: int
    rank: int


class AdapterPool(NamedTuple):
    """The device-resident f32 factor pool (module doc for the shapes)."""

    a_qkv: torch.Tensor
    b_qkv: torch.Tensor
    a_wi: torch.Tensor
    b_wi: torch.Tensor
    a_wo: torch.Tensor
    b_wo: torch.Tensor


def adapter_dims(model) -> Dict[str, tuple]:
    """``(d_in, d_out)`` of each adapted projection of ``model`` (a
    :class:`~tpudist_torch.models.TransformerLM`): ``qkv`` covers the fused
    q/k/v output (GQA-aware), ``wi``/``wo`` the dense FFN halves."""
    d = int(model.d_model)
    kv_dim = int(model.n_kv) * int(model.head_dim)
    return {
        "qkv": (d, d + 2 * kv_dim),
        "wi": (d, int(model.d_ff)),
        "wo": (int(model.d_ff), d),
    }


def init_adapter_pool(model, cfg: AdapterPoolConfig,
                      device=None) -> AdapterPool:
    """All-zeros pool over ``model``'s geometry on ``device`` (default: the
    model's); a zero factor pair is a no-op delta."""
    if cfg.num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {cfg.num_blocks}")
    if cfg.rank < 1:
        raise ValueError(f"rank must be >= 1, got {cfg.rank}")
    if device is None:
        device = model.tok_embed.device
    L, B, r = int(model.n_layers), cfg.num_blocks, cfg.rank
    out = {}
    for proj, (din, dout) in adapter_dims(model).items():
        out[f"a_{proj}"] = torch.zeros(L, B, din, r, device=device)
        out[f"b_{proj}"] = torch.zeros(L, B, r, dout, device=device)
    return AdapterPool(**out)


def adapter_block_bytes(model, cfg: AdapterPoolConfig) -> int:
    """Resident bytes of ONE adapter block across all layers and
    projections (f32 factors)."""
    L, r = int(model.n_layers), cfg.rank
    return sum(L * r * (din + dout) * 4
               for din, dout in adapter_dims(model).values())


def make_adapter_factors(gen: torch.Generator, model, rank: int, *,
                         scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """Random f32 factor set for ``model`` at ``rank`` from ``gen`` (a CPU
    ``torch.Generator``): ``a_*`` normal with variance ``1/d_in``, ``b_*``
    normal times ``scale`` — both non-zero, unlike a fresh LoRA whose B is
    zero, so the delta path does work."""
    L = int(model.n_layers)
    out: Dict[str, torch.Tensor] = {}
    for proj, (din, dout) in adapter_dims(model).items():
        out[f"a_{proj}"] = torch.randn(L, din, rank,
                                       generator=gen) * din ** -0.5
        out[f"b_{proj}"] = torch.randn(L, rank, dout, generator=gen) * scale
    return out


def check_factors(model, cfg: AdapterPoolConfig,
                  factors: Dict[str, Any]) -> None:
    """Loud shape validation before a load touches the pool."""
    L, r = int(model.n_layers), cfg.rank
    for proj, (din, dout) in adapter_dims(model).items():
        for key, want in ((f"a_{proj}", (L, din, r)),
                          (f"b_{proj}", (L, r, dout))):
            if key not in factors:
                raise ValueError(f"adapter factors missing {key!r}")
            got = tuple(np.shape(factors[key]))
            if got != want:
                raise ValueError(
                    f"adapter factor {key} shape {got} != expected {want} "
                    f"(module geometry × pool rank {r})")


class PlacedAdapterPool(NamedTuple):
    """An adapter pool over ``model`` places (the serving mesh): ``b_qkv``
    and ``b_wi`` hold one tensor a place, the output columns of its slice
    of ``qkv`` / ``wi`` (``cols``: ``{key: [column index a place]}``, on
    each place's device); the A factors and ``b_wo`` are whole.  A
    1-tuple is a B factor that stays whole (its weight does)."""

    a_qkv: torch.Tensor
    b_qkv: Tuple[torch.Tensor, ...]
    a_wi: torch.Tensor
    b_wi: Tuple[torch.Tensor, ...]
    a_wo: torch.Tensor
    b_wo: torch.Tensor
    cols: Dict[str, List[torch.Tensor]]


def place_adapter_pool(pool: AdapterPool,
                       cols: Dict[str, Optional[List[torch.Tensor]]],
                       devices: Sequence) -> PlacedAdapterPool:
    """``pool`` over places: ``cols[key]`` (``b_qkv``, ``b_wi``) the
    output columns each place owns, or None to keep that factor whole."""
    parts, kept = {}, {}
    for key in ("b_qkv", "b_wi"):
        whole = getattr(pool, key)
        ix = cols.get(key)
        if ix is None:
            parts[key] = (whole,)
            kept[key] = [torch.arange(whole.shape[-1],
                                      device=whole.device)]
            continue
        kept[key] = [c.to(dev) for c, dev in zip(ix, devices)]
        parts[key] = tuple(whole[..., c.to(whole.device)].to(dev)
                           .contiguous() for c, dev in zip(ix, devices))
    return PlacedAdapterPool(a_qkv=pool.a_qkv, b_qkv=parts["b_qkv"],
                             a_wi=pool.a_wi, b_wi=parts["b_wi"],
                             a_wo=pool.a_wo, b_wo=pool.b_wo, cols=kept)


def _factor_parts(pool, key: str):
    """``(tensor, columns)`` pairs of factor ``key``: one whole tensor
    (columns None) or a placed pool's parts."""
    t = getattr(pool, key)
    if isinstance(t, tuple):
        return list(zip(t, pool.cols[key]))
    return [(t, None)]


@torch.no_grad()
def load_factors(pool, bid: int, factors: Dict[str, Any]):
    """Write one adapter's factor set into block ``bid`` in place (loads
    are rare next to decode steps; a placed pool's parts take their
    columns).  Returns ``pool``."""
    for key in FACTOR_KEYS:
        src = factors[key]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.asarray(src, np.float32))
        for dst, cols in _factor_parts(pool, key):
            part = src if cols is None else src[..., cols.to(src.device)]
            dst[:, bid].copy_(part)
    return pool


@torch.no_grad()
def zero_block(pool, bid: int):
    """Zero block ``bid`` in place: a freed block must not leak a tenant's
    fine-tune into a later lane.  Returns ``pool``."""
    for key in FACTOR_KEYS:
        for dst, _ in _factor_parts(pool, key):
            dst[:, bid].zero_()
    return pool


def pool_collection(pool: AdapterPool, ids: torch.Tensor) -> Dict[str, Any]:
    """The adapters every block of a forward reads: the FULL factor pools
    (no gather, no copy), the per-slot ``ids [S]`` int32 and ``on = ids <
    num_blocks`` [S] bool on the device — sentinel lanes ride the bit-exact
    base select."""
    ids = ids.to(torch.int32).contiguous()
    col: Dict[str, Any] = {key: getattr(pool, key) for key in FACTOR_KEYS}
    col["ids"] = ids
    col["on"] = ids < pool.a_qkv.shape[1]
    return col


def gather_collection(pool: AdapterPool,
                      ids: torch.Tensor) -> Dict[str, Any]:
    """The adapters of a dense or gather program: each slot's factors
    gathered at ``ids [S]`` (``a_* [L, S, d_in, r]``, ``b_* [L, S, r,
    d_out]``) and ``on = ids < num_blocks`` — the JAX ``gather_collection``.
    Sentinel ids clamp onto a real block, which ``on`` deselects: a
    base-only lane is the base model bit for bit."""
    B = pool.a_qkv.shape[1]
    ids = ids.long()
    safe = ids.clamp(max=B - 1)
    col: Dict[str, Any] = {key: getattr(pool, key)[:, safe]
                           for key in FACTOR_KEYS}
    col["on"] = ids < B
    return col


def place_collections(pool: PlacedAdapterPool, ids: torch.Tensor,
                      kernel: bool, places: int) -> List[Dict[str, Any]]:
    """Each of ``places`` places' adapter collection over a placed pool:
    :func:`pool_collection` (``kernel``) or :func:`gather_collection` with
    the place's ``b_qkv``/``b_wi`` slices (the first when a factor stays
    whole)."""
    out = []
    for m in range(places):
        view = AdapterPool(
            a_qkv=pool.a_qkv, b_qkv=pool.b_qkv[min(m, len(pool.b_qkv) - 1)],
            a_wi=pool.a_wi, b_wi=pool.b_wi[min(m, len(pool.b_wi) - 1)],
            a_wo=pool.a_wo, b_wo=pool.b_wo)
        out.append((pool_collection if kernel else gather_collection)(
            view, ids))
    return out


def pool_bytes(pool) -> int:
    if pool is None:
        return 0
    return sum(t.numel() * t.element_size() for k in FACTOR_KEYS
               for t, _ in _factor_parts(pool, k))
