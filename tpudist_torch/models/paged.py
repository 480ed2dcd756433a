"""Paged KV-cache storage for the slot engine — the PyTorch counterpart of
:mod:`tpudist.models.paged`.

A pool of ``num_blocks`` fixed-size blocks shared by every slot and layer
(``[L, num_blocks, n_kv, block_size, dh]``, int8 with one f32 scale per
(layer, block, kv head) when quantized), a per-slot block table
(``[num_slots, max_len // block_size]`` int32, sentinel ``num_blocks`` =
unmapped) and a per-slot cursor.  Which block backs which position is the
host allocator's decision (:mod:`tpudist_torch.serve.paged_alloc`).

JAX's scatters silently drop out-of-range ids and its gathers clamp them;
here the sentinels are clamped on every gather and filtered out of every
scatter explicitly.  Unlike the JAX package, which returns new arrays, the
commits update the pool IN PLACE: a functional copy of a pool that holds
the whole KV cache (0.54 GB at the serving slice's width) per dispatch
would cost more than the dispatch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class PagedKVConfig(NamedTuple):
    """Static pool geometry: ``num_blocks`` blocks of ``block_size``
    tokens (must divide ``max_len``), int8 storage when ``quantized``."""

    num_blocks: int
    block_size: int
    quantized: bool = False


class PagedKV(NamedTuple):
    """The device-resident paged cache: pools and scales (module doc),
    ``table [num_slots, M]`` and ``cursor [num_slots]`` int32 — each
    lane's filled length (the JAX package's per-layer ``idx`` meta, one
    vector since every layer's cursor is the same)."""

    pool_k: torch.Tensor
    pool_v: torch.Tensor
    scale_k: torch.Tensor
    scale_v: torch.Tensor
    table: torch.Tensor
    cursor: torch.Tensor


class PagedLane(NamedTuple):
    """A lane as its pool stores it, for a transfer between engines of one
    pool geometry (:meth:`_Paged.extract_blocks`): the first ``n`` blocks
    of the slot's table row, ``k``/``v [L, n, n_kv, block_size, dh]`` in
    the storage dtype (int8 on a quantized pool), ``scale_k``/``scale_v
    [L, n, n_kv]`` f32 (ones on a float pool) and the ``cursor``.  Written
    into other block ids (:meth:`_Paged.adopt_blocks`), it gives back the
    exported blocks' bytes: an int8 lane is neither dequantized nor
    requantized on the way."""

    k: torch.Tensor
    v: torch.Tensor
    scale_k: torch.Tensor
    scale_v: torch.Tensor
    cursor: torch.Tensor


def block_bytes(n_layers: int, n_kv: int, dh: int, itemsize: int,
                cfg: PagedKVConfig) -> int:
    """Resident bytes of one logical block across all layers, K and V,
    scales included when quantized."""
    item = 1 if cfg.quantized else itemsize
    data = n_layers * 2 * n_kv * cfg.block_size * dh * item
    scales = n_layers * 2 * n_kv * 4 if cfg.quantized else 0
    return data + scales


def _set_rows(dst: torch.Tensor, ids: torch.Tensor, vals) -> None:
    """``dst[:, ids] = vals`` with sentinel ids (``>= dst.shape[1]``)
    dropped — JAX's out-of-range ``.at[].set`` semantics."""
    keep = ids < dst.shape[1]
    idx = ids[keep].long()
    if torch.is_tensor(vals):
        dst[:, idx] = vals[:, keep].to(dst.dtype)
    else:
        dst[:, idx] = vals


class _Paged:
    """Gather/scatter machinery over one model's pool geometry (``n_kv``:
    the kv heads the pool holds, the model's unless a serving-mesh place
    holds a slice of them)."""

    def __init__(self, model, num_slots: int, cfg: PagedKVConfig, device,
                 n_kv: Optional[int] = None):
        self.cfg = cfg
        self.num_slots = num_slots
        self.n_layers = model.n_layers
        self.n_kv = model.n_kv if n_kv is None else int(n_kv)
        self.dh = model.head_dim
        self.max_len = model.max_len
        self.compute_dtype = model.dtype
        self.device = torch.device(device)
        if cfg.block_size < 1 or self.max_len % cfg.block_size:
            raise ValueError(
                f"block_size {cfg.block_size} must be >= 1 and divide "
                f"max_len {self.max_len}")
        if cfg.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {cfg.num_blocks}")
        self.blocks_per_slot = self.max_len // cfg.block_size
        self.storage_dtype = (torch.int8 if cfg.quantized
                              else self.compute_dtype)

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> PagedKV:
        L, B, cfg = self.n_layers, self.cfg.num_blocks, self.cfg
        shape = (L, B, self.n_kv, cfg.block_size, self.dh)
        dev = self.device
        return PagedKV(
            pool_k=torch.zeros(shape, dtype=self.storage_dtype, device=dev),
            pool_v=torch.zeros(shape, dtype=self.storage_dtype, device=dev),
            scale_k=torch.ones((L, B, self.n_kv), device=dev),
            scale_v=torch.ones((L, B, self.n_kv), device=dev),
            table=torch.full((self.num_slots, self.blocks_per_slot), B,
                             dtype=torch.int32, device=dev),
            cursor=torch.zeros(self.num_slots, dtype=torch.int32,
                               device=dev))

    # -- gather -------------------------------------------------------------

    def dense_kv(self, pkv: PagedKV, rows: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather block ids ``rows [..., M']`` into dense K/V
        ``[L, ..., n_kv, M' * bs, dh]`` in the compute dtype, int8 pools
        dequantized (sentinel ids clamp onto a real block — garbage past
        every cursor).  Through whole tables it is the JAX ``slot_cache``
        (every slot) and ``lane_cache`` (an admission batch's rows): the
        dense views the gather and teacher-forced programs run over, a new
        tensor committed back by :meth:`commit_rows`."""
        bs = self.cfg.block_size
        span = rows.shape[-1] * bs
        rows = rows.long().clamp(max=self.cfg.num_blocks - 1)

        def view(pool, scale):
            # [L, ..., M', nk, bs, dh] -> [L, ..., nk, M', bs, dh]
            g = pool[:, rows].to(self.compute_dtype)
            if self.cfg.quantized:
                g = g * scale[:, rows][..., None, None].to(self.compute_dtype)
            g = g.movedim(-3, -4)
            return g.reshape(g.shape[:-4] + (self.n_kv, span, self.dh))

        return view(pkv.pool_k, pkv.scale_k), view(pkv.pool_v, pkv.scale_v)

    # -- scatter ------------------------------------------------------------

    def touch_count(self, span: int) -> int:
        """Blocks covering ``span`` written positions from any start."""
        bs = self.cfg.block_size
        return min(self.blocks_per_slot, (max(1, span) - 1) // bs + 2)

    def scatter_values(self, pkv: PagedKV, ids: torch.Tensor,
                       vk: torch.Tensor, vv: torch.Tensor) -> PagedKV:
        """Quantize (int8 mode) and write per-block values ``[L, N, n_kv,
        bs, dh]`` into the pool at ``ids [N]`` (sentinels dropped)."""
        if self.cfg.quantized:
            def quant(v):
                v32 = v.float()
                amax = v32.abs().amax(dim=(-2, -1))          # [L, N, nk]
                # a tensor divisor keeps IEEE division on CUDA too (a
                # Python-scalar divisor becomes a reciprocal multiply)
                scale = torch.where(amax > 0,
                                    amax / torch.full_like(amax, 127.0),
                                    torch.ones_like(amax))
                q = torch.clamp(torch.round(v32 / scale[..., None, None]),
                                -127, 127).to(torch.int8)
                return q, scale

            qk, sk = quant(vk)
            qv, sv = quant(vv)
            return self.commit_quantized(pkv, ids, qk, qv, sk, sv)
        _set_rows(pkv.pool_k, ids, vk)
        _set_rows(pkv.pool_v, ids, vv)
        return pkv

    def window_view(self, span: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decode arm's window buffers ``[L, S, n_kv, span, dh]`` (all
        zeros: they hold only a dispatch's own uncommitted tokens)."""
        shape = (self.n_layers, self.num_slots, self.n_kv, span, self.dh)
        return (torch.zeros(shape, dtype=self.compute_dtype,
                            device=self.device),
                torch.zeros(shape, dtype=self.compute_dtype,
                            device=self.device))

    def commit_window(self, pkv: PagedKV, wk: torch.Tensor, wv: torch.Tensor,
                      pos0: torch.Tensor, span: int,
                      lane_mask: torch.Tensor) -> PagedKV:
        """Commit window buffers written at ``[pos0, pos0 + span)``: gather
        each live lane's touched blocks, overlay the window at the lane's
        in-block offset, requantize, scatter back.  Masked lanes and blocks
        below ``pos0``'s write nothing."""
        bs, B = self.cfg.block_size, self.cfg.num_blocks
        M, T = self.blocks_per_slot, self.touch_count(span)
        L, S, nk, dh = self.n_layers, self.num_slots, self.n_kv, self.dh
        dev = self.device
        pos0 = pos0.long()
        t0 = torch.div(pos0, bs, rounding_mode="floor")
        start = t0.clamp(0, M - T)
        logical = start[:, None] + torch.arange(T, device=dev)[None]
        ids = torch.gather(pkv.table.long(), 1, logical.clamp(max=M - 1))
        live = (logical >= t0[:, None]) & (logical < M) & lane_mask[:, None]
        ids = torch.where(live, ids, torch.full_like(ids, B))
        old_k, old_v = self.dense_kv(pkv, ids)       # [L, S, nk, T*bs, dh]
        # lax.dynamic_update_slice clamps its start so the update fits
        off = (pos0 - start * bs).clamp(0, T * bs - span)
        cols = off[:, None] + torch.arange(span, device=dev)[None]
        idx = cols[None, :, None, :, None].expand(L, S, nk, span, dh)

        def vals_of(old, w):
            x = old.scatter(3, idx, w.to(old.dtype))
            x = x.reshape(L, S, nk, T, bs, dh).permute(0, 1, 3, 2, 4, 5)
            return x.reshape(L, S * T, nk, bs, dh)

        return self.scatter_values(pkv, ids.reshape(-1), vals_of(old_k, wk),
                                   vals_of(old_v, wv))

    def commit_rows(self, pkv: PagedKV, rows: torch.Tensor,
                    dk: torch.Tensor, dv: torch.Tensor, pos0: torch.Tensor,
                    span: int, lane_mask: torch.Tensor) -> PagedKV:
        """Scatter the blocks dense views ``dk``/``dv [L, S', n_kv,
        max_len, dh]`` wrote in ``[pos0, pos0 + span)`` back into the pool
        through ``rows [S', M]`` (requantized on an int8 pool; the JAX
        ``_Paged._commit``, and through ``pkv.table`` its
        ``commit_slots``).  Masked lanes and blocks below ``pos0``'s are
        never written, so shared prefix blocks stay as they are."""
        bs, B = self.cfg.block_size, self.cfg.num_blocks
        M, T = self.blocks_per_slot, self.touch_count(span)
        L, nk, dh = self.n_layers, self.n_kv, self.dh
        n = rows.shape[0]
        dev = dk.device
        pos0 = pos0.long()
        t0 = torch.div(pos0, bs, rounding_mode="floor")
        start = t0.clamp(0, M - T)
        logical = start[:, None] + torch.arange(T, device=dev)[None]
        ids = torch.gather(rows.long(), 1, logical.clamp(max=M - 1))
        live = (logical >= t0[:, None]) & (logical < M) & lane_mask[:, None]
        ids = torch.where(live, ids, torch.full_like(ids, B))
        cols = (start[:, None] * bs
                + torch.arange(T * bs, device=dev)[None])       # [S', T*bs]
        idx = cols[None, :, None, :, None].expand(L, n, nk, T * bs, dh)

        def vals_of(dense):
            x = dense.gather(3, idx).reshape(L, n, nk, T, bs, dh)
            return x.permute(0, 1, 3, 2, 4, 5).reshape(L, n * T, nk, bs, dh)

        return self.scatter_values(pkv, ids.reshape(-1), vals_of(dk),
                                   vals_of(dv))

    def commit_lanes(self, pkv: PagedKV, dk: torch.Tensor, dv: torch.Tensor,
                     rows: torch.Tensor, dsts: torch.Tensor,
                     pos0: torch.Tensor, span: int,
                     cursor: torch.Tensor) -> PagedKV:
        """Commit lanes' dense views after a prefill wrote ``[pos0,
        pos0 + span)``: each lane's blocks through its OWN row, then install
        the rows and ``cursor`` at ``dsts`` (sentinel ``num_slots`` = an
        unused lane, dropped)."""
        keep = dsts < self.num_slots
        pkv = self.commit_rows(pkv, rows, dk, dv, pos0, span, keep)
        d = dsts[keep].long()
        pkv.table[d] = rows[keep].to(torch.int32)
        pkv.cursor[d] = cursor[keep].to(torch.int32)
        return pkv

    # -- KV handoff ---------------------------------------------------------

    def extract_lane(self, pkv: PagedKV, slot: int):
        """One slot's KV as a dense lane ``(k, v, cursor)``, ``k``/``v``
        ``[L, n_kv, max_len, dh]`` in the compute dtype (int8 dequantized;
        past the cursor the clamped gather's garbage, which every reader
        masks) — the export half of a KV handoff."""
        k, v = self.dense_kv(pkv, pkv.table[slot])
        return k, v, pkv.cursor[slot].clone()

    def adopt_lane(self, pkv: PagedKV, slot: int, row: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   cursor: torch.Tensor) -> PagedKV:
        """The import half: scatter a dense lane into the blocks of the
        (host-allocated) table ``row [M]`` (sentinel entries drop), install
        the row and ``cursor`` at ``slot``.  An int8 pool requantizes: in
        an f32 compute dtype that gives back the exported blocks' bytes; a
        bf16 view has rounded the products ``q * scale``, as in the JAX
        package, so its blocks can come back a step apart."""
        dev = pkv.table.device
        one = torch.ones(1, dtype=torch.int32, device=dev)
        return self.commit_lanes(
            pkv, k[:, None], v[:, None], row.reshape(1, -1).to(dev),
            one * int(slot), 0 * one, self.max_len,
            torch.as_tensor(cursor, device=dev).reshape(1))

    def extract_blocks(self, pkv: PagedKV, slot: int, n: int) -> PagedLane:
        """The first ``n`` blocks of ``slot``'s table row as stored
        (:class:`PagedLane`): the export half of a lane transfer."""
        ids = pkv.table[slot, :n].long()
        return PagedLane(pkv.pool_k[:, ids], pkv.pool_v[:, ids],
                         pkv.scale_k[:, ids], pkv.scale_v[:, ids],
                         pkv.cursor[slot].clone())

    def adopt_blocks(self, pkv: PagedKV, slot: int, row: torch.Tensor,
                     lane: PagedLane) -> PagedKV:
        """The import half: write the lane's ``n`` blocks at the first
        ``n`` ids of the (host-allocated) table ``row [M]`` (sentinel
        entries drop), install the row and the cursor at ``slot``."""
        dev = pkv.table.device
        row = row.reshape(-1).to(dev)
        self.commit_quantized(pkv, row[:lane.k.shape[1]],
                              *(t.to(dev) for t in lane[:4]))
        pkv.table[slot] = row.to(pkv.table.dtype)
        pkv.cursor[slot] = torch.as_tensor(lane.cursor).to(pkv.cursor)
        return pkv

    def write_tables(self, rows: torch.Tensor, pos0: torch.Tensor,
                     clen: torch.Tensor, span: int,
                     lane_mask: torch.Tensor) -> torch.Tensor:
        """The prefill kernel's write table ``[S, touch_count(span)]``:
        ids of the blocks each lane's chunk ``[pos0, pos0 + clen)`` covers,
        entry ``w`` = logical block ``pos0 // bs + w``, sentinel past the
        lane's span and on masked lanes."""
        bs, B = self.cfg.block_size, self.cfg.num_blocks
        M, T = self.blocks_per_slot, self.touch_count(span)
        pos0, clen = pos0.long(), clen.long()
        t0 = torch.div(pos0, bs, rounding_mode="floor")
        n_t = torch.where(
            clen > 0, torch.div(pos0 + clen - 1, bs, rounding_mode="floor")
            - t0 + 1, torch.zeros_like(clen))
        ar = torch.arange(T, device=rows.device)[None]
        logical = t0[:, None] + ar
        ids = torch.gather(rows.long(), 1, logical.clamp(max=M - 1))
        live = (ar < n_t[:, None]) & (logical < M) & lane_mask[:, None]
        return torch.where(live, ids, torch.full_like(ids, B)).to(torch.int32)

    def commit_quantized(self, pkv: PagedKV, ids: torch.Tensor, qk, qv, sk,
                         sv) -> PagedKV:
        """Adopt blocks already in storage form (``[L, N, n_kv, bs, dh]``,
        scales ``[L, N, n_kv]``, used only when quantized) at ``ids [N]``,
        sentinels dropped."""
        _set_rows(pkv.pool_k, ids, qk)
        _set_rows(pkv.pool_v, ids, qv)
        if self.cfg.quantized:
            _set_rows(pkv.scale_k, ids, sk)
            _set_rows(pkv.scale_v, ids, sv)
        return pkv

    # -- evict --------------------------------------------------------------

    def release(self, pkv: PagedKV, slot: int,
                free_ids: torch.Tensor) -> PagedKV:
        """Unmap ``slot`` (sentinel table row, cursor 0; ``slot ==
        num_slots`` skips the unmap) and zero the freed pool blocks
        ``free_ids`` (sentinel-padded) — a recycled block never carries a
        previous tenant's K/V."""
        B = self.cfg.num_blocks
        _set_rows(pkv.pool_k, free_ids, 0)
        _set_rows(pkv.pool_v, free_ids, 0)
        _set_rows(pkv.scale_k, free_ids, 1.0)
        _set_rows(pkv.scale_v, free_ids, 1.0)
        if 0 <= slot < self.num_slots:
            pkv.table[slot] = B
            pkv.cursor[slot] = 0
        return pkv

    # -- accounting ---------------------------------------------------------

    @property
    def block_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        return block_bytes(self.n_layers, self.n_kv, self.dh, itemsize,
                           self.cfg)

    @property
    def pool_bytes(self) -> int:
        return self.block_bytes * self.cfg.num_blocks

    @property
    def bytes_per_pos(self) -> float:
        return self.block_bytes / self.cfg.block_size


class PlacedKV(NamedTuple):
    """A paged pool split over ``model`` places by kv heads (the serving
    mesh, :mod:`tpudist_torch.serve.spmd`): ``pool_k``/``pool_v``/
    ``scale_k``/``scale_v`` hold one tensor a place, ``[L, num_blocks,
    n_kv/P, block_size, dh]`` and ``[L, num_blocks, n_kv/P]`` on the
    place's device; the block table and the cursors are the host's
    decisions and exist once, on the engine's device."""

    pool_k: Tuple[torch.Tensor, ...]
    pool_v: Tuple[torch.Tensor, ...]
    scale_k: Tuple[torch.Tensor, ...]
    scale_v: Tuple[torch.Tensor, ...]
    table: torch.Tensor
    cursor: torch.Tensor

    def place(self, m: int) -> PagedKV:
        """Place ``m``'s pool as a :class:`PagedKV` (the table and cursors
        on its device)."""
        dev = self.pool_k[m].device
        return PagedKV(self.pool_k[m], self.pool_v[m], self.scale_k[m],
                       self.scale_v[m], self.table.to(dev),
                       self.cursor.to(dev))


class _PlacedPaged:
    """The machinery of :class:`_Paged` over a :class:`PlacedKV`: one
    :class:`_Paged` a place over its ``n_kv/P`` heads.  Each per-place
    view or buffer is a list, one tensor a place; the table and cursors
    are written once.  The geometry and byte counts are the whole pool's,
    which the split only divides."""

    def __init__(self, model, num_slots: int, cfg: PagedKVConfig,
                 devices: Sequence, device):
        P = len(devices)
        if model.n_kv % P:
            raise ValueError(f"{model.n_kv} kv heads do not split over "
                             f"{P} places")
        self.places = [_Paged(model, num_slots, cfg, dev,
                              n_kv=model.n_kv // P) for dev in devices]
        self.whole = _Paged(model, num_slots, cfg, device)
        for name in ("cfg", "num_slots", "n_layers", "n_kv", "dh",
                     "max_len", "compute_dtype", "device",
                     "blocks_per_slot", "storage_dtype"):
            setattr(self, name, getattr(self.whole, name))

    def init(self) -> PlacedKV:
        pools = [pg.init() for pg in self.places]
        return PlacedKV(
            *(tuple(getattr(p, f) for p in pools)
              for f in ("pool_k", "pool_v", "scale_k", "scale_v")),
            table=torch.full((self.num_slots, self.blocks_per_slot),
                             self.cfg.num_blocks, dtype=torch.int32,
                             device=self.device),
            cursor=torch.zeros(self.num_slots, dtype=torch.int32,
                               device=self.device))

    def _each(self, pkv: PlacedKV):
        return [(pg, pkv.place(m), pg.device)
                for m, pg in enumerate(self.places)]

    def dense_kv(self, pkv: PlacedKV, rows: torch.Tensor):
        """Each place's dense K/V views through ``rows`` (:meth:`_Paged.
        dense_kv`): ``(ks, vs)``, lists."""
        views = [pg.dense_kv(p, rows.to(dev)) for pg, p, dev
                 in self._each(pkv)]
        return [k for k, _ in views], [v for _, v in views]

    def window_view(self, span: int):
        views = [pg.window_view(span) for pg in self.places]
        return [k for k, _ in views], [v for _, v in views]

    def commit_window(self, pkv: PlacedKV, wk: List[torch.Tensor],
                      wv: List[torch.Tensor], pos0, span: int,
                      lane_mask) -> PlacedKV:
        for (pg, p, dev), k, v in zip(self._each(pkv), wk, wv):
            pg.commit_window(p, k, v, pos0.to(dev), span,
                             lane_mask.to(dev))
        return pkv

    def commit_rows(self, pkv: PlacedKV, rows, dk: List[torch.Tensor],
                    dv: List[torch.Tensor], pos0, span: int,
                    lane_mask) -> PlacedKV:
        for (pg, p, dev), k, v in zip(self._each(pkv), dk, dv):
            pg.commit_rows(p, rows.to(dev), k, v, pos0.to(dev), span,
                           lane_mask.to(dev))
        return pkv

    def commit_lanes(self, pkv: PlacedKV, dk, dv, rows, dsts, pos0,
                     span: int, cursor) -> PlacedKV:
        keep = dsts < self.num_slots
        self.commit_rows(pkv, rows, dk, dv, pos0, span, keep)
        d = dsts[keep].long()
        pkv.table[d] = rows[keep].to(torch.int32)
        pkv.cursor[d] = cursor[keep].to(torch.int32)
        return pkv

    def commit_quantized(self, pkv: PlacedKV, ids, parts) -> PlacedKV:
        """``parts[m] = (qk, qv, sk, sv)``: place ``m``'s blocks in storage
        form (:meth:`_Paged.commit_quantized`)."""
        for (pg, p, dev), part in zip(self._each(pkv), parts):
            pg.commit_quantized(p, ids.to(dev), *part)
        return pkv

    def write_tables(self, rows, pos0, clen, span: int, lane_mask):
        return self.whole.write_tables(rows, pos0, clen, span, lane_mask)

    def touch_count(self, span: int) -> int:
        return self.whole.touch_count(span)

    def extract_lane(self, pkv: PlacedKV, slot: int):
        """The whole lane ``(k, v, cursor)`` (:meth:`_Paged.extract_lane`):
        the places' heads put back together, on the engine's device."""
        ks, vs = self.dense_kv(pkv, pkv.table[slot])
        return (torch.cat([k.to(self.device) for k in ks], 1),
                torch.cat([v.to(self.device) for v in vs], 1),
                pkv.cursor[slot].clone())

    def adopt_lane(self, pkv: PlacedKV, slot: int, row: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, cursor) -> PlacedKV:
        """Scatter a whole lane into ``row``'s blocks, each place its kv
        heads (:meth:`_Paged.adopt_lane`)."""
        hk = self.places[0].n_kv
        for m, (pg, p, dev) in enumerate(self._each(pkv)):
            heads = slice(m * hk, (m + 1) * hk)
            pg.adopt_lane(p, slot, row.to(dev), k[:, heads].to(dev),
                          v[:, heads].to(dev), cursor)
        pkv.table[slot] = row.reshape(-1).to(pkv.table)
        pkv.cursor[slot] = torch.as_tensor(cursor).to(pkv.cursor)
        return pkv

    def extract_blocks(self, pkv: PlacedKV, slot: int, n: int) -> PagedLane:
        """The whole lane's first ``n`` blocks as stored
        (:meth:`_Paged.extract_blocks`): the places' heads put back
        together, on the engine's device."""
        parts = [pg.extract_blocks(p, slot, n) for pg, p, _ in
                 self._each(pkv)]
        return PagedLane(*(torch.cat([q[i].to(self.device) for q in parts],
                                     2) for i in range(4)),
                         pkv.cursor[slot].clone())

    def adopt_blocks(self, pkv: PlacedKV, slot: int, row: torch.Tensor,
                     lane: PagedLane) -> PlacedKV:
        """Write a whole lane's blocks into ``row``'s, each place its kv
        heads (:meth:`_Paged.adopt_blocks`)."""
        hk = self.places[0].n_kv
        for m, (pg, p, dev) in enumerate(self._each(pkv)):
            heads = slice(m * hk, (m + 1) * hk)
            pg.adopt_blocks(p, slot, row.to(dev), PagedLane(
                *(t[:, :, heads] for t in lane[:4]), lane.cursor))
        pkv.table[slot] = row.reshape(-1).to(pkv.table)
        pkv.cursor[slot] = torch.as_tensor(lane.cursor).to(pkv.cursor)
        return pkv

    def release(self, pkv: PlacedKV, slot: int,
                free_ids: torch.Tensor) -> PlacedKV:
        for pg, p, dev in self._each(pkv):
            pg.release(p, self.num_slots, free_ids.to(dev))
        if 0 <= slot < self.num_slots:
            pkv.table[slot] = self.cfg.num_blocks
            pkv.cursor[slot] = 0
        return pkv

    @property
    def block_bytes(self) -> int:
        return sum(pg.block_bytes for pg in self.places)

    @property
    def pool_bytes(self) -> int:
        return self.block_bytes * self.cfg.num_blocks

    @property
    def bytes_per_pos(self) -> float:
        return self.block_bytes / self.cfg.block_size
