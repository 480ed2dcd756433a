"""Slot-decode programs of the serving engine — the paged-kernel subset of
:func:`tpudist.models.generate.make_slot_decode`, in PyTorch.

``num_slots`` KV lanes over one paged pool plus a per-slot
:class:`SlotState` on the device.  Every program runs fixed-shape over all
slots: idle lanes compute too, and the ``active`` mask keeps them from
advancing or writing.  The attention arms are the paged decode kernel (a
K-step decode block with in-loop token feedback, its tokens held in window
buffers and committed once per block) and the paged prefill kernel (one
batched call per admission batch; a chunk extend runs the same program
with a one-hot batch).  With ``fused_rope`` the QKV projection and the
rotation run as one kernel; with ``adapters`` every forward reads each
lane's LoRA factors from the adapter pool through its ``SlotState.
adapter_id``.  Sampling goes through the fused sampling kernel:
greedy arg-max where ``temp <= 0``, else a categorical draw from a
per-request stream keyed by ``(seed, count)`` — independent of the slot,
the neighbours and the block size.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpudist_torch.models.lora import (AdapterPool, AdapterPoolConfig,
                                      pool_collection)
from tpudist_torch.models.paged import PagedKV, PagedKVConfig, _Paged
from tpudist_torch.models.transformer import PagedDecode, PagedPrefill
from tpudist_torch.ops import fused_sample_prep

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, b: int):
    """32 x 32 → 64-bit product of ``a`` (int64 holding uint32) and the
    constant ``b``, as ``(lo, hi)`` words, without int64 overflow."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    mid = p0 + ((p1 & 0xFFFF) << 16)
    return mid & _MASK32, ((p1 >> 16) + (mid >> 32)) & _MASK32


def philox_uniform(seeds: torch.Tensor, counts: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``[S, n]`` uniforms in (0, 1) from Philox4x32-10 keyed by each
    lane's ``seed``, at counter ``(i, count)`` — one reproducible stream
    per request, the same bits on every device."""
    S = seeds.shape[0]
    dev = seeds.device
    nblk = -(-n // 4)
    seeds = seeds.long()[:, None]
    counts = counts.long()[:, None]
    k0, k1 = seeds & _MASK32, (seeds >> 32) & _MASK32
    c0 = torch.arange(nblk, device=dev, dtype=torch.int64)[None].expand(
        S, nblk)
    c1 = (counts & _MASK32).expand(S, nblk)
    c2 = ((counts >> 32) & _MASK32).expand(S, nblk)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        lo0, hi0 = _mulhilo(c0, _PHILOX_M[0])
        lo1, hi1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    x = torch.stack([c0, c1, c2, c3], dim=-1).reshape(S, nblk * 4)[:, :n]
    return ((x >> 8).float() + 0.5) * (2.0 ** -24)


def sample_tail(logits: torch.Tensor, seeds: torch.Tensor,
                temps: torch.Tensor, counts: torch.Tensor,
                sampled: Optional[bool] = None) -> torch.Tensor:
    """Per-slot next tokens ``[S]`` int32 from ``logits [S, V]`` f32: the
    fused kernel's greedy arg-max where ``temps <= 0``, else the Gumbel-max
    draw ``argmax(scaled + g)`` with ``g`` from :func:`philox_uniform`.
    ``sampled=False`` promises no lane has ``temp > 0`` (skips the noise);
    ``None`` checks."""
    _, scaled, greedy = fused_sample_prep(logits, temps)
    if sampled is None:
        sampled = bool((temps > 0).any())
    if not sampled:
        return greedy
    u = philox_uniform(seeds, counts, logits.shape[1])
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temps > 0, drawn.to(torch.int32), greedy)


class SlotState(NamedTuple):
    """Per-slot decode state on the device, each ``[num_slots]``:
    ``last_tok`` (the token the next step consumes), ``active`` (decoding),
    ``pos`` (filled positions), ``counts`` (tokens emitted — the sampling
    stream index), ``temps`` f32, ``seeds`` int64 and ``adapter_id`` int32
    — the lane's block in the adapter pool, the pool's ``num_blocks``
    sentinel for a base-only lane (zeros on an engine without adapters)."""

    last_tok: torch.Tensor
    active: torch.Tensor
    pos: torch.Tensor
    counts: torch.Tensor
    temps: torch.Tensor
    seeds: torch.Tensor
    adapter_id: torch.Tensor


class SlotDecode(NamedTuple):
    """The slot-decode programs (see :func:`make_slot_decode`)."""

    num_slots: int
    prefill_pad: int
    init_state: Callable
    init_slots: Callable
    insert_batch: Callable
    prefill_extend: Callable
    decode_block: Callable
    evict: Callable
    prefill_chunk: Callable
    paged: _Paged


def make_slot_decode(model, num_slots: int, prefill_pad: int,
                     paged: PagedKVConfig, *, attn_kernel: str = "paged",
                     prefill_kernel: bool = True,
                     sample_kernel: bool = True, fused_rope: bool = False,
                     lora_kernel: bool = False,
                     adapters: Optional[AdapterPoolConfig] = None
                     ) -> SlotDecode:
    """Build the slot programs over ``model`` (a
    :class:`~tpudist_torch.models.TransformerLM` on its serving device):

    - ``init_state()`` / ``init_slots()`` — zero state / empty pool;
    - ``insert_batch(state, pkv, tables [S, M], poss [S], prompts [S, pad],
      clens [S], dsts [S], seeds [S], temps [S], last [S], sampled=None,
      aids=None, apool=None)`` → ``(state, pkv, firsts [S])``: prefill lane
      ``j``'s chunk at ``poss[j]`` through its table row (with adapter
      block ``aids[j]``), install it in slot ``dsts[j]`` (``num_slots`` =
      unused lane), and where ``last[j]`` sample the first token and arm
      the slot;
    - ``prefill_extend(state, pkv, slot, chunk [pad], clen, is_last,
      sampled=None, apool=None)`` → ``(state, pkv, first)``: append one
      prompt chunk at the slot's cursor (the batched prefill with a one-hot
      batch);
    - ``decode_block(state, pkv, k, sampled=None, apool=None)`` →
      ``(state, pkv, toks [k, S])``: ``k`` decode steps with in-loop token
      feedback;
    - ``evict(state, pkv, slot, free_ids [M])`` — free a lane, zero the
      blocks whose refcount hit zero, reset its adapter to the sentinel;
    - ``prefill_chunk(pkv, rows, poss, clens, prompts, lane_mask,
      ads=None)`` → ``(pkv, logits [S, pad, V] f32)`` — the model-level
      prefill.

    ``fused_rope`` runs both arms' QKV projection and rotation through the
    fused RoPE+QKV kernel.  ``adapters`` (an :class:`~tpudist_torch.
    models.lora.AdapterPoolConfig`) turns on the per-tenant adapter seam:
    every forward program takes the pool (``apool``, an :class:`~
    tpudist_torch.models.lora.AdapterPool`) and reads each lane's factors
    from its ``SlotState.adapter_id`` through the LoRA gather-matmul
    kernel.  ``lora_kernel`` is validated as the JAX package validates it;
    the port always takes the pool form, so either value runs the same
    kernel path.  Only the kernel configuration is ported; other engine
    paths raise ``NotImplementedError``.  Pools update in place (see
    :mod:`tpudist_torch.models.paged`)."""
    if attn_kernel != "paged":
        raise NotImplementedError(
            f"attn_kernel={attn_kernel!r}: only the paged decode kernel is "
            "ported; the gather path waits for ROADMAP.md queue A item 5")
    if not prefill_kernel:
        raise NotImplementedError(
            "prefill_kernel=False: the teacher-forced gather prefill waits "
            "for ROADMAP.md queue A item 5")
    if not sample_kernel:
        raise NotImplementedError(
            "sample_kernel=False: the unfused sampling tail waits for "
            "ROADMAP.md queue A item 5")
    if lora_kernel and adapters is None:
        raise ValueError(
            "lora_kernel=True is the in-kernel adapter gather-matmul — "
            "it requires the adapter seam (pass adapters=...)")
    if num_slots < 1:
        raise ValueError(f"num_slots must be >= 1, got {num_slots}")
    if not 1 <= prefill_pad <= model.max_len:
        raise ValueError(f"prefill_pad {prefill_pad} must be in "
                         f"[1, {model.max_len}]")
    device = model.tok_embed.device
    pg = _Paged(model, num_slots, paged, device)
    S = num_slots
    lanes = torch.arange(S, device=device)
    #: the sentinel adapter id = base-only (also what evict resets to)
    aid_empty = int(adapters.num_blocks) if adapters is not None else 0

    def _ads(apool: Optional[AdapterPool], ids):
        if adapters is None:
            return None
        if apool is None:
            raise ValueError("an adapter engine's programs take the adapter "
                             "pool (apool=...)")
        return pool_collection(apool, ids)

    def init_state() -> SlotState:
        z = torch.zeros(S, dtype=torch.int32, device=device)
        return SlotState(last_tok=z.clone(),
                         active=torch.zeros(S, dtype=torch.bool,
                                            device=device),
                         pos=z.clone(), counts=z.clone(),
                         temps=torch.zeros(S, device=device),
                         seeds=torch.zeros(S, dtype=torch.int64,
                                           device=device),
                         adapter_id=torch.full((S,), aid_empty,
                                               dtype=torch.int32,
                                               device=device))

    def _pool(pkv: PagedKV, table, pos0) -> dict:
        return dict(pool_k=pkv.pool_k, pool_v=pkv.pool_v,
                    scale_k=pkv.scale_k, scale_v=pkv.scale_v,
                    table=table.to(torch.int32).contiguous(),
                    pos0=pos0.to(torch.int32).contiguous())

    @torch.no_grad()
    def prefill_chunk(pkv, rows, poss, clens, prompts, lane_mask, ads=None):
        wtables = pg.write_tables(rows, poss, clens, prefill_pad, lane_mask)
        pool = _pool(pkv, rows, poss)
        pool.update(clen=clens.to(torch.int32).contiguous(),
                    wtable=wtables.contiguous())
        ctx = PagedPrefill(pool, model.rope, model.sliding_window,
                           fused_rope=fused_rope, adapters=ads)
        logits = model(prompts, ctx).float()
        n = wtables.numel()

        def flat(i):
            t = torch.stack([w[i] for w in ctx.writes])  # [L, S, Mw, ...]
            return t.reshape((t.shape[0], n) + t.shape[3:])

        pg.commit_quantized(pkv, wtables.reshape(n), flat(0), flat(1),
                            flat(2), flat(3))
        return pkv, logits

    def _last(logits, clens):
        idx = (clens.long() - 1).clamp(0, logits.shape[1] - 1)
        return logits[lanes, idx]

    @torch.no_grad()
    def insert_batch(state, pkv, tables, poss, prompts, clens, dsts, seeds,
                     temps, last, sampled=None, aids=None, apool=None):
        keep = dsts < S
        if aids is None:
            aids = torch.full((S,), aid_empty, dtype=torch.int32,
                              device=device)
        pkv, logits = prefill_chunk(pkv, tables, poss, clens, prompts, keep,
                                    _ads(apool, aids))
        new_cur = (poss + clens).to(torch.int32)
        zero = torch.zeros(S, dtype=torch.int32, device=device)
        firsts = sample_tail(_last(logits, clens), seeds, temps, zero,
                             sampled)
        d = dsts[keep].long()
        pkv.table[d] = tables[keep].to(torch.int32)
        pkv.cursor[d] = new_cur[keep]
        state.last_tok[d] = torch.where(last, firsts, zero)[keep]
        state.active[d] = last[keep]
        state.pos[d] = new_cur[keep]
        state.counts[d] = last.to(torch.int32)[keep]
        state.temps[d] = temps[keep].float()
        state.seeds[d] = seeds[keep].long()
        state.adapter_id[d] = aids[keep].to(torch.int32)
        return state, pkv, firsts

    @torch.no_grad()
    def prefill_extend(state, pkv, slot: int, chunk, clen: int,
                       is_last: bool, sampled=None, apool=None):
        onehot = lanes == slot
        poss = pkv.cursor.clone()
        prompts = torch.zeros((S, prefill_pad), dtype=torch.int32,
                              device=device)
        prompts[slot] = chunk.to(torch.int32)
        clens = torch.where(onehot, int(clen), 0).to(torch.int32)
        pkv, logits = prefill_chunk(pkv, pkv.table, poss, clens, prompts,
                                    onehot, _ads(apool, state.adapter_id))
        pkv.cursor[slot] += int(clen)
        row = logits[slot, max(0, min(int(clen), prefill_pad) - 1)][None]
        first = sample_tail(row, state.seeds[slot:slot + 1],
                            state.temps[slot:slot + 1],
                            torch.zeros(1, dtype=torch.int32, device=device),
                            sampled)[0]
        state.pos[slot] += int(clen)
        state.active[slot] = bool(is_last)
        state.last_tok[slot] = first if is_last else 0
        state.counts[slot] = int(bool(is_last))
        return state, pkv, first

    @torch.no_grad()
    def decode_block(state, pkv, k: int, sampled=None, apool=None):
        ads = _ads(apool, state.adapter_id)
        pos0 = pkv.cursor.clone()
        active = state.active.clone()
        inc = active.to(torch.int32)
        wk, wv = pg.window_view(k)
        pool = _pool(pkv, pkv.table, pos0)
        cursor = pos0.clone()
        last_tok, counts, pos = state.last_tok, state.counts, state.pos
        if sampled is None:
            sampled = bool((state.temps > 0).any())
        toks_all = []
        for _ in range(k):
            ctx = PagedDecode(pool, wk, wv, cursor, active, model.rope,
                              model.sliding_window, fused_rope=fused_rope,
                              adapters=ads)
            logits = model(last_tok[:, None], ctx)[:, -1].float()
            toks = sample_tail(logits, state.seeds, state.temps, counts,
                               sampled)
            last_tok = torch.where(active, toks, last_tok)
            counts = counts + inc
            pos = pos + inc
            cursor = cursor + inc
            toks_all.append(last_tok)
        pg.commit_window(pkv, wk, wv, pos0, k, active)
        pkv.cursor.copy_(cursor)
        state.last_tok.copy_(last_tok)
        state.counts.copy_(counts)
        state.pos.copy_(pos)
        return state, pkv, torch.stack(toks_all)

    @torch.no_grad()
    def evict(state, pkv, slot: int, free_ids):
        pg.release(pkv, slot, free_ids)
        for leaf in state:
            leaf[slot] = 0
        state.adapter_id[slot] = aid_empty
        return state, pkv

    return SlotDecode(num_slots=S, prefill_pad=prefill_pad,
                      init_state=init_state, init_slots=pg.init,
                      insert_batch=insert_batch,
                      prefill_extend=prefill_extend,
                      decode_block=decode_block, evict=evict,
                      prefill_chunk=prefill_chunk, paged=pg)
