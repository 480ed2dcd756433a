"""Decoding — the counterpart of :mod:`tpudist.models.generate`: the
sequential dense-cache :func:`generate` (the LM entry point's
``--generate``), and the slot-decode programs of the serving engine, the
paged-kernel subset of :func:`tpudist.models.generate.make_slot_decode`.

:func:`generate` runs the model one token at a time over a dense KV cache
(:class:`~tpudist_torch.models.transformer.DenseDecode`), teacher-forcing
the prompt and then sampling with :func:`sample_logits` (greedy arg-max at
temperature 0; else top-k/top-p filtered draws from an explicit
``torch.Generator``).  Like the JAX dense path it runs no kernel.  The slot
engine's own gather and dense paths stay unported (ROADMAP queue A, item
A5).

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

Speculative decoding (``spec=`` a draft :class:`~tpudist_torch.models.
TransformerLM`, usually :func:`~tpudist_torch.models.tied_draft`) adds the
JAX package's draft programs beside these: the draft keeps its own
unquantized pool at the target pool's block geometry (same block ids, so
the host allocator, prefix reuse and evict free-lists are shared) in cursor
lockstep with the target; ``draft_propose`` runs ``K + 1`` draft decode
steps with in-loop token feedback, and ``spec_verify`` scores the whole
``[last, d_1..d_K]`` window in ONE target pass through the paged decode
kernel (``s = K + 1`` queries a lane), accepts the leading prefix
(:func:`spec_accept`, the residual prep kernel for sampled lanes), commits
the window and rolls both cursors back to ``pos0 + emitted``.  Rejected K/V
past a cursor is masked garbage that the next window overwrites.  The JAX
package runs its draft on the dense gather view; the port has no gather
path, so the draft runs on the target's kernel arms (paged prefill, paged
decode, fused RoPE+QKV and the LoRA kernel when on), and a plain block is
teacher-forced through the draft in one ``s = K`` window pass.  That moves
only the draft's rounding, never the output: the target verify is the
oracle.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from tpudist_torch.models.lora import (AdapterPool, AdapterPoolConfig,
                                      pool_collection)
from tpudist_torch.models.paged import PagedKV, PagedKVConfig, _Paged
from tpudist_torch.models.transformer import (CacheFullError, DenseDecode,
                                              PagedDecode, PagedPrefill)
from tpudist_torch.ops import fused_residual_prep, fused_sample_prep

def filter_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """``logits [batch, vocab]`` (f32) scaled by ``1 / temperature`` and
    filtered as the JAX ``sample_logits`` does before its draw: ``top_k``
    keeps the logits at least the k-th largest, then ``top_p`` keeps the
    smallest prefix of the sorted vocabulary whose mass reaches ``top_p``
    (the first token crossing it, and the top token, always stay); ties
    with a cutoff survive.  Masked entries are f32's lowest value."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    logits = logits / temperature
    neg = torch.finfo(logits.dtype).min
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, neg),
                             logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        keep = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                         dim=-1) < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, math.inf)).min(
            dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, torch.full_like(logits, neg),
                             logits)
    return logits


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator]
                  = None, *, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Token ids ``[batch]`` from ``logits [batch, vocab]`` (f32):
    ``temperature == 0`` is the greedy arg-max (filters ignored), else a
    categorical draw from ``generator`` over :func:`filter_logits`."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature=temperature,
                                        top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, prompt: torch.Tensor, max_new: int, *,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[batch, plen + max_new]`` tokens: ``prompt [batch, plen]`` fed one
    token at a time through the dense KV cache, then ``max_new`` tokens
    drawn by :func:`sample_logits` (the JAX ``generate``'s sequence,
    prompt included).  ``generator`` seeds the draws; greedy decoding needs
    none.  Raises ``ValueError`` when ``plen + max_new`` exceeds the
    model's ``max_len`` (the cache's size)."""
    batch, plen = prompt.shape
    if plen + max_new > model.max_len:
        raise ValueError(
            f"prompt {plen} + max_new {max_new} exceeds the model's max_len "
            f"{model.max_len} (the KV-cache size)")
    ctx = DenseDecode(model, batch, prompt.device)
    out = [prompt[:, :1]]
    tok = prompt[:, :1]
    for i in range(plen + max_new - 1):
        logits = model(tok, ctx)[:, -1].float()
        ctx.pos += tok.shape[1]
        if i + 1 < plen:
            nxt = prompt[:, i + 1]
        else:
            nxt = sample_logits(logits, generator, temperature=temperature,
                                top_k=top_k, top_p=top_p).to(prompt.dtype)
        tok = nxt[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


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
                   n: int, stream: int = 0) -> torch.Tensor:
    """``[S, n]`` uniforms in (0, 1) from Philox4x32-10 keyed by each
    lane's ``seed``, at counter ``(i, count, stream)`` — one reproducible
    stream per request, the same bits on every device.  ``stream`` picks a
    substream (the JAX package's ``fold_in(fold_in(key, count), j)``): 0
    the plain draws, 1 the draft's proposals, 2 the acceptance uniforms, 3
    the residual draws of speculative decoding."""
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
    c3 = torch.full_like(c0, int(stream) & _MASK32)
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
                sampled: Optional[bool] = None, stream: int = 0,
                gpool=None, gidx: Optional[torch.Tensor] = None,
                gstate: Optional[torch.Tensor] = None):
    """Per-slot next tokens from ``logits [S, V]`` f32 — the JAX
    ``_sample_tail``: the fused kernel masks each row by its grammar row
    (``gpool = (gallow [G+1, S_max, V] bool, gnext)`` at ``gidx`` /
    ``gstate [S]`` int32; ``None`` = no grammar seam) and takes the greedy
    arg-max of the masked row where ``temps <= 0``; elsewhere the
    Gumbel-max draw ``argmax(scaled + g)`` runs on the kernel's ``scaled``
    (the masked row over the temperature), ``g`` from
    :func:`philox_uniform` on substream ``stream``, so a forbidden token is
    neither pick.  ``sampled=False`` promises no lane has ``temp > 0``
    (skips the noise); ``None`` checks.  Returns ``(toks [S] int32, masked
    [S, V] f32)``; ``masked`` feeds :func:`top_logprobs`."""
    if gpool is None:
        masked, scaled, greedy = fused_sample_prep(logits, temps)
    else:
        masked, scaled, greedy = fused_sample_prep(logits, temps, gpool[0],
                                                   gidx, gstate)
    if sampled is None:
        sampled = bool((temps > 0).any())
    if not sampled:
        return greedy, masked
    u = philox_uniform(seeds, counts, logits.shape[1], stream)
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temps > 0, drawn.to(torch.int32), greedy), masked


def grammar_advance(gpool, gidx: torch.Tensor, gstate: torch.Tensor,
                    toks: torch.Tensor, moved: torch.Tensor) -> torch.Tensor:
    """The automaton advance over one emitted token a lane — the JAX
    ``_gadvance``: ``gnext[gidx, gstate, tok]`` where ``moved``, else the
    old state (the tables self-loop on forbidden tokens, so even a
    defensive gather stays inside the automaton).  ``gpool`` None (no
    grammar seam) leaves ``gstate`` as it is."""
    if gpool is None:
        return gstate
    nxt = gpool[1][gidx, gstate, toks]
    return torch.where(moved, nxt, gstate)


def top_logprobs(masked: torch.Tensor, n: int):
    """Top-``n`` ``(ids int32, logprobs f32)`` over the last axis of the
    POST-MASK ``log_softmax`` — the JAX ``_top_lp`` (``lax.top_k``: the
    lower id first among equal values, which a stable descending sort
    keeps)."""
    lp = torch.log_softmax(masked, dim=-1)
    vals, ids = torch.sort(lp, dim=-1, descending=True, stable=True)
    return ids[..., :n].to(torch.int32), vals[..., :n].contiguous()


class SlotState(NamedTuple):
    """Per-slot decode state on the device, each ``[num_slots]``:
    ``last_tok`` (the token the next step consumes), ``active`` (decoding),
    ``pos`` (filled positions), ``counts`` (tokens emitted — the sampling
    stream index), ``temps`` f32, ``seeds`` int64 and ``adapter_id`` int32
    — the lane's block in the adapter pool, the pool's ``num_blocks``
    sentinel for a base-only lane (zeros on an engine without adapters).
    ``gidx`` / ``gstate`` int32 are the lane's block in the grammar pool
    and its automaton state: the pool's ``num_blocks`` sentinel (its
    all-True row keeps a free lane's logits bit for bit) and 0 for an
    unconstrained lane, zeros on an engine without ``constrain``.  The JAX
    state's per-lane ``accepted`` / ``drafted`` tallies have no reader; the
    engine counts acceptance from ``spec_verify``'s packed fetch."""

    last_tok: torch.Tensor
    active: torch.Tensor
    pos: torch.Tensor
    counts: torch.Tensor
    temps: torch.Tensor
    seeds: torch.Tensor
    adapter_id: torch.Tensor
    gidx: torch.Tensor
    gstate: torch.Tensor


def spec_accept(state: SlotState, logits: torch.Tensor,
                drafts: torch.Tensor, dlogits: torch.Tensor,
                spec_on: torch.Tensor, rem: torch.Tensor,
                sampled: Optional[bool] = None,
                tok_ok: Optional[torch.Tensor] = None):
    """Leading-prefix acceptance over a verify window, the correction /
    bonus token and the per-lane budget clamp — the JAX ``_accept``.

    ``logits [S, k+1, V]`` f32: row ``i`` scores the token after ``[last,
    d_1..d_i]``; ``drafts [k, S]``, ``dlogits [k, S, V]`` the draft's
    proposals and logits; ``spec_on [S]`` bool, ``rem [S]`` each lane's
    remaining budget.  Greedy lanes accept while the draft equals the
    target's arg-max (from the fused sampling kernel), so their stream is the
    sequential decode's.  Sampled lanes accept ``d`` iff ``u · pd(d) <=
    pt(d)`` and on a rejection draw from ``max(pt - pd, 0)`` (the residual
    prep kernel); ``u`` is substream 2 and the residual draw substream 3 of
    :func:`philox_uniform` at that token's count.  A row with no pending
    draft — the bonus row, or row 0 of a spec-off lane — draws on substream
    0 through :func:`sample_tail`, as the non-speculative engine does at the
    same count.  The emitted count is clamped to ``rem``; a clamped lane's
    last token is its last accepted draft.

    On a constrained engine ``logits`` are the verify rows masked along
    each lane's automaton trajectory (:func:`spec_verify`'s), and ``tok_ok
    [S, k]`` marks the drafts the grammar allows: a forbidden draft is
    rejected outright (``acc &= tok_ok``), whatever ``u`` says — its
    masked target probability is tiny, not zero.

    Returns ``(x, a_raw, inc, out)``: the last emitted token ``[S]``, the
    unclamped accept count, the emitted count (0 on inactive lanes) and the
    emitted tokens ``[S, k+1]`` (zero past ``inc``)."""
    S, k1, V = logits.shape
    k = k1 - 1
    dev = logits.device
    active = state.active
    greedy = state.temps <= 0
    if sampled is None:
        sampled = bool((state.temps > 0).any())
    d = drafts.t().long()                                    # [S, k]
    ar = torch.arange(k1, device=dev)
    call = state.counts.long()[:, None] + ar[None]           # [S, k+1]

    def per_row(t, n):
        return t[:, None].expand(S, n).reshape(-1)

    # the arg-max rows of greedy lanes and the plain draws of sampled ones
    rows = sample_tail(logits.reshape(S * k1, V), per_row(state.seeds, k1),
                       per_row(state.temps, k1), call.reshape(-1),
                       sampled)[0].reshape(S, k1).long()
    pt, pd, res_logits = fused_residual_prep(
        logits[:, :k].contiguous(), dlogits.transpose(0, 1).contiguous(),
        state.temps)
    acc = d == rows[:, :k]
    res_rows = torch.zeros_like(d)
    if sampled:
        seeds_k = per_row(state.seeds, k)
        cidx = call[:, :k].reshape(-1)
        u = philox_uniform(seeds_k, cidx, 1, stream=2).reshape(S, k)
        pt_d = pt.gather(-1, d[..., None])[..., 0]
        pd_d = pd.gather(-1, d[..., None])[..., 0]
        acc = torch.where(greedy[:, None], acc, u * pd_d <= pt_d)
        g = torch.log(-torch.log(philox_uniform(seeds_k, cidx, V, stream=3)))
        res_rows = torch.argmax(res_logits.reshape(S * k, V) - g,
                                dim=-1).reshape(S, k)
    if tok_ok is not None:
        acc = acc & tok_ok
    acc = acc & (spec_on & active)[:, None]
    a_raw = torch.cumprod(acc.long(), dim=1).sum(1)
    a = torch.minimum(a_raw, torch.clamp(rem.long() - 1, min=0))
    row_p = rows.gather(1, a[:, None])[:, 0]
    row_r = torch.cat([res_rows, rows[:, -1:]], 1).gather(1, a[:, None])[:, 0]
    # row a rejected a pending draft: residual draw; row k (or a spec-off
    # lane's row 0) has no pending draft: the plain draw
    specced = spec_on & active & (a < k) & ~greedy
    x = torch.where(specced, row_r, row_p)
    clamp_d = d.gather(1, a.clamp(max=k - 1)[:, None])[:, 0]
    x = torch.where(a < a_raw, clamp_d, x)
    inc = torch.where(active, a + 1, torch.zeros_like(a))
    dpad = torch.cat([d, torch.zeros_like(d[:, :1])], 1)
    out = torch.where(ar[None] < a[:, None], dpad,
                      torch.where(ar[None] == a[:, None], x[:, None],
                                  torch.zeros_like(dpad)))
    out = torch.where(active[:, None], out, torch.zeros_like(out))
    return (x.to(torch.int32), a_raw.to(torch.int32), inc.to(torch.int32),
            out.to(torch.int32))


def _trajectory_mask(gpool, state: SlotState, logits: torch.Tensor,
                     drafts: torch.Tensor):
    """The verify rows masked along each lane's automaton trajectory — the
    grammar half of the JAX ``_accept``: row ``i`` of ``logits [S, k+1,
    V]`` at the state after ``d_1..d_i`` (row 0 at the lane's current
    state, so a spec-off lane's one token is right whatever its drafts
    are).  A forbidden draft holds the state.  Returns ``(masked, tok_ok
    [S, k])``."""
    gallow, gnext = gpool
    gidx = state.gidx.long()
    st = state.gstate.long()
    traj, oks = [st], []
    for dt in drafts.long():                                 # [S] a step
        ok = gallow[gidx, st, dt]
        st = torch.where(ok, gnext[gidx, st, dt].long(), st)
        traj.append(st)
        oks.append(ok)
    traj = torch.stack(traj, 1)                              # [S, k+1]
    allow = gallow[gidx[:, None], traj]                      # [S, k+1, V]
    masked = torch.where(allow, logits, torch.full_like(
        logits, torch.finfo(logits.dtype).min))
    return masked, torch.stack(oks, 1)


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
    # -- speculative decoding (``spec=``), else None: see make_slot_decode
    init_draft: Optional[Callable] = None
    draft_prefill: Optional[Callable] = None
    draft_extend: Optional[Callable] = None
    draft_evict: Optional[Callable] = None
    draft_arm: Optional[Callable] = None
    draft_track: Optional[Callable] = None
    draft_propose: Optional[Callable] = None
    spec_verify: Optional[Callable] = None
    draft_paged: Optional[_Paged] = None


def make_slot_decode(model, num_slots: int, prefill_pad: int,
                     paged: PagedKVConfig, *, attn_kernel: str = "paged",
                     prefill_kernel: bool = True,
                     sample_kernel: bool = True, fused_rope: bool = False,
                     lora_kernel: bool = False,
                     adapters: Optional[AdapterPoolConfig] = None,
                     spec=None, constrain=None,
                     logprobs: int = 0) -> SlotDecode:
    """Build the slot programs over ``model`` (a
    :class:`~tpudist_torch.models.TransformerLM` on its serving device):

    - ``init_state()`` / ``init_slots()`` — zero state / empty pool;
    - ``insert_batch(state, pkv, tables [S, M], poss [S], prompts [S, pad],
      clens [S], dsts [S], seeds [S], temps [S], last [S], sampled=None,
      aids=None, apool=None, gids=None, gpool=None)`` → ``(state, pkv,
      firsts [S])``: prefill lane ``j``'s chunk at ``poss[j]`` through its
      table row (with adapter block ``aids[j]``), install it in slot
      ``dsts[j]`` (``num_slots`` = unused lane) with grammar block
      ``gids[j]``, and where ``last[j]`` sample the first token and arm
      the slot;
    - ``prefill_extend(state, pkv, slot, chunk [pad], clen, is_last,
      sampled=None, apool=None, gpool=None)`` → ``(state, pkv, first)``:
      append one prompt chunk at the slot's cursor (the batched prefill
      with a one-hot batch);
    - ``decode_block(state, pkv, k, sampled=None, apool=None, gpool=None)``
      → ``(state, pkv, toks [k, S])``, plus ``(lp_ids [k, S, n], lp_vals
      [k, S, n])`` with ``logprobs = n > 0``: ``k`` decode steps with
      in-loop token feedback;
    - ``evict(state, pkv, slot, free_ids [M])`` — free a lane, zero the
      blocks whose refcount hit zero, reset its adapter and grammar to the
      sentinels;
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
    :mod:`tpudist_torch.models.paged`).

    ``constrain`` (a :class:`~tpudist_torch.constrain.ConstrainConfig`)
    turns on the structured-output seam: the programs that sample take the
    grammar pool ``gpool = (gallow [G+1, S_max, V] bool, gnext [G+1,
    S_max, V] int32)`` (block ``G`` the all-True sentinel), the sampling
    kernel masks each lane's row at its ``(gidx, gstate)`` before the pick,
    and ``gstate`` advances with every committed token
    (:func:`grammar_advance`).  ``logprobs = n`` makes ``decode_block`` and
    ``spec_verify`` also return the top-``n`` rows of the post-mask
    ``log_softmax`` at each emitted position (:func:`top_logprobs`);
    prefill-sampled first tokens carry none.

    ``spec`` (a draft :class:`~tpudist_torch.models.TransformerLM` on the
    same device, sharing ``vocab`` and ``max_len``) adds the speculative
    programs (module doc):

    - ``init_draft()`` — the empty draft pool (a :class:`PagedKV`);
    - ``draft_prefill(dkv, tables, poss, prompts, clens, dsts, aids=None,
      apool=None)`` and ``draft_extend(dkv, slot, chunk, clen, aids=None,
      apool=None)`` — the draft twins of ``insert_batch`` /
      ``prefill_extend``'s cache half (``aids [S]``: each lane's adapter
      block);
    - ``draft_evict(dkv, slot, free_ids)``;
    - ``draft_track(state, dkv, prev_last [S], toks [K, S], apool=None)`` —
      teacher-force a plain block's emitted tokens through the draft;
    - ``draft_propose(state, dkv, k, sampled=None, apool=None)`` → ``(dkv,
      drafts [k, S], dlogits [k, S, V])``;
    - ``spec_verify(state, pkv, dkv, drafts, dlogits, spec_on [S], rem [S],
      sampled=None, apool=None, gpool=None)`` → ``(state, pkv, dkv, packed
      [S, k+3])``, plus ``(lp_ids [S, k+1, n], lp_vals [S, k+1, n])`` with
      ``logprobs = n > 0``: column 0 the emitted count, 1 the unclamped
      accept count, 2.. the emitted tokens.  The draft proposes unmasked;
      the verify rows are masked along each lane's automaton trajectory
      over its drafts, a forbidden draft is a rejection, and ``gstate``
      advances over the emitted tokens only.

    The tied draft shares its lane's adapter (its blocks are the target's
    first layers, so they read the pool's first layer slices); a loaded
    draft of another projection geometry runs base-only."""
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
    n_lp = int(logprobs)
    if n_lp < 0:
        raise ValueError(f"logprobs must be >= 0, got {n_lp}")
    if not 1 <= prefill_pad <= model.max_len:
        raise ValueError(f"prefill_pad {prefill_pad} must be in "
                         f"[1, {model.max_len}]")
    device = model.tok_embed.device
    pg = _Paged(model, num_slots, paged, device)
    S = num_slots
    lanes = torch.arange(S, device=device)
    #: the sentinel adapter id = base-only (also what evict resets to)
    aid_empty = int(adapters.num_blocks) if adapters is not None else 0
    #: the sentinel grammar id = unconstrained (also what evict resets to)
    gid_empty = int(constrain.num_blocks) if constrain is not None else 0

    def _ads(apool: Optional[AdapterPool], ids):
        if adapters is None:
            return None
        if apool is None:
            raise ValueError("an adapter engine's programs take the adapter "
                             "pool (apool=...)")
        return pool_collection(apool, ids)

    def _gp(gpool):
        """The grammar pool a program samples through (None when the seam
        is off)."""
        if constrain is None:
            return None
        if gpool is None:
            raise ValueError("a constrained engine's programs take the "
                             "grammar pool (gpool=...)")
        return gpool

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
                                               device=device),
                         gidx=torch.full((S,), gid_empty, dtype=torch.int32,
                                         device=device),
                         gstate=z.clone())

    def _pool(pkv: PagedKV, table, pos0) -> dict:
        return dict(pool_k=pkv.pool_k, pool_v=pkv.pool_v,
                    scale_k=pkv.scale_k, scale_v=pkv.scale_v,
                    table=table.to(torch.int32).contiguous(),
                    pos0=pos0.to(torch.int32).contiguous())

    def _prefill_on(mdl, pgx: _Paged, pkv, rows, poss, clens, prompts,
                    lane_mask, ads):
        """One batched paged-prefill forward of ``mdl`` over its pool
        ``pkv`` (geometry ``pgx``), the touched blocks committed."""
        wtables = pgx.write_tables(rows, poss, clens, prefill_pad, lane_mask)
        pool = _pool(pkv, rows, poss)
        pool.update(clen=clens.to(torch.int32).contiguous(),
                    wtable=wtables.contiguous())
        ctx = PagedPrefill(pool, mdl.rope, mdl.sliding_window,
                           fused_rope=fused_rope, adapters=ads)
        logits = mdl(prompts, ctx).float()
        n = wtables.numel()

        def flat(i):
            t = torch.stack([w[i] for w in ctx.writes])  # [L, S, Mw, ...]
            return t.reshape((t.shape[0], n) + t.shape[3:])

        pgx.commit_quantized(pkv, wtables.reshape(n), flat(0), flat(1),
                             flat(2), flat(3))
        return pkv, logits

    def _window(mdl, pool, wk, wv, cursor, active, toks, ads):
        """One paged-decode forward of ``mdl``: ``toks [S, s]`` at each
        lane's ``cursor``, their K/V appended to the window buffers
        ``wk``/``wv`` (``pool`` holds the dispatch-start ``pos0``) →
        logits ``[S, s, V]`` f32."""
        ctx = PagedDecode(pool, wk, wv, cursor, active, mdl.rope,
                          mdl.sliding_window, fused_rope=fused_rope,
                          adapters=ads)
        return mdl(toks, ctx).float()

    @torch.no_grad()
    def prefill_chunk(pkv, rows, poss, clens, prompts, lane_mask, ads=None):
        return _prefill_on(model, pg, pkv, rows, poss, clens, prompts,
                           lane_mask, ads)

    def _last(logits, clens):
        idx = (clens.long() - 1).clamp(0, logits.shape[1] - 1)
        return logits[lanes, idx]

    @torch.no_grad()
    def insert_batch(state, pkv, tables, poss, prompts, clens, dsts, seeds,
                     temps, last, sampled=None, aids=None, apool=None,
                     gids=None, gpool=None):
        keep = dsts < S
        gp = _gp(gpool)
        if aids is None:
            aids = torch.full((S,), aid_empty, dtype=torch.int32,
                              device=device)
        if gids is None:
            gids = torch.full((S,), gid_empty, dtype=torch.int32,
                              device=device)
        pkv, logits = prefill_chunk(pkv, tables, poss, clens, prompts, keep,
                                    _ads(apool, aids))
        new_cur = (poss + clens).to(torch.int32)
        zero = torch.zeros(S, dtype=torch.int32, device=device)
        firsts, _ = sample_tail(_last(logits, clens), seeds, temps, zero,
                                sampled, gpool=gp, gidx=gids, gstate=zero)
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
        state.gidx[d] = gids[keep].to(torch.int32)
        state.gstate[d] = grammar_advance(gp, gids, zero, firsts, last)[keep]
        return state, pkv, firsts

    @torch.no_grad()
    def prefill_extend(state, pkv, slot: int, chunk, clen: int,
                       is_last: bool, sampled=None, apool=None, gpool=None):
        gp = _gp(gpool)
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
        gi = state.gidx[slot:slot + 1]
        gs = state.gstate[slot:slot + 1]
        first = sample_tail(row, state.seeds[slot:slot + 1],
                            state.temps[slot:slot + 1],
                            torch.zeros(1, dtype=torch.int32, device=device),
                            sampled, gpool=gp, gidx=gi, gstate=gs)[0]
        state.pos[slot] += int(clen)
        state.active[slot] = bool(is_last)
        state.last_tok[slot] = first[0] if is_last else 0
        state.counts[slot] = int(bool(is_last))
        if is_last:
            state.gstate[slot:slot + 1] = grammar_advance(
                gp, gi, gs, first, torch.ones(1, dtype=torch.bool,
                                              device=device))
        return state, pkv, first[0]

    @torch.no_grad()
    def decode_block(state, pkv, k: int, sampled=None, apool=None,
                     gpool=None):
        ads = _ads(apool, state.adapter_id)
        gp = _gp(gpool)
        pos0 = pkv.cursor.clone()
        active = state.active.clone()
        inc = active.to(torch.int32)
        wk, wv = pg.window_view(k)
        pool = _pool(pkv, pkv.table, pos0)
        cursor = pos0.clone()
        last_tok, counts, pos = state.last_tok, state.counts, state.pos
        gstate = state.gstate
        if sampled is None:
            sampled = bool((state.temps > 0).any())
        toks_all, masked_all = [], []
        for _ in range(k):
            logits = _window(model, pool, wk, wv, cursor, active,
                             last_tok[:, None], ads)[:, -1]
            toks, masked = sample_tail(logits, state.seeds, state.temps,
                                       counts, sampled, gpool=gp,
                                       gidx=state.gidx, gstate=gstate)
            last_tok = torch.where(active, toks, last_tok)
            gstate = grammar_advance(gp, state.gidx, gstate, last_tok,
                                     active)
            counts = counts + inc
            pos = pos + inc
            cursor = cursor + inc
            toks_all.append(last_tok)
            if n_lp:
                masked_all.append(masked)
        pg.commit_window(pkv, wk, wv, pos0, k, active)
        pkv.cursor.copy_(cursor)
        state.last_tok.copy_(last_tok)
        state.counts.copy_(counts)
        state.pos.copy_(pos)
        if gp is not None:
            state.gstate.copy_(gstate)
        if n_lp:
            # the block's top-n rows in one pass over its k masked rows
            return (state, pkv, torch.stack(toks_all)) + top_logprobs(
                torch.stack(masked_all), n_lp)
        return state, pkv, torch.stack(toks_all)

    @torch.no_grad()
    def evict(state, pkv, slot: int, free_ids):
        pg.release(pkv, slot, free_ids)
        for leaf in state:
            leaf[slot] = 0
        state.adapter_id[slot] = aid_empty
        state.gidx[slot] = gid_empty
        return state, pkv

    progs = dict(num_slots=S, prefill_pad=prefill_pad,
                 init_state=init_state, init_slots=pg.init,
                 insert_batch=insert_batch, prefill_extend=prefill_extend,
                 decode_block=decode_block, evict=evict,
                 prefill_chunk=prefill_chunk, paged=pg)
    if spec is None:
        return SlotDecode(**progs)

    # -- speculative decoding ------------------------------------------------
    draft = spec
    if int(draft.vocab) != int(model.vocab):
        raise ValueError(f"draft vocab {draft.vocab} != target vocab "
                         f"{model.vocab}")
    if int(draft.max_len) != int(model.max_len):
        raise ValueError(
            f"draft max_len {draft.max_len} != target max_len "
            f"{model.max_len} (draft and target cursors move in lockstep)")
    if draft.tok_embed.device != device:
        raise ValueError(f"draft on {draft.tok_embed.device}, target on "
                         f"{device}")
    # the tied draft IS the target's first layers, so it reads the pool's
    # first layer slices; a loaded draft does too iff its projection
    # geometry matches, else it runs base-only (acceptance only)
    d_lora = adapters is not None and (
        draft.d_model == model.d_model and draft.d_ff == model.d_ff
        and draft.n_heads == model.n_heads and draft.n_kv == model.n_kv
        and draft.n_layers <= model.n_layers)
    # the draft pool: the target pool's block geometry (block ids are
    # shared), the draft's bytes, always unquantized
    pg_d = _Paged(draft, S, PagedKVConfig(paged.num_blocks, paged.block_size,
                                          False), device)

    def _d_ads(apool, ids):
        return _ads(apool, ids) if d_lora else None

    def _aids(aids):
        return aids if aids is not None else torch.full(
            (S,), aid_empty, dtype=torch.int32, device=device)

    @torch.no_grad()
    def draft_prefill(dkv, tables, poss, prompts, clens, dsts, aids=None,
                      apool=None):
        keep = dsts < S
        dkv, _ = _prefill_on(draft, pg_d, dkv, tables, poss, clens, prompts,
                             keep, _d_ads(apool, _aids(aids)))
        d = dsts[keep].long()
        dkv.table[d] = tables[keep].to(torch.int32)
        dkv.cursor[d] = (poss + clens).to(torch.int32)[keep]
        return dkv

    @torch.no_grad()
    def draft_extend(dkv, slot: int, chunk, clen: int, aids=None,
                     apool=None):
        onehot = lanes == slot
        prompts = torch.zeros((S, prefill_pad), dtype=torch.int32,
                              device=device)
        prompts[slot] = chunk.to(torch.int32)
        clens = torch.where(onehot, int(clen), 0).to(torch.int32)
        dkv, _ = _prefill_on(draft, pg_d, dkv, dkv.table, dkv.cursor.clone(),
                             clens, prompts, onehot,
                             _d_ads(apool, _aids(aids)))
        dkv.cursor[slot] += int(clen)
        return dkv

    @torch.no_grad()
    def draft_evict(dkv, slot: int, free_ids):
        pg_d.release(dkv, slot, free_ids)
        return dkv

    def draft_arm(*_args, **_kw):
        raise NotImplementedError(
            "draft_arm (a cold draft lane after a KV handoff import) belongs "
            "to the lane handoff, not ported to tpudist_torch yet "
            "(ROADMAP.md queue A item 8)")

    @torch.no_grad()
    def draft_track(state, dkv, prev_last, toks, apool=None):
        k = toks.shape[0]
        active = state.active.clone()
        pos0 = dkv.cursor.clone()
        fed = torch.cat([prev_last[None].to(torch.int32),
                         toks[:-1].to(torch.int32)], 0).t().contiguous()
        wk, wv = pg_d.window_view(k)
        _window(draft, _pool(dkv, dkv.table, pos0), wk, wv, pos0, active,
                fed, _d_ads(apool, state.adapter_id))
        pg_d.commit_window(dkv, wk, wv, pos0, k, active)
        dkv.cursor.copy_(pos0 + k * active.to(torch.int32))
        return dkv

    @torch.no_grad()
    def draft_propose(state, dkv, k: int, sampled=None, apool=None):
        ads = _d_ads(apool, state.adapter_id)
        active = state.active.clone()
        inc = active.to(torch.int32)
        pos0 = dkv.cursor.clone()
        wk, wv = pg_d.window_view(k + 1)
        pool = _pool(dkv, dkv.table, pos0)
        if sampled is None:
            sampled = bool((state.temps > 0).any())
        cursor, tok = pos0.clone(), state.last_tok
        drafts, dlogits = [], []
        # step k feeds d_k, so an all-accepted verify leaves both cursors
        # equal; its logits are not needed
        for i in range(k + 1):
            lg = _window(draft, pool, wk, wv, cursor, active, tok[:, None],
                         ads)[:, -1]
            if i == k:
                break
            d, _ = sample_tail(lg, state.seeds, state.temps,
                               state.counts + i, sampled, stream=1)
            tok = torch.where(active, d, state.last_tok)
            drafts.append(tok)
            dlogits.append(lg)
            cursor = cursor + inc
        pg_d.commit_window(dkv, wk, wv, pos0, k + 1, active)
        dkv.cursor.copy_(pos0 + (k + 1) * inc)
        return dkv, torch.stack(drafts), torch.stack(dlogits)

    @torch.no_grad()
    def spec_verify(state, pkv, dkv, drafts, dlogits, spec_on, rem,
                    sampled=None, apool=None, gpool=None):
        gp = _gp(gpool)
        k = drafts.shape[0]
        active = state.active.clone()
        pos0 = pkv.cursor.clone()
        toks = torch.cat([state.last_tok[None], drafts.to(torch.int32)],
                         0).t().contiguous()                  # [S, k+1]
        wk, wv = pg.window_view(k + 1)
        logits = _window(model, _pool(pkv, pkv.table, pos0), wk, wv, pos0,
                         active, toks, _ads(apool, state.adapter_id))
        tok_ok = None
        if gp is not None:
            logits, tok_ok = _trajectory_mask(gp, state, logits, drafts)
        x, a_raw, inc, out = spec_accept(state, logits, drafts, dlogits,
                                         spec_on, rem, sampled, tok_ok)
        if gp is not None:
            # the automaton over the EMITTED tokens only (out[:, :inc]):
            # accepted drafts passed tok_ok and corrections come from the
            # masked rows, so every consumed transition is a real one
            gnew = state.gstate
            for j in range(k + 1):
                gnew = grammar_advance(gp, state.gidx, gnew, out[:, j],
                                       j < inc)
            state.gstate.copy_(gnew)
        pg.commit_window(pkv, wk, wv, pos0, k + 1, active)
        new_cur = (pos0 + inc).to(torch.int32)
        pkv.cursor.copy_(new_cur)
        dkv.cursor.copy_(new_cur)
        state.last_tok.copy_(torch.where(active, x, state.last_tok))
        state.counts.add_(inc)
        state.pos.add_(inc)
        packed = torch.cat([inc[:, None], a_raw[:, None], out], 1)
        if n_lp:
            return (state, pkv, dkv, packed) + top_logprobs(logits, n_lp)
        return state, pkv, dkv, packed

    return SlotDecode(**progs, init_draft=pg_d.init,
                      draft_prefill=draft_prefill, draft_extend=draft_extend,
                      draft_evict=draft_evict, draft_arm=draft_arm,
                      draft_track=draft_track, draft_propose=draft_propose,
                      spec_verify=spec_verify, draft_paged=pg_d)
