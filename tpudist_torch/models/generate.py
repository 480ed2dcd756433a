"""Decoding — the counterpart of :mod:`tpudist.models.generate`: the
sequential dense-cache :func:`generate` (the LM entry point's
``--generate``), and the slot-decode programs of the serving engine,
:func:`make_slot_decode` with every arm of the JAX one.

:func:`generate` runs the model one token at a time over a dense KV cache
(:class:`~tpudist_torch.models.transformer.DenseDecode`), teacher-forcing
the prompt and then sampling with :func:`sample_logits` (greedy arg-max at
temperature 0; else top-k/top-p filtered draws from an explicit
``torch.Generator``).  Like the JAX dense path it runs no kernel.

The slot programs keep ``num_slots`` KV lanes plus a per-slot
:class:`SlotState` on the device, over a paged pool (:class:`PagedKV`) or
the dense slot cache (:class:`DenseKV`, ``paged=None``).  Every program
runs fixed-shape over all slots: idle lanes compute too, and the
``active`` mask keeps them from advancing or writing.  The arms:

- decode: the paged decode kernel (``attn_kernel="paged"``: a K-step
  block with in-loop token feedback, its tokens held in window buffers and
  committed once per block), or a dense view
  (:class:`~tpudist_torch.models.transformer.SlotDense`) — the dense cache
  itself, or on a paged pool its gather through the block tables
  (``"gather"``), whose touched blocks are committed back after the block;
- prefill: the paged prefill kernel (``prefill_kernel``: one batched call
  per admission batch; a chunk extend runs the same program with a one-hot
  batch), or the teacher-forced prefill: ONE causal forward of the chunk
  over a dense view, the rows past its length writing nothing (the JAX
  package scans single-token steps; one forward streams the weights once
  and computes the same function);
- sampling: the fused sampling kernel (``sample_kernel``), or the unfused
  tail, its plain formulas in tensor ops — the same masked row, arg-max
  and IEEE division by ``max(t, 1e-6)``, so both tails draw the same
  streams; greedy arg-max where ``temp <= 0``, else a categorical draw from
  a per-request stream keyed by ``(seed, count)`` — independent of the
  slot, the neighbours and the block size.

A model with an MoE FFN serves on every arm through the dense top-1
reference (:func:`~tpudist_torch.models.transformer.dense_moe_reference`,
routing in f32, ties to the lower expert), whatever ``moe_fn`` it carries
from training: the serving contexts never call it, as the JAX programs
clone ``moe_fn=None``.

With ``fused_rope`` the kernel arms' QKV projection and rotation run as one
kernel; with ``adapters`` every forward reads each lane's LoRA factors
from the adapter pool through its ``SlotState.adapter_id`` (the kernel
arms through the LoRA gather-matmul kernel, the dense views as
pre-gathered factors).

Speculative decoding (``spec=`` a draft :class:`~tpudist_torch.models.
TransformerLM`, usually :func:`~tpudist_torch.models.tied_draft`) adds the
JAX package's draft programs beside these: the draft keeps its own KV (on a
paged engine an unquantized pool at the target pool's block geometry, so
the host allocator, prefix reuse and evict free-lists are shared) in cursor
lockstep with the target; ``draft_propose`` runs ``K + 1`` draft decode
steps with in-loop token feedback, and ``spec_verify`` scores the whole
``[last, d_1..d_K]`` window in ONE target pass (``s = K + 1`` queries a
lane), accepts the leading prefix (:func:`spec_accept`), commits the
window and rolls both cursors back to ``pos0 + emitted``.  Rejected K/V
past a cursor is masked garbage that the next window overwrites.  The JAX
package runs its draft on the dense gather view; the port's draft runs on
the target's arms, and a plain block is teacher-forced through the draft
in one ``s = K`` window pass.  That moves only the draft's rounding, never
the output: the target verify is the oracle.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from tpudist_torch.models.lora import (AdapterPool, AdapterPoolConfig,
                                      gather_collection, place_collections,
                                      pool_collection)
from tpudist_torch.models.paged import (PagedKV, PagedKVConfig, PagedLane,
                                        _Paged, _PlacedPaged)
from tpudist_torch.models.transformer import (CacheFullError,
                                              DenseDecode, PagedDecode,
                                              PagedPrefill, Places,
                                              SlotDense)
from tpudist_torch.ops import fused_residual_prep, fused_sample_prep
from tpudist_torch.ops.fused_sample import (fused_residual_reference,
                                            fused_sample_reference)

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
                gstate: Optional[torch.Tensor] = None, kernel: bool = True):
    """Per-slot next tokens from ``logits [S, V]`` f32 — the JAX
    ``_sample_tail``: the fused kernel masks each row by its grammar row
    (``gpool = (gallow [G+1, S_max, V] bool, gnext)`` at ``gidx`` /
    ``gstate [S]`` int32; ``None`` = no grammar seam) and takes the greedy
    arg-max of the masked row where ``temps <= 0``; elsewhere the
    Gumbel-max draw ``argmax(scaled + g)`` runs on the kernel's ``scaled``
    (the masked row over the temperature), ``g`` from
    :func:`philox_uniform` on substream ``stream``, so a forbidden token is
    neither pick.  ``kernel=False`` is the unfused tail (the JAX ``_gmask``
    + ``_slot_sample``): the same three values from the kernel's plain
    formulas in tensor ops on the logits' device — the division by a
    tensor, as the kernel's, so both tails draw the same tokens.
    ``sampled=False`` promises no lane has ``temp > 0`` (skips the noise);
    ``None`` checks.  Returns ``(toks [S] int32, masked [S, V] f32)``;
    ``masked`` feeds :func:`top_logprobs`."""
    prep = fused_sample_prep if kernel else fused_sample_reference
    if gpool is None:
        masked, scaled, greedy = prep(logits, temps)
    else:
        masked, scaled, greedy = prep(logits, temps, gpool[0], gidx, gstate)
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
                tok_ok: Optional[torch.Tensor] = None, kernel: bool = True):
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
    last token is its last accepted draft.  ``kernel=False`` runs both
    preps unfused (the JAX ``_accept``'s own formulas: ``softmax(l / t)``
    of both, ``log(max(pt - pd, 0) + 1e-30)`` or ``lt / t`` where the
    residual is empty).

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
                       sampled, kernel=kernel)[0].reshape(S, k1).long()
    prep = fused_residual_prep if kernel else fused_residual_reference
    pt, pd, res_logits = prep(
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


class DenseKV(NamedTuple):
    """The dense slot cache (``make_slot_decode(paged=None)``): ``k``/``v``
    ``[L, S, n_kv, max_len, dh]`` in the compute dtype, every slot owning
    ``max_len`` positions, and ``cursor [S]`` int32, each lane's filled
    length (the JAX cache's per-lane ``idx``).  Updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    cursor: torch.Tensor


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
    sample: Callable
    peek_logits: Callable
    export_lane: Callable
    import_lane: Callable
    #: the kernel prefill's model-level program (None on the other arm)
    prefill_chunk: Optional[Callable] = None
    #: the pool's geometry helper (None on the dense cache)
    paged: Optional[_Paged] = None
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


class _Lanes:
    """One model's KV lanes and the arms its slot programs run on: the
    dense slot cache (``pg`` None) or a paged pool ``pg``; decode through
    the paged decode kernel (``kernel_decode``) or a dense view; prefill
    through the paged prefill kernel (``kernel_prefill``) or teacher-forced
    over a dense view.  ``ads(apool, ids, kernel)`` builds the lanes'
    adapter collection for a kernel program (the pool form) or a dense one
    (pre-gathered factors), None without the seam."""

    def __init__(self, mdl, pg: Optional[_Paged], num_slots: int,
                 prefill_pad: int, device, *, kernel_decode: bool,
                 kernel_prefill: bool, fused_rope: bool, ads: Callable):
        self.mdl, self.pg = mdl, pg
        self.S, self.pad, self.device = num_slots, prefill_pad, device
        self.kernel_decode = kernel_decode
        self.kernel_prefill = kernel_prefill
        self.fused_rope = fused_rope
        self.ads = ads
        self.lanes = torch.arange(num_slots, device=device)

    def init(self):
        if self.pg is not None:
            return self.pg.init()
        m = self.mdl
        shape = (m.n_layers, self.S, m.n_kv, m.max_len, m.head_dim)
        return DenseKV(
            k=torch.zeros(shape, dtype=m.dtype, device=self.device),
            v=torch.zeros(shape, dtype=m.dtype, device=self.device),
            cursor=torch.zeros(self.S, dtype=torch.int32,
                               device=self.device))

    def _dense(self, k, v, cursor, n_write, toks, ads):
        """One forward of ``toks [S', s]`` over dense views → f32 logits."""
        m = self.mdl
        return m(toks, SlotDense(k, v, cursor, n_write, m.rope,
                                 m.sliding_window, ads)).float()

    @staticmethod
    def _last(logits, clens):
        idx = (clens.long() - 1).clamp(0, logits.shape[1] - 1)
        return logits[torch.arange(logits.shape[0],
                                   device=logits.device), idx]

    # -- prefill ------------------------------------------------------------

    def prefill_chunk(self, pkv, rows, poss, clens, prompts, lane_mask,
                      ads=None):
        """One batched paged-prefill kernel forward over the pool (lane
        ``j``'s chunk at ``poss[j]`` through its row ``rows[j]``), the
        touched blocks committed → ``(pkv, logits [S, pad, V] f32)``."""
        pg, m = self.pg, self.mdl
        wtables = pg.write_tables(rows, poss, clens, self.pad, lane_mask)
        pool = dict(pool_k=pkv.pool_k, pool_v=pkv.pool_v,
                    scale_k=pkv.scale_k, scale_v=pkv.scale_v,
                    table=rows.to(torch.int32).contiguous(),
                    pos0=poss.to(torch.int32).contiguous(),
                    clen=clens.to(torch.int32).contiguous(),
                    wtable=wtables.contiguous())
        ctx = PagedPrefill(pool, m.rope, m.sliding_window,
                           fused_rope=self.fused_rope, adapters=ads)
        logits = m(prompts, ctx).float()
        n = wtables.numel()

        def flat(i):
            t = torch.stack([w[i] for w in ctx.writes])  # [L, S, Mw, ...]
            return t.reshape((t.shape[0], n) + t.shape[3:])

        pg.commit_quantized(pkv, wtables.reshape(n), flat(0), flat(1),
                            flat(2), flat(3))
        return pkv, logits

    def insert(self, kv, tables, poss, prompts, clens, dsts, apool, aids):
        """Prefill an admission batch's chunks and install lane ``j`` in
        slot ``dsts[j]`` (``num_slots`` = unused) → ``(kv, logits after
        each lane's last live token [S, V] f32)``."""
        keep = dsts < self.S
        d = dsts[keep].long()
        new_cur = (poss + clens).to(torch.int32)
        if self.pg is None:                          # fresh lanes, then in
            k, v = torch.zeros_like(kv.k), torch.zeros_like(kv.v)
            logits = self._dense(k, v, poss, clens, prompts,
                                 self.ads(apool, aids, False))
            kv.k[:, d] = k[:, keep]
            kv.v[:, d] = v[:, keep]
            kv.cursor[d] = new_cur[keep]
        elif self.kernel_prefill:
            kv, logits = self.prefill_chunk(kv, tables, poss, clens, prompts,
                                            keep, self.ads(apool, aids, True))
            kv.table[d] = tables[keep].to(torch.int32)
            kv.cursor[d] = new_cur[keep]
        else:
            k, v = self.pg.dense_kv(kv, tables)
            logits = self._dense(k, v, poss, clens, prompts,
                                 self.ads(apool, aids, False))
            kv = self.pg.commit_lanes(kv, k, v, tables, dsts, poss, self.pad,
                                      new_cur)
        return kv, self._last(logits, clens)

    def extend(self, kv, slot: int, chunk, clen: int, apool, aids):
        """Append one prompt chunk at ``slot``'s cursor → ``(kv, the
        logits after its last live token [V] f32)``.  The kernel arm runs
        the batched program with a one-hot batch (every lane's adapter);
        the teacher-forced arm runs the one lane."""
        last = max(0, min(int(clen), self.pad) - 1)
        if self.kernel_prefill:
            onehot = self.lanes == slot
            prompts = torch.zeros((self.S, self.pad), dtype=torch.int32,
                                  device=self.device)
            prompts[slot] = chunk.to(torch.int32)
            clens = torch.where(onehot, int(clen), 0).to(torch.int32)
            kv, logits = self.prefill_chunk(
                kv, kv.table, kv.cursor.clone(), clens, prompts, onehot,
                self.ads(apool, aids, True))
            row = logits[slot, last]
        else:
            one = slice(slot, slot + 1)
            pos0 = kv.cursor[one].clone()
            n = torch.full((1,), int(clen), dtype=torch.int32,
                           device=self.device)
            ads = self.ads(apool, aids[one], False)
            if self.pg is None:                       # the slot, in place
                k, v = kv.k[:, one], kv.v[:, one]
            else:
                k, v = self.pg.dense_kv(kv, kv.table[one])
            row = self._dense(k, v, pos0, n, chunk[None].to(torch.int32),
                              ads)[0, last]
            if self.pg is not None:
                self.pg.commit_rows(kv, kv.table[one], k, v, pos0, self.pad,
                                    torch.ones(1, dtype=torch.bool,
                                               device=self.device))
        kv.cursor[slot] += int(clen)
        return kv, row

    # -- decode -------------------------------------------------------------

    def open(self, kv, span: int):
        """A decode dispatch's view at the dispatch-start cursors: window
        buffers and the pool (kernel), the gathered dense view (gather) or
        the dense cache itself."""
        if self.kernel_decode:
            pg = self.pg
            wk, wv = pg.window_view(span)
            pool = dict(pool_k=kv.pool_k, pool_v=kv.pool_v,
                        scale_k=kv.scale_k, scale_v=kv.scale_v,
                        table=kv.table.to(torch.int32).contiguous(),
                        pos0=kv.cursor.clone())
            return pool, wk, wv
        if self.pg is not None:
            return self.pg.dense_kv(kv, kv.table)
        return kv.k, kv.v

    def forward(self, view, cursor, active, toks, ads):
        """``toks [S, s]`` at each lane's ``cursor``, their K/V written
        where ``active`` → logits ``[S, s, V]`` f32."""
        m = self.mdl
        if self.kernel_decode:
            pool, wk, wv = view
            ctx = PagedDecode(pool, wk, wv, cursor, active, m.rope,
                              m.sliding_window, fused_rope=self.fused_rope,
                              adapters=ads)
            return m(toks, ctx).float()
        n = toks.shape[1] * active.to(torch.int32)
        return self._dense(view[0], view[1], cursor, n, toks, ads)

    def close(self, kv, view, pos0, span: int, active, new_cur):
        """Commit a dispatch's ``[pos0, pos0 + span)`` writes and set the
        cursors to ``new_cur``."""
        if self.kernel_decode:
            self.pg.commit_window(kv, view[1], view[2], pos0, span, active)
        elif self.pg is not None:
            self.pg.commit_rows(kv, kv.table, view[0], view[1], pos0, span,
                                active)
        kv.cursor.copy_(new_cur)
        return kv

    # -- peek, handoff, evict -----------------------------------------------

    def peek(self, state, kv, apool):
        """Every lane's next-token logits ``[S, V]`` f32 from a dense view
        (a copy: nothing advances) — the JAX ``peek_logits``, which runs the
        gather step on every paged arm too."""
        if self.pg is None:
            k, v = kv.k.clone(), kv.v.clone()
        else:
            k, v = self.pg.dense_kv(kv, kv.table)
        n = torch.ones(self.S, dtype=torch.int32, device=self.device)
        return self._dense(k, v, kv.cursor, n, state.last_tok[:, None],
                           self.ads(apool, state.adapter_id, False))[:, -1]

    def export(self, kv, slot: int, blocks: Optional[int] = None):
        if self.pg is not None:
            if blocks is not None:
                return self.pg.extract_blocks(kv, slot, blocks)
            return self.pg.extract_lane(kv, slot)
        return (kv.k[:, slot].clone(), kv.v[:, slot].clone(),
                kv.cursor[slot].clone())

    def adopt(self, kv, slot: int, row, lane):
        if isinstance(lane, PagedLane):
            return self.pg.adopt_blocks(kv, slot, row, lane)
        k, v, cursor = lane
        if self.pg is not None:
            return self.pg.adopt_lane(kv, slot, row, k, v, cursor)
        kv.k[:, slot] = k.to(kv.k.device, kv.k.dtype)
        kv.v[:, slot] = v.to(kv.v.device, kv.v.dtype)
        kv.cursor[slot] = torch.as_tensor(cursor).to(kv.cursor.device)
        return kv

    def release(self, kv, slot: int, free_ids=None):
        if self.pg is not None:
            return self.pg.release(kv, slot, free_ids)
        kv.k[:, slot] = 0
        kv.v[:, slot] = 0
        kv.cursor[slot] = 0
        return kv


class PlacedDenseKV(NamedTuple):
    """The dense slot cache over ``model`` places (the serving mesh):
    ``k``/``v`` hold one ``[L, S, n_kv/P, max_len, dh]`` tensor a place,
    its kv heads; ``cursor [S]`` exists once.  The ``data`` axis's rows
    are slot ranges of each place's tensor: its places share the model
    places' devices, and a place attends over all its rows' lanes in one
    batched call (split a row a call, the CPU's batched product rounds the
    scores of a grouped multi-query window otherwise)."""

    k: tuple
    v: tuple
    cursor: torch.Tensor


class _PlacedLanes(_Lanes):
    """:class:`_Lanes` over a serving mesh's places: ``fwd`` the model's
    forward over them (:class:`~tpudist_torch.models.transformer.
    PlacedLM`), the KV split by kv heads (a :class:`~tpudist_torch.models.
    paged.PlacedKV` through ``pg``, a :class:`PlacedDenseKV` without a
    pool).  Every arm and program of :class:`_Lanes`, each place making
    its own launches over its slice; the table, the cursors and the
    sampling are the unsplit engine's."""

    def __init__(self, mdl, fwd, pg, num_slots: int, prefill_pad: int,
                 device, **kw):
        super().__init__(mdl, pg, num_slots, prefill_pad, device, **kw)
        self.fwd = fwd
        self.P = fwd.attn_places
        self.devices = fwd.devices[:self.P]

    def init(self):
        if self.pg is not None:
            return self.pg.init()
        m = self.mdl
        shape = (m.n_layers, self.S, m.n_kv // self.P, m.max_len,
                 m.head_dim)

        def arena():
            return tuple(torch.zeros(shape, dtype=m.dtype, device=dev)
                         for dev in self.devices)

        return PlacedDenseKV(k=arena(), v=arena(), cursor=torch.zeros(
            self.S, dtype=torch.int32, device=self.device))

    def _dense(self, k, v, cursor, n_write, toks, ads):
        """One forward of ``toks [S', s]`` over each place's dense views."""
        m = self.mdl
        ctx = Places([SlotDense(kk, vv, cursor.to(dev), n_write.to(dev),
                                m.rope, m.sliding_window)
                      for kk, vv, dev in zip(k, v, self.devices)], ads)
        return self.fwd(toks, ctx).float()

    def prefill_chunk(self, pkv, rows, poss, clens, prompts, lane_mask,
                      ads=None):
        pg, m = self.pg, self.mdl
        wtables = pg.write_tables(rows, poss, clens, self.pad, lane_mask)
        ctxs = []
        for i, dev in enumerate(self.devices):
            p = pkv.place(i)
            pool = dict(pool_k=p.pool_k, pool_v=p.pool_v,
                        scale_k=p.scale_k, scale_v=p.scale_v,
                        table=rows.to(dev, torch.int32).contiguous(),
                        pos0=poss.to(dev, torch.int32).contiguous(),
                        clen=clens.to(dev, torch.int32).contiguous(),
                        wtable=wtables.to(dev).contiguous())
            ctxs.append(PagedPrefill(pool, m.rope, m.sliding_window,
                                     fused_rope=self.fused_rope))
        logits = self.fwd(prompts, Places(ctxs, ads)).float()
        n = wtables.numel()

        def flat(c, i):
            t = torch.stack([w[i] for w in c.writes])  # [L, S, Mw, ...]
            return t.reshape((t.shape[0], n) + t.shape[3:])

        pg.commit_quantized(pkv, wtables.reshape(n),
                            [tuple(flat(c, i) for i in range(4))
                             for c in ctxs])
        return pkv, logits

    def insert(self, kv, tables, poss, prompts, clens, dsts, apool, aids):
        keep = dsts < self.S
        d = dsts[keep].long()
        new_cur = (poss + clens).to(torch.int32)
        if self.pg is None:                          # fresh lanes, then in
            k = [torch.zeros_like(t) for t in kv.k]
            v = [torch.zeros_like(t) for t in kv.v]
            logits = self._dense(k, v, poss, clens, prompts,
                                 self.ads(apool, aids, False))
            for dst, src in zip(kv.k + kv.v, k + v):
                dst[:, d.to(dst.device)] = src[:, keep.to(src.device)]
            kv.cursor[d] = new_cur[keep]
        elif self.kernel_prefill:
            kv, logits = self.prefill_chunk(kv, tables, poss, clens, prompts,
                                            keep, self.ads(apool, aids, True))
            kv.table[d] = tables[keep].to(torch.int32)
            kv.cursor[d] = new_cur[keep]
        else:
            k, v = self.pg.dense_kv(kv, tables)
            logits = self._dense(k, v, poss, clens, prompts,
                                 self.ads(apool, aids, False))
            kv = self.pg.commit_lanes(kv, k, v, tables, dsts, poss, self.pad,
                                      new_cur)
        return kv, self._last(logits, clens)

    def extend(self, kv, slot: int, chunk, clen: int, apool, aids):
        last = max(0, min(int(clen), self.pad) - 1)
        if self.kernel_prefill:
            return super().extend(kv, slot, chunk, clen, apool, aids)
        one = slice(slot, slot + 1)
        pos0 = kv.cursor[one].clone()
        n = torch.full((1,), int(clen), dtype=torch.int32,
                       device=self.device)
        ads = self.ads(apool, aids[one], False)
        if self.pg is None:                           # the slot, in place
            k, v = [t[:, one] for t in kv.k], [t[:, one] for t in kv.v]
        else:
            k, v = self.pg.dense_kv(kv, kv.table[one])
        row = self._dense(k, v, pos0, n, chunk[None].to(torch.int32),
                          ads)[0, last]
        if self.pg is not None:
            self.pg.commit_rows(kv, kv.table[one], k, v, pos0, self.pad,
                                torch.ones(1, dtype=torch.bool,
                                           device=self.device))
        kv.cursor[slot] += int(clen)
        return kv, row

    def open(self, kv, span: int):
        if self.kernel_decode:
            wk, wv = self.pg.window_view(span)
            pools = []
            for i, dev in enumerate(self.devices):
                p = kv.place(i)
                pools.append(dict(pool_k=p.pool_k, pool_v=p.pool_v,
                                  scale_k=p.scale_k, scale_v=p.scale_v,
                                  table=p.table.contiguous(),
                                  pos0=kv.cursor.to(dev).clone()))
            return pools, wk, wv
        if self.pg is not None:
            return self.pg.dense_kv(kv, kv.table)
        return kv.k, kv.v

    def forward(self, view, cursor, active, toks, ads):
        m = self.mdl
        if self.kernel_decode:
            pools, wk, wv = view
            ctx = Places([PagedDecode(
                pool, k, v, cursor.to(dev), active.to(dev), m.rope,
                m.sliding_window, fused_rope=self.fused_rope)
                for pool, k, v, dev in zip(pools, wk, wv, self.devices)],
                ads)
            return self.fwd(toks, ctx).float()
        n = toks.shape[1] * active.to(torch.int32)
        return self._dense(view[0], view[1], cursor, n, toks, ads)

    def close(self, kv, view, pos0, span: int, active, new_cur):
        if self.kernel_decode:
            self.pg.commit_window(kv, view[1], view[2], pos0, span, active)
        elif self.pg is not None:
            self.pg.commit_rows(kv, kv.table, view[0], view[1], pos0, span,
                                active)
        kv.cursor.copy_(new_cur)
        return kv

    def peek(self, state, kv, apool):
        if self.pg is None:
            k, v = [t.clone() for t in kv.k], [t.clone() for t in kv.v]
        else:
            k, v = self.pg.dense_kv(kv, kv.table)
        n = torch.ones(self.S, dtype=torch.int32, device=self.device)
        return self._dense(k, v, kv.cursor, n, state.last_tok[:, None],
                           self.ads(apool, state.adapter_id, False))[:, -1]

    def export(self, kv, slot: int, blocks: Optional[int] = None):
        if self.pg is not None:
            if blocks is not None:
                return self.pg.extract_blocks(kv, slot, blocks)
            return self.pg.extract_lane(kv, slot)
        return (torch.cat([t[:, slot].to(self.device) for t in kv.k], 1),
                torch.cat([t[:, slot].to(self.device) for t in kv.v], 1),
                kv.cursor[slot].clone())

    def adopt(self, kv, slot: int, row, lane):
        if isinstance(lane, PagedLane):
            return self.pg.adopt_blocks(kv, slot, row, lane)
        k, v, cursor = lane
        if self.pg is not None:
            return self.pg.adopt_lane(kv, slot, row, k, v, cursor)
        hk = self.mdl.n_kv // self.P
        for i, (dk, dv) in enumerate(zip(kv.k, kv.v)):
            heads = slice(i * hk, (i + 1) * hk)
            dk[:, slot] = k[:, heads].to(dk.device, dk.dtype)
            dv[:, slot] = v[:, heads].to(dv.device, dv.dtype)
        kv.cursor[slot] = torch.as_tensor(cursor).to(kv.cursor.device)
        return kv

    def release(self, kv, slot: int, free_ids=None):
        if self.pg is not None:
            return self.pg.release(kv, slot, free_ids)
        for t in kv.k + kv.v:
            t[:, slot] = 0
        kv.cursor[slot] = 0
        return kv


def make_slot_decode(model, num_slots: int, prefill_pad: int,
                     paged: Optional[PagedKVConfig], *,
                     attn_kernel: str = "paged",
                     prefill_kernel: bool = True,
                     sample_kernel: bool = True, fused_rope: bool = False,
                     lora_kernel: bool = False,
                     adapters: Optional[AdapterPoolConfig] = None,
                     spec=None, constrain=None,
                     logprobs: int = 0, places=None,
                     draft_places=None) -> SlotDecode:
    """Build the slot programs over ``model`` (a
    :class:`~tpudist_torch.models.TransformerLM` on its serving device) —
    the JAX ``make_slot_decode``, the mesh aside.  ``paged`` a
    :class:`PagedKVConfig` keeps the KV in a paged pool (``cache`` below is
    a :class:`PagedKV`); None keeps the dense slot cache (a
    :class:`DenseKV`), where the programs drop their ``tables``, ``poss``
    and ``free_ids`` arguments, as in JAX:

    - ``init_state()`` / ``init_slots()`` — zero state / empty cache;
    - ``insert_batch(state, cache, [tables [S, M], poss [S],] prompts [S,
      pad], clens [S], dsts [S], seeds [S], temps [S], last [S],
      sampled=None, aids=None, apool=None, gids=None, gpool=None)`` →
      ``(state, cache, firsts [S])``: prefill lane ``j``'s chunk (at
      ``poss[j]`` through its table row) with adapter block ``aids[j]``,
      install it in slot ``dsts[j]`` (``num_slots`` = unused lane) with
      grammar block ``gids[j]``, and where ``last[j]`` sample the first
      token and arm the slot;
    - ``prefill_extend(state, cache, slot, chunk [pad], clen, is_last,
      sampled=None, apool=None, gpool=None)`` → ``(state, cache, first)``:
      append one prompt chunk at the slot's cursor;
    - ``decode_block(state, cache, k, sampled=None, apool=None,
      gpool=None)`` → ``(state, cache, toks [k, S])``, plus ``(lp_ids [k,
      S, n], lp_vals [k, S, n])`` with ``logprobs = n > 0``: ``k`` decode
      steps with in-loop token feedback;
    - ``evict(state, cache, slot[, free_ids [M]])`` — free a lane (a paged
      pool zeroes the blocks whose refcount hit zero), reset its adapter and
      grammar to the sentinels;
    - ``sample(logits [S, V], seeds, temps, counts)`` → ``[S]`` int32: the
      unfused tail (:func:`sample_tail`);
    - ``peek_logits(state, cache, apool=None)`` → ``[S, V]`` f32: every
      lane's next-token logits, nothing advanced (the int8-accuracy
      oracle);
    - ``export_lane(state, cache, slot, blocks=None)`` → ``(lane,
      lane_state)``: the lane ``(k, v, cursor)``, ``k``/``v`` ``[L, n_kv,
      max_len, dh]`` (on a paged pool the dense view through the slot's
      table, int8 dequantized), and the slot's :class:`SlotState` row;
      with ``blocks`` on a paged pool, the lane is the first ``blocks``
      blocks of the slot's row as stored, a
      :class:`~tpudist_torch.models.paged.PagedLane`;
    - ``import_lane(state, cache, slot, [row [M],] lane, lane_state)`` →
      ``(state, cache)``: install an exported lane in ``slot`` (a paged
      pool scatters a dense lane into the host-allocated ``row``'s
      blocks, requantizing, and writes a ``PagedLane``'s blocks as they
      are).  The row carries ``last_tok``, ``counts`` and ``seeds``, so a
      continuation in another engine and slot draws what the source
      would have;
    - ``prefill_chunk(pkv, rows, poss, clens, prompts, lane_mask,
      ads=None)`` → ``(pkv, logits [S, pad, V] f32)`` — the kernel
      prefill's model-level program (``prefill_kernel`` only).

    ``attn_kernel`` is ``"paged"`` (the paged decode kernel; needs a pool)
    or ``"gather"`` (decode over a dense view: the dense cache, or the
    pool gathered through the tables and committed back after each
    dispatch); ``prefill_kernel`` the paged prefill kernel (needs a pool)
    or the teacher-forced prefill; ``sample_kernel`` the fused sampling
    and residual kernels or the unfused tail (module doc).  ``fused_rope``
    runs the kernel arms' QKV projection and rotation through the fused
    RoPE+QKV kernel.  ``adapters`` (an :class:`~tpudist_torch.models.lora.
    AdapterPoolConfig`) turns on the per-tenant adapter seam: every forward
    program takes the pool (``apool``) and reads each lane's factors from
    its ``SlotState.adapter_id`` — the kernel arms through the LoRA
    gather-matmul kernel, the dense views as pre-gathered factors.
    ``lora_kernel`` and ``fused_rope`` are validated as the JAX package
    validates them; the port's kernel programs always take the pool form,
    so either ``lora_kernel`` value runs the same kernel path.  Caches
    update in place (see :mod:`tpudist_torch.models.paged`).

    ``constrain`` (a :class:`~tpudist_torch.constrain.ConstrainConfig`)
    turns on the structured-output seam: the programs that sample take the
    grammar pool ``gpool = (gallow [G+1, S_max, V] bool, gnext [G+1,
    S_max, V] int32)`` (block ``G`` the all-True sentinel), each lane's row
    is masked at its ``(gidx, gstate)`` before the pick, and ``gstate``
    advances with every committed token (:func:`grammar_advance`).
    ``logprobs = n`` makes ``decode_block`` and ``spec_verify`` also return
    the top-``n`` rows of the post-mask ``log_softmax`` at each emitted
    position (:func:`top_logprobs`); prefill-sampled first tokens carry
    none.

    ``spec`` (a draft :class:`~tpudist_torch.models.TransformerLM` on the
    same device, sharing ``vocab`` and ``max_len``) adds the speculative
    programs (module doc), the draft on the target's arms:

    - ``init_draft()`` — the empty draft cache;
    - ``draft_prefill(dkv, [tables, poss,] prompts, clens, dsts, aids=None,
      apool=None)`` and ``draft_extend(dkv, slot, chunk, clen, aids=None,
      apool=None)`` — the draft twins of ``insert_batch`` /
      ``prefill_extend``'s cache half (``aids [S]``: each lane's adapter
      block);
    - ``draft_evict(dkv, slot[, free_ids])``;
    - ``draft_arm(dkv, slot, [row [M],] pos)`` — cold-start an imported
      lane's draft at cursor ``pos`` over a zeroed context (a paged pool
      maps ``row``'s freshly admitted blocks);
    - ``draft_track(state, dkv, prev_last [S], toks [K, S], apool=None)`` —
      teacher-force a plain block's emitted tokens through the draft;
    - ``draft_propose(state, dkv, k, sampled=None, apool=None)`` → ``(dkv,
      drafts [k, S], dlogits [k, S, V])``;
    - ``spec_verify(state, cache, dkv, drafts, dlogits, spec_on [S], rem
      [S], sampled=None, apool=None, gpool=None)`` → ``(state, cache, dkv,
      packed [S, k+3])``, plus ``(lp_ids [S, k+1, n], lp_vals [S, k+1,
      n])`` with ``logprobs = n > 0``: column 0 the emitted count, 1 the
      unclamped accept count, 2.. the emitted tokens.  The draft proposes
      unmasked; the verify rows are masked along each lane's automaton
      trajectory over its drafts, a forbidden draft is a rejection, and
      ``gstate`` advances over the emitted tokens only.

    The tied draft shares its lane's adapter (its blocks are the target's
    first layers, so they read the pool's first layer slices); a loaded
    draft of another projection geometry runs base-only.

    ``places`` (a :class:`~tpudist_torch.models.transformer.PlacedLM`, the
    serving mesh of :mod:`tpudist_torch.serve.spmd`) runs every program
    over ``model`` places: the forward is ``places``', the KV splits by kv
    heads (a :class:`~tpudist_torch.models.paged.PlacedKV` or a
    :class:`PlacedDenseKV`), the adapter pool is a :class:`~tpudist_torch.
    models.lora.PlacedAdapterPool`; ``draft_places`` is the draft's.  The table, the
    cursors, the state and the sampling are the unsplit programs', and
    so are ``peek_logits``' and the exported lanes' tensors."""
    if attn_kernel not in ("gather", "paged"):
        raise ValueError(
            f"attn_kernel must be 'gather' or 'paged', got {attn_kernel!r}")
    if attn_kernel == "paged" and paged is None:
        raise ValueError(
            "attn_kernel='paged' is the paged-pool kernel — it requires a "
            "paged cache (pass paged=PagedKVConfig(...))")
    if prefill_kernel and paged is None:
        raise ValueError(
            "prefill_kernel=True is the paged-prefill kernel — it requires "
            "a paged cache (pass paged=PagedKVConfig(...))")
    kernel_decode = attn_kernel == "paged"
    if fused_rope and not kernel_decode and not prefill_kernel:
        raise ValueError(
            "fused_rope=True fuses RoPE+QKV on the kernel arms only — "
            "enable attn_kernel='paged' and/or prefill_kernel=True")
    if lora_kernel and adapters is None:
        raise ValueError(
            "lora_kernel=True is the in-kernel adapter gather-matmul — "
            "it requires the adapter seam (pass adapters=...)")
    if lora_kernel and not kernel_decode and not prefill_kernel:
        raise ValueError(
            "lora_kernel=True rides the slot-batched kernel programs only "
            "— enable attn_kernel='paged' and/or prefill_kernel=True (the "
            "dense and gather programs take pre-gathered factors)")
    if num_slots < 1:
        raise ValueError(f"num_slots must be >= 1, got {num_slots}")
    n_lp = int(logprobs)
    if n_lp < 0:
        raise ValueError(f"logprobs must be >= 0, got {n_lp}")
    if not 1 <= prefill_pad <= model.max_len:
        raise ValueError(f"prefill_pad {prefill_pad} must be in "
                         f"[1, {model.max_len}]")
    device = model.tok_embed.device
    S = num_slots
    kern = bool(sample_kernel)
    #: the sentinel adapter id = base-only (also what evict resets to)
    aid_empty = int(adapters.num_blocks) if adapters is not None else 0
    #: the sentinel grammar id = unconstrained (also what evict resets to)
    gid_empty = int(constrain.num_blocks) if constrain is not None else 0

    def _ads(apool: Optional[AdapterPool], ids, kernel: bool):
        if adapters is None:
            return None
        if apool is None:
            raise ValueError("an adapter engine's programs take the adapter "
                             "pool (apool=...)")
        if places is not None:
            return place_collections(apool, ids, kernel, len(places.devices))
        return (pool_collection if kernel else gather_collection)(apool, ids)

    def _gp(gpool):
        """The grammar pool a program samples through (None when the seam
        is off)."""
        if constrain is None:
            return None
        if gpool is None:
            raise ValueError("a constrained engine's programs take the "
                             "grammar pool (gpool=...)")
        return gpool

    def _ids(ids, empty: int):
        return ids if ids is not None else torch.full(
            (S,), empty, dtype=torch.int32, device=device)

    arms = dict(kernel_decode=kernel_decode,
                kernel_prefill=bool(prefill_kernel),
                fused_rope=bool(fused_rope))
    def lanes(mdl, fwd, pcfg, ads):
        """One model's lanes: plain, or over ``fwd``'s places."""
        if fwd is None:
            pg = None if pcfg is None else _Paged(mdl, S, pcfg, device)
            return _Lanes(mdl, pg, S, prefill_pad, device, ads=ads, **arms)
        pg = None if pcfg is None else _PlacedPaged(
            mdl, S, pcfg, fwd.devices[:fwd.attn_places], device)
        return _PlacedLanes(mdl, fwd, pg, S, prefill_pad, device, ads=ads,
                            **arms)

    tgt = lanes(model, places, paged, _ads)
    pg = tgt.pg
    zeros = torch.zeros(S, dtype=torch.int32, device=device)

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

    @torch.no_grad()
    def _insert(state, kv, tables, poss, prompts, clens, dsts, seeds, temps,
                last, sampled, aids, apool, gids, gpool):
        keep = dsts < S
        gp = _gp(gpool)
        aids, gids = _ids(aids, aid_empty), _ids(gids, gid_empty)
        kv, last_logits = tgt.insert(kv, tables, poss, prompts, clens, dsts,
                                     apool, aids)
        new_cur = (poss + clens).to(torch.int32)
        firsts, _ = sample_tail(last_logits, seeds, temps, zeros, sampled,
                                gpool=gp, gidx=gids, gstate=zeros,
                                kernel=kern)
        d = dsts[keep].long()
        state.last_tok[d] = torch.where(last, firsts, zeros)[keep]
        state.active[d] = last[keep]
        state.pos[d] = new_cur[keep]
        state.counts[d] = last.to(torch.int32)[keep]
        state.temps[d] = temps[keep].float()
        state.seeds[d] = seeds[keep].long()
        state.adapter_id[d] = aids[keep].to(torch.int32)
        state.gidx[d] = gids[keep].to(torch.int32)
        state.gstate[d] = grammar_advance(gp, gids, zeros, firsts, last)[keep]
        return state, kv, firsts

    if pg is None:
        def insert_batch(state, cache, prompts, clens, dsts, seeds, temps,
                         last, sampled=None, aids=None, apool=None,
                         gids=None, gpool=None):
            return _insert(state, cache, None, zeros, prompts, clens, dsts,
                           seeds, temps, last, sampled, aids, apool, gids,
                           gpool)
    else:
        def insert_batch(state, pkv, tables, poss, prompts, clens, dsts,
                         seeds, temps, last, sampled=None, aids=None,
                         apool=None, gids=None, gpool=None):
            return _insert(state, pkv, tables, poss, prompts, clens, dsts,
                           seeds, temps, last, sampled, aids, apool, gids,
                           gpool)

    @torch.no_grad()
    def prefill_extend(state, kv, slot: int, chunk, clen: int,
                       is_last: bool, sampled=None, apool=None, gpool=None):
        gp = _gp(gpool)
        kv, row = tgt.extend(kv, slot, chunk, clen, apool, state.adapter_id)
        gi = state.gidx[slot:slot + 1]
        gs = state.gstate[slot:slot + 1]
        first = sample_tail(row[None], state.seeds[slot:slot + 1],
                            state.temps[slot:slot + 1], zeros[:1], sampled,
                            gpool=gp, gidx=gi, gstate=gs, kernel=kern)[0]
        state.pos[slot] += int(clen)
        state.active[slot] = bool(is_last)
        state.last_tok[slot] = first[0] if is_last else 0
        state.counts[slot] = int(bool(is_last))
        if is_last:
            state.gstate[slot:slot + 1] = grammar_advance(
                gp, gi, gs, first, torch.ones(1, dtype=torch.bool,
                                              device=device))
        return state, kv, first[0]

    @torch.no_grad()
    def decode_block(state, kv, k: int, sampled=None, apool=None,
                     gpool=None):
        ads = _ads(apool, state.adapter_id, kernel_decode)
        gp = _gp(gpool)
        pos0 = kv.cursor.clone()
        active = state.active.clone()
        inc = active.to(torch.int32)
        view = tgt.open(kv, k)
        cursor = pos0.clone()
        last_tok, counts, pos = state.last_tok, state.counts, state.pos
        gstate = state.gstate
        if sampled is None:
            sampled = bool((state.temps > 0).any())
        toks_all, masked_all = [], []
        for _ in range(k):
            logits = tgt.forward(view, cursor, active, last_tok[:, None],
                                 ads)[:, -1]
            toks, masked = sample_tail(logits, state.seeds, state.temps,
                                       counts, sampled, gpool=gp,
                                       gidx=state.gidx, gstate=gstate,
                                       kernel=kern)
            last_tok = torch.where(active, toks, last_tok)
            gstate = grammar_advance(gp, state.gidx, gstate, last_tok,
                                     active)
            counts = counts + inc
            pos = pos + inc
            cursor = cursor + inc
            toks_all.append(last_tok)
            if n_lp:
                masked_all.append(masked)
        tgt.close(kv, view, pos0, k, active, cursor)
        state.last_tok.copy_(last_tok)
        state.counts.copy_(counts)
        state.pos.copy_(pos)
        if gp is not None:
            state.gstate.copy_(gstate)
        if n_lp:
            # the block's top-n rows in one pass over its k masked rows
            return (state, kv, torch.stack(toks_all)) + top_logprobs(
                torch.stack(masked_all), n_lp)
        return state, kv, torch.stack(toks_all)

    def _reset(state, slot: int):
        for leaf in state:
            leaf[slot] = 0
        state.adapter_id[slot] = aid_empty
        state.gidx[slot] = gid_empty
        return state

    if pg is None:
        @torch.no_grad()
        def evict(state, cache, slot: int):
            return _reset(state, slot), tgt.release(cache, slot)
    else:
        @torch.no_grad()
        def evict(state, pkv, slot: int, free_ids):
            return _reset(state, slot), tgt.release(pkv, slot, free_ids)

    @torch.no_grad()
    def sample(logits, seeds, temps, counts):
        return sample_tail(logits, seeds, temps, counts, kernel=False)[0]

    @torch.no_grad()
    def peek_logits(state, kv, apool=None):
        return tgt.peek(state, kv, apool)

    @torch.no_grad()
    def export_lane(state, kv, slot: int, blocks: Optional[int] = None):
        return tgt.export(kv, slot, blocks), SlotState(
            *(leaf[slot].clone() for leaf in state))

    def _import(state, kv, slot, row, lane, lane_state):
        kv = tgt.adopt(kv, slot, row, lane)
        for leaf, val in zip(state, lane_state):
            leaf[slot] = torch.as_tensor(val).to(leaf.device, leaf.dtype)
        return state, kv

    if pg is None:
        @torch.no_grad()
        def import_lane(state, cache, slot: int, lane, lane_state):
            return _import(state, cache, slot, None, lane, lane_state)
    else:
        @torch.no_grad()
        def import_lane(state, pkv, slot: int, row, lane, lane_state):
            return _import(state, pkv, slot, row, lane, lane_state)

    progs = dict(num_slots=S, prefill_pad=prefill_pad,
                 init_state=init_state, init_slots=tgt.init,
                 insert_batch=insert_batch, prefill_extend=prefill_extend,
                 decode_block=decode_block, evict=evict, sample=sample,
                 peek_logits=peek_logits, export_lane=export_lane,
                 import_lane=import_lane, paged=pg,
                 prefill_chunk=(torch.no_grad()(tgt.prefill_chunk)
                                if prefill_kernel else None))
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

    def _d_ads(apool, ids, kernel: bool):
        return _ads(apool, ids, kernel) if d_lora else None

    # the draft pool: the target pool's block geometry (block ids are
    # shared), the draft's bytes, always unquantized
    dft = lanes(draft, draft_places, None if paged is None else
                PagedKVConfig(paged.num_blocks, paged.block_size, False),
                _d_ads)
    pg_d = dft.pg

    @torch.no_grad()
    def _draft_prefill(dkv, tables, poss, prompts, clens, dsts, aids,
                       apool):
        return dft.insert(dkv, tables, poss, prompts, clens, dsts, apool,
                          _ids(aids, aid_empty))[0]

    if pg is None:
        def draft_prefill(dkv, prompts, clens, dsts, aids=None, apool=None):
            return _draft_prefill(dkv, None, zeros, prompts, clens, dsts,
                                  aids, apool)

        @torch.no_grad()
        def draft_evict(dkv, slot: int):
            return dft.release(dkv, slot)
    else:
        def draft_prefill(dkv, tables, poss, prompts, clens, dsts,
                          aids=None, apool=None):
            return _draft_prefill(dkv, tables, poss, prompts, clens, dsts,
                                  aids, apool)

        @torch.no_grad()
        def draft_evict(dkv, slot: int, free_ids):
            return dft.release(dkv, slot, free_ids)

    @torch.no_grad()
    def draft_extend(dkv, slot: int, chunk, clen: int, aids=None,
                     apool=None):
        return dft.extend(dkv, slot, chunk, clen, apool,
                          _ids(aids, aid_empty))[0]

    # draft_arm: an imported lane's draft cursor cold-started at ``pos``
    # over a zeroed context (the JAX draft_arm): the draft's missing
    # context only lowers acceptance, the target's verify stays the oracle
    if pg is None:
        @torch.no_grad()
        def draft_arm(dkv, slot: int, pos: int):
            dkv = dft.release(dkv, slot)
            dkv.cursor[slot] = int(pos)
            return dkv
    else:
        @torch.no_grad()
        def draft_arm(dkv, slot: int, row, pos: int):
            # the row's blocks were freshly admitted, so the draft pool's
            # copies are the zeros the last evict left there
            dkv.table[slot] = row.to(dkv.table)
            dkv.cursor[slot] = int(pos)
            return dkv

    @torch.no_grad()
    def draft_track(state, dkv, prev_last, toks, apool=None):
        k = toks.shape[0]
        active = state.active.clone()
        pos0 = dkv.cursor.clone()
        fed = torch.cat([prev_last[None].to(torch.int32),
                         toks[:-1].to(torch.int32)], 0).t().contiguous()
        view = dft.open(dkv, k)
        dft.forward(view, pos0, active, fed,
                    _d_ads(apool, state.adapter_id, kernel_decode))
        return dft.close(dkv, view, pos0, k, active,
                         pos0 + k * active.to(torch.int32))

    @torch.no_grad()
    def draft_propose(state, dkv, k: int, sampled=None, apool=None):
        ads = _d_ads(apool, state.adapter_id, kernel_decode)
        active = state.active.clone()
        inc = active.to(torch.int32)
        pos0 = dkv.cursor.clone()
        view = dft.open(dkv, k + 1)
        if sampled is None:
            sampled = bool((state.temps > 0).any())
        cursor, tok = pos0.clone(), state.last_tok
        drafts, dlogits = [], []
        # step k feeds d_k, so an all-accepted verify leaves both cursors
        # equal; its logits are not needed
        for i in range(k + 1):
            lg = dft.forward(view, cursor, active, tok[:, None], ads)[:, -1]
            if i == k:
                break
            d, _ = sample_tail(lg, state.seeds, state.temps,
                               state.counts + i, sampled, stream=1,
                               kernel=kern)
            tok = torch.where(active, d, state.last_tok)
            drafts.append(tok)
            dlogits.append(lg)
            cursor = cursor + inc
        dkv = dft.close(dkv, view, pos0, k + 1, active, pos0 + (k + 1) * inc)
        return dkv, torch.stack(drafts), torch.stack(dlogits)

    @torch.no_grad()
    def spec_verify(state, kv, dkv, drafts, dlogits, spec_on, rem,
                    sampled=None, apool=None, gpool=None):
        gp = _gp(gpool)
        k = drafts.shape[0]
        active = state.active.clone()
        pos0 = kv.cursor.clone()
        toks = torch.cat([state.last_tok[None], drafts.to(torch.int32)],
                         0).t().contiguous()                  # [S, k+1]
        view = tgt.open(kv, k + 1)
        logits = tgt.forward(view, pos0, active, toks,
                             _ads(apool, state.adapter_id, kernel_decode))
        tok_ok = None
        if gp is not None:
            logits, tok_ok = _trajectory_mask(gp, state, logits, drafts)
        x, a_raw, inc, out = spec_accept(state, logits, drafts, dlogits,
                                         spec_on, rem, sampled, tok_ok,
                                         kernel=kern)
        if gp is not None:
            # the automaton over the EMITTED tokens only (out[:, :inc]):
            # accepted drafts passed tok_ok and corrections come from the
            # masked rows, so every consumed transition is a real one
            gnew = state.gstate
            for j in range(k + 1):
                gnew = grammar_advance(gp, state.gidx, gnew, out[:, j],
                                       j < inc)
            state.gstate.copy_(gnew)
        new_cur = (pos0 + inc).to(torch.int32)
        tgt.close(kv, view, pos0, k + 1, active, new_cur)
        dkv.cursor.copy_(new_cur)
        state.last_tok.copy_(torch.where(active, x, state.last_tok))
        state.counts.add_(inc)
        state.pos.add_(inc)
        packed = torch.cat([inc[:, None], a_raw[:, None], out], 1)
        if n_lp:
            return (state, kv, dkv, packed) + top_logprobs(logits, n_lp)
        return state, kv, dkv, packed

    return SlotDecode(**progs, init_draft=dft.init,
                      draft_prefill=draft_prefill, draft_extend=draft_extend,
                      draft_evict=draft_evict, draft_arm=draft_arm,
                      draft_track=draft_track, draft_propose=draft_propose,
                      spec_verify=spec_verify, draft_paged=pg_d)
