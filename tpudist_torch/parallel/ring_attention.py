"""Ring attention over the ``seq`` mesh axis — the counterpart of
:mod:`tpudist.parallel.ring_attention`.

The sequence is cut into ``N`` equal shards, one a place on the ring.  Each
place holds its shard's Q, K and V; K and V travel the ring (one
``ring.hop`` a step, :mod:`tpudist_torch.parallel.ring`) while each place
folds the blocks that reach it into its own queries' attention.  The ring
is differentiable end to end: the same code trains.

Two shard-local bodies, as in the JAX package:

- :func:`ring_attention_shard` — the plain body: the ``(m, l, o)``
  online-softmax carry over each arriving block (optionally in
  ``inner_block``-wide sub-blocks whose forward the backward recomputes),
  every block computed and masked.  The CPU runs it; nothing on the card's
  main path does.
- :func:`ring_attention_shard_flash` — every hop a complete attention over
  its block through the hand-written flash kernels
  (:func:`tpudist_torch.ops.flash_attention_with_lse` with an f32 output),
  the partials merged through their logsumexps in f32
  (:func:`_merge_partials`).  Causally dead hops launch nothing; a sliding
  window turns a later hop into the band ``(None, window − step·shard)``
  and stops the ring where the band leaves every shard.  The backward is
  the autodiff of the hops and merges, through the lse cotangent of
  :class:`tpudist_torch.ops.FlashAttention`, as in JAX.

The zigzag layout (:func:`zigzag_indices`) balances the causal ring: place
``i`` holds half-chunks ``i`` and ``2N−1−i`` and every (place, hop) costs
the same.  :func:`ring_attention_shard_zigzag` is its plain body;
:func:`ring_attention_shard_zigzag_flash` its kernel body.

Shapes are the JAX package's: ``[batch, heads, tokens, head_dim]`` with
``tokens`` this process's shards laid end to end (all ``N`` on a
:class:`~tpudist_torch.parallel.ring.LocalRing`, one on a
:class:`~tpudist_torch.parallel.ring.ProcessGroupRing`).  Grouped-query
K/V travel the ring un-repeated.  :class:`SeqLayout` is the data path's
side: which tokens of a data row this process holds, their global
positions and next-token targets, and the loss scale that makes the mean
over every rank the global batch's.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from tpudist_torch.models.transformer import (attention_reference,
                                              lm_loss_with_targets)
from tpudist_torch.ops import flash_attention_with_lse

__all__ = ["SeqLayout", "attention_reference", "make_ring_attention",
           "make_zigzag_lm_loss", "make_zigzag_ring_attention",
           "ring_attention_shard", "ring_attention_shard_flash",
           "ring_attention_shard_zigzag", "ring_attention_shard_zigzag_flash",
           "zigzag_indices"]

# Finite stand-in for -inf: keeps exp() NaN-free when a whole row is masked
# (a fully-masked KV block contributes exp(NEG - m_finite) == 0).
_MASK_VALUE = -1e30


def _check_window(causal: bool, window: Optional[int]) -> None:
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _check_inner_block(inner_block: Optional[int], shard: int) -> None:
    if inner_block is not None and shard % inner_block:
        raise ValueError(
            f"inner_block {inner_block} must divide seq shard {shard}")


def _shards(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``t [b, h, n·shard, d]`` as ``n`` contiguous ``[b, h, shard, d]``."""
    if t.shape[-2] % n:
        raise ValueError(f"{t.shape[-2]} tokens do not divide into {n} "
                         f"equal seq shards")
    return [s.contiguous() for s in t.chunk(n, dim=-2)]


def _kv_group(q, k) -> int:
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of "
                         f"kv heads {k.shape[1]}")
    return q.shape[1] // k.shape[1]


def _repeat(t: torch.Tensor, group: int) -> torch.Tensor:
    return t if group == 1 else t.repeat_interleave(group, dim=1)


def _block_update(q, k, v, m, l, o, *, scale, mask=None):
    """One online-softmax accumulation step over a KV block.

    ``m`` row-max, ``l`` normalizer sum, ``o`` unnormalized output — the
    (m, l, o) running triple of blockwise/flash attention, f32 whatever the
    input dtype (products of input-dtype operands accumulated in f32)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(_MASK_VALUE, device=s.device))
    m_new = torch.maximum(m, s.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, o_new


def _causal_mask(q_off: int, k_off: int, bq: int, bk: int, window=None,
                 device=None):
    q_pos = q_off + torch.arange(bq, device=device)[:, None]
    k_pos = k_off + torch.arange(bk, device=device)[None]
    keep = q_pos >= k_pos
    if window is not None:
        keep = keep & (q_pos - k_pos < window)
    return keep


def _fresh(q: torch.Tensor):
    """The empty (m, l, o) carry of ``q``'s rows."""
    return (torch.full(q.shape[:-1], _MASK_VALUE, dtype=torch.float32,
                       device=q.device),
            torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device),
            torch.zeros(q.shape, dtype=torch.float32, device=q.device))


def ring_attention_shard(q, k, v, ring, *, causal: bool = False,
                         inner_block: Optional[int] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """The plain ring body (the JAX ``ring_attention_shard``).

    Shard ``i``'s K/V travel the ring; at step ``t`` the shard at place
    ``i`` folds in the block that started at place ``(i − t) mod N``, so
    step 0 is its own (diagonal) block, never fully masked under causal
    attention.  ``inner_block``: each step's KV shard is consumed in
    ``inner_block``-wide sub-blocks, each a checkpointed update (the
    backward recomputes its scores), so at most ``[shard, inner_block]``
    scores live at once.  ``window`` (causal only): the band ``q − k <
    window``, and the ring stops once it has left every shard."""
    n, places = ring.size, ring.indices
    qs, ks, vs = (_shards(t, len(places)) for t in (q, k, v))
    shard = qs[0].shape[-2]
    scale = q.shape[-1] ** -0.5
    group = _kv_group(q, k)
    _check_window(causal, window)
    _check_inner_block(inner_block, shard)

    def consume(qj, q_off, kv_idx, kt, vt, carry):
        kt, vt = _repeat(kt, group), _repeat(vt, group)
        if inner_block is None:
            mask = _causal_mask(q_off, kv_idx * shard, shard, shard, window,
                                q.device) if causal else None
            return _block_update(qj, kt, vt, *carry, scale=scale, mask=mask)
        from torch.utils.checkpoint import checkpoint

        for sub in range(shard // inner_block):
            cols = slice(sub * inner_block, (sub + 1) * inner_block)
            mask = _causal_mask(q_off, kv_idx * shard + sub * inner_block,
                                shard, inner_block, window,
                                q.device) if causal else None
            carry = checkpoint(
                functools.partial(_block_update, scale=scale, mask=mask),
                qj, kt[..., cols, :], vt[..., cols, :], *carry,
                use_reentrant=False)
        return carry

    carries = [_fresh(qj) for qj in qs]
    for step in range(n):
        for j, place in enumerate(places):
            carries[j] = consume(qs[j], place * shard, (place - step) % n,
                                 ks[j], vs[j], carries[j])
        if window is not None and window - (step + 1) * shard <= -(shard - 1):
            # Sliding window: every later hop is fully masked for every
            # place (un-wrapped hops sit left of the band at the offset
            # (step+1)·shard; wrapped hops are causally dead): stop.
            break
        if step + 1 < n:
            ks, vs = ring.hop(ks, vs)
    out = torch.cat([(o / l[..., None]).to(q.dtype) for _, l, o in carries],
                    dim=-2)
    return ring.finish(out, ks, vs)


def _merge_partials(out_c, lse_c, out_h, lse_h):
    """Exact, stabilized merge of two attention partials over disjoint KV
    sets, each given as (normalized out, row logsumexp): the merged lse is
    their ``logaddexp`` and each output weighs in by ``exp(lse − merged)``.
    Fully-masked partials (lse == _MASK_VALUE, out == 0) merge to a no-op.
    All f32."""
    lse_new = torch.logaddexp(lse_c, lse_h)
    w_c = torch.exp(lse_c - lse_new)[..., None]
    w_h = torch.exp(lse_h - lse_new)[..., None]
    return torch.addcmul(out_c * w_c, out_h, w_h), lse_new


def ring_attention_shard_flash(q, k, v, ring, *, causal: bool = False,
                               block_q: int = 128, block_k: int = 128,
                               window: Optional[int] = None) -> torch.Tensor:
    """The ring body whose per-hop math is the flash kernels (the JAX
    ``ring_attention_shard_flash``).

    Hop 0 is each shard's own block: the causal kernel (windowed if asked).
    Under causal attention a later hop is either wholly in the past of the
    shard (the block started at a lower place: the unmasked kernel, or the
    band ``(None, window − step·shard)`` shifted by the hop's offset) or
    wholly in its future (dead: nothing launched, though the hop itself
    still runs).  Each hop's output comes back in f32 with its lse and is
    merged in f32.  The kernels take any shard length, so no fit check
    sends a shard to the plain body (the JAX body's fallback); ``block_q``
    and ``block_k`` only tile the plain versions on the CPU."""
    _check_window(causal, window)
    n, places = ring.size, ring.indices
    qs, ks, vs = (_shards(t, len(places)) for t in (q, k, v))
    _kv_group(q, k)
    shard = qs[0].shape[-2]
    parts = [flash_attention_with_lse(qj, kj, vj, causal, block_q, block_k,
                                      True, window)
             for qj, kj, vj in zip(qs, ks, vs)]
    for step in range(1, n):
        if window is not None and window - step * shard <= -(shard - 1):
            # the band ends before this hop's block for every place, and
            # later hops lie further left still: the ring stops here
            break
        ks, vs = ring.hop(ks, vs)
        band = (None, window - step * shard) if window is not None else None
        for j, place in enumerate(places):
            if causal and (place - step) % n >= place:
                continue  # a block from the future: dead, nothing launched
            part = flash_attention_with_lse(qs[j], ks[j], vs[j], False,
                                            block_q, block_k, True, band)
            parts[j] = _merge_partials(*parts[j], *part)
    out = torch.cat([o for o, _ in parts], dim=-2).to(q.dtype)
    return ring.finish(out, ks, vs)


def _check_kernel(kernel: str) -> None:
    if kernel not in ("auto", "xla", "flash"):
        raise ValueError(f"kernel must be auto|xla|flash, got {kernel!r}")


def _uses_flash(kernel: str, device: torch.device) -> bool:
    """``auto``: the kernel body on CUDA tensors, the plain body on the
    CPU's."""
    return kernel == "flash" or (kernel == "auto" and device.type == "cuda")


def _ring_of(mesh):
    ring = getattr(mesh, "ring", mesh)
    if ring is None:
        raise ValueError("the mesh has no seq axis to ring over")
    return ring


def make_ring_attention(mesh, *, causal: bool = False,
                        inner_block: Optional[int] = None,
                        kernel: str = "auto", block_q: int = 128,
                        block_k: int = 128, window: Optional[int] = None):
    """Ring attention over the ``seq`` axis of ``mesh`` (a
    :class:`~tpudist_torch.runtime.mesh.Mesh` with a seq axis, or a ring
    itself): ``attn(q, k, v)`` over this process's shards.

    ``kernel`` selects the shard-local math: ``'xla'`` the plain carry body
    (:func:`ring_attention_shard`), ``'flash'`` the kernel body
    (:func:`ring_attention_shard_flash`; on the CPU it runs the kernels'
    plain versions), ``'auto'`` the kernel body on CUDA tensors and the
    plain body on the CPU's.  ``inner_block`` keeps its divisibility check
    on both; the plain body consumes each block in sub-blocks of that
    width, while the kernel body's tiles already bound the score memory to
    a tile, so there it changes nothing else.  The returned function carries
    the ``window`` tag and ``supports_gqa``: grouped K/V travel the ring
    un-repeated."""
    ring = _ring_of(mesh)
    _check_kernel(kernel)
    _check_window(causal, window)

    def attn(q, k, v):
        if _uses_flash(kernel, q.device):
            _check_inner_block(inner_block, q.shape[-2] // len(ring.indices))
            return ring_attention_shard_flash(
                q, k, v, ring, causal=causal, block_q=block_q,
                block_k=block_k, window=window)
        return ring_attention_shard(q, k, v, ring, causal=causal,
                                    inner_block=inner_block, window=window)

    attn.window = window
    attn.supports_gqa = True
    return attn


# ---------------------------------------------------------------------------
# Zigzag (causal-balanced) ring layout
# ---------------------------------------------------------------------------

def zigzag_indices(seq_len: int, n_shards: int) -> np.ndarray:
    """Token permutation for the zigzag causal-balanced ring layout.

    The sequence splits into ``2n`` half-chunks; ring position ``i`` holds
    half-chunks ``i`` and ``2n−1−i``.  Returns the gather indices ``π``
    (int32) such that ``x[..., π, :]`` is the zigzag-ordered sequence whose
    contiguous ``seq_len/n``-wide shards land one a ring place.  Invert
    with ``np.argsort(π)``."""
    if seq_len % (2 * n_shards):
        raise ValueError(
            f"seq {seq_len} must divide into 2*{n_shards} half-chunks")
    half = seq_len // (2 * n_shards)
    order = []
    for i in range(n_shards):
        order += [i, 2 * n_shards - 1 - i]
    chunks = [np.arange(c * half, (c + 1) * half) for c in order]
    return np.concatenate(chunks).astype(np.int32)


def _zigzag_shapes(q, k):
    shard = q.shape[-2]
    if shard % 2:
        raise ValueError(f"zigzag shard must be even, got {shard}")
    return shard // 2, _kv_group(q, k)


def ring_attention_shard_zigzag(q, k, v, ring) -> torch.Tensor:
    """Causal ring attention over the ZIGZAG layout, the plain body (the
    JAX ``ring_attention_shard_zigzag``).

    Each place's shard is half-chunks ``(i, 2n−1−i)``.  At hop ``t`` the
    block of place ``j = (i − t) mod n`` arrives: my high half attends its
    low half, always live and unmasked; exactly one of (my low × its low,
    live iff ``j < i``; my high × its high, live iff ``j > i``) is live;
    hop 0 adds the two triangular diagonal blocks.  Causal only."""
    n, places = ring.size, ring.indices
    qs, ks, vs = (_shards(t, len(places)) for t in (q, k, v))
    half, group = _zigzag_shapes(qs[0], ks[0])
    scale = q.shape[-1] ** -0.5
    diag = _causal_mask(0, 0, half, half, device=q.device)
    lo = [_fresh(qj[..., :half, :]) for qj in qs]
    hi = [_fresh(qj[..., half:, :]) for qj in qs]
    for t in range(n):
        for j, my in enumerate(places):
            q_lo, q_hi = qs[j][..., :half, :], qs[j][..., half:, :]
            kf, vf = _repeat(ks[j], group), _repeat(vs[j], group)
            k_lo, k_hi = kf[..., :half, :], kf[..., half:, :]
            v_lo, v_hi = vf[..., :half, :], vf[..., half:, :]
            if t == 0:
                lo[j] = _block_update(q_lo, k_lo, v_lo, *lo[j], scale=scale,
                                      mask=diag)
                hi[j] = _block_update(q_hi, k_lo, v_lo, *hi[j], scale=scale)
                hi[j] = _block_update(q_hi, k_hi, v_hi, *hi[j], scale=scale,
                                      mask=diag)
                continue
            hi[j] = _block_update(q_hi, k_lo, v_lo, *hi[j], scale=scale)
            if (my - t) % n < my:
                lo[j] = _block_update(q_lo, k_lo, v_lo, *lo[j], scale=scale)
            else:
                hi[j] = _block_update(q_hi, k_hi, v_hi, *hi[j], scale=scale)
        if t + 1 < n:
            ks, vs = ring.hop(ks, vs)
    out = torch.cat([torch.cat([(o / l[..., None]).to(q.dtype)
                                for _, l, o in (lo[j], hi[j])], dim=-2)
                     for j in range(len(places))], dim=-2)
    return ring.finish(out, ks, vs)


def ring_attention_shard_zigzag_flash(q, k, v, ring, *, block_q: int = 128,
                                      block_k: int = 128) -> torch.Tensor:
    """The zigzag ring whose per-hop math is the flash kernels.

    In the layout's array order a shard's own block is plain causal (its low
    queries never see its high keys, its high queries see all its low keys),
    so hop 0 is one causal launch.  At a later hop the block of place ``j``
    arrives: if ``j < i`` every query of the shard attends its low half
    unmasked (my high × its high is dead), else my high half attends the
    whole block unmasked (my low × anything is dead) — one launch of
    ``shard × shard/2`` pairs either way, so every hop costs the same
    everywhere.  Partials merge in f32 as in
    :func:`ring_attention_shard_flash` (the second kind into the high half
    only)."""
    n, places = ring.size, ring.indices
    qs, ks, vs = (_shards(t, len(places)) for t in (q, k, v))
    half, _ = _zigzag_shapes(qs[0], ks[0])
    parts = [flash_attention_with_lse(qj, kj, vj, True, block_q, block_k,
                                      True)
             for qj, kj, vj in zip(qs, ks, vs)]
    for t in range(1, n):
        ks, vs = ring.hop(ks, vs)
        for j, my in enumerate(places):
            out, lse = parts[j]
            if (my - t) % n < my:
                part = flash_attention_with_lse(
                    qs[j], ks[j][..., :half, :].contiguous(),
                    vs[j][..., :half, :].contiguous(), False, block_q,
                    block_k, True)
                parts[j] = _merge_partials(out, lse, *part)
                continue
            out_h, lse_h = flash_attention_with_lse(
                qs[j][..., half:, :].contiguous(), ks[j], vs[j], False,
                block_q, block_k, True)
            o_hi, l_hi = _merge_partials(out[..., half:, :], lse[..., half:],
                                         out_h, lse_h)
            parts[j] = (torch.cat([out[..., :half, :], o_hi], dim=-2),
                        torch.cat([lse[..., :half], l_hi], dim=-1))
    out = torch.cat([o for o, _ in parts], dim=-2).to(q.dtype)
    return ring.finish(out, ks, vs)


def make_zigzag_ring_attention(mesh, *, kernel: str = "auto",
                               block_q: int = 128, block_k: int = 128):
    """Zigzag ring attention (causal) over the ``seq`` axis of ``mesh``.

    Consumes and produces tokens in the ZIGZAG order: permute them with
    :func:`zigzag_indices` at the data layer (the positions travel with
    the tokens) and the loss (:func:`make_zigzag_lm_loss`) needs no
    unpermute.  ``kernel`` as :func:`make_ring_attention`: on CUDA the
    flash body, on the CPU the plain one."""
    ring = _ring_of(mesh)
    _check_kernel(kernel)

    def attn(q, k, v):
        if _uses_flash(kernel, q.device):
            return ring_attention_shard_zigzag_flash(
                q, k, v, ring, block_q=block_q, block_k=block_k)
        return ring_attention_shard_zigzag(q, k, v, ring)

    attn.window = None
    attn.supports_gqa = True
    return attn


def _next_token_map(order: np.ndarray, seq_len: int):
    """For tokens at temporal positions ``order`` of a ``seq_len`` row:
    the temporal position of each token's successor (clamped to the row)
    and whether it has one."""
    nxt = order.astype(np.int64) + 1
    return np.minimum(nxt, seq_len - 1), nxt < seq_len


def make_zigzag_lm_loss(seq_len: int, n_shards: int):
    """Next-token LM loss for a zigzag-permuted token stream (the JAX
    ``make_zigzag_lm_loss``): ``loss_fn(logits, tokens)`` over the whole
    permuted row, targets gathered from the permuted tokens themselves and
    the final temporal position masked; equal to :func:`lm_loss` on the
    natural order."""
    pi = zigzag_indices(seq_len, n_shards)
    inv = np.argsort(pi)
    nxt, has = _next_token_map(pi, seq_len)
    nxt_idx = torch.as_tensor(np.where(has, inv[nxt], 0), dtype=torch.long)
    mask = torch.as_tensor(has)

    def loss_fn(logits, tokens):
        targets = torch.where(mask[None, :].to(tokens.device),
                              tokens[:, nxt_idx.to(tokens.device)].long(),
                              torch.full_like(tokens, -1, dtype=torch.long))
        return lm_loss_with_targets(logits, targets)

    return loss_fn


class SeqLayout:
    """A data row's ``[batch, seq_len]`` tokens over the ``seq`` axis of
    ``ring``: the JAX demo's ``place()`` (zigzag permutation, then the seq
    sharding) as the data path's side of the ring.

    ``positions`` are the global (temporal) positions of this process's
    tokens, in the order they lie: ``place·shard + arange(shard)`` for each
    of its places in natural order, the zigzag permutation's under
    ``zigzag``.  :meth:`place` cuts a row batch into this process's tokens
    and their next-token targets, built in temporal order (the final
    temporal position masked with −1), so a shard's last token predicts the
    next shard's first.  :meth:`loss` is :func:`lm_loss_with_targets`
    scaled so that the mean over every rank of the process group (DDP's
    average) is the global batch's mean: each rank's share of the targets
    counted against the global count, not its own."""

    def __init__(self, ring, seq_len: int, zigzag: bool = False):
        n = ring.size
        if seq_len % n:
            raise ValueError(f"seq_len {seq_len} must divide over the {n} "
                             f"seq shards")
        self.ring, self.seq_len, self.zigzag = ring, seq_len, zigzag
        self.shard = seq_len // n
        order = (zigzag_indices(seq_len, n) if zigzag
                 else np.arange(seq_len, dtype=np.int32))
        cols = np.concatenate([np.arange(p * self.shard, (p + 1) * self.shard)
                               for p in ring.indices])
        self.positions = order[cols].astype(np.int64)
        self._next, self._has_next = _next_token_map(self.positions, seq_len)
        # this rank's targets a row against every rank's of its data row
        self.loss_scale = (int(self._has_next.sum()) * ring.processes
                           / (seq_len - 1))

    def place(self, batch: np.ndarray):
        """``(tokens, targets)`` of this process for a row batch ``[b,
        seq_len]`` in temporal order: int32 tokens at :attr:`positions`,
        int64 targets (−1 at the final temporal position)."""
        batch = np.asarray(batch)
        if batch.ndim != 2 or batch.shape[1] != self.seq_len:
            raise ValueError(f"a row batch is [batch, {self.seq_len}], got "
                             f"{batch.shape}")
        tokens = batch[:, self.positions].astype(np.int32)
        targets = np.where(self._has_next[None], batch[:, self._next],
                           -1).astype(np.int64)
        return tokens, targets

    def loss(self, logits: torch.Tensor, targets: torch.Tensor):
        """This rank's share of the global mean next-token loss."""
        return lm_loss_with_targets(logits, targets) * self.loss_scale
