"""Decoder-only Transformer LM — the PyTorch counterpart of
:mod:`tpudist.models.transformer`.

The same pre-LN, bias-free block (LayerNorm in f32 with flax's defaults:
epsilon 1e-6, variance ``E[x²] − E[x]²``; tanh-approximate GELU; rotary
GPT-NeoX half-split positions or a learned table) over three attention arms,
chosen by the attention context the caller passes:

- ``None`` — the training-mode forward over the whole sequence: on CUDA the
  hand-written flash kernels (:class:`tpudist_torch.ops.FlashAttention`,
  forward and backward, native GQA, the model's sliding window); on the CPU
  the dense causal softmax (:func:`attention_reference`, K/V broadcast to
  every q head);
- :class:`PagedDecode` — the serving decode arm: this call's K/V go to a
  small per-layer window buffer and attention runs through the paged decode
  kernel (:func:`tpudist_torch.ops.paged_attention`), which walks the block
  pool in place;
- :class:`PagedPrefill` — the serving prefill arm: multi-token chunks per
  slot attend over their pool prefix plus themselves through the paged
  prefill kernel, which also returns the touched KV blocks (kept on the
  context for the caller to commit).

The two serving arms carry two more seams:

- ``fused_rope`` — the QKV projection, the head split and the rotation run
  as one kernel (:func:`tpudist_torch.ops.fused_rope_qkv`) at the arm's
  per-slot offsets (the decode cursors, the prefill chunk starts), and the
  arm skips its own rotation.  The training arm keeps the unfused
  projection and raises for it, as the JAX package does;
- ``adapters`` — per-tenant LoRA (:func:`tpudist_torch.models.lora.
  pool_collection`): the qkv, wi and wo outputs become ``where(on, y +
  (x·A)·B, y)`` with the delta from the LoRA gather-matmul kernel
  (:func:`tpudist_torch.ops.lora_delta`); an off lane is the base tensor
  bit for bit.

The FFN is the dense ``wi``/``wo`` pair, or, with ``n_experts > 0``, a
routed MoE (:class:`MoEFFN`: the expert-parallel layer ``moe_fn`` of
:func:`tpudist_torch.parallel.make_moe`, else :func:`dense_moe_reference`;
every serving context runs the dense reference, as the JAX decode modules
clone ``moe_fn`` away), or an injected ``mlp_fn(params, x)`` over the
pair's kernels (the overlapped FSDP MLP,
:func:`tpudist_torch.parallel.overlap_fsdp_mlp`).  The
MoE layers' statistics of a forward are collected by :func:`sown_stats`
(the JAX model's sown ``intermediates``).

Weights live in ``param_dtype`` (default: the compute dtype ``dtype``) and
are cast to ``dtype`` where they are used, as flax's ``nn.Dense(dtype=...)``
and ``nn.Embed(dtype=...)`` cast their f32 masters at apply; LayerNorm scales
stay f32.  Serving builds the model in its compute dtype (the casts are
no-ops); training keeps f32 masters under bf16 compute
(``param_dtype=float32, dtype=bfloat16``), so gradients land in f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch.ops import (FlashAttention, fused_rope_qkv, lora_delta,
                               paged_attention, paged_prefill_attention)

_MASK_VALUE = -1e30


def rope_freqs(half: int, base: float = 10000.0, device=None):
    """The ``half`` rotation frequencies ``base ** (-j / half)`` in f32, as
    :func:`rope_rotate` forms them (the fused RoPE+QKV kernel's split and
    wgmma arms read this table)."""
    expo = -torch.arange(half, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(base, dtype=torch.float32, device=device),
                     expo / torch.full_like(expo, half))


def rope_rotate(x: torch.Tensor, base: float = 10000.0, offset=0):
    """Rotary embedding over ``[batch, heads, seq, head_dim]`` (GPT-NeoX
    half split, f32 angles).  ``offset`` is a scalar or a ``[batch]``
    vector of per-lane start positions."""
    half = x.shape[-1] // 2
    dev = x.device
    freqs = rope_freqs(half, base, dev)
    off = torch.as_tensor(offset, device=dev).to(torch.float32)
    positions = off[..., None] + torch.arange(
        x.shape[-2], dtype=torch.float32, device=dev)
    angles = positions[..., None] * freqs               # [(b,) s, half]
    if off.dim():
        angles = angles[:, None]                        # [b, 1, s, half]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """flax ``nn.LayerNorm(use_bias=False, dtype=float32)``."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    mean2 = (x * x).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * scale)


def moe_expert_fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The MoE FFN's expert, ``relu(x·w)·wo`` — shared by the
    expert-parallel layer (:func:`tpudist_torch.parallel.make_moe`) and
    :func:`dense_moe_reference`, as in the JAX package."""
    return torch.relu(tokens @ params["w"]) @ params["wo"]


def dense_moe_reference(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Every expert on every token, combined by the top-1 gate (routing in
    f32, the experts in the compute dtype): the MoE FFN without a
    ``moe_fn``, equal to the expert-parallel layer's top-1 output when no
    token overflows capacity.  Ties go to the lower expert index."""
    probs = torch.softmax((tokens @ params["router"]).float(), dim=-1)
    idx = probs.argmax(dim=-1)
    gate = probs.gather(-1, idx[:, None])[:, 0]
    h = torch.relu(torch.einsum("td,edf->tef", tokens,
                                params["experts"]["w"]))
    y_all = torch.einsum("tef,efd->ted", h, params["experts"]["wo"])
    pick = F.one_hot(idx, probs.shape[-1]).to(tokens.dtype)
    return torch.einsum("ted,te->td", y_all,
                        pick * gate.to(tokens.dtype)[:, None])


class MoEFFN(nn.Module):
    """The routed FFN of a block with ``n_experts > 0`` (the JAX
    ``MoEFFN``): ``router [d, E]``, ``w [E, d, d_ff]`` and ``wo [E, d_ff,
    d]``, stored as the JAX package holds them and cast to the compute
    dtype where they are used.  ``moe_fn`` (:func:`tpudist_torch.parallel.
    make_moe`) runs the expert-parallel layer and returns its
    :class:`~tpudist_torch.parallel.MoEStats`; without it the dense
    reference runs and there are no stats."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 moe_fn: Optional[Callable], dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.n_experts, self.moe_fn, self.dtype = n_experts, moe_fn, dtype
        self.router = nn.Parameter(torch.empty(d_model, n_experts,
                                               dtype=param_dtype))
        self.w = nn.Parameter(torch.empty(n_experts, d_model, d_ff,
                                          dtype=param_dtype))
        self.wo = nn.Parameter(torch.empty(n_experts, d_ff, d_model,
                                           dtype=param_dtype))

    def forward(self, h: torch.Tensor, dense: bool = False):
        """``(y, stats)`` of ``h [b, s, d]``; ``dense`` runs the dense
        reference whatever ``moe_fn`` is (the serving forwards)."""
        b, s, d = h.shape
        dt = self.dtype
        params = {"router": self.router.to(dt),
                  "experts": {"w": self.w.to(dt), "wo": self.wo.to(dt)}}
        tokens = h.reshape(b * s, d).to(dt)
        if self.moe_fn is None or dense:
            return dense_moe_reference(params, tokens).reshape(b, s, d), None
        y, stats = self.moe_fn(params, tokens)
        return y.reshape(b, s, d), stats


@contextlib.contextmanager
def sown_stats(model: nn.Module):
    """Collect the MoE statistics of the forwards of ``model`` run inside:
    yields a list that each MoE layer appends its
    :class:`~tpudist_torch.parallel.MoEStats` to, in layer order (the JAX
    model's ``intermediates``; a dense model appends nothing)."""
    sown: list = []
    blocks = [b for b in getattr(model, "blocks", ()) if hasattr(b, "sow")]
    for b in blocks:
        b.sow = sown
    try:
        yield sown
    finally:
        for b in blocks:
            b.sow = None


def attention_reference(q, k, v, *, causal: bool = False,
                        window: Optional[int] = None):
    """Plain softmax attention over ``[batch, heads, seq, head_dim]`` — the
    single-device ground truth (the JAX ``tpudist.parallel.
    attention_reference``): f32 scores and softmax, weights cast back to
    ``v``'s dtype.  ``causal`` masks ``q < k``; ``window`` (requires
    ``causal``) bands to ``q - k < window``."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if causal:
        T, K = scores.shape[-2], scores.shape[-1]
        qi = torch.arange(T, device=q.device)[:, None]
        kj = torch.arange(K, device=q.device)[None]
        keep = qi >= kj
        if window is not None:
            keep = keep & (qi - kj < window)
        scores = torch.where(keep, scores,
                             torch.tensor(_MASK_VALUE, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype).float(),
                        v.float()).to(q.dtype)


class _Causal:
    """Training-mode attention arm at positions ``0..T-1``: the flash
    kernels on CUDA (grouped K/V consumed natively), the dense causal
    softmax with K/V broadcast to every q head on the CPU.  No adapters;
    the fused RoPE+QKV projection is a serving-arm seam (``fused_rope``
    set here raises in :meth:`rope_offsets`)."""

    fused_rope = False
    adapters = None
    #: an MoE block runs its ``moe_fn`` here; every other context (the
    #: serving arms) runs the dense reference.  Off on an instance, the
    #: training forward is the JAX ``moe_fn=None`` clone's
    moe_routed = True

    def __init__(self, rope: bool, window: Optional[int]):
        self.rope = rope
        self.window = window

    def positions(self, batch: int, seq: int, device) -> torch.Tensor:
        return torch.arange(seq, device=device)[None].expand(batch, seq)

    def rope_offsets(self) -> torch.Tensor:
        raise ValueError(
            "fused_rope fuses the QKV projection with the per-slot rope "
            "offsets of the paged decode/prefill arms — training keeps the "
            "unfused projection")

    def attend(self, layer: int, q, k, v, rotated: bool = False):
        if self.rope and not rotated:
            q, k = rope_rotate(q), rope_rotate(k)
        if q.device.type == "cuda":
            out, _ = FlashAttention.apply(q.contiguous(), k.contiguous(),
                                          v.contiguous(), True, self.window)
            return out
        group = q.shape[1] // k.shape[1]
        if group > 1:
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        return attention_reference(q, k, v, causal=True, window=self.window)


class RingCausal(_Causal):
    """Training-mode attention arm over this process's shards of a
    sequence-parallel run (the JAX model's ``positions`` argument with an
    injected layout-aware attention, ``tpudist/models/transformer.py:
    709-732``).  ``attention`` is a ring (:func:`tpudist_torch.parallel.
    make_ring_attention` or :func:`~tpudist_torch.parallel.
    make_zigzag_ring_attention`) over ``[batch, heads, tokens, dh]``;
    ``positions`` are the global positions of the tokens this process holds
    (:attr:`tpudist_torch.parallel.SeqLayout.positions`), which the learned
    table reads and RoPE rotates by.  The model's own ``sliding_window`` is
    not read: the window lives inside the ring, as in JAX."""

    def __init__(self, rope: bool, attention, positions):
        super().__init__(rope, getattr(attention, "window", None))
        self.attention = attention
        pos = torch.as_tensor(positions, dtype=torch.long)
        self._positions = pos
        start = int(pos[0])
        if rope and not torch.equal(pos, torch.arange(start, start + len(pos))):
            raise ValueError("rope rotates by contiguous positions: a "
                             "permuted layout (zigzag) needs the learned "
                             "position table")
        self.rope_start = start

    def positions(self, batch: int, seq: int, device) -> torch.Tensor:
        if seq != len(self._positions):
            raise ValueError(f"{seq} tokens given to a ring context of "
                             f"{len(self._positions)}")
        return self._positions.to(device)[None].expand(batch, seq)

    def attend(self, layer: int, q, k, v, rotated: bool = False):
        if self.rope and not rotated:
            q = rope_rotate(q, offset=self.rope_start)
            k = rope_rotate(k, offset=self.rope_start)
        return self.attention(q.contiguous(), k.contiguous(), v.contiguous())


def cached_attention(q, ck, cv, qpos, window: Optional[int]):
    """Attention of ``q [b, nh, s, dh]`` over a dense cache ``ck``/``cv
    [b, n_kv, max_len, dh]`` (grouped: the cache is read un-repeated), query
    ``i`` of lane ``b`` over positions ``<= qpos[b, i]`` within the sliding
    ``window``: f32 scores and softmax, the weights cast to the cache dtype
    (the JAX ``Block._decode_attention``)."""
    b, nh, s, dh = q.shape
    n_kv, max_len = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, n_kv, nh // n_kv, s, dh).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, ck.float()) * (dh ** -0.5)
    kpos = torch.arange(max_len, device=q.device)
    live = kpos <= qpos[..., None]                              # [b, s, K]
    if window is not None:
        live = live & (kpos > qpos[..., None] - window)
    scores = torch.where(live[:, None, None], scores,
                         torch.tensor(_MASK_VALUE, device=q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqk,bnkd->bngqd", w.to(cv.dtype).float(),
                       cv.float())
    return out.reshape(b, nh, s, dh).to(q.dtype)


class CacheFullError(RuntimeError):
    """A decode step was asked to write past ``max_len``: the dense KV
    cache is full (:class:`DenseDecode`; ``generate`` checks its budget up
    front)."""


class DenseDecode:
    """The sequential decode arm over a dense KV cache (the JAX package's
    ``Block._decode_attention``): per layer ``[batch, n_kv, max_len, dh]``
    K/V buffers in the compute dtype and one cursor ``pos`` for the whole
    batch.  Each call writes its ``s`` tokens' K/V at the cursor and every
    query attends over the filled prefix plus the call's tokens before it
    (f32 scores and softmax, the weights cast to the cache's dtype).  The
    caller advances ``pos`` by ``s`` after the forward.  Plain tensor ops:
    the JAX dense path runs no Pallas kernel either."""

    fused_rope = False
    adapters = None

    def __init__(self, model: "TransformerLM", batch: int, device):
        shape = (batch, model.n_kv, model.max_len, model.head_dim)
        self.k = [torch.zeros(shape, dtype=model.dtype, device=device)
                  for _ in range(model.n_layers)]
        self.v = [torch.zeros(shape, dtype=model.dtype, device=device)
                  for _ in range(model.n_layers)]
        self.rope = model.rope
        self.window = model.sliding_window
        self.max_len = model.max_len
        self.pos = 0

    def positions(self, batch: int, seq: int, device) -> torch.Tensor:
        return (self.pos + torch.arange(seq, device=device))[None].expand(
            batch, seq)

    def attend(self, layer: int, q, k, v, rotated: bool = False):
        pos = self.pos
        b, nh, s, dh = q.shape
        if pos + s > self.max_len:
            raise CacheFullError(
                f"KV cache full: cursor {pos} + {s} token(s) exceeds "
                f"max_len {self.max_len}")
        if self.rope and not rotated:
            q = rope_rotate(q, offset=pos)
            k = rope_rotate(k, offset=pos)
        ck, cv = self.k[layer], self.v[layer]
        ck[:, :, pos:pos + s] = k.to(ck.dtype)
        cv[:, :, pos:pos + s] = v.to(cv.dtype)
        qpos = (pos + torch.arange(s, device=q.device))[None].expand(b, s)
        return cached_attention(q, ck, cv, qpos, self.window)


class SlotDense:
    """The slot engine's dense decode arm (the JAX package's vmapped
    ``Block._decode_attention`` over batch-1 caches): ``k``/``v`` ``[L, S,
    n_kv, max_len, dh]`` in the compute dtype — the dense slot cache, or a
    view gathered from the paged pool — written IN PLACE, one cursor a lane
    ``cursor [S]`` (RoPE and learned positions at each lane's own offset),
    and ``n_write [S]``: each lane writes the K/V of its first ``n_write``
    rows at ``cursor + i`` (0 for an inactive lane, which neither writes
    nor, by its caller, advances; ``clen`` for a prefill chunk, whose
    padded rows write nothing).  Every query ``i`` attends over positions
    ``<= cursor + i`` within the sliding window (:func:`cached_attention`,
    as :class:`DenseDecode`).  ``adapters`` is the gathered
    collection (:func:`tpudist_torch.models.lora.gather_collection`).  Plain
    tensor ops: the JAX dense path runs no Pallas kernel either."""

    fused_rope = False

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 cursor: torch.Tensor, n_write: torch.Tensor, rope: bool,
                 window: Optional[int], adapters: Optional[dict] = None):
        self.k, self.v = k, v
        self.cursor = cursor.long()
        self.n_write = n_write.long()
        self.rope = rope
        self.window = window
        self.adapters = adapters

    def positions(self, batch: int, seq: int, device) -> torch.Tensor:
        return self.cursor[:, None] + torch.arange(seq, device=device)

    def attend(self, layer: int, q, k, v, rotated: bool = False):
        S, s = q.shape[0], q.shape[2]
        ck, cv = self.k[layer], self.v[layer]
        max_len = ck.shape[2]
        dev = q.device
        pos = self.cursor
        if self.rope and not rotated:
            q = rope_rotate(q, offset=pos)
            k = rope_rotate(k, offset=pos)
        # rows [0, nw) write at pos + i; the other rows rewrite the old
        # value of one position outside that range (every lane's written
        # rows are its leading ones), so duplicate targets carry one value
        nw = torch.minimum(self.n_write, (max_len - pos).clamp(min=0))
        rows = torch.arange(s, device=dev)[None]
        write = rows < nw[:, None]                                # [S, s]
        spare = ((pos + nw) % max_len)[:, None]
        cols = torch.where(write, pos[:, None] + rows, spare)
        lanes = torch.arange(S, device=dev)[:, None]
        keep = write[:, :, None, None]
        ck[lanes, :, cols] = torch.where(keep, k.to(ck.dtype).transpose(1, 2),
                                         ck[lanes, :, cols])
        cv[lanes, :, cols] = torch.where(keep, v.to(cv.dtype).transpose(1, 2),
                                         cv[lanes, :, cols])
        return cached_attention(q, ck, cv, pos[:, None] + rows, self.window)


class PagedDecode:
    """Decode arm over a paged pool, batched over the slot axis.

    ``pool`` holds ``pool_k``/``pool_v``/``scale_k``/``scale_v``/``table``
    (the whole ``[L, ...]`` pool, read in place) and ``pos0 [S]`` — the
    dispatch-start cursors, below which the pool is the live prefix.
    ``window_k``/``window_v`` are per-layer ``[S, n_kv, W, dh]`` buffers of
    this dispatch's uncommitted tokens; ``cursor [S]`` is each lane's
    absolute position.  Lanes with ``active`` False keep their buffers and
    cursor (their outputs are discarded by the caller).  ``fused_rope`` and
    ``adapters`` are the module doc's seams."""

    def __init__(self, pool: Dict[str, torch.Tensor],
                 window_k: List[torch.Tensor], window_v: List[torch.Tensor],
                 cursor: torch.Tensor, active: torch.Tensor, rope: bool,
                 window: Optional[int], fused_rope: bool = False,
                 adapters: Optional[dict] = None):
        self.pool = pool
        self.window_k = window_k
        self.window_v = window_v
        self.cursor = cursor
        self.active = active
        self.rope = rope
        self.window = window
        self.fused_rope = fused_rope
        self.adapters = adapters

    def positions(self, batch: int, seq: int, device) -> torch.Tensor:
        return self.cursor.long()[:, None] + torch.arange(seq, device=device)

    def rope_offsets(self) -> torch.Tensor:
        """Each lane's absolute position of this call's first token."""
        return self.cursor

    def attend(self, layer: int, q, k, v, rotated: bool = False):
        pool = self.pool
        pos = self.cursor
        fill = (pos - pool["pos0"]).to(torch.int32)
        if self.rope and not rotated:
            q = rope_rotate(q, offset=pos)
            k = rope_rotate(k, offset=pos)
        wk, wv = self.window_k[layer], self.window_v[layer]
        S, s = q.shape[0], q.shape[2]
        lanes = torch.arange(S, device=q.device)[:, None]
        cols = fill.long()[:, None] + torch.arange(s, device=q.device)[None]
        cols = cols.clamp(0, wk.shape[2] - 1)              # [S, s]
        keep = self.active[:, None, None, None]
        # append this call's K/V at each active lane's window offset
        wk[lanes, :, cols] = torch.where(
            keep, k.to(wk.dtype).transpose(1, 2),
            wk[lanes, :, cols])
        wv[lanes, :, cols] = torch.where(
            keep, v.to(wv.dtype).transpose(1, 2),
            wv[lanes, :, cols])
        return paged_attention(
            q.contiguous(), pool["pool_k"], pool["pool_v"], pool["scale_k"],
            pool["scale_v"], pool["table"], pool["pos0"], fill, wk, wv,
            layer=layer, window=self.window)


class PagedPrefill:
    """Prefill arm: each lane's chunk of ``P`` tokens at ``pos0`` attends
    over its pool prefix plus itself.  ``pool`` is as for
    :class:`PagedDecode` plus ``clen [S]`` and ``wtable [S, Mw]``; the
    touched blocks each layer emits collect in ``writes`` (per layer
    ``(qk, qv, sk, sv)``) for the caller to commit after the forward.
    ``fused_rope`` and ``adapters`` are the module doc's seams."""

    def __init__(self, pool: Dict[str, torch.Tensor], rope: bool,
                 window: Optional[int], fused_rope: bool = False,
                 adapters: Optional[dict] = None):
        self.pool = pool
        self.rope = rope
        self.window = window
        self.fused_rope = fused_rope
        self.adapters = adapters
        self.writes: List[tuple] = []

    def positions(self, batch: int, seq: int, device) -> torch.Tensor:
        return self.pool["pos0"].long()[:, None] + torch.arange(
            seq, device=device)

    def rope_offsets(self) -> torch.Tensor:
        """Each lane's chunk start: its first row's absolute position."""
        return self.pool["pos0"]

    def attend(self, layer: int, q, k, v, rotated: bool = False):
        pool = self.pool
        if self.rope and not rotated:
            q = rope_rotate(q, offset=pool["pos0"])
            k = rope_rotate(k, offset=pool["pos0"])
        o, qk, qv, sk, sv = paged_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), pool["pool_k"],
            pool["pool_v"], pool["scale_k"], pool["scale_v"], pool["table"],
            pool["wtable"], pool["pos0"], pool["clen"], layer=layer,
            window=self.window)
        self.writes.append((qk, qv, sk, sv))
        return o


class Block(nn.Module):
    """Pre-LN decoder block: ``x + proj(attn(LN(x)))``, then
    ``x + wo(gelu(wi(LN(x))))`` — or the routed :class:`MoEFFN` with
    ``n_experts > 0``, or ``mlp_fn({'wi': [d, d_ff], 'wo': [d_ff, d]}, x)``
    over the pair's kernels in the JAX layout (this rank's pieces of them
    when ``mlp_fn.pieces`` cuts whole weights, as the overlapped FSDP MLP
    takes).  Linear weights are stored ``[out, in]`` and cast to ``dtype``
    where they are used (``cast_weights``: the ZeRO-3 runtime gathers them
    in that dtype).  ``sow``, when a list (:func:`sown_stats`), receives
    the MoE layer's statistics of each forward."""

    cast_weights = ("qkv", "proj", "wi", "wo", "moe.router", "moe.w",
                    "moe.wo")

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 n_kv_heads: Optional[int], layer_idx: int,
                 dtype: torch.dtype, param_dtype: torch.dtype, *,
                 n_experts: int = 0, moe_fn: Optional[Callable] = None,
                 mlp_fn: Optional[Callable] = None):
        super().__init__()
        if n_experts > 0 and mlp_fn is not None:
            raise ValueError("mlp_fn replaces the dense FFN; it cannot "
                             "compose with the MoE FFN (n_experts > 0)")
        n_kv = n_heads if n_kv_heads is None else n_kv_heads
        if not 1 <= n_kv <= n_heads or n_heads % n_kv:
            raise ValueError(f"n_kv_heads {n_kv} must be in [1, {n_heads}] "
                             f"and divide n_heads {n_heads}")
        self.d_model, self.n_heads, self.n_kv = d_model, n_heads, n_kv
        self.dh = d_model // n_heads
        self.layer_idx = layer_idx
        self.dtype = dtype
        kv_dim = n_kv * self.dh
        f32, pd = torch.float32, param_dtype
        self.ln1 = nn.Parameter(torch.ones(d_model, dtype=f32))
        self.qkv = nn.Parameter(torch.empty(d_model + 2 * kv_dim, d_model,
                                            dtype=pd))
        self.proj = nn.Parameter(torch.empty(d_model, d_model, dtype=pd))
        self.ln2 = nn.Parameter(torch.ones(d_model, dtype=f32))
        self.d_ff, self.n_experts, self.mlp_fn = d_ff, n_experts, mlp_fn
        self.sow = None
        if n_experts > 0:
            self.moe = MoEFFN(d_model, d_ff, n_experts, moe_fn, dtype, pd)
        else:
            self.wi = nn.Parameter(torch.empty(d_ff, d_model, dtype=pd))
            self.wo = nn.Parameter(torch.empty(d_model, d_ff, dtype=pd))

    def _delta(self, ads: dict, h_in: torch.Tensor, proj: str):
        """The raw adapter delta ``(h·A)·B`` of one projection: through the
        LoRA gather-matmul kernel from the pool form (each lane's own
        factor block), or as two batched products in the compute dtype
        from pre-gathered factors (:func:`~tpudist_torch.models.lora.
        gather_collection`, the dense and gather programs)."""
        h = h_in.to(self.dtype)
        if "ids" not in ads:
            a = ads[f"a_{proj}"][self.layer_idx].to(self.dtype)
            b = ads[f"b_{proj}"][self.layer_idx].to(self.dtype)
            return torch.bmm(torch.bmm(h, a), b)
        return lora_delta(h.contiguous(), ads[f"a_{proj}"], ads[f"b_{proj}"],
                          ads["ids"], layer=self.layer_idx)

    def _ad(self, ads: Optional[dict], y: torch.Tensor, h_in: torch.Tensor,
            proj: str) -> torch.Tensor:
        """``where(on, y + (h·A)·B, y)`` — a select, so an off lane's
        output is the base tensor bit for bit."""
        if ads is None:
            return y
        delta = self._delta(ads, h_in, proj)
        return torch.where(ads["on"][:, None, None], y + delta, y)

    def forward(self, x: torch.Tensor, ctx) -> torch.Tensor:
        dtype = self.dtype
        b, s, _ = x.shape
        ads = getattr(ctx, "adapters", None)
        if ads is not None and (self.n_experts > 0
                                or self.mlp_fn is not None):
            raise ValueError(
                "lora_rank adapters wrap the plain qkv/wi/wo Dense path; "
                "they cannot compose with an MoE FFN or an injected mlp_fn "
                "(the fused MLP hides the wi/wo seam)")
        h = layer_norm(x, self.ln1)
        kv_dim = self.n_kv * self.dh
        if getattr(ctx, "fused_rope", False):
            offsets = ctx.rope_offsets().to(torch.int32)
            extra = on = None
            if ads is not None:
                extra, on = self._delta(ads, h, "qkv"), ads["on"]
            # the [dtot, d] weight's transposed view: read in place
            q, k, v = fused_rope_qkv(
                h.to(dtype), self.qkv.to(dtype).t(), offsets, extra, on,
                n_heads=self.n_heads, n_kv=self.n_kv, dh=self.dh,
                rope=ctx.rope)
            attn = ctx.attend(self.layer_idx, q, k, v, rotated=True)
        else:
            qkv = self._ad(ads, F.linear(h.to(dtype), self.qkv.to(dtype)),
                           h, "qkv")
            q = qkv[..., :self.d_model]
            k = qkv[..., self.d_model:self.d_model + kv_dim]
            v = qkv[..., self.d_model + kv_dim:]

            def heads(t, n):  # [b, s, n·dh] -> [b, n, s, dh]
                return t.reshape(b, s, n, self.dh).transpose(1, 2)

            attn = ctx.attend(self.layer_idx, heads(q, self.n_heads),
                              heads(k, self.n_kv), heads(v, self.n_kv))
        attn = attn.transpose(1, 2).reshape(b, s, self.d_model)
        x = x + F.linear(attn.to(dtype), self.proj.to(dtype))
        h = layer_norm(x, self.ln2)
        if self.n_experts > 0:
            y, stats = self.moe(h, dense=not getattr(ctx, "moe_routed",
                                                     False))
            if stats is not None and self.sow is not None:
                self.sow.append(stats)
            return x + y
        if self.mlp_fn is not None:
            wi, wo = self.wi.to(dtype).t(), self.wo.to(dtype).t()
            if wi.shape[1] == self.d_ff:  # whole weights: this rank's part
                wi, wo = self.mlp_fn.pieces(wi, wo)
            return x + self.mlp_fn({"wi": wi, "wo": wo}, h.to(dtype))
        y = self._ad(ads, F.linear(h.to(dtype), self.wi.to(dtype)), h, "wi")
        y = F.gelu(y, approximate="tanh")
        return x + self._ad(ads, F.linear(y, self.wo.to(dtype)), y, "wo")


class Places:
    """The attention context of a forward over ``model`` places
    (:class:`PlacedLM`): ``places[m]`` is place ``m``'s arm context (a
    :class:`PagedDecode`, :class:`PagedPrefill` or :class:`SlotDense` over
    its kv heads' slice of the KV storage),
    ``adapters[m]`` its adapter collection (None without the seam).  The
    positions and rope offsets are every place's, read from the first."""

    def __init__(self, places: list, adapters: Optional[list] = None):
        self.places = places
        self.adapters = adapters
        self.rope = places[0].rope
        self.fused_rope = getattr(places[0], "fused_rope", False)

    def positions(self, batch: int, seq: int, device) -> torch.Tensor:
        return self.places[0].positions(batch, seq, device)

    def rope_offsets(self) -> torch.Tensor:
        return self.places[0].rope_offsets()


def qkv_place_rows(d_model: int, n_heads: int, n_kv: int, dh: int,
                   places: int) -> List[torch.Tensor]:
    """The rows of a ``[dtot, d]`` qkv weight each of ``places`` places
    owns when attention splits by whole kv heads: its ``n_heads/places``
    query heads, then its ``n_kv/places`` kv heads' k rows and v rows —
    contiguous, so the place's own product yields its heads in the layout
    of a block with ``n_heads/places`` and ``n_kv/places`` heads."""
    kv_dim = n_kv * dh
    hq, hk = n_heads // places, n_kv // places
    out = []
    for i in range(places):
        q = torch.arange(i * hq * dh, (i + 1) * hq * dh)
        k = d_model + torch.arange(i * hk * dh, (i + 1) * hk * dh)
        out.append(torch.cat([q, k, k + kv_dim]))
    return out


def even_rows(n: int, places: int) -> List[torch.Tensor]:
    """``places`` contiguous, equal runs of ``range(n)``."""
    k = n // places
    return [torch.arange(i * k, (i + 1) * k) for i in range(places)]


class PlacedLM:
    """The serving forward of a :class:`TransformerLM` over ``model``
    places (:mod:`tpudist_torch.serve.spmd`): ``devices[m]`` holds place
    ``m``'s slices of the split weights, each a contiguous copy in the
    compute dtype, and makes its launches.

    Per block: LayerNorm once; each of ``attn_places`` places projects its
    q/k/v columns (:func:`qkv_place_rows`: the fused RoPE+QKV kernel at
    ``n_heads/P``, ``n_kv/P`` heads on the kernel arms) and attends over
    its kv heads' slice of the KV storage (``ctx.places[m]``); the heads
    are gathered and ``proj`` runs once.  ``wi`` is split over
    ``wi_places`` places and gathered after GELU, ``wo`` runs once — or,
    with ``mlp_fn`` (:func:`~tpudist_torch.serve.spmd.
    serve_overlap_mlp_fn`), ``wi`` and ``wo`` both split over the ring.
    An MoE block's FFN (router and expert stacks) stays whole and runs
    the dense reference once.
    ``head`` is split over ``head_places`` places and the logits gathered.
    A count of 1 keeps that piece whole: it runs once on the first place.
    Adapters split ``b_qkv`` and ``b_wi`` with their weights
    (``ctx.adapters[m]``); each place's LoRA delta reads its slice.

    The embedding, the norms, ``proj`` and the gathers run once per
    forward, not once a place: on a folded card nothing replicated is
    computed twice.  Every split column is the same dot product as the
    whole weight's, so the result is the unsplit model's wherever the
    device's GEMM rounds a column alike at both widths."""

    def __init__(self, model: "TransformerLM", devices, *,
                 attn_places: int = 1, wi_places: int = 1,
                 head_places: int = 1, wo_places: int = 1,
                 mlp_fn: Optional[Callable] = None, _blocks=None,
                 _head=None):
        if getattr(model, "mlp_fn", None) is not None:
            raise ValueError("an injected mlp_fn replaces the FFN the "
                             "serving mesh splits")
        self.model = model
        self.devices = tuple(torch.device(d) for d in devices)
        self.attn_places, self.wi_places = attn_places, wi_places
        self.head_places, self.wo_places = head_places, wo_places
        self.mlp_fn = mlp_fn
        dt = model.dtype

        def cut(w, rows):
            return [w.detach()[ix.to(w.device)].to(dt).to(dev).contiguous()
                    for ix, dev in zip(rows, self.devices)]

        if _blocks is None:
            _blocks = []
            for blk in model.blocks:
                pw = {}
                if attn_places > 1:
                    pw["qkv"] = cut(blk.qkv, qkv_place_rows(
                        blk.d_model, blk.n_heads, blk.n_kv, blk.dh,
                        attn_places))
                if wi_places > 1:
                    pw["wi"] = cut(blk.wi, even_rows(blk.d_ff, wi_places))
                if wo_places > 1:
                    pw["wo"] = cut(blk.wo, even_rows(blk.d_model,
                                                     wo_places))
                _blocks.append(pw)
        self.blocks = _blocks
        self.head = _head if _head is not None else (
            cut(model.head, even_rows(model.vocab, head_places))
            if head_places > 1 else None)

    def __getattr__(self, name):
        # the model's geometry (n_layers, n_kv, rope, max_len, ...)
        return getattr(self.__dict__["model"], name)

    def draft(self, draft: "TransformerLM") -> "PlacedLM":
        """The tied draft's places (:func:`tied_draft` of this model): its
        blocks' and head's place weights are this model's, shared."""
        return PlacedLM(draft, self.devices, attn_places=self.attn_places,
                        wi_places=self.wi_places,
                        head_places=self.head_places,
                        wo_places=self.wo_places, mlp_fn=self.mlp_fn,
                        _blocks=self.blocks[:draft.n_layers],
                        _head=self.head)

    def __call__(self, tokens: torch.Tensor, ctx: Places) -> torch.Tensor:
        m = self.model
        x = m.embed(tokens, ctx)
        for blk, pw in zip(m.blocks, self.blocks):
            x = self._block(blk, pw, x, ctx)
        x = layer_norm(x, m.ln_f).to(m.dtype)
        if self.head is None:
            return F.linear(x, m.head.to(m.dtype))
        return torch.cat([F.linear(x.to(dev), w).to(x.device)
                          for w, dev in zip(self.head, self.devices)], -1)

    @staticmethod
    def _on(ads: Optional[dict], dev) -> Optional[dict]:
        return None if ads is None else {k: v.to(dev)
                                         for k, v in ads.items()}

    def _block(self, blk: Block, pw: dict, x: torch.Tensor, ctx: Places):
        dtype = blk.dtype
        b, s, _ = x.shape
        ads = ctx.adapters
        P = self.attn_places
        hq, hk, dh = blk.n_heads // P, blk.n_kv // P, blk.dh
        h = layer_norm(x, blk.ln1).to(dtype)
        outs = []
        for i, (c, dev) in enumerate(zip(ctx.places, self.devices[:P])):
            hm = h.to(dev)
            a = self._on(None if ads is None else ads[i], dev)
            w = pw["qkv"][i] if "qkv" in pw else blk.qkv.to(dtype)
            if ctx.fused_rope:
                offsets = c.rope_offsets().to(torch.int32).to(dev)
                extra = on = None
                if a is not None:
                    extra, on = blk._delta(a, hm, "qkv"), a["on"]
                q, k, v = fused_rope_qkv(hm, w.t(), offsets, extra, on,
                                         n_heads=hq, n_kv=hk, dh=dh,
                                         rope=ctx.rope)
                attn = c.attend(blk.layer_idx, q, k, v, rotated=True)
            else:
                qkv = blk._ad(a, F.linear(hm, w), hm, "qkv")

                def heads(t, n):
                    return t.reshape(b, s, n, dh).transpose(1, 2)

                attn = c.attend(blk.layer_idx,
                                heads(qkv[..., :hq * dh], hq),
                                heads(qkv[..., hq * dh:(hq + hk) * dh], hk),
                                heads(qkv[..., (hq + hk) * dh:], hk))
            outs.append(attn.to(x.device))
        attn = torch.cat(outs, 1).transpose(1, 2).reshape(b, s, blk.d_model)
        x = x + F.linear(attn.to(dtype), blk.proj.to(dtype))
        h = layer_norm(x, blk.ln2).to(dtype)
        a0 = None if ads is None else ads[0]
        if blk.n_experts > 0:
            # the MoE FFN stays whole (JAX splits only the 2-D qkv, wi and
            # head kernels): the dense reference, once
            return x + blk.moe(h, dense=True)[0]
        if self.mlp_fn is not None:
            return x + self.mlp_fn([w.t() for w in pw["wi"]],
                                   [w.t() for w in pw["wo"]], h)
        if "wi" in pw:
            parts = []
            for i, (w, dev) in enumerate(zip(pw["wi"], self.devices)):
                hm = h.to(dev)
                a = self._on(None if ads is None else ads[i], dev)
                y = blk._ad(a, F.linear(hm, w), hm, "wi")
                parts.append(F.gelu(y, approximate="tanh").to(x.device))
            y = torch.cat(parts, -1)
        else:
            y = F.gelu(blk._ad(a0, F.linear(h, blk.wi.to(dtype)), h, "wi"),
                       approximate="tanh")
        return x + blk._ad(a0, F.linear(y, blk.wo.to(dtype)), y, "wo")


def _same_device(d, dev: torch.device) -> bool:
    """Whether ``d`` names ``dev`` (``cuda`` without an index names the
    current card)."""
    d = torch.device(d)
    if d.type != dev.type:
        return False
    if d.type == "cuda" and d.index is None:
        return dev.index == torch.cuda.current_device()
    return d.index == dev.index


class _CopyToShards(torch.autograd.Function):
    """Megatron's ``f``: the input to every model device in the forward, the
    sum of their gradients in the backward."""

    @staticmethod
    def forward(ctx, devices, x):
        ctx.device = x.device
        return tuple(x.view_as(x) if _same_device(d, x.device)
                     else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        total = live[0].to(ctx.device)
        for g in live[1:]:
            total = total + g.to(ctx.device)
        return None, total


class _SumShards(torch.autograd.Function):
    """Megatron's ``g``: the sum of the model devices' partial outputs on
    ``device`` in the forward (taken in f32, rounded once to the partials'
    dtype), the gradient to every device in the backward."""

    @staticmethod
    def forward(ctx, device, *parts):
        ctx.where = [(p.device, p.dtype) for p in parts]
        total = parts[0].float().to(device)
        for p in parts[1:]:
            total = total + p.float().to(device)
        return total.to(parts[0].dtype)

    @staticmethod
    def backward(ctx, g):
        return (None, *(g.to(dev, dt) for dev, dt in ctx.where))


class TPBlock(nn.Module):
    """The Megatron form of :class:`Block` over ``devices``, the ``model``
    axis of this rank (repeats allowed: on one card every shard folds onto
    it and makes its own launches).  Shard ``m`` holds heads ``[m·h/M,
    (m+1)·h/M)`` — its q rows and the k and v rows of its kv heads, each
    query group whole with its kv head — and the matching ``proj`` columns,
    ``d_ff/M`` rows of ``wi`` and the matching ``wo`` columns.  The forward
    copies the normed input to every shard (``f``), runs each shard's
    attention (the flash kernels over its heads on CUDA) and MLP, and sums
    the partial outputs of ``proj`` and of ``wo`` (``g``), one sum each.
    The norms stay whole (the ``ln1``/``ln2`` parameters of the block it
    was made from).  The training arm only: the serving arms (decode,
    prefill, fused RoPE, adapters) keep the replicated block.

    A block with the routed :class:`MoEFFN` splits its expert stacks
    ``moe.w``/``moe.wo`` on the expert axis, ``E/M`` experts a shard, the
    router replicated (the JAX layout, ``tpudist/models/transformer.py:
    815-818``): with a ``moe_fn`` (:func:`tpudist_torch.parallel.make_moe`
    over the same model devices) each expert's rows run on the device that
    holds it; without one, each shard computes the dense reference over its
    experts and the partial outputs are summed.  A block with an injected
    ``mlp_fn`` keeps ``wi``/``wo`` split as a dense block's and hands the
    ``mlp_fn`` the whole kernels put together from the shards (what JAX's
    partitioner does to feed the ``mlp_fn``'s own layout).

    Under a ring (:class:`RingCausal`) each shard's attention runs the
    ring over its own heads (whole GQA groups): every live hop makes one
    forward, dq and dk/dv flash launch a shard (3-D parallelism).

    The state dict holds the whole tensors under the block's own keys
    (``qkv``, ``proj``, ``wi``, ``wo``, ``moe.*``), assembled from the
    shards and cut into them on load.  ``SPLIT`` (a dense block) and
    ``MOE_SPLIT`` (an MoE block) are the one statement of which dimension
    each weight splits along: :func:`transformer_tp_sharding` and the
    runtime read them."""

    SPLIT = {"qkv": 0, "proj": 1, "wi": 0, "wo": 1}
    MOE_SPLIT = {"qkv": 0, "proj": 1, "moe.w": 0, "moe.wo": 0}
    sow = None  # as Block's: a list receives the MoE layer's statistics

    def __init__(self, block: Block, devices):
        super().__init__()
        devices = tuple(torch.device(d) for d in devices)
        m = len(devices)
        h, kv = block.n_heads, block.n_kv
        moe = block.n_experts > 0
        width = ("n_experts", block.n_experts) if moe else (
            "d_ff", block.wi.shape[0])
        for what, n in (("n_heads", h), ("n_kv_heads", kv), width):
            if n % m:
                raise ValueError(f"{what} {n} does not divide over a model "
                                 f"axis of {m}")
        self.devices, self.m = devices, m
        self.d_model, self.n_heads, self.n_kv = block.d_model, h, kv
        self.dh, self.layer_idx, self.dtype = block.dh, block.layer_idx, \
            block.dtype
        self.d_ff, self.n_experts = block.d_ff, block.n_experts
        self.mlp_fn = block.mlp_fn
        self.ln1, self.ln2 = block.ln1, block.ln2
        self.split = self.MOE_SPLIT if moe else self.SPLIT
        self._idx = {"qkv": self._qkv_rows(),
                     "proj": self._even(h * self.dh)}
        if moe:
            self.moe_fn = block.moe.moe_fn
            self.moe = nn.Module()  # the replicated router, at "moe.router"
            self.moe.router = block.moe.router
            self._idx.update({"moe.w": self._even(block.n_experts),
                              "moe.wo": self._even(block.n_experts)})
        else:
            self._idx.update({"wi": self._even(block.d_ff),
                              "wo": self._even(block.d_ff)})
        for name in self.split:
            param = block.get_parameter(name)
            for i, part in enumerate(self.slice(name, param.detach(),
                                                self.split_dim(name))):
                setattr(self, self._piece(name, i), nn.Parameter(
                    part.to(devices[i]).clone(),
                    requires_grad=param.requires_grad))

    @staticmethod
    def _piece(name: str, i: int) -> str:
        return f"{name.replace('.', '_')}_s{i}"

    def _even(self, n: int):
        k = n // self.m
        return [torch.arange(i * k, (i + 1) * k) for i in range(self.m)]

    def _qkv_rows(self):
        d, dh = self.d_model, self.dh
        kv_dim = self.n_kv * dh
        hq, hk = self.n_heads // self.m, self.n_kv // self.m
        out = []
        for i in range(self.m):
            q = torch.arange(i * hq * dh, (i + 1) * hq * dh)
            k = d + torch.arange(i * hk * dh, (i + 1) * hk * dh)
            out.append(torch.cat([q, k, k + kv_dim]))
        return out

    @classmethod
    def split_of(cls, block: nn.Module) -> Dict[str, int]:
        """``{weight: dimension}`` of the weights the model axis splits in
        ``block`` (a :class:`Block` or a :class:`TPBlock`)."""
        return cls.MOE_SPLIT if getattr(block, "n_experts", 0) > 0 \
            else cls.SPLIT

    @classmethod
    def split_dim(cls, name: str) -> int:
        """The dimension of the ``[out, in]`` weight the shards split
        (``SPLIT``, ``MOE_SPLIT``): rows of ``qkv`` and ``wi``, columns of
        ``proj`` and ``wo``, the expert axis of the MoE stacks."""
        return {**cls.SPLIT, **cls.MOE_SPLIT}[name]

    def pieces(self, name: str) -> List[nn.Parameter]:
        return [getattr(self, self._piece(name, i)) for i in range(self.m)]

    def slice(self, name: str, whole: torch.Tensor, dim: int):
        """The shards' parts of ``whole``, a tensor that runs along weight
        ``name``'s split dimension at its own dimension ``dim``."""
        return [whole.index_select(dim, ix.to(whole.device))
                for ix in self._idx[name]]

    def assemble(self, name: str, parts, dim: int) -> torch.Tensor:
        """The inverse of :meth:`slice`, on the first shard's device."""
        dev = parts[0].device
        shape = list(parts[0].shape)
        shape[dim] = sum(p.shape[dim] for p in parts)
        out = parts[0].new_empty(shape)
        for ix, p in zip(self._idx[name], parts):
            out.index_copy_(dim, ix.to(dev), p.detach().to(dev))
        return out

    def _replicated(self) -> Tuple[str, ...]:
        return ("ln1", "ln2") + (("moe.router",) if self.n_experts else ())

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name in self._replicated():
            t = self.get_parameter(name)
            destination[prefix + name] = t if keep_vars else t.detach()
        for name in self.split:
            destination[prefix + name] = self.assemble(
                name, self.pieces(name), self.split_dim(name))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        with torch.no_grad():
            for name in self._replicated() + tuple(self.split):
                key = prefix + name
                if key not in state_dict:
                    missing_keys.append(key)
                    continue
                whole = state_dict[key]
                if name in self._replicated():
                    self.get_parameter(name).copy_(whole)
                    continue
                for p, part in zip(self.pieces(name), self.slice(
                        name, whole, self.split_dim(name))):
                    p.copy_(part)

    def to_block(self) -> Block:
        """The replicated :class:`Block` of the same weights (on the first
        shard's device)."""
        blk = Block(self.d_model, self.n_heads, self.d_ff, self.n_kv,
                    self.layer_idx, self.dtype, self.pieces("qkv")[0].dtype,
                    n_experts=self.n_experts,
                    moe_fn=getattr(self, "moe_fn", None),
                    mlp_fn=self.mlp_fn).to(self.devices[0])
        blk.ln1, blk.ln2 = self.ln1, self.ln2
        if self.n_experts:
            blk.moe.router = self.moe.router
        for name in self.split:
            p0 = self.pieces(name)[0]
            owner, leaf = (blk.moe, name[4:]) if name.startswith("moe.") \
                else (blk, name)
            setattr(owner, leaf, nn.Parameter(
                self.assemble(name, self.pieces(name), self.split_dim(name)),
                requires_grad=p0.requires_grad))
        return blk

    def _whole(self, name: str, device) -> torch.Tensor:
        """Weight ``name`` put together from the shards on ``device``,
        differentiably (the shards split it into contiguous runs)."""
        return torch.cat([p.to(device) for p in self.pieces(name)],
                         self.split_dim(name))

    def _moe(self, h: torch.Tensor) -> torch.Tensor:
        b, s, d = h.shape
        dt = self.dtype
        tokens = h.reshape(b * s, d).to(dt)
        router = self.moe.router.to(dt)
        if self.moe_fn is not None:
            # one expert's weights a tensor, each on the shard holding it
            experts = {name[4:]: [e.to(dt) for p in self.pieces(name)
                                  for e in p.unbind(0)]
                       for name in ("moe.w", "moe.wo")}
            y, stats = self.moe_fn({"router": router, "experts": experts},
                                   tokens)
            if stats is not None and self.sow is not None:
                self.sow.append(stats)
            return y.reshape(b, s, d)
        # the dense reference, decomposed over the shards' experts
        probs = torch.softmax((tokens @ router).float(), dim=-1)
        idx = probs.argmax(dim=-1)
        gate = probs.gather(-1, idx[:, None])[:, 0]
        pick = F.one_hot(idx, probs.shape[-1]).to(dt) * gate.to(dt)[:, None]
        k = self.n_experts // self.m
        parts = []
        for i, (dev, w, wo) in enumerate(zip(
                self.devices, self.pieces("moe.w"), self.pieces("moe.wo"))):
            t = tokens.to(dev)
            hh = torch.relu(torch.einsum("td,edf->tef", t, w.to(dt)))
            y_all = torch.einsum("tef,efd->ted", hh, wo.to(dt))
            parts.append(torch.einsum("ted,te->td", y_all,
                                      pick[:, i * k:(i + 1) * k].to(dev)))
        return _SumShards.apply(h.device, *parts).reshape(b, s, d)

    def forward(self, x: torch.Tensor, ctx) -> torch.Tensor:
        if not isinstance(ctx, _Causal):
            raise ValueError(
                "the tensor-parallel block runs the training arm only: "
                "decode, prefill, fused RoPE and adapters keep the "
                "replicated block")
        dtype = self.dtype
        b, s, _ = x.shape
        hq, hk, dh = self.n_heads // self.m, self.n_kv // self.m, self.dh

        def heads(t, n):
            return t.reshape(b, s, n, dh).transpose(1, 2)

        hs = _CopyToShards.apply(self.devices,
                                 layer_norm(x, self.ln1).to(dtype))
        parts = []
        for h, w, pw in zip(hs, self.pieces("qkv"), self.pieces("proj")):
            qkv = F.linear(h, w.to(dtype))
            q = qkv[..., :hq * dh]
            k = qkv[..., hq * dh:(hq + hk) * dh]
            v = qkv[..., (hq + hk) * dh:]
            attn = ctx.attend(self.layer_idx, heads(q, hq), heads(k, hk),
                              heads(v, hk))
            attn = attn.transpose(1, 2).reshape(b, s, hq * dh)
            parts.append(F.linear(attn.to(dtype), pw.to(dtype)))
        x = x + _SumShards.apply(x.device, *parts)
        if self.n_experts:
            return x + self._moe(layer_norm(x, self.ln2))
        if self.mlp_fn is not None:
            h = layer_norm(x, self.ln2).to(dtype)
            wi = self._whole("wi", x.device).to(dtype).t()
            wo = self._whole("wo", x.device).to(dtype).t()
            wi, wo = self.mlp_fn.pieces(wi, wo)
            return x + self.mlp_fn({"wi": wi, "wo": wo}, h)
        hs = _CopyToShards.apply(self.devices,
                                 layer_norm(x, self.ln2).to(dtype))
        parts = [F.linear(F.gelu(F.linear(h, wi.to(dtype)),
                                 approximate="tanh"), wo.to(dtype))
                 for h, wi, wo in zip(hs, self.pieces("wi"),
                                      self.pieces("wo"))]
        return x + _SumShards.apply(x.device, *parts)


def transformer_tp_sharding(mesh, model: nn.Module, optimizer=None, *,
                            axis_name: str = "model"):
    """The Megatron layout of a :class:`TransformerLM` (and, when given, of
    its optimizer's state): per block ``qkv`` and ``wi`` column-split,
    ``proj`` and ``wo`` row-split on the JAX-shaped ``[in, out]`` view —
    the port's ``[out, in]`` weights split along :attr:`TPBlock.SPLIT`'s
    dimension — the MoE expert stacks split on their expert axis with the
    router replicated, embeddings, norms and head replicated: the JAX
    package's path rules.  An optimizer slot follows its parameter's rule unless it
    has fewer than two dimensions (counters, Adafactor's factored
    statistics and placeholders), as JAX's ``ndim`` check.  ``mesh`` is the port's mesh or
    a ``{axis: size}`` dict; :mod:`tpudist_torch.parallel.zero` carries it
    out with :class:`TPBlock`."""
    from tpudist_torch.parallel.fsdp import (Leaf, make_layout,
                                             optimizer_leaves, param_leaves)

    leaves = param_leaves(model)
    if optimizer is not None:
        leaves.update(optimizer_leaves(model, optimizer))
    out = {}
    for key, (shape, transposed, itemsize) in leaves.items():
        spec = [None] * len(shape)
        words = key.replace("/", ".").split(".")
        hit = [f"moe.{w}" for a, w in zip(words, words[1:])
               if a == "moe" and f"moe.{w}" in TPBlock.MOE_SPLIT]
        if "moe" not in words:
            hit = [w for w in words if w in TPBlock.SPLIT]
        if hit and len(shape) >= 2:
            spec[TPBlock.split_dim(hit[0])] = axis_name
        out[key] = Leaf(shape, transposed, itemsize, tuple(spec))
    return make_layout(out, mesh)


class TransformerLM(nn.Module):
    """Causal LM: token (+ learned position) embeddings, ``n_layers``
    pre-LN blocks, final LayerNorm, untied head — the
    :class:`tpudist.models.TransformerLM` geometry and numerics.

    ``block_fn``, when set, runs each block in place of the module's own
    call: ``block_fn(block, x, ctx, remat, remat_policy) -> x`` (the ZeRO-3
    runtime gathers a block's shards there, :mod:`tpudist_torch.parallel.
    zero`).  ``jax_transposed`` names the weights the port stores ``[out,
    in]`` where flax keeps ``[in, out]`` (the sharding rules read them);
    ``cast_weights`` those cast to ``dtype`` where they are used, as
    :class:`Block`'s.  ``n_experts``, ``moe_fn`` and ``mlp_fn`` are every
    block's FFN (:class:`Block`); ``moe_fn`` and ``mlp_fn`` may be set
    after construction (the same parameters either way)."""

    jax_transposed = ("qkv", "proj", "wi", "wo", "head")
    cast_weights = ("head",)

    def __init__(self, vocab: int = 256, d_model: int = 128,
                 n_layers: int = 2, n_heads: int = 4, d_ff: int = 512,
                 max_len: int = 2048, rope: bool = False,
                 n_kv_heads: Optional[int] = None,
                 sliding_window: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, remat_policy: str = "nothing",
                 n_experts: int = 0, moe_fn: Optional[Callable] = None,
                 mlp_fn: Optional[Callable] = None):
        super().__init__()
        if sliding_window is not None and sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {sliding_window}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of "
                             f"{sorted(REMAT_POLICIES)}, got "
                             f"{remat_policy!r}")
        self.remat, self.remat_policy = remat, remat_policy
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.n_heads, self.d_ff, self.max_len = n_heads, d_ff, max_len
        self.rope, self.sliding_window = rope, sliding_window
        self.n_kv_heads, self.n_experts = n_kv_heads, n_experts
        self.dtype = dtype
        pd = dtype if param_dtype is None else param_dtype
        self.param_dtype = pd
        self.tok_embed = nn.Parameter(torch.empty(vocab, d_model, dtype=pd))
        self.pos_embed = (None if rope else nn.Parameter(
            torch.empty(max_len, d_model, dtype=pd)))
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, d_ff, n_kv_heads, i, dtype, pd,
                  n_experts=n_experts, moe_fn=moe_fn, mlp_fn=mlp_fn)
            for i in range(n_layers))
        self.ln_f = nn.Parameter(torch.ones(d_model, dtype=torch.float32))
        self.head = nn.Parameter(torch.empty(vocab, d_model, dtype=pd))
        self.block_fn = None

    @property
    def n_kv(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads

    @property
    def moe_fn(self) -> Optional[Callable]:
        blk = self.blocks[0]
        return blk.moe.moe_fn if getattr(blk, "n_experts", 0) > 0 else None

    @moe_fn.setter
    def moe_fn(self, fn: Optional[Callable]) -> None:
        if fn is not None and self.n_experts == 0:
            raise ValueError("moe_fn needs a model with n_experts > 0")
        for blk in self.blocks:
            if getattr(blk, "n_experts", 0) > 0:
                blk.moe.moe_fn = fn

    @property
    def mlp_fn(self) -> Optional[Callable]:
        return getattr(self.blocks[0], "mlp_fn", None)

    @mlp_fn.setter
    def mlp_fn(self, fn: Optional[Callable]) -> None:
        if fn is not None and self.n_experts > 0:
            raise ValueError("mlp_fn replaces the dense FFN; it cannot "
                             "compose with the MoE FFN (n_experts > 0)")
        for blk in self.blocks:
            blk.mlp_fn = fn

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def forward(self, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
        """``tokens [batch, seq]`` → logits ``[batch, seq, vocab]`` in the
        compute dtype.  ``ctx`` selects the attention arm (module doc)."""
        if ctx is None:
            ctx = self.train_context()
        x = self.embed(tokens, ctx)
        remat = self.remat and isinstance(ctx, _Causal) and \
            torch.is_grad_enabled()
        run = getattr(self, "block_fn", None)
        for block in self.blocks:
            if run is not None:
                x = run(block, x, ctx, remat, self.remat_policy)
            else:
                x = (rematerialized(block, x, ctx, self.remat_policy)
                     if remat else block(x, ctx))
        return self.logits(x)

    def train_context(self) -> "_Causal":
        """The training arm's attention context: causal at positions
        ``0..T-1``, with the model's RoPE and sliding window."""
        return _Causal(self.rope, self.sliding_window)

    def embed(self, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
        """The token (+ position) embedding of ``tokens [batch, seq]`` in
        the compute dtype: the forward's first step (the pipeline's stage-0
        input)."""
        ctx = self.train_context() if ctx is None else ctx
        b, s = tokens.shape
        x = F.embedding(tokens.long(), self.tok_embed).to(self.dtype)
        if not self.rope:
            # padded chunk rows and idle lanes may sit past the table; their
            # outputs are never read, so clamping keeps them finite
            pos = ctx.positions(b, s, tokens.device).clamp(0, self.max_len - 1)
            x = x + F.embedding(pos, self.pos_embed).to(self.dtype)
        return x

    def logits(self, x: torch.Tensor, ln_f: Optional[torch.Tensor] = None,
               head: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The final norm and the vocabulary head of the last block's
        output: the forward's last step.  ``ln_f``/``head`` stand in for
        the model's own (the pipeline's head differentiates them apart)."""
        ln_f = self.ln_f if ln_f is None else ln_f
        head = self.head if head is None else head
        x = layer_norm(x, ln_f)
        return F.linear(x.to(self.dtype), head.to(self.dtype))


# what a rematerialized block's backward may keep besides its input, as the
# JAX package's jax.checkpoint policies: nothing (recompute the whole block),
# every matmul output (checkpoint_dots), or the matmuls without batch
# dimensions (checkpoint_dots_with_no_batch_dims: the 2-D projections, not
# the attention's batched products)
REMAT_POLICIES = {
    "nothing": (),
    "dots": ("mm", "addmm", "bmm", "matmul", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def _remat_context(policy: str):
    """The selective-checkpoint context function of ``policy`` (``None``
    for ``nothing``): the listed aten products are saved in the forward,
    everything else recomputed.  The flash kernels launch through ctypes
    inside an autograd Function, below the dispatcher, so no policy saves
    their output: under every policy the forward kernel runs again in the
    backward, as a ``pallas_call`` is no ``dot_general`` for
    ``checkpoint_dots`` either."""
    names = REMAT_POLICIES[policy]
    if not names:
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    saved = {getattr(torch.ops.aten, n).default for n in names}

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy_fn)


def rematerialized(block: nn.Module, x: torch.Tensor, ctx, policy: str):
    """``block(x, ctx)`` whose internals the backward recomputes (flax
    ``nn.remat(Block, policy=...)``); the non-reentrant form, which keeps
    DDP's gradient hooks working."""
    from torch.utils.checkpoint import checkpoint

    context_fn = _remat_context(policy)
    if context_fn is None:
        return checkpoint(block, x, ctx, use_reentrant=False)
    return checkpoint(block, x, ctx, use_reentrant=False,
                      context_fn=context_fn)


def tied_draft(model: TransformerLM, layers: int) -> TransformerLM:
    """The weight-tied shallow draft of speculative decoding: a
    :class:`TransformerLM` view over ``model``'s embeddings, first
    ``layers`` blocks, final LayerNorm and head — the SAME ``Parameter``
    objects (no copy, zero extra bytes), the counterpart of
    :func:`tpudist.models.generate.tied_draft`.  Draft quality moves only
    the acceptance rate, never the output: the target verify is the
    oracle."""
    n = int(model.n_layers)
    if not 1 <= layers <= n:
        raise ValueError(f"draft layers {layers} must be in [1, {n}]")
    draft = TransformerLM.__new__(TransformerLM)
    nn.Module.__init__(draft)
    for name in ("vocab", "d_model", "n_heads", "d_ff", "max_len", "rope",
                 "sliding_window", "n_kv_heads", "n_experts", "dtype",
                 "param_dtype", "remat", "remat_policy"):
        setattr(draft, name, getattr(model, name))
    draft.n_layers = int(layers)
    draft.tok_embed = model.tok_embed
    draft.pos_embed = model.pos_embed
    draft.blocks = nn.ModuleList(model.blocks[:layers])
    draft.ln_f = model.ln_f
    draft.head = model.head
    draft.block_fn = None
    return draft


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's lecun_normal: truncated normal (±2σ), variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                generator=gen)
    with torch.no_grad():
        w.copy_(t)


def create_transformer(seed: int = 0, *, device="cuda",
                       dtype: torch.dtype = torch.float32,
                       param_dtype: Optional[torch.dtype] = None,
                       trainable: bool = False, **cfg) -> TransformerLM:
    """A :class:`TransformerLM` with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (on the CPU, so every device
    and dtype gets the same values), moved to ``device``.  Frozen
    (``requires_grad`` off) for serving unless ``trainable``.  Raises on a
    box without CUDA unless ``device="cpu"``."""
    device = resolve_device(device)
    model = TransformerLM(dtype=dtype, param_dtype=param_dtype, **cfg)
    gen = torch.Generator().manual_seed(int(seed))
    d = model.d_model
    _lecun_normal_(model.tok_embed, d, gen)
    if model.pos_embed is not None:
        _lecun_normal_(model.pos_embed, d, gen)
    for blk in model.blocks:
        _lecun_normal_(blk.qkv, d, gen)
        _lecun_normal_(blk.proj, d, gen)
        if blk.n_experts > 0:
            # flax's lecun_normal counts the expert axis into the fan-in
            e = blk.n_experts
            _lecun_normal_(blk.moe.router, d, gen)
            _lecun_normal_(blk.moe.w, d * e, gen)
            _lecun_normal_(blk.moe.wo, model.d_ff * e, gen)
            continue
        _lecun_normal_(blk.wi, d, gen)
        _lecun_normal_(blk.wo, model.d_ff, gen)
    _lecun_normal_(model.head, d, gen)
    return model.to(device).requires_grad_(trainable)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — there
    is no silent fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's "
            "plain CPU path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (mean over all predicted positions), in
    f32 whatever the logits' dtype."""
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def lm_loss_with_targets(logits: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy against explicit per-position targets; ``-1`` masks a
    position out (mean over the unmasked ones)."""
    valid = targets >= 0
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, safe[..., None])[..., 0]
    return -torch.where(valid, ll, torch.zeros_like(ll)).sum() / torch.clamp(
        valid.sum(), min=1)
