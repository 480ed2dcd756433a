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

Weights live in ``param_dtype`` (default: the compute dtype ``dtype``) and
are cast to ``dtype`` where they are used, as flax's ``nn.Dense(dtype=...)``
and ``nn.Embed(dtype=...)`` cast their f32 masters at apply; LayerNorm scales
stay f32.  Serving builds the model in its compute dtype (the casts are
no-ops); training keeps f32 masters under bf16 compute
(``param_dtype=float32, dtype=bfloat16``), so gradients land in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

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


def attention_reference(q, k, v, *, window: Optional[int] = None):
    """Plain causal softmax attention over ``[batch, heads, seq,
    head_dim]`` (optionally banded to ``q - k < window``): f32 scores and
    softmax, weights cast back to ``v``'s dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
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
        return attention_reference(q, k, v, window=self.window)


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
    ``x + wo(gelu(wi(LN(x))))``.  Linear weights are stored ``[out, in]``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 n_kv_heads: Optional[int], layer_idx: int,
                 dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
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
        self.wi = nn.Parameter(torch.empty(d_ff, d_model, dtype=pd))
        self.wo = nn.Parameter(torch.empty(d_model, d_ff, dtype=pd))

    def _delta(self, ads: dict, h_in: torch.Tensor, proj: str):
        """The raw adapter delta ``(h·A)·B`` of one projection through the
        LoRA gather-matmul kernel (each lane's own factor block)."""
        return lora_delta(h_in.to(self.dtype).contiguous(), ads[f"a_{proj}"],
                          ads[f"b_{proj}"], ads["ids"], layer=self.layer_idx)

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
        y = self._ad(ads, F.linear(h.to(dtype), self.wi.to(dtype)), h, "wi")
        y = F.gelu(y, approximate="tanh")
        return x + self._ad(ads, F.linear(y, self.wo.to(dtype)), y, "wo")


class TransformerLM(nn.Module):
    """Causal LM: token (+ learned position) embeddings, ``n_layers``
    pre-LN blocks, final LayerNorm, untied head — the
    :class:`tpudist.models.TransformerLM` geometry and numerics."""

    def __init__(self, vocab: int = 256, d_model: int = 128,
                 n_layers: int = 2, n_heads: int = 4, d_ff: int = 512,
                 max_len: int = 2048, rope: bool = False,
                 n_kv_heads: Optional[int] = None,
                 sliding_window: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        super().__init__()
        if sliding_window is not None and sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {sliding_window}")
        if remat:
            raise NotImplementedError(
                "remat (rematerialized blocks) is not ported yet: ROADMAP "
                "queue A, item 6a")
        self.vocab, self.d_model, self.n_layers = vocab, d_model, n_layers
        self.n_heads, self.d_ff, self.max_len = n_heads, d_ff, max_len
        self.rope, self.sliding_window = rope, sliding_window
        self.n_kv_heads = n_kv_heads
        self.dtype = dtype
        pd = dtype if param_dtype is None else param_dtype
        self.param_dtype = pd
        self.tok_embed = nn.Parameter(torch.empty(vocab, d_model, dtype=pd))
        self.pos_embed = (None if rope else nn.Parameter(
            torch.empty(max_len, d_model, dtype=pd)))
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, d_ff, n_kv_heads, i, dtype, pd)
            for i in range(n_layers))
        self.ln_f = nn.Parameter(torch.ones(d_model, dtype=torch.float32))
        self.head = nn.Parameter(torch.empty(vocab, d_model, dtype=pd))

    @property
    def n_kv(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def forward(self, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
        """``tokens [batch, seq]`` → logits ``[batch, seq, vocab]`` in the
        compute dtype.  ``ctx`` selects the attention arm (module doc)."""
        if ctx is None:
            ctx = _Causal(self.rope, self.sliding_window)
        b, s = tokens.shape
        x = self.tok_embed[tokens.long()].to(self.dtype)
        if not self.rope:
            # padded chunk rows and idle lanes may sit past the table; their
            # outputs are never read, so clamping keeps them finite
            pos = ctx.positions(b, s, tokens.device).clamp(0, self.max_len - 1)
            x = x + self.pos_embed[pos].to(self.dtype)
        for block in self.blocks:
            x = block(x, ctx)
        x = layer_norm(x, self.ln_f)
        return F.linear(x.to(self.dtype), self.head.to(self.dtype))


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
                 "sliding_window", "n_kv_heads", "dtype", "param_dtype"):
        setattr(draft, name, getattr(model, name))
    draft.n_layers = int(layers)
    draft.tok_embed = model.tok_embed
    draft.pos_embed = model.pos_embed
    draft.blocks = nn.ModuleList(model.blocks[:layers])
    draft.ln_f = model.ln_f
    draft.head = model.head
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
