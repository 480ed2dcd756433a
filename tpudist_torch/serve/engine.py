"""Slot-based continuous-batching decode engine — the PyTorch port of
``tpudist/serve/engine.py`` for the kernel configuration: a paged KV pool
(native or int8) with the paged decode kernel, the paged prefill kernel and
the fused sampling kernel, with or without a prefix cache, optionally the
fused RoPE+QKV kernel (``fused_rope``) and per-tenant LoRA adapters
(``adapters``: a factor pool beside the KV pool, named adapters bound to
lanes by the host registry of :mod:`tpudist_torch.serve.adapters`, each
lane's delta from the LoRA gather-matmul kernel).

The engine is the device half: ``num_slots`` KV lanes over the slot
programs of :func:`tpudist_torch.models.make_slot_decode`, plus host shadow
cursors (occupied/decoding, pos, counts, budget) for admission and
block-size decisions.  Per engine iteration: ONE batched prefill for an
admission batch, one chunk per still-prefilling slot (chunked prefill), and
ONE decode block of ``K`` steps followed by ONE fetch of the ``K × S``
tokens.  Single-threaded by contract.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpudist_torch import ops
from tpudist_torch.models import lora as _lora
from tpudist_torch.models.generate import make_slot_decode
from tpudist_torch.models.paged import PagedKVConfig
from tpudist_torch.models.transformer import resolve_device
from tpudist_torch.serve.adapters import (AdapterMissingError,
                                          AdapterRegistry)
from tpudist_torch.serve.paged_alloc import BlockAllocator

#: ``start_batch`` item: (slot, prompt_1d_int32, temperature, seed, max_new)
#: plus an optional 6th element — the prompt's prefix hash chain — an
#: optional 7th — the speculative-decoding opt (speculation is not ported;
#: the flag is accepted and ignored, as a non-speculative JAX engine
#: ignores it) — an optional 8th — the lane's adapter NAME (None =
#: base-only) — and an optional 9th — a grammar (structured output is not
#: ported: anything but None raises)
InsertItem = Tuple[int, np.ndarray, float, int, int]


def _pow2_floor(k: int) -> int:
    """Largest power of two ``<= k`` (the decode block-size buckets)."""
    return 1 << (max(1, k).bit_length() - 1)


def _unported(knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported to tpudist_torch yet (ROADMAP.md queue A "
        f"item {item}); the port's engine runs paged=True, "
        "attn_kernel='paged', prefill_kernel=True, sample_kernel=True")


class SlotEngine:
    """``num_slots`` KV lanes + host shadow cursors over the slot programs.

    Per slot the host shadows ``occupied`` (prefilling or decoding),
    ``decoding``, ``pos`` (filled positions), ``counts`` (tokens emitted),
    ``budget`` (``max_new``) and ``temps``; the authoritative state lives on
    the device.  ``model`` is moved to ``device`` (``"cuda"`` by default;
    a box without CUDA raises unless ``device="cpu"``)."""

    def __init__(self, model, *, num_slots: int = 4,
                 prefill_pad: Optional[int] = None,
                 decode_block: Optional[int] = None,
                 paged: bool = True, kv_block: int = 16,
                 kv_blocks: Optional[int] = None, kv_int8: bool = False,
                 prefix_cache_blocks: int = 0,
                 attn_kernel: str = "paged",
                 prefill_kernel: bool = True,
                 sample_kernel: bool = True,
                 fused_rope: bool = False,
                 lora_kernel: bool = False,
                 adapters: bool = False, adapter_blocks: int = 8,
                 adapter_rank: int = 8,
                 mesh=None, spec_draft=None,
                 device="cuda"):
        # the JAX engine's rules for the kernel family's knobs (env-free
        # here; ServeConfig.from_env parses TPUDIST_SERVE_* once)
        if fused_rope and attn_kernel != "paged" and not prefill_kernel:
            raise ValueError(
                "fused_rope=True fuses RoPE+QKV on the kernel arms only "
                "— enable attn_kernel='paged' and/or prefill_kernel=True "
                "(TPUDIST_SERVE_FUSED_ROPE)")
        if lora_kernel and not adapters:
            raise ValueError(
                "lora_kernel=True is the in-kernel adapter gather-matmul "
                "— it requires adapters=True (TPUDIST_SERVE_LORA_KERNEL)")
        if lora_kernel and attn_kernel != "paged" and not prefill_kernel:
            raise ValueError(
                "lora_kernel=True rides the slot-batched kernel programs "
                "only — enable attn_kernel='paged' and/or "
                "prefill_kernel=True (TPUDIST_SERVE_LORA_KERNEL)")
        if mesh is not None:
            raise _unported("mesh (the SPMD serving mesh)", "8")
        if spec_draft is not None:
            raise _unported("spec_draft (speculative decoding)", "3")
        if not paged:
            raise _unported("paged=False (the dense slot cache)", "5")
        if attn_kernel != "paged":
            raise _unported(f"attn_kernel={attn_kernel!r}", "5")
        if not prefill_kernel:
            raise _unported("prefill_kernel=False", "5")
        if not sample_kernel:
            raise _unported("sample_kernel=False", "5")
        self.device = resolve_device(device)
        model = model.to(self.device)
        self.model = model
        self.fused_rope = bool(fused_rope)
        self.lora_kernel = bool(lora_kernel)
        # -- per-tenant adapters: the factor pool, the host registry, and
        # the host shadow slot → bound ``(name, block_id)`` (None =
        # base-only; the bid pins the factor generation the lane bound)
        self.adapters: Optional[AdapterRegistry] = None
        self.adapter_cfg: Optional[_lora.AdapterPoolConfig] = None
        self.apool: Optional[_lora.AdapterPool] = None
        self.slot_adapter: List[Optional[Tuple[str, int]]] = \
            [None] * num_slots
        if adapters:
            self.adapter_cfg = _lora.AdapterPoolConfig(
                num_blocks=max(1, int(adapter_blocks)),
                rank=max(1, int(adapter_rank)))
            self.apool = _lora.init_adapter_pool(model, self.adapter_cfg)
            self.adapters = AdapterRegistry(self.adapter_cfg.num_blocks)
        self.max_len = int(model.max_len)
        if prefill_pad is None:
            prefill_pad = min(self.max_len, 64)
        kv_block = min(int(kv_block), self.max_len)
        if self.max_len % kv_block:
            raise ValueError(
                f"kv_block {kv_block} must divide max_len {self.max_len}")
        if kv_blocks is None:
            # dense-equivalent capacity
            kv_blocks = num_slots * (self.max_len // kv_block)
        self.paged_cfg = PagedKVConfig(num_blocks=int(kv_blocks),
                                       block_size=kv_block,
                                       quantized=bool(kv_int8))
        self.fns = make_slot_decode(model, num_slots, prefill_pad,
                                    self.paged_cfg,
                                    fused_rope=self.fused_rope,
                                    lora_kernel=self.lora_kernel,
                                    adapters=self.adapter_cfg)
        self.alloc = BlockAllocator(self.paged_cfg.num_blocks, kv_block,
                                    self.max_len,
                                    prefix_cache_blocks=prefix_cache_blocks)
        self.num_slots = num_slots
        self.prefill_pad = prefill_pad
        self.block = max(1, int(decode_block if decode_block else 8))
        self.state = self.fns.init_state()
        self.cache = self.fns.init_slots()
        self.occupied = np.zeros(num_slots, bool)
        self.decoding = np.zeros(num_slots, bool)
        self.pos = np.zeros(num_slots, np.int32)
        self.counts = np.zeros(num_slots, np.int32)
        self.budget = np.zeros(num_slots, np.int32)
        self.temps = np.zeros(num_slots, np.float32)
        #: slot → (full prompt, next chunk offset) for prompts longer than
        #: one prefill chunk
        self._prefill_rest: Dict[int, Tuple[np.ndarray, int]] = {}
        self.peak_occupied = 0
        #: model forward passes run (one per prefill call, one per decode
        #: step): each runs every layer once
        self.n_forwards = 0
        self.n_decode_blocks = 0
        self.n_decode_tokens = 0
        self.n_decode_steps = 0
        self.t_decode_dispatch_s = 0.0
        self.t_decode_sync_s = 0.0
        self.kv_read_bytes_total = 0
        self.prefill_read_bytes_total = 0
        self.prefill_write_bytes_total = 0

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- inspection ---------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [s for s in range(self.num_slots) if not self.occupied[s]]

    def prefilling_slots(self) -> List[int]:
        """Slots holding a partially-prefilled prompt."""
        return sorted(self._prefill_rest)

    @property
    def num_active(self) -> int:
        return int(self.decoding.sum())

    @property
    def num_occupied(self) -> int:
        return int(self.occupied.sum())

    @property
    def occupancy(self) -> float:
        return self.num_active / self.num_slots

    @staticmethod
    def launch_counts() -> Dict[str, int]:
        """Kernel launches per kernel since the last reset — the port's
        stand-in for the JAX engine's ``compile_counts``."""
        return ops.launch_counts()

    def decode_stats(self) -> Dict[str, float]:
        return {
            "blocks": self.n_decode_blocks,
            "tokens": self.n_decode_tokens,
            "forwards": self.n_forwards,
            "steps": self.n_decode_steps,
            "dispatch_s": self.t_decode_dispatch_s,
            "sync_s": self.t_decode_sync_s,
            "kv_read_bytes": self.kv_read_bytes_total,
        }

    def _decode_kv_read_bytes(self, pos0: np.ndarray, passes: int,
                              window_per_lane: int) -> int:
        """KV bytes one decode dispatch's attention streams: each pass walks
        every lane's live blocks (whole blocks) plus its window positions
        (unquantized, in the compute dtype)."""
        pg = self.fns.paged
        bs = self.paged_cfg.block_size
        live = ((pos0.astype(np.int64) + bs - 1) // bs) * bs
        itemsize = torch.empty((), dtype=pg.compute_dtype).element_size()
        window_bpp = 2 * pg.n_layers * pg.n_kv * pg.dh * itemsize
        return int(passes * int(live.sum()) * pg.bytes_per_pos
                   + len(pos0) * window_per_lane * window_bpp)

    def _prefill_kv_bytes(self, pos0: np.ndarray,
                          clens: np.ndarray) -> Tuple[int, int]:
        """``(read, write)`` KV bytes of one prefill dispatch: each lane
        walks its pool prefix in whole blocks and writes the blocks its
        chunk ``[pos0, pos0 + clen)`` covers."""
        bpp = self.fns.paged.bytes_per_pos
        bs = self.paged_cfg.block_size
        pos0 = np.asarray(pos0, np.int64)
        clens = np.asarray(clens, np.int64)
        pref = ((pos0 + bs - 1) // bs) * bs
        touched = np.where(clens > 0,
                           (pos0 + clens - 1) // bs - pos0 // bs + 1, 0)
        return int(pref.sum() * bpp), int(touched.sum() * bs * bpp)

    def kv_stats(self) -> Dict[str, object]:
        """KV residency accounting (the serving report's capacity story)."""
        pg, al = self.fns.paged, self.alloc
        return {
            "paged": True, "attn_kernel": "paged", "prefill_kernel": True,
            "sample_kernel": True, "fused_rope": self.fused_rope,
            "lora_kernel": self.lora_kernel,
            "prefill_read_bytes": self.prefill_read_bytes_total,
            "prefill_write_bytes": self.prefill_write_bytes_total,
            "quantized": self.paged_cfg.quantized,
            "block_size": self.paged_cfg.block_size,
            "blocks_total": al.num_blocks,
            "blocks_in_use": al.blocks_in_use,
            "blocks_free": al.free_blocks,
            "cached_blocks": al.cached_blocks,
            "block_occupancy": al.blocks_in_use / al.num_blocks,
            "pool_bytes": pg.pool_bytes,
            "bytes_resident": al.blocks_in_use * pg.block_bytes,
            "bytes_per_pos": pg.bytes_per_pos,
            "peak_occupied_slots": self.peak_occupied,
            "prefix_hit_blocks": al.prefix_hit_blocks,
            "prefix_miss_blocks": al.prefix_miss_blocks,
            "prefix_hit_tokens": al.prefix_hit_tokens,
            "blocks_admitted_total": al.blocks_admitted_total,
            "blocks_released_total": al.blocks_released_total,
        }

    # -- per-tenant adapters ------------------------------------------------

    def has_adapter(self, name: Optional[str]) -> bool:
        """Would a NEW request naming ``name`` bind right now?  (None =
        base-only, always true; a named adapter needs an adapter pool
        holding it and not marked for unload.)"""
        if name is None:
            return True
        return self.adapters is not None and self.adapters.has(name)

    def load_adapter(self, name: str, factors) -> Dict[str, object]:
        """Load ``factors`` (:func:`tpudist_torch.models.lora.
        make_adapter_factors`-shaped: ``a_* [L, d_in, r]``, ``b_* [L, r,
        d_out]``) under ``name``: reserves a pool block (LRU-evicting a
        cold adapter if full — its block is zeroed first), writes the
        factors and returns ``{"block", "evicted", "resident"}``.  Safe
        beside the engine thread: only a block no lane is bound to is
        written, and the name stays unbindable until its factors are in."""
        if self.adapters is None:
            raise RuntimeError("engine built without adapters=True")
        _lora.check_factors(self.model, self.adapter_cfg, factors)
        bid, evicted = self.adapters.load(name)
        if evicted is not None:
            _lora.zero_block(self.apool, evicted[1])
        _lora.load_factors(self.apool, bid, factors)
        self.adapters.activate(name)
        return {"block": bid,
                "evicted": None if evicted is None else evicted[0],
                "resident": self.adapters.resident}

    def unload_adapter(self, name: str) -> Dict[str, object]:
        """Unload ``name``: frees (and zeroes) its block now when no lane
        holds it, else defers — new requests reject ``adapter_missing`` at
        once, the block frees when the last bound lane evicts.  Returns
        ``{"freed", "resident", "known"}``."""
        if self.adapters is None:
            raise RuntimeError("engine built without adapters=True")
        res = self.adapters.unload(name)
        if res is None:
            return {"freed": False, "resident": self.adapters.resident,
                    "known": False}
        freed_now, bid = res
        if freed_now:
            _lora.zero_block(self.apool, bid)
        return {"freed": freed_now, "resident": self.adapters.resident,
                "known": True}

    def adapter_stats(self) -> Dict[str, object]:
        """Adapter-pool accounting: registry counters plus pool geometry
        and bytes (``{"enabled": False}`` without adapters)."""
        if self.adapters is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "rank": self.adapter_cfg.rank,
            "block_bytes": _lora.adapter_block_bytes(self.model,
                                                     self.adapter_cfg),
            "pool_bytes": _lora.pool_bytes(self.apool),
            "slots_bound": sum(1 for a in self.slot_adapter
                               if a is not None),
            **self.adapters.stats(),
        }

    def _aid_sentinel(self) -> int:
        return (self.adapter_cfg.num_blocks
                if self.adapter_cfg is not None else 0)

    def _acquire_adapter(self, slot: int, name: Optional[str]) -> int:
        """Bind ``name`` to ``slot`` (refcount pin) and return its pool
        block id — the sentinel for a base-only lane.  Raises
        :class:`~tpudist_torch.serve.adapters.AdapterMissingError` when the
        name is not bindable."""
        if name is None:
            return self._aid_sentinel()
        if self.adapters is None:
            raise AdapterMissingError(name)
        bid = self.adapters.acquire(name)
        if bid is None:
            raise AdapterMissingError(name)
        self.slot_adapter[slot] = (name, bid)
        return bid

    def _release_adapter(self, slot: int) -> None:
        bound = self.slot_adapter[slot]
        if self.adapters is None or bound is None:
            return
        self.slot_adapter[slot] = None
        freed = self.adapters.release(*bound)
        if freed is not None:
            # a deferred unload / retired generation just completed: zero
            # the block before the free list hands it on
            _lora.zero_block(self.apool, freed)

    # -- admission ----------------------------------------------------------

    def check_budget(self, prompt_len: int, max_new: int) -> Optional[str]:
        """``None`` if a request fits, else the rejection reason (the one
        budget rule admission control and the engine agree on)."""
        if prompt_len < 1:
            return "empty_prompt"
        if max_new < 1:
            return "max_new_must_be_positive"
        if prompt_len + max_new > self.max_len:
            return (f"budget_exceeded: prompt {prompt_len} + max_new "
                    f"{max_new} > max_len {self.max_len}")
        need = self.alloc.blocks_needed(prompt_len, max_new)
        if need > self.alloc.num_blocks:
            return (f"kv_exhausted: footprint {need} blocks > pool "
                    f"{self.alloc.num_blocks}")
        return None

    def cache_full_slots(self) -> List[int]:
        """Decoding slots whose cursor reached ``max_len`` with budget left
        (only reachable when the budget rule was bypassed)."""
        return [int(s) for s in np.nonzero(
            self.decoding & (self.pos >= self.max_len)
            & (self.counts < self.budget))[0]]

    def can_admit_kv(self, prompt_len: int, max_new: int,
                     prefix_hashes: Sequence[str] = (), *,
                     reserve: int = 0) -> bool:
        """Would the pool cover this request right now, on top of
        ``reserve`` blocks promised to same-batch admissions?"""
        return self.alloc.can_admit(prompt_len, max_new, prefix_hashes,
                                    reserve=reserve)

    def kv_admission_probe(self, prompt_len: int, max_new: int,
                           prefix_hashes: Sequence[str] = (), *,
                           reserve: int = 0, protect: Sequence[int] = ()):
        """``(fresh_blocks, reused_ids)`` if the pool covers this request on
        top of ``reserve`` and ``protect``, else ``None``."""
        return self.alloc.probe(prompt_len, max_new, prefix_hashes,
                                reserve=reserve, protect=protect)

    def start_batch(self, items: Sequence[InsertItem]
                    ) -> Dict[int, Optional[int]]:
        """Admit up to ``num_slots`` requests in ONE batched prefill: each
        request's first chunk (after its reused prefix) is prefilled and
        installed in its slot.  Returns ``slot → first token`` for prompts
        that fit one chunk and ``slot → None`` for longer ones, which go on
        through :meth:`advance_prefill`.  Each item's whole block footprint
        is reserved here."""
        if not items:
            return {}
        if len(items) > self.num_slots:
            raise ValueError(
                f"start_batch of {len(items)} > num_slots {self.num_slots}")
        S, pad = self.num_slots, self.prefill_pad
        prompts = np.zeros((S, pad), np.int32)
        clens = np.zeros(S, np.int32)
        dsts = np.full(S, S, np.int32)  # num_slots marks an unused lane
        seeds = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        last = np.zeros(S, bool)
        # validate the whole batch before touching any state
        norm = []
        taken = set()
        adapter_names: Dict[int, Optional[str]] = {}
        for item in items:
            slot, prompt, temperature, seed, max_new = item[:5]
            hashes = tuple(item[5]) if len(item) > 5 else ()
            adapter = item[7] if len(item) > 7 else None
            if adapter is not None and not self.has_adapter(adapter):
                # a vanished adapter must not leak half-admitted
                # neighbours: the server finishes it "adapter_missing"
                raise AdapterMissingError(str(adapter))
            adapter_names[int(slot)] = adapter
            if len(item) > 8 and item[8] is not None:
                raise ValueError(
                    "constrained request on an engine built without "
                    "constrain= (structured output is not ported: ROADMAP.md "
                    "queue A item 5)")
            if self.occupied[slot] or slot in taken:
                raise ValueError(f"slot {slot} is occupied")
            taken.add(slot)
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            reason = self.check_budget(len(prompt), max_new)
            if reason is not None:
                raise ValueError(reason)
            norm.append((int(slot), prompt, float(temperature), int(seed),
                         int(max_new), hashes))
        # bind each lane's adapter first, transactionally: a mid-batch
        # AdapterMissingError (an unload raced the validation) rolls every
        # earlier pin back
        aids = np.full(S, self._aid_sentinel(), np.int32)
        bound: List[int] = []
        try:
            for j, (slot, *_rest) in enumerate(norm):
                aids[j] = self._acquire_adapter(slot, adapter_names[slot])
                bound.append(slot)
        except AdapterMissingError:
            for slot in bound:
                self._release_adapter(slot)
            raise
        M = self.max_len // self.paged_cfg.block_size
        tables = np.full((S, M), self.paged_cfg.num_blocks, np.int32)
        reused_len = np.zeros(S, np.int32)
        admitted = []
        # pin every item's reusable chain for the whole batch
        protect: List[int] = []
        for _, prompt, _, _, _, hashes in norm:
            protect.extend(self.alloc.reusable_blocks(len(prompt), hashes))
        try:
            for j, (slot, prompt, _, _, max_new, hashes) in enumerate(norm):
                row, reused = self.alloc.admit(slot, len(prompt), max_new,
                                               hashes, protect=protect)
                admitted.append(slot)
                tables[j, :len(row)] = row
                reused_len[j] = reused
        except RuntimeError:
            for slot in admitted:
                self.alloc.release(slot)
            for slot in bound:
                self._release_adapter(slot)
            raise
        for j, (slot, prompt, temperature, seed, _, _) in enumerate(norm):
            rest = len(prompt) - int(reused_len[j])
            clen = min(rest, pad)
            prompts[j, :clen] = prompt[reused_len[j]:reused_len[j] + clen]
            clens[j] = clen
            dsts[j] = slot
            seeds[j] = seed & 0xFFFFFFFF
            temps[j] = temperature
            last[j] = rest <= pad
        self.state, self.cache, firsts = self.fns.insert_batch(
            self.state, self.cache, self._t(tables), self._t(reused_len),
            self._t(prompts), self._t(clens), self._t(dsts), self._t(seeds),
            self._t(temps), self._t(last), sampled=bool((temps > 0).any()),
            aids=self._t(aids), apool=self.apool)
        self.n_forwards += 1
        r, w = self._prefill_kv_bytes(reused_len, clens)
        self.prefill_read_bytes_total += r
        self.prefill_write_bytes_total += w
        firsts_h = firsts.cpu().numpy() if last.any() else None
        out: Dict[int, Optional[int]] = {}
        for j, (slot, prompt, temperature, _, max_new, _) in enumerate(norm):
            self.occupied[slot] = True
            self.budget[slot] = max_new
            self.temps[slot] = temperature
            self.pos[slot] = reused_len[j] + clens[j]
            self.alloc.note_progress(slot, int(self.pos[slot]))
            if last[j]:
                self.decoding[slot] = True
                self.counts[slot] = 1
                out[slot] = int(firsts_h[j])
            else:
                self.counts[slot] = 0
                self._prefill_rest[slot] = (
                    prompt, int(reused_len[j]) + int(clens[j]))
                out[slot] = None
        self.peak_occupied = max(self.peak_occupied, self.num_occupied)
        return out

    def advance_prefill(self) -> Dict[int, int]:
        """Feed ONE prompt chunk to every prefilling slot.  Returns ``slot →
        first token`` for the slots whose prompt just completed."""
        if not self._prefill_rest:
            return {}
        pad = self.prefill_pad
        done: List[Tuple[int, torch.Tensor]] = []
        for slot in sorted(self._prefill_rest):
            prompt, off = self._prefill_rest[slot]
            clen = min(pad, len(prompt) - off)
            chunk = np.zeros(pad, np.int32)
            chunk[:clen] = prompt[off:off + clen]
            is_last = off + clen >= len(prompt)
            self.state, self.cache, first = self.fns.prefill_extend(
                self.state, self.cache, slot, self._t(chunk), clen, is_last,
                sampled=bool(self.temps[slot] > 0), apool=self.apool)
            self.n_forwards += 1
            # the one-hot batched program walks every lane's prefix
            r, w = self._prefill_kv_bytes(
                self.pos, np.where(np.arange(self.num_slots) == slot, clen,
                                   0))
            self.prefill_read_bytes_total += r
            self.prefill_write_bytes_total += w
            self.pos[slot] += clen
            self.alloc.note_progress(slot, int(self.pos[slot]))
            if is_last:
                del self._prefill_rest[slot]
                self.decoding[slot] = True
                self.counts[slot] = 1
                done.append((slot, first))
            else:
                self._prefill_rest[slot] = (prompt, off + clen)
        return {int(s): int(f) for s, f in done}

    # -- decode -------------------------------------------------------------

    def decode_block(self, max_k: Optional[int] = None
                     ) -> Tuple[Optional[dict], Dict[int, List[int]]]:
        """One fused decode block over every decoding slot: ``K`` steps,
        one fetch of the ``K × num_slots`` tokens.  ``K = min(block, min
        remaining budget, cache headroom)`` bucketed to a power of two, so
        no slot overshoots its budget.  Returns ``(info, slot → K
        tokens)`` (``None, {}`` when no slot is decoding)."""
        if not self.decoding.any():
            return None, {}
        dec = np.nonzero(self.decoding)[0]
        remaining = self.budget[dec] - self.counts[dec]
        if (remaining < 1).any():
            raise RuntimeError(
                "decoding slot with exhausted budget — the caller must "
                "evict finished slots before the next block")
        if (self.pos[dec] >= self.max_len).any():
            raise RuntimeError("active slot at max_len — admission budget "
                               "violated")
        cap = self.block if max_k is None else max(1, int(max_k))
        headroom = int((self.max_len - self.pos[dec]).min())
        k = _pow2_floor(min(cap, int(remaining.min()), headroom))
        pos0 = self.pos[dec].copy()
        t0 = time.perf_counter()
        self.state, self.cache, blocks = self.fns.decode_block(
            self.state, self.cache, k,
            sampled=bool((self.temps[dec] > 0).any()), apool=self.apool)
        t1 = time.perf_counter()
        arr = blocks.cpu().numpy()  # ONE host sync for K x num_slots tokens
        t2 = time.perf_counter()
        self.n_decode_blocks += 1
        self.n_forwards += k
        self.n_decode_tokens += k * len(dec)
        self.n_decode_steps += k
        self.t_decode_dispatch_s += t1 - t0
        self.t_decode_sync_s += t2 - t1
        self.counts[dec] += k
        self.pos[dec] += k
        out = {int(s): [int(t) for t in arr[:, s]] for s in dec}
        kv_read = self._decode_kv_read_bytes(pos0, k, k * (k + 1) // 2)
        self.kv_read_bytes_total += kv_read
        info = {"k": k, "tokens": k * len(dec), "dispatch_s": t1 - t0,
                "sync_s": t2 - t1, "kv_read_bytes": int(kv_read)}
        return info, out

    def decode_auto_plain(self, max_k: Optional[int] = None):
        """The plain fused block (no draft model in this slice)."""
        return self.decode_block(max_k=max_k)

    def decode_auto(self):
        """The serving loop's decode dispatcher."""
        return self.decode_block()

    def step(self) -> Dict[int, int]:
        """One single-token decode iteration (a K=1 block)."""
        _, toks = self.decode_block(max_k=1)
        return {s: t[0] for s, t in toks.items()}

    def evict(self, slot: int) -> None:
        """Free a lane: release its blocks on the host, zero the ones no
        tenant or prefix-cache entry still holds, reset the device state
        and the host shadows, and unpin its adapter (a deferred unload
        completes here)."""
        freed = self.alloc.release(slot)
        M = self.max_len // self.paged_cfg.block_size
        free_ids = np.full(M, self.paged_cfg.num_blocks, np.int32)
        free_ids[:len(freed)] = freed
        self.state, self.cache = self.fns.evict(
            self.state, self.cache, int(slot), self._t(free_ids))
        self._release_adapter(slot)
        self.occupied[slot] = False
        self.decoding[slot] = False
        self.pos[slot] = 0
        self.counts[slot] = 0
        self.budget[slot] = 0
        self.temps[slot] = 0.0
        self._prefill_rest.pop(slot, None)
