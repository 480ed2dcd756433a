"""Slot-based continuous-batching decode engine — the PyTorch port of
``tpudist/serve/engine.py``: a paged KV pool
(native or int8, with or without a prefix cache) or the dense slot cache
(``paged=False``: every slot owns ``max_len`` positions and a free slot is
the whole admission budget); decode through the paged decode kernel or a
dense view (``attn_kernel="gather"``), prefill through the paged prefill
kernel or teacher-forced (``prefill_kernel=False``), sampling through the
fused sampling kernel or the unfused tail (``sample_kernel=False``);
optionally the fused RoPE+QKV kernel (``fused_rope``) and per-tenant LoRA
adapters
(``adapters``: a factor pool beside the KV pool, named adapters bound to
lanes by the host registry of :mod:`tpudist_torch.serve.adapters`, each
lane's delta from the LoRA gather-matmul kernel), optionally speculative
decoding (``spec_draft``: a draft proposes ``K`` tokens a lane, the target
verifies them in one pass and emits ``accepted + 1``), optionally structured
output (``constrain``: a grammar-table pool beside the KV pool, compiled
grammars bound to lanes by the host registry of :mod:`tpudist_torch.
constrain.registry`, each lane's row masked by the sampling kernel) and
top-n logprobs (``logprobs``), and optionally a serving mesh (``mesh``:
``data × model`` places, :mod:`tpudist_torch.serve.spmd`).  A decoding
lane moves between slots and engines — the host tier's parks and
preemptions, the fleet's migrations — through :meth:`SlotEngine.
export_slot` and :meth:`SlotEngine.import_slot` / :meth:`SlotEngine.
resume_slot` (a parked session's next turn prefills only its suffix).

The engine is the device half: ``num_slots`` KV lanes over the slot
programs of :func:`tpudist_torch.models.make_slot_decode`, plus host shadow
cursors (occupied/decoding, pos, counts, budget) for admission and
block-size decisions.  Per engine iteration: ONE batched prefill for an
admission batch, one chunk per still-prefilling slot (chunked prefill), and
ONE decode block of ``K`` steps followed by ONE fetch of the ``K × S``
tokens.  Single-threaded by contract.

On a speculative engine the decode iteration is :meth:`SlotEngine.
spec_decode_block`: one ``draft_propose`` (``K + 1`` draft steps), one
``spec_verify`` (one target pass over the ``K + 1``-token window, the
acceptance, the rollback) and one fetch of the packed ``[S, K + 3]``
tokens.  Every plain block of a spec engine is draft-tracked, so the draft
never desyncs from the target.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpudist_torch import ops
from tpudist_torch.constrain import (ConstrainConfig, GrammarError,
                                     GrammarRegistry, compile_cache_stats)
from tpudist_torch.models import lora as _lora
from tpudist_torch.models.generate import make_slot_decode
from tpudist_torch.models.paged import PagedKVConfig, PagedLane
from tpudist_torch.models.transformer import (PlacedLM, TransformerLM,
                                              resolve_device,
                                              tied_draft)
from tpudist_torch.serve.adapters import (AdapterMissingError,
                                          AdapterRegistry)
from tpudist_torch.serve import spmd
from tpudist_torch.serve.paged_alloc import BlockAllocator

#: ``start_batch`` item: (slot, prompt_1d_int32, temperature, seed, max_new)
#: plus an optional 6th element — the prompt's prefix hash chain — an
#: optional 7th — the speculative-decoding opt (True/None = speculate;
#: False rides the spec programs with acceptance forced to zero and draws
#: the non-speculative stream; ignored by a non-spec engine) — an optional
#: 8th — the lane's adapter NAME (None =
#: base-only) — and an optional 9th — the request's compiled
#: :class:`tpudist_torch.constrain.TokenGrammar` (None = unconstrained; the
#: engine binds it into the grammar pool)
InsertItem = Tuple[int, np.ndarray, float, int, int]


def _tensors(t) -> list:
    """A tensor, or a placed cache's tuple of them, as a list."""
    return list(t) if isinstance(t, tuple) else [t]


def _own_modules(module: nn.Module) -> nn.Module:
    """A shallow copy of ``module`` whose parameter, buffer and submodule
    tables are its own (the submodules copied alike): assigning to it
    leaves ``module`` as it is, while the tensors stay shared until
    replaced."""
    out = copy.copy(module)
    out._parameters = dict(module._parameters)
    out._buffers = dict(module._buffers)
    out._modules = {k: None if m is None else _own_modules(m)
                    for k, m in module._modules.items()}
    return out


def _pow2_floor(k: int) -> int:
    """Largest power of two ``<= k`` (the decode block-size buckets)."""
    return 1 << (max(1, k).bit_length() - 1)


class SlotEngine:
    """``num_slots`` KV lanes + host shadow cursors over the slot programs.

    Per slot the host shadows ``occupied`` (prefilling or decoding),
    ``decoding``, ``pos`` (filled positions), ``counts`` (tokens emitted),
    ``budget`` (``max_new``) and ``temps``; the authoritative state lives on
    the device.  ``model`` is moved to ``device`` (``"cuda"`` by default;
    a box without CUDA raises unless ``device="cpu"``).

    ``attn_kernel`` (``"paged"`` or ``"gather"``) and ``prefill_kernel``
    left at None take the kernel arms on a paged engine and the dense arms
    on a dense one (the kernel arms need the pool: asked for on a dense
    engine, they raise as the JAX engine's do).  ``prefix_cache_blocks``
    sizes the block allocator's prefix cache and does nothing on a dense
    engine, which has no allocator.

    ``spec_draft`` turns speculative decoding on: an int ties the target's
    first that many layers (:func:`~tpudist_torch.models.tied_draft`), a
    :class:`~tpudist_torch.models.TransformerLM` is a loaded draft (same
    ``vocab`` and ``max_len``); ``spec_k`` is the most tokens drafted per
    block.

    ``constrain`` (a :class:`~tpudist_torch.constrain.ConstrainConfig`)
    turns on structured output: a device pool ``[G+1, S_max, V]`` of allow
    and next-state tables (block ``G`` the all-True sentinel free lanes
    index), written once per grammar bind.  ``logprobs = n`` returns the
    top-``n`` post-mask logprobs of every decoded token in the decode
    blocks' ``info["logprobs"]``.

    ``mesh`` (a :class:`~tpudist_torch.serve.spmd.ServeMeshConfig` or its
    ``"DxM"`` shape) serves over ``data × model`` places (folded onto the
    engine's card when the host has fewer): the model's weights, the KV
    storage and the adapter pool split as :mod:`tpudist_torch.serve.spmd`
    lays them out, each place making its own kernel launches; the host
    half — state, tables, allocator, registries — is the unsplit
    engine's.  The TP overlap (``tp_overlap`` or the knobs) runs the MLP
    through the collective matmuls, except beside adapters, as in JAX; a
    tied draft shares the target's places.  :meth:`spmd_stats` reports
    the layout."""

    def __init__(self, model, *, num_slots: int = 4,
                 prefill_pad: Optional[int] = None,
                 decode_block: Optional[int] = None,
                 paged: bool = True, kv_block: int = 16,
                 kv_blocks: Optional[int] = None, kv_int8: bool = False,
                 prefix_cache_blocks: int = 0,
                 attn_kernel: Optional[str] = None,
                 prefill_kernel: Optional[bool] = None,
                 sample_kernel: bool = True,
                 fused_rope: bool = False,
                 lora_kernel: bool = False,
                 adapters: bool = False, adapter_blocks: int = 8,
                 adapter_rank: int = 8,
                 mesh=None, spec_draft=None, spec_k: int = 4,
                 constrain: Optional[ConstrainConfig] = None,
                 logprobs: int = 0, device="cuda"):
        # the JAX engine's rules for the kernel family's knobs (env-free
        # here; ServeConfig.from_env parses TPUDIST_SERVE_* once)
        if attn_kernel is None:
            attn_kernel = "paged" if paged else "gather"
        if prefill_kernel is None:
            prefill_kernel = bool(paged)
        if attn_kernel not in ("gather", "paged"):
            raise ValueError(
                f"attn_kernel must be 'gather' or 'paged', got "
                f"{attn_kernel!r} (TPUDIST_SERVE_ATTN_KERNEL)")
        if attn_kernel == "paged" and not paged:
            raise ValueError(
                "attn_kernel='paged' walks the paged block pool in-kernel "
                "— it requires paged=True (TPUDIST_SERVE_PAGED)")
        if prefill_kernel and not paged:
            raise ValueError(
                "prefill_kernel=True is the paged-prefill kernel — it "
                "requires paged=True (TPUDIST_SERVE_PREFILL_KERNEL)")
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
        if adapters and (getattr(model, "n_experts", 0) > 0
                         or getattr(model, "mlp_fn", None) is not None):
            raise ValueError(
                "adapters wrap the plain qkv/wi/wo Dense path — they "
                "cannot compose with an MoE FFN or an injected mlp_fn")
        self.device = resolve_device(device)
        model = model.to(self.device)
        self.model = model
        # -- the serving mesh: the model's forward over data × model places
        # (spmd.place_model), the KV, adapter and draft layouts following
        self.mesh = None
        self.tp_overlap = "off"
        self._mesh_cfg = None
        self.places = None
        if mesh is not None:
            cfg = (mesh if isinstance(mesh, spmd.ServeMeshConfig)
                   else spmd.ServeMeshConfig(shape=str(mesh)))
            self._mesh_cfg = cfg
            self.mesh = spmd.build_serve_mesh(cfg, self.device)
        if self.mesh is not None:
            self.tp_overlap = spmd.resolve_serve_overlap(self._mesh_cfg)
            mlp_fn = None
            # the MoE FFN owns the mlp seam: its router and expert stacks
            # stay whole on every place (JAX forces the overlap off too)
            if (self.tp_overlap != "off" and not adapters
                    and getattr(model, "n_experts", 0) == 0):
                # the ring needs both FFN weights split; the fused
                # overlapped MLP hides the wi/wo seam adapters wrap
                mlp_fn = spmd.serve_overlap_mlp_fn(self.mesh,
                                                   mode=self.tp_overlap)
                m = self.mesh.model
                if model.d_ff % m or model.d_model % m:
                    mlp_fn = None
            if mlp_fn is None:
                self.tp_overlap = "off"
            self._param_sharding = spmd.serve_param_sharding(
                self.mesh, model, overlap=mlp_fn is not None)
            self._spmd_param_stats = spmd.sharded_param_bytes(
                model, self._param_sharding)
            self.places = spmd.place_model(self.mesh, model,
                                           self._param_sharding, mlp_fn)
        self.attn_kernel = attn_kernel
        self.prefill_kernel = bool(prefill_kernel)
        self.sample_kernel = bool(sample_kernel)
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
            if self.mesh is not None:
                self.apool = spmd.place_adapter_pool(self.mesh, self.apool,
                                                     model)
            self.adapters = AdapterRegistry(self.adapter_cfg.num_blocks)
        # -- structured output: the grammar-table pool, the host registry
        # deciding which compiled grammar occupies which block, and the
        # host shadow slot → bound ``(TokenGrammar, block_id)`` (None =
        # unconstrained; the grammar is the shadow automaton the server
        # walks over delivered tokens)
        self.constrain_cfg = constrain
        self.grammars: Optional[GrammarRegistry] = None
        self.gpool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.slot_grammar: List[Optional[Tuple[object, int]]] = \
            [None] * num_slots
        V = int(model.vocab)
        if constrain is not None:
            if len(constrain.vocab) != V:
                raise ValueError(
                    f"constrain vocab has {len(constrain.vocab)} entries, "
                    f"model vocab is {V}")
            self.grammars = GrammarRegistry(constrain.num_blocks)
            G, S_max = constrain.num_blocks, constrain.max_states
            # every block starts as the identity (all-True, next 0): a
            # never-written block decodes unconstrained instead of sampling
            # an all-masked row, and block G stays the sentinel (binds only
            # write blocks < G)
            self.gpool = (
                torch.ones((G + 1, S_max, V), dtype=torch.bool,
                           device=self.device),
                torch.zeros((G + 1, S_max, V), dtype=torch.int32,
                            device=self.device))
        #: top-n logprobs width of the decode programs (0 = off); a
        #: request's ``logprobs=n`` is a host-side slice of it
        self.n_lp = max(0, int(logprobs))
        if self.n_lp > V:
            raise ValueError(f"logprobs {self.n_lp} > vocab {V}")
        self.max_len = int(model.max_len)
        if prefill_pad is None:
            prefill_pad = min(self.max_len, 64)
        self.paged_cfg: Optional[PagedKVConfig] = None
        if paged:
            kv_block = min(int(kv_block), self.max_len)
            if self.max_len % kv_block:
                raise ValueError(
                    f"kv_block {kv_block} must divide max_len "
                    f"{self.max_len}")
            if kv_blocks is None:
                # dense-equivalent capacity
                kv_blocks = num_slots * (self.max_len // kv_block)
            self.paged_cfg = PagedKVConfig(num_blocks=int(kv_blocks),
                                           block_size=kv_block,
                                           quantized=bool(kv_int8))
        # -- speculative decoding: an int ties the target's first N layers
        # (zero extra parameters), a TransformerLM is a loaded draft
        self.spec = spec_draft is not None
        self.spec_k = max(1, int(spec_k))
        self.draft_model: Optional[TransformerLM] = None
        draft_places = None
        if isinstance(spec_draft, bool):
            raise TypeError("spec_draft is a layer count or a TransformerLM")
        if isinstance(spec_draft, int):
            self.draft_model = tied_draft(model, spec_draft)
            if self.places is not None:
                draft_places = self.places.draft(self.draft_model)
        elif isinstance(spec_draft, TransformerLM):
            self.draft_model = spec_draft.to(self.device).requires_grad_(
                False)
            if self.mesh is not None:
                draft_places = spmd.place_model(
                    self.mesh, self.draft_model,
                    spmd.serve_spec_param_sharding(self.mesh,
                                                   self.draft_model))
        elif spec_draft is not None:
            raise TypeError(f"spec_draft must be an int or a TransformerLM, "
                            f"got {type(spec_draft).__name__}")
        self.fns = make_slot_decode(model, num_slots, prefill_pad,
                                    self.paged_cfg, attn_kernel=attn_kernel,
                                    prefill_kernel=self.prefill_kernel,
                                    sample_kernel=self.sample_kernel,
                                    fused_rope=self.fused_rope,
                                    lora_kernel=self.lora_kernel,
                                    adapters=self.adapter_cfg,
                                    spec=self.draft_model,
                                    constrain=constrain, logprobs=self.n_lp,
                                    places=self.places,
                                    draft_places=draft_places)
        #: the draft's places under a mesh (the programs hold them): a
        #: swap re-cuts their weights in place
        self._draft_places = draft_places
        #: whether the draft's modules are its own (a swap's first step:
        #: a tied draft's blocks are the target's)
        self._draft_owned = False
        #: applied draft hot-swaps (:meth:`swap_draft`)
        self.draft_swaps = 0
        #: the block allocator (None on the dense engine: a free slot is
        #: the whole admission budget)
        self.alloc: Optional[BlockAllocator] = None
        if paged:
            self.alloc = BlockAllocator(
                self.paged_cfg.num_blocks, kv_block, self.max_len,
                prefix_cache_blocks=prefix_cache_blocks)
        self.num_slots = num_slots
        self.prefill_pad = prefill_pad
        self.block = max(1, int(decode_block if decode_block else 8))
        self.state = self.fns.init_state()
        self.cache = self.fns.init_slots()
        self.dcache = self.fns.init_draft() if self.spec else None
        self.occupied = np.zeros(num_slots, bool)
        self.decoding = np.zeros(num_slots, bool)
        self.pos = np.zeros(num_slots, np.int32)
        self.counts = np.zeros(num_slots, np.int32)
        self.budget = np.zeros(num_slots, np.int32)
        self.temps = np.zeros(num_slots, np.float32)
        #: per-slot speculative opt (the host shadow of ``spec_on``)
        self.spec_on = np.ones(num_slots, bool)
        #: slot → (full prompt, next chunk offset) for prompts longer than
        #: one prefill chunk
        self._prefill_rest: Dict[int, Tuple[np.ndarray, int]] = {}
        self.peak_occupied = 0
        #: target forward passes run (one per prefill call, one per decode
        #: step or verify pass): each runs every layer once
        self.n_forwards = 0
        self.n_decode_blocks = 0
        self.n_decode_tokens = 0
        #: target forwards of the decode arm (decode steps, verify passes)
        self.n_decode_steps = 0
        #: draft forward passes (prefill calls, propose steps, track
        #: passes) and those of the decode arm (propose steps, track passes)
        self.n_draft_forwards = 0
        self.n_draft_decode_forwards = 0
        # speculative-decode counters (spec_stats)
        self.n_spec_blocks = 0
        self.n_spec_lane_passes = 0  # sum of active lanes over spec blocks
        self.n_spec_tokens = 0
        self.n_spec_accepted = 0
        self.n_spec_drafted = 0
        self.n_spec_rollbacks = 0
        self.t_spec_draft_s = 0.0
        self.t_spec_verify_s = 0.0
        self.t_spec_sync_s = 0.0
        #: adapter name → [accepted, drafted] over lanes bound to it
        self.spec_adapter_counts: Dict[str, List[int]] = {}
        self.t_decode_dispatch_s = 0.0
        self.t_decode_sync_s = 0.0
        self.kv_read_bytes_total = 0
        self.prefill_read_bytes_total = 0
        self.prefill_write_bytes_total = 0
        #: the dense arena's resident bytes (0 on a paged engine)
        self._dense_resident_bytes = (
            0 if paged else int(num_slots * self.max_len
                                * self._bytes_per_pos()))

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
            "draft_forwards": self.n_draft_forwards,
            "draft_decode_forwards": self.n_draft_decode_forwards,
            "dispatch_s": self.t_decode_dispatch_s,
            "sync_s": self.t_decode_sync_s,
            "kv_read_bytes": self.kv_read_bytes_total,
        }

    def spec_stats(self) -> Dict[str, object]:
        """Speculative-decode counters: blocks, emitted tokens, drafted vs
        accepted (``accepted_per_pass`` = tokens per lane pass,
        ``acceptance_rate`` = accepted / drafted), rollbacks (a verify that
        rejected a draft), the draft / verify / fetch wall split, the
        per-adapter acceptance and the draft pool's bytes."""
        out = {
            "enabled": self.spec,
            "blocks": self.n_spec_blocks,
            "lane_passes": self.n_spec_lane_passes,
            "tokens": self.n_spec_tokens,
            "accepted": self.n_spec_accepted,
            "drafted": self.n_spec_drafted,
            "rollbacks": self.n_spec_rollbacks,
            "accepted_per_pass": (
                self.n_spec_tokens / self.n_spec_lane_passes
                if self.n_spec_lane_passes else None),
            "acceptance_rate": (self.n_spec_accepted / self.n_spec_drafted
                                if self.n_spec_drafted else None),
            "draft_s": self.t_spec_draft_s,
            "verify_s": self.t_spec_verify_s,
            "sync_s": self.t_spec_sync_s,
            "spec_k": self.spec_k if self.spec else None,
            "draft_swaps": self.draft_swaps,
        }
        if self.spec and self.spec_adapter_counts:
            out["by_adapter"] = {
                name: {"accepted": a, "drafted": d,
                       "acceptance_rate": (a / d if d else None)}
                for name, (a, d) in sorted(self.spec_adapter_counts.items())}
        if self.spec:
            out["draft_pool_bytes"] = (
                self.fns.draft_paged.pool_bytes if self.alloc is not None
                else sum(t.nbytes for t in _tensors(self.dcache.k)
                         + _tensors(self.dcache.v)))
        return out

    def spmd_stats(self) -> Dict[str, object]:
        """The serving-mesh story (JAX's keys): mesh geometry, the
        TP-overlap routing mode, and where the parameter bytes live; plus
        ``replicated``, the pieces a ``model`` axis above 1 leaves whole
        because it does not divide them (``attention``: ``n_kv``, so
        ``qkv`` and the KV; ``wi``; ``head``; ``moe``, an MoE model's
        router and expert stacks, always) and ``slots`` where ``data``
        does not divide the dense arena's slots.  Trivial on a
        single-device engine."""
        if self.mesh is None:
            return {"mesh": None, "tp_overlap": "off"}
        d, m = self._mesh_cfg.dims
        pl = self.places
        moe = getattr(self.model, "n_experts", 0) > 0
        whole = [name for name, n in (("attention", pl.attn_places),
                                      ("moe", 1) if moe
                                      else ("wi", pl.wi_places),
                                      ("head", pl.head_places))
                 if m > 1 and n == 1]
        if self.alloc is None and d > 1 and self.num_slots % d:
            whole.append("slots")
        return {"mesh": {"data": d, "model": m},
                "n_devices": self._mesh_cfg.n_devices,
                "tp_overlap": self.tp_overlap,
                **self._spmd_param_stats, "replicated": whole}

    # -- speculative draft hot-swap (tpudist_torch.distill) ----------------

    def swap_draft(self, new_params) -> Dict[str, object]:
        """Replace the serving draft's weights with a same-geometry
        candidate ``new_params`` (a state dict of the draft's names) — a
        weight update: the slot programs call the draft module, so no
        program is rebuilt (``fns`` stays the same object) and no kernel
        is built.

        The geometry is ASSERTED, not assumed: the names, shapes and dtypes
        must equal the serving draft's state dict (``ValueError`` naming
        the first mismatch).  The first swap gives the draft modules and
        parameters of its own — a tied draft's blocks, embeddings and head
        are the target's, which stay as they are; each later swap replaces
        the draft's parameters again.  Each tensor lands on the serving
        copy's device and dtype; under a mesh the draft's places are cut
        anew from it (never the target's views).  Then every OCCUPIED
        lane's draft context is re-armed through ``draft_arm`` (cursor at
        the lane's target position over a cold context: the import_slot
        precedent — a cold draft context can only lower acceptance, never
        correctness).  Greedy output does not depend on the draft: the
        target verify is the oracle (on the kernel arms the acceptance
        moves the verify windows, whose rounding may part a stream at a
        near tie, ROADMAP C3).

        Single-threaded by the engine contract — callers on another thread
        go through ``InferenceServer.swap_draft``, which lands the swap
        between decode blocks."""
        if not self.spec:
            raise RuntimeError("engine built without spec_draft")
        t0 = time.perf_counter()
        draft = self.draft_model
        ref = draft.state_dict()
        if not isinstance(new_params, Mapping) \
                or set(new_params) != set(ref):
            got = sorted(new_params) if isinstance(new_params, Mapping) \
                else type(new_params).__name__
            raise ValueError(
                "draft swap geometry mismatch: candidate names != serving "
                f"draft's ({got} vs {sorted(ref)})")
        new = {name: torch.as_tensor(new_params[name]) for name in ref}
        for name, r in ref.items():
            n = new[name]
            if tuple(n.shape) != tuple(r.shape) or n.dtype != r.dtype:
                raise ValueError(
                    f"draft swap geometry mismatch: {name} "
                    f"{tuple(n.shape)}/{n.dtype} != serving "
                    f"{tuple(r.shape)}/{r.dtype}")
        if not self._draft_owned:
            draft.blocks = nn.ModuleList(_own_modules(b)
                                         for b in draft.blocks)
            self._draft_owned = True
        with torch.no_grad():
            for name, r in ref.items():
                path, _, leaf = name.rpartition(".")
                owner = draft.get_submodule(path) if path else draft
                setattr(owner, leaf, nn.Parameter(
                    torch.empty_like(r).copy_(new[name]),
                    requires_grad=False))
        dp = self._draft_places
        if dp is not None:
            fresh = PlacedLM(draft, dp.devices, attn_places=dp.attn_places,
                             wi_places=dp.wi_places,
                             head_places=dp.head_places,
                             wo_places=dp.wo_places, mlp_fn=dp.mlp_fn)
            dp.blocks, dp.head = fresh.blocks, fresh.head
        rearmed = 0
        for slot in range(self.num_slots):
            if not self.occupied[slot]:
                continue
            pos = int(self.pos[slot])
            if self.alloc is not None:
                self.dcache = self.fns.draft_arm(
                    self.dcache, slot, self.dcache.table[slot].clone(), pos)
            else:
                self.dcache = self.fns.draft_arm(self.dcache, slot, pos)
            rearmed += 1
        self.draft_swaps += 1
        return {"swapped": True, "lanes_rearmed": rearmed,
                "swap_s": time.perf_counter() - t0,
                "draft_swaps": self.draft_swaps}

    def _bytes_per_pos(self) -> float:
        """Resident KV bytes per cached position: the pool's (int8 and
        scales when quantized) or the dense cache's K and V rows over every
        layer."""
        if self.alloc is not None:
            return self.fns.paged.bytes_per_pos
        m = self.model
        itemsize = torch.empty((), dtype=m.dtype).element_size()
        return float(2 * m.n_layers * m.n_kv * m.head_dim * itemsize)

    def _decode_kv_read_bytes(self, pos0: np.ndarray, passes: int,
                              window_per_lane: int) -> int:
        """KV bytes one decode dispatch's attention streams, per the arm
        (the JAX engine's model): on the paged kernel each pass walks every
        lane's live blocks (whole blocks) plus its window positions
        (unquantized, in the compute dtype); on the gather and dense arms
        every pass sweeps the full ``[num_slots, max_len]`` view."""
        bpp = self._bytes_per_pos()
        if self.attn_kernel != "paged":
            return int(passes * self.num_slots * self.max_len * bpp)
        pg = self.fns.paged
        bs = self.paged_cfg.block_size
        live = ((pos0.astype(np.int64) + bs - 1) // bs) * bs
        itemsize = torch.empty((), dtype=pg.compute_dtype).element_size()
        window_bpp = 2 * pg.n_layers * pg.n_kv * pg.dh * itemsize
        return int(passes * int(live.sum()) * bpp
                   + len(pos0) * window_per_lane * window_bpp)

    def _prefill_kv_bytes(self, pos0: np.ndarray, clens: np.ndarray,
                          lanes: int) -> Tuple[int, int]:
        """``(read, write)`` KV bytes of one prefill dispatch, per the arm:
        the kernel walks each lane's pool prefix in whole blocks and writes
        the blocks its chunk ``[pos0, pos0 + clen)`` covers; the
        teacher-forced arm builds a ``max_len`` dense view for each of its
        ``lanes`` and sweeps it once in its one forward (the JAX scan
        sweeps it once a padded step), and writes back the static span of
        blocks a chunk can touch (the dense engine: the whole lane)."""
        bpp = self._bytes_per_pos()
        pos0 = np.asarray(pos0, np.int64)
        clens = np.asarray(clens, np.int64)
        live = clens > 0
        if self.prefill_kernel:
            bs = self.paged_cfg.block_size
            pref = ((pos0 + bs - 1) // bs) * bs
            touched = np.where(live,
                               (pos0 + clens - 1) // bs - pos0 // bs + 1, 0)
            return int(pref.sum() * bpp), int(touched.sum() * bs * bpp)
        read = lanes * 2 * self.max_len * bpp
        if self.alloc is not None:
            pg = self.fns.paged
            write = int(live.sum()) * pg.touch_count(self.prefill_pad) * \
                self.paged_cfg.block_size * bpp
        else:
            write = int(live.sum()) * self.max_len * bpp
        return int(read), int(write)

    def kv_stats(self) -> Dict[str, object]:
        """KV residency accounting (the serving report's capacity story):
        the dense engine pins its whole arena, the paged engine the blocks
        tenants and the prefix cache hold."""
        arms = {"attn_kernel": self.attn_kernel,
                "prefill_kernel": self.prefill_kernel,
                "sample_kernel": self.sample_kernel,
                "fused_rope": self.fused_rope,
                "lora_kernel": self.lora_kernel,
                "prefill_read_bytes": self.prefill_read_bytes_total,
                "prefill_write_bytes": self.prefill_write_bytes_total}
        if self.alloc is None:
            return {
                "paged": False, **arms, "quantized": False,
                "block_size": None, "blocks_total": None,
                "blocks_in_use": None, "blocks_free": None,
                "cached_blocks": None, "block_occupancy": None,
                "pool_bytes": self._dense_resident_bytes,
                "bytes_resident": self._dense_resident_bytes,
                "bytes_per_pos": self._bytes_per_pos(),
                "peak_occupied_slots": self.peak_occupied,
            }
        pg, al = self.fns.paged, self.alloc
        return {
            "paged": True, **arms,
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

    def kv_gauges(self) -> Tuple[Optional[float], int]:
        """The two per-decode-block telemetry gauges ``(block_occupancy,
        bytes_resident)`` — cheap enough for the decode hot loop (two
        counter reads; :meth:`kv_stats` builds the full dict)."""
        if self.alloc is None:
            return None, self._dense_resident_bytes
        return (self.alloc.blocks_in_use / self.alloc.num_blocks,
                self.alloc.blocks_in_use * self.fns.paged.block_bytes)

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

    # -- structured output (the grammar pool) -------------------------------

    def has_constrain(self) -> bool:
        """Would a NEW constrained request bind (pool-full deferral
        aside)?  False on an engine built without ``constrain=``."""
        return self.grammars is not None

    def _gid_sentinel(self) -> int:
        return (self.constrain_cfg.num_blocks
                if self.constrain_cfg is not None else 0)

    def _write_grammar_block(self, block: int, tg) -> None:
        """Upload ``tg``'s tables into pool ``block`` (one host-to-device
        copy a bind, never a step); rows past ``n_states`` stay the
        identity, so a defensive gather never lands on an all-masked
        row."""
        cfg = self.constrain_cfg
        S_max, V = cfg.max_states, len(cfg.vocab)
        if tg.n_states > S_max or tg.allowed.shape[1] != V:
            raise GrammarError(
                f"grammar tables [{tg.n_states}, {tg.allowed.shape[1]}] "
                f"exceed the pool row [{S_max}, {V}] "
                "(TPUDIST_CONSTRAIN_STATES)")
        allow = np.ones((S_max, V), bool)
        nxt = np.zeros((S_max, V), np.int32)
        allow[:tg.n_states] = tg.allowed
        nxt[:tg.n_states] = tg.next_state
        self.gpool[0][block].copy_(torch.from_numpy(allow))
        self.gpool[1][block].copy_(torch.from_numpy(nxt))

    def _acquire_grammar(self, slot: int, tg) -> int:
        """Bind compiled grammar ``tg`` to ``slot`` (refcount pin) and
        return its pool block id — the sentinel for an unconstrained lane.
        A fresh bind writes the tables before any lane decodes under the
        block.  Raises :class:`~tpudist_torch.constrain.GrammarPoolFull`
        when every block is pinned (the server defers the request)."""
        if tg is None:
            return self._gid_sentinel()
        if self.grammars is None:
            raise RuntimeError("engine built without constrain=")
        block, fresh = self.grammars.bind(tg)
        if fresh:
            try:
                self._write_grammar_block(block, tg)
            except BaseException:
                self.grammars.release(block)
                raise
        self.slot_grammar[slot] = (tg, block)
        return block

    def _release_grammar(self, slot: int) -> None:
        if self.grammars is None:
            return
        bound = self.slot_grammar[slot]
        if bound is None:
            return
        self.slot_grammar[slot] = None
        self.grammars.release(bound[1])

    def constrain_stats(self) -> Dict[str, object]:
        """Grammar-pool accounting: registry counters, the compile cache's
        hits and misses, the pool's geometry and bytes (``{"enabled":
        False}`` without ``constrain``)."""
        if self.grammars is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "max_states": self.constrain_cfg.max_states,
            "pool_bytes": int(self.gpool[0].numel()
                              + self.gpool[1].numel() * 4),
            "slots_bound": sum(1 for g in self.slot_grammar
                               if g is not None),
            "compile_cache": compile_cache_stats(),
            **self.grammars.stats(),
        }

    # -- lane transfer (the host tier, preemption, the fleet) ---------------

    def export_slot(self, slot: int) -> Dict[str, object]:
        """Package a DECODING slot for another engine or the host tier: its
        KV lane ``(k, v, cursor)``, its :class:`~tpudist_torch.models.
        generate.SlotState` row (``last_tok``/``counts``/``seeds``: the
        sampling stream continues bit for bit wherever the lane lands) and
        the host shadows the importer needs.  A paged lane is the blocks
        the slot's row maps, as the pool stores them (a
        :class:`~tpudist_torch.models.paged.PagedLane`: an int8 pool's
        blocks and scales travel as they are), a dense one ``(k, v,
        cursor)`` over all ``max_len`` positions.  Does not evict."""
        if not self.decoding[slot]:
            raise ValueError(
                f"slot {slot} is not decoding (export happens after the "
                "prompt completes and the first token is sampled)")
        blocks = (None if self.alloc is None
                  else len(self.alloc.slot_row(slot)))
        lane, lane_state = self.fns.export_lane(self.state, self.cache,
                                                int(slot), blocks)
        return {"paged": self.alloc is not None,
                "lane": lane, "state": lane_state,
                "pos": int(self.pos[slot]),
                "counts": int(self.counts[slot]),
                "budget": int(self.budget[slot]),
                # the adapter travels by NAME and the grammar by SOURCE:
                # pool block ids are local, the importer re-binds
                "adapter": (self.slot_adapter[slot][0]
                            if self.adapters is not None
                            and self.slot_adapter[slot] is not None
                            else None),
                "grammar": (
                    {"source": self.slot_grammar[slot][0].source,
                     "eos_id": int(self.slot_grammar[slot][0].eos_id)}
                    if self.grammars is not None
                    and self.slot_grammar[slot] is not None else None)}

    def can_import(self, package: Dict[str, object]) -> bool:
        """Would the KV pool take the package right now (the caller checks
        for a free slot)?  A paged engine reserves the lane's whole
        remaining footprint; a dense one always fits."""
        if self.alloc is None:
            return True
        return self.alloc.can_admit(int(package["pos"]),
                                    int(package["budget"]), ())

    def import_slot(self, slot: int, package: Dict[str, object], *,
                    spec: Optional[bool] = None) -> None:
        """Install an exported lane into free ``slot`` and arm it for
        decode.  A paged engine reserves the remaining footprint on its
        pool (fresh blocks, no prefix sharing) and scatters the lane into
        them.  A speculative engine cold-starts the lane's draft at ``pos``
        over a zeroed context (``draft_arm``): that lowers acceptance, never
        correctness.  ``spec=False`` opts the lane out of speculation."""
        if self.occupied[slot]:
            raise ValueError(f"slot {slot} is occupied")
        if bool(package["paged"]) != (self.alloc is not None):
            raise ValueError("lane package and engine disagree on paged "
                             "mode — engines must share KV geometry")
        pos, counts = int(package["pos"]), int(package["counts"])
        budget = int(package["budget"])
        row_state = package["state"]
        self._install_lane(slot, package["lane"], row_state, pos,
                           admit_span=(pos, budget),
                           adapter=package.get("adapter"),
                           grammar=package.get("grammar"))
        self.occupied[slot] = True
        self.decoding[slot] = True
        self.pos[slot] = pos
        self.counts[slot] = counts
        self.budget[slot] = budget
        self.temps[slot] = float(row_state.temps)
        self.spec_on[slot] = True if spec is None else bool(spec)
        self.peak_occupied = max(self.peak_occupied, self.num_occupied)

    def _install_lane(self, slot: int, lane, row_state, pos: int, *,
                      admit_span: Tuple[int, int],
                      adapter: Optional[str] = None,
                      grammar: Optional[Dict[str, object]] = None) -> None:
        """The one import both :meth:`import_slot` and :meth:`resume_slot`
        ride: re-bind the adapter by name and the grammar by source (ids
        are pool-local; a name this pool does not hold raises
        :class:`~tpudist_torch.serve.adapters.AdapterMissingError` before
        any state changes), reserve ``admit_span`` on a paged pool, install
        the lane and the row (``import_lane``) and cold-start the draft
        (``draft_arm``)."""
        moved = [torch.as_tensor(t).to(self.device) for t in lane]
        lane = (PagedLane(*moved) if isinstance(lane, PagedLane)
                else tuple(moved))
        if adapter is not None or self.adapters is not None:
            aid = self._acquire_adapter(slot, adapter)
            row_state = row_state._replace(
                adapter_id=torch.tensor(aid, dtype=torch.int32))
        if grammar is not None and self.grammars is None:
            self._release_adapter(slot)
            raise GrammarError(
                "imported lane carries a grammar but this engine was built "
                "without constrain= — engines must agree on "
                "structured-output support")
        if grammar is not None or self.grammars is not None:
            gid = self._gid_sentinel()
            if grammar is not None:
                from tpudist_torch.constrain import compile_grammar

                src = grammar["source"]
                try:
                    tg = compile_grammar(
                        regex=(src["src"] if src["kind"] == "regex"
                               else None),
                        json_schema=(src["src"]
                                     if src["kind"] == "json_schema"
                                     else None),
                        vocab=self.constrain_cfg.vocab,
                        eos_id=int(grammar["eos_id"]),
                        max_states=self.constrain_cfg.max_states)
                    gid = self._acquire_grammar(slot, tg)
                except BaseException:
                    self._release_adapter(slot)
                    raise
                row_state = row_state._replace(
                    gidx=torch.tensor(gid, dtype=torch.int32))
            else:
                # a foreign gstate could exceed this pool's state rows
                row_state = row_state._replace(
                    gidx=torch.tensor(gid, dtype=torch.int32),
                    gstate=torch.tensor(0, dtype=torch.int32))
        if self.alloc is None:
            self.state, self.cache = self.fns.import_lane(
                self.state, self.cache, int(slot), lane, row_state)
            if self.spec:
                self.dcache = self.fns.draft_arm(self.dcache, int(slot), pos)
            return
        try:
            row, _ = self.alloc.admit(slot, admit_span[0], admit_span[1], ())
        except BaseException:
            self._release_adapter(slot)
            self._release_grammar(slot)
            raise
        M = self.max_len // self.paged_cfg.block_size
        full = np.full(M, self.paged_cfg.num_blocks, np.int32)
        full[:len(row)] = row
        self.state, self.cache = self.fns.import_lane(
            self.state, self.cache, int(slot), self._t(full), lane,
            row_state)
        if self.spec:
            self.dcache = self.fns.draft_arm(self.dcache, int(slot),
                                             self._t(full), pos)

    def resume_slot(self, slot: int, package: Dict[str, object], prompt,
                    *, temperature: float = 0.0, seed: int = 0,
                    max_new: int = 1, spec: Optional[bool] = None) -> None:
        """Install a PARKED lane (a host-tier session) into free ``slot``
        and go on in prefill mode: the package's ``pos`` covered positions
        are a prefix of ``prompt`` (the tier checked the tokens), so only
        ``prompt[pos:]`` is teacher-forced, through the ordinary chunked
        prefill.  The row is re-armed for the new turn as
        :meth:`start_batch` arms a fresh one — ``seeds`` the request's
        seed, ``counts`` 0, the new ``temps`` — so the resumed stream is a
        fresh serve's at the same seed, minus the covered prefix's
        recompute.  A paged engine reserves the whole ``prompt + max_new``
        footprint (a resumed lane's context is private)."""
        if self.occupied[slot]:
            raise ValueError(f"slot {slot} is occupied")
        if bool(package["paged"]) != (self.alloc is not None):
            raise ValueError("parked package and engine disagree on paged "
                             "mode — tiers must share KV geometry")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pos = int(package["pos"])
        max_new = int(max_new)
        if not 0 < pos < len(prompt):
            raise ValueError(
                f"resume cursor {pos} outside prompt of {len(prompt)} — the "
                "parked context must be a strict prefix of the new turn's "
                "prompt")
        reason = self.check_budget(len(prompt), max_new)
        if reason is not None:
            raise ValueError(reason)
        zero = torch.tensor(0, dtype=torch.int32)
        row_state = package["state"]._replace(
            last_tok=zero, active=torch.tensor(False), counts=zero,
            temps=torch.tensor(float(temperature), dtype=torch.float32),
            seeds=torch.tensor(int(seed) & 0xFFFFFFFF, dtype=torch.int64))
        self._install_lane(slot, package["lane"], row_state, pos,
                           admit_span=(len(prompt), max_new),
                           adapter=package.get("adapter"),
                           grammar=package.get("grammar"))
        self.occupied[slot] = True
        self.decoding[slot] = False
        self.pos[slot] = pos
        self.counts[slot] = 0
        self.budget[slot] = max_new
        self.temps[slot] = float(temperature)
        self.spec_on[slot] = True if spec is None else bool(spec)
        # the uncovered suffix rides the chunked prefill (its first token
        # is the parked last token: teacher-forcing it writes the one
        # position the park left pending)
        self._prefill_rest[slot] = (prompt, pos)
        self.peak_occupied = max(self.peak_occupied, self.num_occupied)

    def exportable(self, slot: int, delivered: int) -> bool:
        """Can this decoding lane park without overshoot — do the device
        counts equal the ``delivered`` tokens?  An eos mid-block leaves
        tokens in the cache past the delivered stream; such a lane is not
        parked (its next turn re-prefills)."""
        return bool(self.decoding[slot]) \
            and int(self.counts[slot]) == int(delivered)

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
        if self.alloc is not None:
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
        ``reserve`` blocks promised to same-batch admissions?  Always on
        the dense engine."""
        if self.alloc is None:
            return True
        return self.alloc.can_admit(prompt_len, max_new, prefix_hashes,
                                    reserve=reserve)

    def kv_admission_probe(self, prompt_len: int, max_new: int,
                           prefix_hashes: Sequence[str] = (), *,
                           reserve: int = 0, protect: Sequence[int] = ()):
        """``(fresh_blocks, reused_ids)`` if the pool covers this request on
        top of ``reserve`` and ``protect``, else ``None`` (``(0, [])`` on the
        dense engine)."""
        if self.alloc is None:
            return 0, []
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
        spec_flags: Dict[int, bool] = {}
        adapter_names: Dict[int, Optional[str]] = {}
        grammar_objs: Dict[int, Optional[object]] = {}
        for item in items:
            slot, prompt, temperature, seed, max_new = item[:5]
            hashes = tuple(item[5]) if len(item) > 5 else ()
            spec_flags[int(slot)] = (bool(item[6]) if len(item) > 6
                                     and item[6] is not None else True)
            adapter = item[7] if len(item) > 7 else None
            if adapter is not None and not self.has_adapter(adapter):
                # a vanished adapter must not leak half-admitted
                # neighbours: the server finishes it "adapter_missing"
                raise AdapterMissingError(str(adapter))
            adapter_names[int(slot)] = adapter
            grammar = item[8] if len(item) > 8 else None
            if grammar is not None and self.grammars is None:
                raise ValueError(
                    "constrained request on an engine built without "
                    "constrain= (TPUDIST_SERVE_CONSTRAIN)")
            grammar_objs[int(slot)] = grammar
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
        # grammar binds follow the adapter discipline: transactional (a
        # mid-batch GrammarPoolFull — every block pinned by running lanes —
        # rolls every earlier pin back, adapter pins included; the server
        # defers the constrained items)
        gids = np.full(S, self._gid_sentinel(), np.int32)
        gbound: List[int] = []
        try:
            for j, (slot, *_rest) in enumerate(norm):
                gids[j] = self._acquire_grammar(slot, grammar_objs[slot])
                gbound.append(slot)
        except BaseException:
            for slot in gbound:
                self._release_grammar(slot)
            for slot in bound:
                self._release_adapter(slot)
            raise
        reused_len = np.zeros(S, np.int32)
        if self.alloc is not None:
            M = self.max_len // self.paged_cfg.block_size
            tables = np.full((S, M), self.paged_cfg.num_blocks, np.int32)
            admitted = []
            # pin every item's reusable chain for the whole batch
            protect: List[int] = []
            for _, prompt, _, _, _, hashes in norm:
                protect.extend(self.alloc.reusable_blocks(len(prompt),
                                                          hashes))
            try:
                for j, (slot, prompt, _, _, max_new, hashes) in \
                        enumerate(norm):
                    row, reused = self.alloc.admit(slot, len(prompt),
                                                   max_new, hashes,
                                                   protect=protect)
                    admitted.append(slot)
                    tables[j, :len(row)] = row
                    reused_len[j] = reused
            except RuntimeError:
                for slot in admitted:
                    self.alloc.release(slot)
                for slot in bound:
                    self._release_adapter(slot)
                for slot in gbound:
                    self._release_grammar(slot)
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
        # the paged programs take each lane's table row and reused length
        where = (() if self.alloc is None
                 else (self._t(tables), self._t(reused_len)))
        self.state, self.cache, firsts = self.fns.insert_batch(
            self.state, self.cache, *where, self._t(prompts),
            self._t(clens), self._t(dsts), self._t(seeds), self._t(temps),
            self._t(last), sampled=bool((temps > 0).any()),
            aids=self._t(aids), apool=self.apool, gids=self._t(gids),
            gpool=self.gpool)
        self.n_forwards += 1
        r, w = self._prefill_kv_bytes(reused_len, clens, S)
        self.prefill_read_bytes_total += r
        self.prefill_write_bytes_total += w
        if self.spec:
            # same chunks, same (host-built) table rows: the draft pool's
            # blocks mirror the target's ids, so a reused prefix's draft
            # K/V is already in place
            self.dcache = self.fns.draft_prefill(
                self.dcache, *where, self._t(prompts), self._t(clens),
                self._t(dsts), aids=self._t(aids), apool=self.apool)
            self.n_draft_forwards += 1
        firsts_h = firsts.cpu().numpy() if last.any() else None
        out: Dict[int, Optional[int]] = {}
        for j, (slot, prompt, temperature, _, max_new, _) in enumerate(norm):
            self.occupied[slot] = True
            self.budget[slot] = max_new
            self.temps[slot] = temperature
            self.spec_on[slot] = spec_flags[slot]
            self.pos[slot] = reused_len[j] + clens[j]
            if self.alloc is not None:
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
                sampled=bool(self.temps[slot] > 0), apool=self.apool,
                gpool=self.gpool)
            self.n_forwards += 1
            if self.spec:
                self.dcache = self.fns.draft_extend(
                    self.dcache, slot, self._t(chunk), clen,
                    aids=self.state.adapter_id, apool=self.apool)
                self.n_draft_forwards += 1
            if self.prefill_kernel:
                # the one-hot batched program walks every lane's prefix
                r, w = self._prefill_kv_bytes(
                    self.pos, np.where(np.arange(self.num_slots) == slot,
                                       clen, 0), self.num_slots)
            else:
                r, w = self._prefill_kv_bytes(self.pos[slot:slot + 1],
                                              np.asarray([clen]), 1)
            self.prefill_read_bytes_total += r
            self.prefill_write_bytes_total += w
            self.pos[slot] += clen
            if self.alloc is not None:
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
        tokens)`` (``None, {}`` when no slot is decoding).  Alone it does
        not move a spec engine's draft: call :meth:`decode_auto` or
        :meth:`decode_auto_plain` there."""
        info, out, _ = self._decode_block(max_k)
        return info, out

    def _decode_block(self, max_k: Optional[int]):
        """:meth:`decode_block` plus the block's tokens ``[K, S]`` still on
        the device (``None`` with no decoding slot)."""
        if not self.decoding.any():
            return None, {}, None
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
        res = self.fns.decode_block(
            self.state, self.cache, k,
            sampled=bool((self.temps[dec] > 0).any()), apool=self.apool,
            gpool=self.gpool)
        self.state, self.cache, blocks = res[:3]
        t1 = time.perf_counter()
        n = self.n_lp
        if n:
            # the top-n rows ride the same fetch: ids and the f32 values'
            # bits packed beside the tokens, [K, S, 1 + 2n] int32
            both = torch.cat([blocks[..., None], res[3],
                              res[4].view(torch.int32)], -1)
            packed = both.cpu().numpy()  # ONE host sync
            arr = packed[..., 0]
            lpi = packed[..., 1:1 + n]
            lpv = packed[..., 1 + n:].view(np.float32)
        else:
            arr = blocks.cpu().numpy()  # ONE host sync for K x S tokens
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
        if n:
            # slot → one (ids, logprobs) top-n pair per emitted token,
            # aligned with the token lists in ``out``
            info["logprobs"] = {
                int(s): [(lpi[i, s].tolist(), lpv[i, s].tolist())
                         for i in range(k)] for s in dec}
        return info, out, blocks

    def decode_auto_plain(self, max_k: Optional[int] = None
                          ) -> Tuple[Optional[dict], Dict[int, List[int]]]:
        """A plain fused block that, on a spec engine, also teacher-forces
        its emitted tokens through the draft (``draft_track``), so draft and
        target cursors stay in lockstep across non-speculative
        iterations."""
        prev_last = (self.state.last_tok.clone()
                     if self.spec and self.decoding.any() else None)
        info, out, blocks = self._decode_block(max_k)
        if self.spec and info is not None:
            self.dcache = self.fns.draft_track(
                self.state, self.dcache, prev_last, blocks, apool=self.apool)
            self.n_draft_forwards += 1
            self.n_draft_decode_forwards += 1
        if info is not None and self.spec:
            info = {**info, "spec": False}
        return info, out

    def spec_decode_block(self, max_k: Optional[int] = None
                          ) -> Tuple[Optional[dict], Dict[int, List[int]]]:
        """One speculative block over every decoding slot: ``K + 1`` draft
        steps, ONE target pass over the ``K + 1``-token window, the
        acceptance and rollback on the device, one fetch of the packed
        tokens.  Each lane emits ``accepted + 1`` tokens, clamped on the
        device to its remaining budget (``rem`` rides as data).  ``K`` is
        capped by the tightest lane's cache headroom and by the largest
        remaining budget and bucketed to a power of two; when it comes to
        0 the iteration is a draft-tracked plain block."""
        if not self.spec:
            raise RuntimeError("engine built without spec_draft")
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
        headroom = int((self.max_len - self.pos[dec]).min())
        cap = self.spec_k if max_k is None else max(1, int(max_k))
        # drafting is waste when every lane needs exactly one more token
        cap = min(cap, max(int(remaining.max()) - 1, 0),
                  max(headroom - 1, 0))
        k = _pow2_floor(cap) if cap >= 1 else 0
        if k < 1:
            return self.decode_auto_plain()
        rem = np.zeros(self.num_slots, np.int32)
        rem[dec] = remaining
        pos0 = self.pos[dec].copy()
        sampled = bool((self.temps[dec] > 0).any())
        t0 = time.perf_counter()
        self.dcache, drafts, dlogits = self.fns.draft_propose(
            self.state, self.dcache, k, sampled=sampled, apool=self.apool)
        t1 = time.perf_counter()
        res = self.fns.spec_verify(
            self.state, self.cache, self.dcache, drafts, dlogits,
            self._t(self.spec_on), self._t(rem), sampled=sampled,
            apool=self.apool, gpool=self.gpool)
        self.state, self.cache, self.dcache, packed = res[:4]
        t2 = time.perf_counter()
        n = self.n_lp
        if n:
            # the verify's [S, k+1, n] top-n rows ride the packed fetch
            S = self.num_slots
            both = torch.cat([packed, res[4].reshape(S, -1),
                              res[5].reshape(S, -1).view(torch.int32)], 1)
            allp = both.cpu().numpy()  # ONE host sync
            pk = allp[:, :k + 3]
            lpi = allp[:, k + 3:k + 3 + (k + 1) * n].reshape(S, k + 1, n)
            lpv = allp[:, k + 3 + (k + 1) * n:].view(np.float32).reshape(
                S, k + 1, n)
        else:
            pk = packed.cpu().numpy()  # ONE host sync: counts + tokens
        t3 = time.perf_counter()
        n_emit = pk[dec, 0]
        a_raw = pk[dec, 1]
        accepted = int(a_raw.sum())
        drafted = int(k * self.spec_on[dec].sum())
        emitted = int(n_emit.sum())
        # a rollback is a verify that rejected a draft (a budget-clamped
        # full accept is not: the drafts were right)
        rollbacks = int(((a_raw < k) & self.spec_on[dec]).sum())
        self.counts[dec] += n_emit
        self.pos[dec] += n_emit
        self.n_forwards += 1
        self.n_decode_steps += 1  # ONE target pass per spec block
        self.n_draft_forwards += k + 1
        self.n_draft_decode_forwards += k + 1
        self.n_decode_blocks += 1
        self.n_decode_tokens += emitted
        self.t_decode_dispatch_s += t2 - t0
        self.t_decode_sync_s += t3 - t2
        self.n_spec_blocks += 1
        self.n_spec_lane_passes += len(dec)
        self.n_spec_tokens += emitted
        self.n_spec_accepted += accepted
        self.n_spec_drafted += drafted
        self.n_spec_rollbacks += rollbacks
        self.t_spec_draft_s += t1 - t0
        self.t_spec_verify_s += t2 - t1
        self.t_spec_sync_s += t3 - t2
        by_adapter: Dict[str, List[int]] = {}
        if self.adapters is not None:
            for j, s in enumerate(dec):
                bound = self.slot_adapter[s]
                if bound is None or not self.spec_on[s]:
                    continue
                tally = by_adapter.setdefault(bound[0], [0, 0])
                tally[0] += int(a_raw[j])
                tally[1] += k
            for name, (acc, dr) in by_adapter.items():
                tot = self.spec_adapter_counts.setdefault(name, [0, 0])
                tot[0] += acc
                tot[1] += dr
        out = {int(s): [int(t) for t in pk[s, 2:2 + pk[s, 0]]] for s in dec
               if pk[s, 0] > 0}
        # one attention sweep over each lane's prefix + the K+1 window (the
        # draft's own sweeps are not charged here)
        kv_read = self._decode_kv_read_bytes(pos0, 1, k + 1)
        self.kv_read_bytes_total += kv_read
        info = {"spec": True, "k": k, "tokens": emitted,
                "accepted": accepted, "drafted": drafted,
                "rollbacks": rollbacks, "draft_s": t1 - t0,
                "verify_s": t2 - t1, "dispatch_s": t2 - t0,
                "sync_s": t3 - t2, "kv_read_bytes": int(kv_read)}
        if by_adapter:
            info["accept_by_adapter"] = {
                name: [int(a), int(d)] for name, (a, d) in
                by_adapter.items()}
        if n:
            # slot → per-emitted-token top-n pairs, rows [:n_emit] of the
            # verify's rows (aligned with ``out``)
            info["logprobs"] = {
                int(s): [(lpi[s, i].tolist(), lpv[s, i].tolist())
                         for i in range(int(pk[s, 0]))]
                for s in dec if pk[s, 0] > 0}
        return info, out

    def decode_auto(self) -> Tuple[Optional[dict], Dict[int, List[int]]]:
        """The serving loop's decode dispatcher: the speculative block when
        the engine has a draft and a decoding lane opted in, else the plain
        block (draft-tracked on a spec engine)."""
        if not self.spec:
            return self.decode_block()
        if not (self.decoding & self.spec_on).any():
            return self.decode_auto_plain()
        return self.spec_decode_block()

    def step(self) -> Dict[int, int]:
        """One single-token decode iteration (a K=1 block; draft-tracked on
        a spec engine)."""
        _, toks = (self.decode_auto_plain(max_k=1) if self.spec
                   else self.decode_block(max_k=1))
        return {s: t[0] for s, t in toks.items()}

    def evict(self, slot: int) -> None:
        """Free a lane: release its blocks on the host, zero the ones no
        tenant or prefix-cache entry still holds, reset the device state
        and the host shadows, and unpin its adapter and grammar (a deferred
        adapter unload completes here)."""
        freed = ()
        if self.alloc is not None:
            freed = self.alloc.release(slot)
            M = self.max_len // self.paged_cfg.block_size
            free_ids = np.full(M, self.paged_cfg.num_blocks, np.int32)
            free_ids[:len(freed)] = freed
            freed = (self._t(free_ids),)
        self.state, self.cache = self.fns.evict(self.state, self.cache,
                                                int(slot), *freed)
        if self.spec:
            # the same recycled block ids: the draft pool's copies are
            # zeroed beside the target's
            self.dcache = self.fns.draft_evict(self.dcache, int(slot),
                                               *freed)
        self._release_adapter(slot)
        self._release_grammar(slot)
        self.occupied[slot] = False
        self.decoding[slot] = False
        self.pos[slot] = 0
        self.counts[slot] = 0
        self.budget[slot] = 0
        self.temps[slot] = 0.0
        self.spec_on[slot] = True
        self._prefill_rest.pop(slot, None)
