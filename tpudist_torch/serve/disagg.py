"""Prefill/decode disaggregation — the port of ``tpudist/serve/disagg.py``:
the KV-handoff wire form and :class:`DisaggServer`, the two worker pools
that hand lanes over in it.

**The wire form.**  A package is ``{"paged", "pos", "counts", "budget",
"trace_id", "adapter", "grammar", "lane", "state"}`` (:meth:`tpudist_torch.
serve.engine.SlotEngine.export_slot`): the lane ``(k, v, cursor)`` and the
slot's :class:`~tpudist_torch.models.generate.SlotState` row are tensors,
the rest host values.  :func:`serialize_package` flattens the tensors to
host bytes (each leaf its raw bytes, its torch dtype NAME and its shape:
``bfloat16`` has no numpy dtype, so the bytes go through a ``uint8`` view
and come back through the named dtype — no ``ml_dtypes`` needed), stamps
the blake2b digest over them and keeps the structure beside them;
:func:`deserialize_package` checks the schema and the digest and rebuilds
CPU tensors, which the importing engine moves to its device.  The host KV
tier parks packages in this form and the fleet router migrates them
between replicas in it.

**The pools.**  The single-pool server interleaves prompt chunks and
decode blocks on one engine, so a burst of long prompts steals decode
iterations from every stream in flight.  :class:`DisaggServer` splits the
two phases (the DistServe/Splitwise layout):

- a **prefill pool** of engines that only teacher-force prompts
  (``start_batch`` + ``advance_prefill``; their slots never decode) and
  sample token 0;
- a **decode pool** of engines that only run decode blocks;
- a bounded **handoff queue** between them carrying each finished
  prompt's package.  ``import_slot`` installs it in a free decode slot
  (copying the lane into that engine's own pool blocks) and the request
  continues bit for bit: the sampling stream is the per-slot Philox
  counter, which rides in the package.

TTFT becomes a prefill-pool number and TPOT a decode-pool number; the
telemetry's serving section splits them per pool, plus the coordinator's
``handoff_wait``.  ``ServeConfig.handoff`` picks the transfer:
``"device"`` hands the exported tensors to the importer, ``"serial"``
round-trips every leaf through the wire form (the stand-in for pools in
separate processes).  Both are byte-preserving.

Thread contract as :class:`~tpudist_torch.serve.server.InferenceServer`'s:
one engine thread drives every engine of both pools, on one stream; any
number of threads submit; SIGTERM or ``close()`` drain everything admitted.

**Recovery** (``ServeConfig.recover``, on by default): a pool worker whose
engine call raises (a real failure, or ``TPUDIST_FAULT=
serve_worker_kill@...``) is marked dead (``worker_lost``), and its lanes go
on on survivors — a decode lane replays its stashed package on another
decode worker (decode is a function of the packaged state, so the tokens
re-emit as they were; those already delivered drop by the replay-skip
count, ``lane_recovered``), a prefill lane requeues ahead of fresh
admissions and prefills again.  Only a pool with no survivor finishes its
lanes ``worker_lost``.  The stash costs one extra copy of each in-flight
decode lane's KV; ``recover=False`` aborts everything as ``"shutdown"``.

**Degradation through the pools** (``ServeConfig.host_tier``): a finished
session turn's decode lane parks in the host tier, and the session's next
turn resumes it on a prefill worker (the suffix alone teacher-forced)
before handing off like any lane; a higher-priority handoff-queue head can
preempt a lower-priority decode lane into the tier (its resume rides the
same placement); the overload controller sheds as on the single pool.

**Backpressure resize** (``ServeConfig.pool_resize`` iterations, 0 = off):
a handoff queue full for that many consecutive loop iterations shrinks the
prefill pool's slot budget by one, and a queue at most half full for as
long grows it back (``pool_resize`` events).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from tpudist_torch.serve.engine import SlotEngine
from tpudist_torch.serve.scheduler import (AdmissionError, RequestHandle,
                                           Scheduler)
from tpudist_torch.serve.server import (ReplicaKilled, ServeConfig,
                                        _Observability, _compile_grammar_for)

#: poll interval of an idle engine loop (host-side only)
_IDLE_WAIT_S = 0.01

#: Wire-format version of a serialized KV-handoff package, the JAX
#: package's: v2 added the schema field and the blob digest, v3 the
#: ``trace_id``, v4 the ``adapter`` name, v5 the ``grammar`` envelope (each
#: additive and outside the digested blob, so older packages still
#: deserialize with the new fields read back as ``None``).
HANDOFF_SCHEMA_VERSION = 5

#: Oldest wire format :func:`deserialize_package` accepts.
HANDOFF_SCHEMA_MIN = 2


class HandoffError(RuntimeError):
    """A serialized package this engine must not import: a wrong or missing
    ``schema_version`` (``reason="schema"``) or a failed blob integrity
    check (``reason="corrupt"``)."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


def _blob_digest(blob) -> str:
    """blake2b-16 over every blob leaf's bytes (a flipped byte in a KV lane
    would otherwise deserialize silently into garbage attention)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for b, _, _ in blob:
        h.update(b)
    return h.hexdigest()


def _flatten(x, leaves: List[torch.Tensor]):
    """``x``'s tensor leaves appended to ``leaves`` in order, and its
    structure: None for a leaf, else ``(kind, type or keys, children)``
    (a NamedTuple keeps its class, as a JAX treedef does)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("named", type(x), [_flatten(c, leaves) for c in x])
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, None, [_flatten(c, leaves) for c in x])
    if isinstance(x, dict):
        keys = list(x)
        return ("dict", keys, [_flatten(x[k], leaves) for k in keys])
    leaves.append(torch.as_tensor(x))
    return None


def _unflatten(tree, leaves) -> Any:
    if tree is None:
        return next(leaves)
    kind, meta, children = tree
    vals = [_unflatten(c, leaves) for c in children]
    if kind == "named":
        return meta(*vals)
    if kind == "dict":
        return dict(zip(meta, vals))
    return tuple(vals) if kind == "tuple" else list(vals)


def _leaf_bytes(t: torch.Tensor) -> Tuple[bytes, str, tuple]:
    """One tensor as ``(raw bytes, dtype name, shape)``."""
    t = t.detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return raw, name, tuple(t.shape)


def _leaf_tensor(raw: bytes, name: str, shape) -> torch.Tensor:
    dtype = getattr(torch, name)
    if not raw:
        return torch.empty(tuple(shape), dtype=dtype)
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return flat.view(dtype).reshape(tuple(shape))


def serialize_package(pkg: dict) -> dict:
    """Flatten a lane package to host bytes — what would ride the wire
    between two engines.  Keeps the structure beside the blob (both ends
    share the engine geometry); byte-preserving for every lane dtype,
    bf16 and int8 included."""
    leaves: List[torch.Tensor] = []
    tree = _flatten((pkg["lane"], pkg["state"]), leaves)
    blob = [_leaf_bytes(t) for t in leaves]
    ser = {"schema_version": HANDOFF_SCHEMA_VERSION,
           "paged": pkg["paged"], "pos": pkg["pos"],
           "counts": pkg["counts"], "budget": pkg["budget"],
           "trace_id": pkg.get("trace_id"),
           "adapter": pkg.get("adapter"),
           "grammar": pkg.get("grammar"),
           "blob": blob, "tree": tree,
           "digest": _blob_digest(blob),
           "bytes": sum(len(b) for b, _, _ in blob)}
    # chaos harness: a due handoff_corrupt fault garbles the package after
    # the digest is stamped (detectable wire corruption); one None check
    # when disarmed
    from tpudist_torch.runtime import faults

    faults.inject_handoff(ser)
    return ser


def check_package_schema(ser: dict) -> None:
    """Raise :class:`HandoffError` unless ``ser`` carries a supported
    ``schema_version`` (``HANDOFF_SCHEMA_MIN`` .. current) — the cheap
    envelope check, no blob work."""
    ver = ser.get("schema_version")
    if (not isinstance(ver, int)
            or not HANDOFF_SCHEMA_MIN <= ver <= HANDOFF_SCHEMA_VERSION):
        raise HandoffError(
            f"handoff package schema_version {ver!r} not in supported "
            f"range [{HANDOFF_SCHEMA_MIN}, {HANDOFF_SCHEMA_VERSION}] "
            "(missing = pre-versioning sender; out of range = mixed "
            "versions across engines) — rejected instead of "
            "shape-crashing mid-import",
            reason="schema")


def deserialize_package(ser: dict) -> dict:
    """Inverse of :func:`serialize_package` (byte-preserving, CPU
    tensors).  Rejects a missing or unsupported ``schema_version`` and a
    blob whose digest no longer matches (:class:`HandoffError`)."""
    check_package_schema(ser)
    digest = ser.get("digest")
    if digest is not None and _blob_digest(ser["blob"]) != digest:
        raise HandoffError(
            "handoff package failed its integrity check (blob digest "
            "mismatch) — corrupted in transit; the request is finished "
            "with a reason instead of decoding garbage KV",
            reason="corrupt")
    flat = iter([_leaf_tensor(b, d, s) for b, d, s in ser["blob"]])
    lane, state = _unflatten(ser["tree"], flat)
    return {"paged": ser["paged"], "pos": ser["pos"],
            "counts": ser["counts"], "budget": ser["budget"],
            "trace_id": ser.get("trace_id"),
            "adapter": ser.get("adapter"),
            "grammar": ser.get("grammar"),
            "lane": lane, "state": state}


class DisaggServer(_Observability):
    """Disaggregated continuous-batching server: prefill pool → KV handoff
    → decode pool (module doc).  The config is the same
    :class:`~tpudist_torch.serve.server.ServeConfig` (``disagg=True``
    selects this class in :func:`~tpudist_torch.serve.server.
    serve_forever`).  Every pool engine goes on ``device`` (``"cuda"`` by
    default; without CUDA the constructor raises unless ``device="cpu"``).

    Prefill engines run the prefill and sampling kernels at decode block 1
    with the prefix cache and the gather decode arm (they never decode);
    the fused RoPE+QKV and LoRA kernels ride there only with the prefill
    kernel.  Decode engines own the speculative draft and the decode
    kernel, with private blocks only.  Both pools take the serving mesh,
    the adapter pool, grammars and logprobs."""

    _statusz_name = "serve-disagg"

    def __init__(self, model, config=None, *, device="cuda",
                 install_signal_handler: bool = True):
        self.config = config or ServeConfig.from_env()
        cfg = self.config
        if cfg.handoff not in ("device", "serial"):
            raise ValueError(
                f"handoff must be 'device' or 'serial', got {cfg.handoff!r}")
        self.handoff_mode = cfg.handoff
        # structured output spans both pools: the prefill engine masks the
        # first sampled token, the decode pool recompiles and re-binds the
        # grammar by source at import
        ccfg = None
        if cfg.constrain:
            from tpudist_torch.constrain import (ConstrainConfig,
                                                 default_vocab)

            ccfg = ConstrainConfig(vocab=default_vocab(int(model.vocab)),
                                   num_blocks=cfg.constrain_blocks,
                                   max_states=cfg.constrain_states)
        self.constrain_cfg = ccfg
        shared = dict(
            prefill_pad=cfg.prefill_pad, paged=cfg.paged,
            kv_block=cfg.kv_block, kv_blocks=cfg.kv_blocks,
            kv_int8=cfg.kv_int8, mesh=cfg.mesh_config(),
            # every pool engine carries the adapter pool: prefill writes
            # the KV through the adapter and the decode pool re-binds it by
            # name at import; load_adapter broadcasts to all of them
            adapters=cfg.adapters, adapter_blocks=cfg.adapter_blocks,
            adapter_rank=cfg.adapter_rank, constrain=ccfg,
            logprobs=cfg.logprobs, sample_kernel=cfg.sample_kernel,
            device=device)
        p_slots = cfg.prefill_slots or cfg.num_slots
        self.prefill_pool: List[SlotEngine] = [
            SlotEngine(model, num_slots=p_slots, decode_block=1,
                       prefix_cache_blocks=cfg.prefix_cache_blocks,
                       attn_kernel="gather",
                       prefill_kernel=cfg.prefill_kernel,
                       fused_rope=cfg.fused_rope and cfg.prefill_kernel,
                       lora_kernel=cfg.lora_kernel and cfg.prefill_kernel,
                       **shared)
            for _ in range(max(1, cfg.prefill_workers))]
        # an imported lane's draft starts cold and warms as it decodes
        self.decode_pool: List[SlotEngine] = [
            SlotEngine(model, num_slots=cfg.num_slots,
                       decode_block=cfg.decode_block, prefix_cache_blocks=0,
                       spec_draft=cfg.resolve_spec_draft(model),
                       spec_k=cfg.spec_k, attn_kernel=cfg.attn_kernel,
                       prefill_kernel=cfg.prefill_kernel,
                       fused_rope=cfg.fused_rope,
                       lora_kernel=cfg.lora_kernel, **shared)
            for _ in range(max(1, cfg.decode_workers))]
        #: the bounded handoff queue of ``(handle, package)``: a full queue
        #: stalls exports (the lane waits in its prefill slot), which in
        #: turn holds admission back through the free prefill slots
        self._handoff: "collections.deque[Tuple[RequestHandle, dict]]" = \
            collections.deque()
        self.handoff_limit = max(1, cfg.handoff_queue)
        pe, de = self.prefill_pool[0], self.decode_pool[0]

        def check_budget(plen: int, max_new: int) -> Optional[str]:
            return pe.check_budget(plen, max_new) \
                or de.check_budget(plen, max_new)

        hasher = None
        if cfg.paged and cfg.prefix_cache_blocks > 0:
            from tpudist_torch.serve.paged_alloc import hash_chain

            bs = pe.paged_cfg.block_size
            hasher = lambda prompt: hash_chain(prompt, bs)  # noqa: E731
        self.scheduler = Scheduler(
            queue_limit=cfg.queue_limit, check_budget=check_budget,
            default_max_new=cfg.max_new, default_deadline_s=cfg.deadline_s,
            prefix_hasher=hasher,
            check_adapter=lambda name: (
                None if pe.has_adapter(name) else "adapter_missing"),
            compile_grammar_fn=(None if ccfg is None else (
                lambda regex, schema, eos: _compile_grammar_for(
                    ccfg, regex, schema, eos))),
            max_logprobs=de.n_lp)
        self._install_signal = install_signal_handler
        self._installed_preemption = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._draining = False
        #: (pool, worker, slot) → handle; pool is "prefill" or "decode"
        self._slot_handles: Dict[Tuple[str, int, int], RequestHandle] = {}
        self.completed = 0
        self.tokens_out = 0
        self.handoffs = 0
        self.handoff_bytes = 0
        self._init_observability()
        # -- recovery (module doc) ------------------------------------------
        self.recover = bool(cfg.recover)
        #: dead worker indices per pool, skipped by every loop phase
        self._dead: Dict[str, set] = {"prefill": set(), "decode": set()}
        #: (decode worker, slot) → (the package as queued, the tokens the
        #: handle held at import net of a pending skip): the replay stash,
        #: dropped the moment the lane finishes
        self._import_pkg: Dict[Tuple[int, int], Tuple[dict, int]] = {}
        # the host tier, the overload controller and ``_skip`` (handle id →
        # tokens to drop on re-emission), which worker-loss replays and
        # host-tier re-prefill fallbacks share
        self._init_degradation(self.scheduler)
        #: the re-prefill line: lanes whose prefill worker died (or whose
        #: parked package was lost) prefill again, ahead of fresh admissions
        self._requeue: "collections.deque[RequestHandle]" = \
            collections.deque()
        #: cumulative engine calls per (pool, worker): the clock of the
        #: serve_worker_kill fault
        self._calls: Dict[Tuple[str, int], int] = {}
        self.workers_lost = 0
        self.lanes_recovered = 0
        # -- backpressure resize --------------------------------------------
        self.pool_resize = max(0, int(cfg.pool_resize))
        self._prefill_slots_total = p_slots * len(self.prefill_pool)
        #: the prefill pool's effective slot budget
        self._prefill_cap = self._prefill_slots_total
        self._bp_full = 0
        self._bp_free = 0
        self.pool_resizes = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DisaggServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        from tpudist_torch import telemetry
        from tpudist_torch.runtime import faults, preemption

        # TPUDIST_FAULT's serve-side kinds (serve_worker_kill,
        # handoff_corrupt) arm here, as the training loops arm at theirs
        faults.arm_from_env()
        telemetry.ensure_started()
        telemetry.event(
            "serve_disagg_config",
            prefill_workers=len(self.prefill_pool),
            decode_workers=len(self.decode_pool),
            prefill_slots=self.prefill_pool[0].num_slots,
            decode_slots=self.decode_pool[0].num_slots,
            handoff=self.handoff_mode,
            mesh=self.decode_pool[0].spmd_stats().get("mesh"))
        self._stamp_adapter_config()
        de0 = self.decode_pool[0]
        if de0.has_constrain() or de0.n_lp:
            cs = de0.constrain_stats()
            telemetry.event(
                "serve_constrain_config", enabled=cs["enabled"],
                blocks=cs.get("blocks"), max_states=cs.get("max_states"),
                pool_bytes=cs.get("pool_bytes"), logprobs=de0.n_lp)
        self._arm_capture_from_env()
        self._start_observability()
        if self._install_signal:
            self._installed_preemption = preemption.install()
        self._thread = threading.Thread(
            target=self._loop, name="tpudist-torch-serve-disagg",
            daemon=True)
        self._thread.start()
        return self

    def submit(self, prompt, *, max_new: Optional[int] = None,
               temperature: float = 0.0, deadline_s: Optional[float] = None,
               seed: Optional[int] = None, eos_id: Optional[int] = None,
               on_token=None, spec: Optional[bool] = None,
               tenant: Optional[str] = None, priority: int = 0,
               session: Optional[str] = None,
               adapter: Optional[str] = None,
               grammar: Optional[str] = None, json_schema=None,
               stop=None, logprobs: int = 0) -> RequestHandle:
        """:meth:`InferenceServer.submit`'s surface and contract."""
        from tpudist_torch import telemetry

        # count the in-flight before the handle becomes visible to the
        # engine thread, so a fast finish cannot decrement first
        tkey = None if tenant is None else str(tenant)
        self._track_tenant(tkey, +1)
        try:
            return self.scheduler.submit(
                prompt, max_new=max_new, temperature=temperature,
                deadline_s=deadline_s, seed=seed, eos_id=eos_id,
                on_token=on_token, spec=spec, tenant=tenant,
                priority=priority, session=session, adapter=adapter,
                grammar=grammar, json_schema=json_schema, stop=stop,
                logprobs=logprobs)
        except BaseException as e:
            self._track_tenant(tkey, -1)  # never admitted
            if isinstance(e, AdmissionError):
                telemetry.event("serve_rejected", reason=e.reason)
            raise

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, finish everything admitted, stop the loop."""
        self._stop.set()
        t = self._thread
        ok = True
        if t is not None:
            t.join(timeout)
            ok = not t.is_alive()
        if ok:
            self.scheduler.refuse_new("draining")
            self._abort_outstanding()
        return ok

    def close(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown (drain) + handler restore."""
        ok = self.drain(timeout)
        self._stop_observability()
        if self._installed_preemption:
            from tpudist_torch.runtime import preemption

            preemption.reset()
            self._installed_preemption = False
        return ok

    def _adapter_engines(self) -> list:
        return list(self.prefill_pool) + list(self.decode_pool)

    # -- the draft hot-swap (the decode pool owns the drafts) ---------------

    def draft_ref(self):
        alive = self._alive("decode")
        if not alive:
            return None
        eng = self.decode_pool[alive[0]]
        if eng.draft_model is None:
            return None
        return (eng.draft_model, eng.draft_model.state_dict())

    def _swap_now(self, new_params) -> dict:
        """Broadcast the gated swap across every ALIVE decode worker —
        all-or-error like the adapter broadcast: the first engine checks
        the geometry (the same draft on every worker, so a pass there is a
        pass everywhere), and a divergent pool can never decode two
        different drafts (the handoff re-bind would make acceptance
        unattributable)."""
        alive = self._alive("decode")
        if not alive:
            raise RuntimeError("no alive decode worker to swap into")
        t0 = time.monotonic()
        rearmed = 0
        swaps = 0
        for w in alive:
            info = self.decode_pool[w].swap_draft(new_params)
            rearmed += int(info.get("lanes_rearmed", 0))
            swaps = info.get("draft_swaps", swaps)
        out = {"swapped": True, "lanes_rearmed": rearmed,
               "swap_s": round(time.monotonic() - t0, 6),
               "draft_swaps": swaps, "engines": len(alive)}
        self._note_swap(out)
        return out

    # -- stats and the live plane -------------------------------------------

    def _agg_spec_stats(self) -> dict:
        """The decode pool's ``spec_stats()`` summed: counters, rates
        recomputed from the sums, per-adapter acceptance merged, the swap
        count (the broadcast keeps the workers' counters in lockstep: the
        pool's logical count is their maximum, not their sum)."""
        keys = ("blocks", "lane_passes", "tokens", "accepted", "drafted",
                "rollbacks", "draft_s", "verify_s", "sync_s")
        spec = {"enabled": self.decode_pool[0].spec, **{k: 0 for k in keys},
                "draft_swaps": 0}
        by_adapter: dict = {}
        for eng in self.decode_pool:
            st = eng.spec_stats()
            for k in keys:
                spec[k] += st.get(k, 0) or 0
            spec["draft_swaps"] = max(spec["draft_swaps"],
                                      int(st.get("draft_swaps", 0) or 0))
            for name, row in (st.get("by_adapter") or {}).items():
                tot = by_adapter.setdefault(
                    name, {"accepted": 0, "drafted": 0})
                tot["accepted"] += row["accepted"]
                tot["drafted"] += row["drafted"]
        spec["spec_k"] = self.decode_pool[0].spec_stats().get("spec_k")
        spec["accepted_per_pass"] = (spec["tokens"] / spec["lane_passes"]
                                     if spec["lane_passes"] else None)
        spec["acceptance_rate"] = (spec["accepted"] / spec["drafted"]
                                   if spec["drafted"] else None)
        if by_adapter:
            spec["by_adapter"] = {
                name: {**row, "acceptance_rate":
                       (row["accepted"] / row["drafted"]
                        if row["drafted"] else None)}
                for name, row in sorted(by_adapter.items())}
        return spec

    def _observability_gauges(self) -> dict:
        return {
            "tpudist_serve_prefill_workers": len(self.prefill_pool),
            "tpudist_serve_decode_workers": len(self.decode_pool),
            "tpudist_serve_handoff_queue_limit": self.handoff_limit,
            "tpudist_serve_queue_limit": self.config.queue_limit,
        }

    def _statusz_doc(self) -> dict:
        """``/statusz`` with a section a pool (worker liveness, slot
        occupancy), the handoff queue's depth (the backpressure signal),
        the decode pool's KV residency and per-tenant in-flight."""
        from tpudist_torch.utils.envutil import env_int

        def _pool(pool: str, engines: List[SlotEngine]) -> dict:
            alive = self._alive(pool)
            return {
                "workers": len(engines),
                "dead": sorted(self._dead[pool]),
                "slots_per_worker": engines[0].num_slots,
                "occupied": sum(engines[i].num_occupied for i in alive),
                "active": sum(engines[i].num_active for i in alive),
            }

        de0 = self.decode_pool[0]
        kv_occ, kv_resident = de0.kv_gauges()
        return {
            "pools": {
                "prefill": {**_pool("prefill", self.prefill_pool),
                            "slot_cap": self._prefill_cap},
                "decode": _pool("decode", self.decode_pool),
            },
            "handoff": {
                "queued": len(self._handoff),
                "limit": self.handoff_limit,
                "total": self.handoffs,
                "bytes": self.handoff_bytes,
            },
            "queue": {
                "pending": self.scheduler.pending(),
                "limit": self.config.queue_limit,
                "rejected": self.scheduler.rejected,
            },
            "kv": {
                "bytes_resident": int(kv_resident),
                "block_occupancy": (None if kv_occ is None
                                    else round(float(kv_occ), 4)),
            },
            "recovery": {
                "workers_lost": self.workers_lost,
                "lanes_recovered": self.lanes_recovered,
                "requeued": len(self._requeue),
                "pool_resizes": self.pool_resizes,
            },
            **({"host_tier": {**self._tier.stats(),
                              "parked_requests": len(self._parked),
                              "preemptions": self.preemptions,
                              "resumes_served": self.tier_resumes,
                              "corrupt": self.tier_corrupt}}
               if self._tier is not None else {}),
            **({"overload": self._ctrl.stats()}
               if self._ctrl is not None else {}),
            "completed": self.completed,
            "tokens_out": self.tokens_out,
            "tenants_in_flight": dict(self._tenant_inflight),
            **({"adapters": de0.adapter_stats()}
               if de0.adapters is not None else {}),
            **({"constrained": {**de0.constrain_stats(),
                                "logprobs": de0.n_lp}}
               if de0.has_constrain() or de0.n_lp else {}),
            **({"spec": self._agg_spec_stats()} if de0.spec else {}),
            # the distillation flywheel's capture ledger (absent when off)
            **({"distill": self._distill_status()}
               if self._capture is not None else {}),
            "world": env_int("TPUDIST_NUM_PROCESSES", None),
            "generation": env_int("TPUDIST_RESTART_COUNT", 0),
            "draining": self._draining,
            "loop_error": self.loop_error,
        }

    def stats(self) -> dict:
        dec: Dict[str, float] = {}
        for eng in self.decode_pool:
            for k, v in eng.decode_stats().items():
                dec[k] = dec.get(k, 0) + v
        de0 = self.decode_pool[0]
        return {
            "completed": self.completed,
            "rejected": self.scheduler.rejected,
            "tokens_out": self.tokens_out,
            "pending": self.scheduler.pending(),
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes,
            "handoff_queued": len(self._handoff),
            "workers_lost": self.workers_lost,
            "lanes_recovered": self.lanes_recovered,
            "requeued": len(self._requeue),
            "pool_resizes": self.pool_resizes,
            "preemptions": self.preemptions,
            "parked": len(self._parked),
            "host_tier": (None if self._tier is None
                          else self._tier.stats()),
            "overload": (None if self._ctrl is None
                         else self._ctrl.stats()),
            # one counter for the process: every engine launches through
            # the same wrappers
            "launch_counts": de0.launch_counts(),
            "prefill_pool": {
                "workers": len(self.prefill_pool),
                "dead": sorted(self._dead["prefill"]),
                "slots": self.prefill_pool[0].num_slots,
                "slot_cap": self._prefill_cap,
                "occupied": sum(e.num_occupied for e in self.prefill_pool),
                "kv": self.prefill_pool[0].kv_stats(),
            },
            "decode_pool": {
                "workers": len(self.decode_pool),
                "dead": sorted(self._dead["decode"]),
                "slots": de0.num_slots,
                "active": sum(e.num_active for e in self.decode_pool),
                "decode": dec,
                "spec": self._agg_spec_stats(),
                "kv": de0.kv_stats(),
            },
            "spmd": de0.spmd_stats(),
            "adapters": de0.adapter_stats(),
            "loop_error": self.loop_error,
        }

    # -- the engine loop ----------------------------------------------------

    def _should_drain(self) -> bool:
        if self._stop.is_set():
            return True
        from tpudist_torch.runtime import preemption

        return preemption.requested()

    def _abort_outstanding(self) -> None:
        self._abort_parked()
        for key in list(self._slot_handles):
            h = self._slot_handles.pop(key)
            h._finish("shutdown")
            self._note_finished(h)
        while self._handoff:
            h, _ = self._handoff.popleft()
            h._finish("shutdown")
            self._note_finished(h)
        while self._requeue:
            h = self._requeue.popleft()
            h._finish("shutdown")
            self._note_finished(h)
        for h in self.scheduler.take(1 << 30):
            if not h.done:
                h._finish("shutdown")
            self._note_finished(h)

    # -- worker-loss recovery -----------------------------------------------

    def _alive(self, pool: str) -> List[int]:
        engines = (self.prefill_pool if pool == "prefill"
                   else self.decode_pool)
        return [i for i in range(len(engines)) if i not in self._dead[pool]]

    def _tick(self, pool: str, w: int) -> None:
        """Count one engine call of ``(pool, w)`` and let a due
        ``serve_worker_kill`` turn it into a death (raises: the caller's
        worker-lost handler takes it from there, the path a real engine
        failure drives)."""
        from tpudist_torch.runtime import faults

        key = (pool, w)
        self._calls[key] = n = self._calls.get(key, 0) + 1
        if faults.inject_serve_worker(0 if pool == "prefill" else 1, w, n):
            raise RuntimeError(
                f"injected serve_worker_kill: {pool} worker {w}")

    def _lose_worker(self, pool: str, w: int, exc: BaseException) -> None:
        """A pool worker's engine died: mark it dead and re-route its lanes
        onto survivors (module doc).  A pool with no survivor finishes its
        lanes ``worker_lost``; with ``recover=False`` the exception
        propagates and the loop aborts everything ``shutdown``."""
        if not self.recover:
            raise exc
        if w in self._dead[pool]:
            return
        from tpudist_torch import telemetry

        self._dead[pool].add(w)
        self.workers_lost += 1
        keys = [k for k in self._slot_handles if k[0] == pool and k[1] == w]
        telemetry.event("worker_lost", pool=pool, worker=w,
                        error=repr(exc)[:200], lanes=len(keys))
        survivors = bool(self._alive(pool))
        for key in keys:
            slot = key[2]
            h = self._slot_handles.pop(key)
            if pool == "decode":
                # close this residency's segment: the replay opens the next
                if h.decode_segments and h.decode_segments[-1][2] is None:
                    h.decode_segments[-1][2] = time.monotonic()
                stash = self._import_pkg.pop((w, slot), None)
                if survivors and stash is not None:
                    pkg, l0 = stash
                    # everything the dead worker emitted since the import
                    # re-emits on replay: drop exactly that many
                    self._skip[h.id] = max(0, len(h.tokens) - l0)
                    self._handoff.appendleft((h, pkg))
                    continue
            elif survivors:
                # nothing exported yet: prefill again on a survivor; a
                # token 0 already delivered skips once
                self._skip[h.id] = len(h.tokens)
                self._requeue.append(h)
                continue
            h._finish("worker_lost")
            self._note_finished(h)
        if not survivors:
            self._pool_collapsed(pool)

    def _pool_collapsed(self, pool: str) -> None:
        """A pool lost its last worker: what depends on it finishes
        ``worker_lost`` (never a hang) and new admissions refuse with the
        same reason; lanes already decoding on the other pool finish."""
        if pool == "decode":
            while self._handoff:
                h, _ = self._handoff.popleft()
                h._finish("worker_lost")
                self._note_finished(h)
            # parked preempted lanes need the decode pool to finish
            while self._parked:
                hid, h = self._parked.popitem(last=False)
                if self._tier is not None:
                    self._tier.discard(("preempt", hid))
                h._finish("worker_lost")
                self._note_finished(h)
        else:
            while self._requeue:
                h = self._requeue.popleft()
                h._finish("worker_lost")
                self._note_finished(h)
        self.scheduler.refuse_new("worker_lost")
        for h in self.scheduler.take(1 << 30):
            if not h.done:
                h._finish("worker_lost")
            self._note_finished(h)

    def _reject_package(self, h: RequestHandle, e: HandoffError) -> None:
        """A package the decode pool must not import (schema mismatch or
        wire corruption): finish its request with a reason, serve on."""
        from tpudist_torch import telemetry

        telemetry.event("handoff_rejected", reason=e.reason,
                        error=str(e)[:200])
        h._finish("handoff_corrupt")
        self._note_finished(h)

    def _loop(self) -> None:
        from tpudist_torch import telemetry

        try:
            self._run_loop()
        except BaseException as e:
            # a dying loop must not strand waiters
            self.loop_error = repr(e)  # /healthz goes 503 on this
            telemetry.event("serve_loop_error", error=repr(e))
            if not isinstance(e, ReplicaKilled):
                raise
        finally:
            self.scheduler.refuse_new("draining")
            self._abort_outstanding()

    def _outstanding(self) -> int:
        return (self.scheduler.pending() + len(self._slot_handles)
                + len(self._handoff) + len(self._requeue)
                + len(self._parked))

    def _run_loop(self) -> None:
        from tpudist_torch import telemetry

        sched = self.scheduler
        while True:
            self._beat = time.monotonic()  # /healthz heartbeat
            self._check_die()  # hard-stop poison (kill / replica_kill)
            # gated draft hot-swap lands HERE — the coordinator loop is the
            # only dispatcher into the decode pool, so a broadcast between
            # iterations lands between decode blocks on every worker at once
            self._apply_pending_swap()
            if not self._draining and self._should_drain():
                self._draining = True
                sched.refuse_new("draining")
                telemetry.event("serve_drain", pending=sched.pending(),
                                active=self._outstanding())
            now = time.monotonic()
            for key, h in list(self._slot_handles.items()):
                if h._expired(now):
                    self._finish_key(key, "deadline")
            # the deadline sweep over the handoff queue keeps its order
            kept: "collections.deque" = collections.deque()
            while self._handoff:
                h, pkg = self._handoff.popleft()
                if h._expired(now):
                    h._finish("deadline")
                    self._note_finished(h)
                else:
                    kept.append((h, pkg))
            self._handoff = kept
            self._expire_requeue(now)
            for h in sched.expire_queued(now):
                self._note_finished(h)
            # parked deadlines and the tier's TTL, the shed tick, then
            # decode-pool preemption and parked resume: host decisions,
            # all before placement so freed capacity is usable now
            self._sweep_parked(now)
            self._shed_tick(now)
            self._maybe_preempt()
            self._resume_preempted()
            did_work = self._admit_prefill(now)
            did_work |= self._advance_prefill()
            did_work |= self._place_handoffs()
            did_work |= self._decode()
            if self.pool_resize:
                self._pool_resize_tick()
            if self._draining and self._outstanding() == 0:
                break
            if not did_work:
                if sched.pending() or self._handoff or self._requeue:
                    # blocked on slots or blocks: nothing frees before a
                    # later iteration, so do not spin the engine thread
                    time.sleep(_IDLE_WAIT_S)
                else:
                    sched.wait_for_work(_IDLE_WAIT_S)

    # -- priority preemption through the handoff machinery ------------------

    def _maybe_preempt(self) -> None:
        """When the handoff queue's head outranks a decoding lane and no
        live decode worker can place it, the lowest-priority decoding lane
        (ties: least progress) exports to the host tier and frees its slot
        and blocks; it comes back through the same placement every import
        rides."""
        if (self._tier is None or not self.config.preempt
                or self._draining or not self._handoff):
            return
        head_h, head_pkg = self._handoff[0]
        hp = head_h.request.priority
        for w in self._alive("decode"):
            eng = self.decode_pool[w]
            if eng.free_slots() and eng.can_import(head_pkg):
                return  # the head can place already
        cands = [(w, slot, h)
                 for (pool, w, slot), h in self._slot_handles.items()
                 if pool == "decode" and w not in self._dead["decode"]
                 and self.decode_pool[w].decoding[slot]
                 and h.request.priority < hp and h.id not in self._skip
                 and h.id not in self._tier_oversize]
        if not cands:
            return
        w, slot, victim = min(cands, key=lambda t: (t[2].request.priority,
                                                    len(t[2].tokens)))
        eng = self.decode_pool[w]
        try:
            self._tick("decode", w)
            pkg = eng.export_slot(slot)
        except Exception as e:
            self._lose_worker("decode", w, e)
            return
        pkg["trace_id"] = victim.trace_id
        stored = self._tier_put(("preempt", victim.id), pkg, pinned=True,
                                kind="preempt")
        if stored is None:
            # the tier cannot hold the lane: placement waits, and this lane
            # is not exported again
            self._tier_oversize.add(victim.id)
            return
        del self._slot_handles[("decode", w, slot)]
        self._import_pkg.pop((w, slot), None)
        self._parked[victim.id] = victim
        self.preemptions += 1
        if victim.decode_segments and victim.decode_segments[-1][2] is None:
            victim.decode_segments[-1][2] = time.monotonic()
        self._tier_event("preempted", id=victim.id, worker=w, slot=slot,
                         priority=victim.request.priority, by_priority=hp,
                         bytes=stored, trace_id=victim.trace_id)
        try:
            eng.evict(slot)
        except Exception as e:
            self._lose_worker("decode", w, e)

    def _resume_preempted(self) -> None:
        """Parked preempted lanes re-enter at the handoff queue's head as
        decode capacity frees (oldest first, unless the queue head
        outranks them).  A spilled or corrupt parked package degrades to a
        re-prefill through the requeue line (``host_tier_corrupt``; the
        tokens already delivered drop as duplicates)."""
        if self._tier is None or not self._parked:
            return
        while self._parked:
            hid, h = next(iter(self._parked.items()))
            if self._handoff and (self._handoff[0][0].request.priority
                                  > h.request.priority):
                return  # the higher class places first
            ser = self._tier.peek(("preempt", hid))
            if ser is None or (ser.get("digest") is not None
                               and _blob_digest(ser["blob"])
                               != ser["digest"]):
                del self._parked[hid]
                if ser is not None:
                    self._tier.get(("preempt", hid))
                    self.tier_corrupt += 1
                    self._tier_event("host_tier_corrupt", kind="preempt",
                                     trace_id=h.trace_id)
                self._skip[h.id] = len(h.tokens)
                self._requeue.append(h)
                continue
            if not self._alive("decode"):
                self._tier.get(("preempt", hid))
                del self._parked[hid]
                h._finish("worker_lost")
                self._note_finished(h)
                continue
            if not any(self.decode_pool[w].free_slots()
                       and self.decode_pool[w].can_import(ser)
                       for w in self._alive("decode")):
                return  # capacity not back yet: parked head-of-line
            self._tier.get(("preempt", hid))
            del self._parked[hid]
            pkg = (ser if self.handoff_mode == "serial"
                   else deserialize_package(ser))
            self._handoff.appendleft((h, pkg))
            self.tier_resumes += 1
            self._tier_event("session_resumed", park_kind="preempt",
                             id=h.id, trace_id=h.trace_id)

    # -- the prefill pool ---------------------------------------------------

    def _pool_resize_tick(self) -> None:
        """The backpressure resize (module doc)."""
        from tpudist_torch import telemetry

        q = len(self._handoff)
        if q >= self.handoff_limit:
            self._bp_full += 1
            self._bp_free = 0
            if self._bp_full >= self.pool_resize and self._prefill_cap > 1:
                self._prefill_cap -= 1
                self.pool_resizes += 1
                self._bp_full = 0
                telemetry.event("pool_resize", pool="prefill",
                                direction="shrink", cap=self._prefill_cap,
                                queued=q)
        elif q * 2 <= self.handoff_limit:
            self._bp_free += 1
            self._bp_full = 0
            if (self._bp_free >= self.pool_resize
                    and self._prefill_cap < self._prefill_slots_total):
                self._prefill_cap += 1
                self.pool_resizes += 1
                self._bp_free = 0
                telemetry.event("pool_resize", pool="prefill",
                                direction="grow", cap=self._prefill_cap,
                                queued=q)
        else:
            self._bp_full = 0
            self._bp_free = 0

    def _admit_prefill(self, now: float) -> bool:
        from tpudist_torch import telemetry
        from tpudist_torch.constrain import GrammarPoolFull
        from tpudist_torch.serve.adapters import AdapterMissingError

        worked = False
        for w in self._alive("prefill"):
            eng = self.prefill_pool[w]
            # the resize caps the pool-wide occupied prefill slots
            occupied = sum(self.prefill_pool[i].num_occupied
                           for i in self._alive("prefill"))
            free = eng.free_slots()[:max(0, self._prefill_cap - occupied)]
            if not free:
                continue
            reserved, pinned = [0], []
            resume_pos: Dict[int, int] = {}

            def _gate(h, _eng=eng, _reserved=reserved, _pinned=pinned,
                      _resume=resume_pos):
                # one KV gate per candidate within one take: ``_reserved``
                # and ``_pinned`` carry what earlier candidates were given
                req = h.request
                if (self._tier is not None and req.session is not None
                        and h.id not in self._skip):
                    pos = self._tier.match(self._session_key(req),
                                           req.prompt)
                    if pos is not None:
                        # a session hit reserves its whole footprint on the
                        # prefill worker (the suffix prefills there, then
                        # the lane hands off like any other)
                        got = _eng.kv_admission_probe(
                            len(req.prompt), req.max_new, (),
                            reserve=_reserved[0], protect=_pinned)
                        if got is None:
                            return False
                        _reserved[0] += got[0]
                        _resume[h.id] = pos
                        return True
                got = _eng.kv_admission_probe(
                    len(req.prompt), req.max_new, req.prefix_hashes,
                    reserve=_reserved[0], protect=_pinned)
                if got is None:
                    return False
                # the decode pool takes it later: a transiently full
                # decode pool only queues the package (bounded)
                _reserved[0] += got[0]
                _pinned.extend(got[1])
                return True

            # worker-lost replays prefill first, head-of-line: this worker
            # takes no fresh admissions while its gate blocks the replay
            # head, or steady small traffic would starve the recovered lane
            batch: List[RequestHandle] = []
            replay_blocked = False
            while self._requeue and len(batch) < len(free):
                if not _gate(self._requeue[0]):
                    replay_blocked = True
                    break
                batch.append(self._requeue.popleft())
            if len(batch) < len(free) and not replay_blocked:
                batch += self.scheduler.take(len(free) - len(batch), now,
                                             admit=_gate)
            alive = []
            for h in batch:
                if h.done:
                    self._note_finished(h)
                elif not eng.has_adapter(h.request.adapter):
                    # its adapter was unloaded while it queued: finish
                    # loudly, never serve base output for it
                    h._finish("adapter_missing")
                    self._note_finished(h)
                else:
                    alive.append(h)
            if not alive:
                continue
            worked = True
            items, t0 = [], time.monotonic()
            for h, slot in zip(alive, free):
                if w in self._dead["prefill"]:
                    # the worker died placing an earlier candidate (a
                    # resume killed it): the rest requeue for survivors
                    self._requeue.append(h)
                    continue
                h.slot = slot
                h.prefill_worker = w
                if h.t_admitted is None:
                    h.t_admitted = t0
                # a session hit resumes its parked lane on this worker (a
                # spilled or corrupt package falls back to a fresh prefill)
                if h.id in resume_pos \
                        and self._resume_session_prefill(w, slot, h):
                    continue
                r = h.request
                items.append((slot, r.prompt, r.temperature, r.seed,
                              r.max_new, r.prefix_hashes, None, r.adapter,
                              r.grammar))
                self._slot_handles[("prefill", w, slot)] = h
            firsts = {}
            while items:
                try:
                    self._tick("prefill", w)
                    with telemetry.span("prefill", n=len(items),
                                        pool="prefill", worker=w):
                        firsts = eng.start_batch(items)
                    break
                except GrammarPoolFull:
                    # every grammar block of this worker is pinned
                    # (start_batch rolled the dispatch back): the
                    # constrained items wait in the requeue line, the rest
                    # admit.  Not a worker death.
                    keep = []
                    for it in items:
                        if it[8] is not None:
                            h2 = self._slot_handles.pop(("prefill", w,
                                                         it[0]))
                            h2.slot = None
                            self._requeue.append(h2)
                        else:
                            keep.append(it)
                    telemetry.event("constrain_deferred",
                                    n=len(items) - len(keep))
                    items = keep
                except AdapterMissingError as e:
                    # an unload raced the recheck (start_batch validated
                    # the whole batch first): finish that adapter's
                    # requests, admit the rest.  Not a worker death.
                    keep = []
                    for it in items:
                        if it[7] == e.adapter:
                            h2 = self._slot_handles.pop(("prefill", w,
                                                         it[0]))
                            h2._finish("adapter_missing")
                            self._note_finished(h2)
                        else:
                            keep.append(it)
                    items = keep
                except Exception as e:
                    # the worker died admitting: the lanes just registered
                    # recover through the standard path
                    self._lose_worker("prefill", w, e)
                    firsts = {}
                    break
            for slot, tok in firsts.items():
                if tok is not None:
                    self._prefill_complete(w, slot, tok)
        return worked

    def _resume_session_prefill(self, w: int, slot: int,
                                h: RequestHandle) -> bool:
        """Resume a parked session lane into prefill worker ``w``: the lane
        imports at its covered cursor and teacher-forces only the new
        turn's suffix, then rides the ordinary handoff.  False on a
        missing or corrupt parked package, or a turn the parked lane cannot
        serve (another adapter, a grammar): the caller prefills fresh."""
        from tpudist_torch.serve.adapters import AdapterMissingError
        from tpudist_torch.serve.host_tier import HostTierError

        eng = self.prefill_pool[w]
        req = h.request
        try:
            ser = self._tier.get(self._session_key(req))
            raw = deserialize_package(ser)  # the digest is checked here
        except HostTierError:
            return False  # raced a TTL sweep or an LRU spill
        except HandoffError as e:
            self.tier_corrupt += 1
            self._tier_event("host_tier_corrupt", kind="session",
                             error=str(e)[:120], trace_id=h.trace_id)
            return False
        if raw.get("adapter") != req.adapter:
            # the parked KV was written through its turn's adapter
            return False
        if raw.get("grammar") is not None or req.grammar is not None:
            # a parked automaton state belongs to its own turn
            return False
        t0 = time.monotonic()
        try:
            self._tick("prefill", w)
            eng.resume_slot(slot, raw, req.prompt,
                            temperature=req.temperature, seed=req.seed,
                            max_new=req.max_new, spec=req.spec)
        except AdapterMissingError:
            return False  # unloaded while parked: the fresh prefill then
            # finishes adapter_missing through the same race
        except Exception as e:
            # the worker died importing: register the lane so the standard
            # recovery requeues it for a fresh prefill on a survivor
            self._slot_handles[("prefill", w, slot)] = h
            self._lose_worker("prefill", w, e)
            return True  # handled: the caller must not prefill it too
        h.resumed = True
        self._slot_handles[("prefill", w, slot)] = h
        self.tier_resumes += 1
        self._tier_event("session_resumed", park_kind="turn", worker=w,
                         slot=slot, covered=int(raw["pos"]),
                         trace_id=h.trace_id,
                         import_s=round(time.monotonic() - t0, 6))
        return True

    def _advance_prefill(self) -> bool:
        from tpudist_torch import telemetry

        worked = False
        for w in self._alive("prefill"):
            eng = self.prefill_pool[w]
            if not eng.prefilling_slots():
                continue
            worked = True
            try:
                self._tick("prefill", w)
                with telemetry.span("prefill",
                                    chunks=len(eng.prefilling_slots()),
                                    pool="prefill", worker=w):
                    done = eng.advance_prefill()
            except Exception as e:
                self._lose_worker("prefill", w, e)
                continue
            for slot, tok in done.items():
                self._prefill_complete(w, slot, tok)
        return worked

    def _prefill_complete(self, w: int, slot: int, tok: int) -> None:
        """A prompt finished on prefill worker ``w``: deliver token 0 (TTFT
        stamps here, in the prefill pool), then finish (a budget of 1; a
        session's lane still parks) or export the lane for the decode
        pool.  A lane prefilled again after its worker died skips a token 0
        it already delivered."""
        from tpudist_torch import telemetry

        key = ("prefill", w, slot)
        h = self._slot_handles.get(key)
        if h is None:
            # the worker died under an earlier completion of this batch:
            # the recovery already requeued or finished this lane
            return
        h.t_prefill_done = time.monotonic()
        replayed = self._skip.get(h.id)
        if replayed is not None and replayed <= 1:
            # the prefill replay of a lane whose worker died is complete;
            # a lane with more tokens out (a preempted lane whose parked
            # package was lost) becomes whole at its decode placement
            self.lanes_recovered += 1
            telemetry.event("lane_recovered", pool="prefill", worker=w,
                            slot=slot, trace_id=h.trace_id,
                            replayed=replayed)
            if not replayed:
                del self._skip[h.id]
        # token 0: a replayed lane's re-emission drops by its skip count
        self._deliver_tokens(h, [tok], None,
                             lambda why: self._finish_key(key, why))
        if key not in self._slot_handles:
            return  # finished there (a session's lane parked first)
        eng = self.prefill_pool[w]
        if not self._alive("decode"):
            # the decode pool collapsed: the rest of the budget can never
            # be served
            del self._slot_handles[key]
            eng.evict(slot)
            h._finish("worker_lost")
            self._note_finished(h)
            return
        if len(self._handoff) >= self.handoff_limit:
            # the queue is full: the lane waits in its prefill slot (which
            # holds admission back) and retries on a later iteration
            return
        self._export(w, slot, h)

    def _export(self, w: int, slot: int, h: RequestHandle) -> None:
        eng = self.prefill_pool[w]
        try:
            self._tick("prefill", w)
            pkg = eng.export_slot(slot)
            # the trace_id crosses the pool boundary in the package
            pkg["trace_id"] = h.trace_id
            if self.handoff_mode == "serial":
                pkg = serialize_package(pkg)
                self.handoff_bytes += pkg["bytes"]
            eng.evict(slot)
        except Exception as e:
            # the lane is still registered under this key: the standard
            # recovery prefills it again (token 0 skips once)
            self._lose_worker("prefill", w, e)
            return
        del self._slot_handles[("prefill", w, slot)]
        self._handoff.append((h, pkg))
        self.handoffs += 1

    def _retry_stalled_exports(self) -> None:
        """Prefill lanes whose export stalled on a full handoff queue
        (decoding, but still in the prefill pool) export now if there is
        room."""
        for w in self._alive("prefill"):
            eng = self.prefill_pool[w]
            for slot in range(eng.num_slots):
                key = ("prefill", w, slot)
                if (eng.decoding[slot] and key in self._slot_handles
                        and len(self._handoff) < self.handoff_limit):
                    if not self._alive("decode"):
                        return
                    self._export(w, slot, self._slot_handles[key])

    # -- handoff → decode pool ----------------------------------------------

    def _place_handoffs(self) -> bool:
        from tpudist_torch import telemetry
        from tpudist_torch.constrain import GrammarPoolFull
        from tpudist_torch.serve.adapters import AdapterMissingError

        self._retry_stalled_exports()
        worked = False
        while self._handoff:
            h, pkg = self._handoff[0]
            if self.handoff_mode == "serial":
                # the cheap envelope check first: a schema-mismatched
                # package must not wedge the queue head
                try:
                    check_package_schema(pkg)
                except HandoffError as e:
                    self._handoff.popleft()
                    self._reject_package(h, e)
                    worked = True
                    continue
            placed = False
            for w in self._alive("decode"):
                eng = self.decode_pool[w]
                free = eng.free_slots()
                # gate on the package's top-level fields, so a full decode
                # pool does not deserialize a lane per blocked iteration
                if not free or not eng.can_import(pkg):
                    continue
                self._handoff.popleft()
                raw = pkg
                if self.handoff_mode == "serial":
                    try:
                        raw = deserialize_package(pkg)
                    except HandoffError as e:
                        # wire corruption: this lane's KV is gone
                        self._reject_package(h, e)
                        placed = worked = True
                        break
                slot = free[0]
                t0 = time.monotonic()
                try:
                    self._tick("decode", w)
                    eng.import_slot(slot, raw, spec=h.request.spec)
                except GrammarPoolFull:
                    # every grammar block of this worker is pinned: the
                    # package is intact and waits at the head (not placed,
                    # else this head would spin within one call)
                    self._handoff.appendleft((h, pkg))
                    break
                except AdapterMissingError:
                    # the adapter was unloaded while the lane crossed the
                    # queue: its KV is the fine-tune's, so it finishes
                    h._finish("adapter_missing")
                    self._note_finished(h)
                    placed = worked = True
                    break
                except Exception as e:
                    # the worker died importing: the package is intact and
                    # goes back to the head for a survivor
                    self._handoff.appendleft((h, pkg))
                    self._lose_worker("decode", w, e)
                    placed = worked = True
                    break
                t1 = time.monotonic()
                if h.t_decode_start is None:
                    h.t_decode_start = t1
                # one segment a residency: a replay after a worker loss
                # opens a second one on the survivor
                h.decode_segments.append([w, t1, None])
                h.slot = slot
                telemetry.event(
                    "kv_handoff", worker=w, slot=slot,
                    mode=self.handoff_mode, trace_id=h.trace_id,
                    wait_s=round(h.handoff_wait_s or 0.0, 6),
                    import_s=round(t1 - t0, 6))
                self._slot_handles[("decode", w, slot)] = h
                # the replay stash; a recovery placement still owes its
                # skip, so the package-equivalent delivered count is the
                # tokens net of it (else a second loss would under-skip)
                self._import_pkg[(w, slot)] = (
                    pkg, len(h.tokens) - self._skip.get(h.id, 0))
                if h.id in self._skip:
                    self.lanes_recovered += 1
                    telemetry.event("lane_recovered", pool="decode",
                                    worker=w, slot=slot,
                                    trace_id=h.trace_id,
                                    replayed=self._skip[h.id])
                    if self._skip[h.id] == 0:
                        del self._skip[h.id]
                placed = worked = True
                break
            if not placed:
                break  # FIFO head-of-line: the decode pool is full
        return worked

    # -- the decode pool ----------------------------------------------------

    def _decode(self) -> bool:
        from tpudist_torch import telemetry

        worked = False
        for w in self._alive("decode"):
            eng = self.decode_pool[w]
            for slot in eng.cache_full_slots():
                if ("decode", w, slot) in self._slot_handles:
                    self._finish_key(("decode", w, slot), "cache_full")
            if not eng.num_active:
                continue
            worked = True
            occ = eng.occupancy
            tele = telemetry.active()
            t0 = time.monotonic()
            try:
                self._tick("decode", w)
                info, blocks = eng.decode_auto()
            except Exception as e:
                # its lanes replay their stashed packages on survivors
                self._lose_worker("decode", w, e)
                continue
            if tele is not None and info is not None:
                self._record_block(tele, eng, t0, info, occ, eng.num_active,
                                   pool="decode", worker=w)
            block_lp = (info or {}).get("logprobs") or {}
            for slot, toks in blocks.items():
                self._deliver_block(w, slot, toks, block_lp.get(slot))
        return worked

    def _deliver_block(self, w: int, slot: int, toks, lp=None) -> None:
        key = ("decode", w, slot)
        h = self._slot_handles.get(key)
        if h is None:
            # the worker died delivering an earlier slot of this block:
            # these tokens re-emit on replay, the skip count is set
            return
        self._deliver_tokens(h, toks, lp,
                             lambda why: self._finish_key(key, why))

    def _finish_key(self, key, reason: str) -> None:
        pool, w, slot = key
        h = self._slot_handles.pop(key)
        if pool == "decode":
            self._import_pkg.pop((w, slot), None)
        # finish first: once popped the handle is invisible to
        # _abort_outstanding, so an evict that kills the worker with
        # recovery off must not strand its waiter
        h._finish(reason)
        self._note_finished(h)
        if w in self._dead[pool]:
            return
        eng = (self.prefill_pool if pool == "prefill"
               else self.decode_pool)[w]
        if (self._tier is not None and h.request.session is not None
                and reason in ("length", "eos", "session_resumed")
                and eng.exportable(slot, len(h.tokens))):
            # park the finished turn's lane before the evict zeroes it (a
            # max_new == 1 turn parks from the prefill pool; an engine
            # call: a death here takes the worker-lost path)
            try:
                self._tick(pool, w)
                self._park_session_lane(eng, slot, h)
            except Exception as e:
                self._lose_worker(pool, w, e)
                return
        try:
            eng.evict(slot)
        except Exception as e:
            # this handle is finished; the worker's other lanes recover
            self._lose_worker(pool, w, e)

    def _note_finished(self, h: RequestHandle) -> None:
        from tpudist_torch import telemetry
        from tpudist_torch.telemetry import trace

        # the one cleanup point of the recovery bookkeeping: a recovering
        # lane that ends early never leaks its skip entry or its memo
        self._skip.pop(h.id, None)
        self._tier_oversize.discard(h.id)
        self.completed += 1
        self._track_tenant(h.request.tenant, -1)
        if self._capture is not None:
            # the distillation flywheel's tap: the finished stream is the
            # training example (bounded ring, drops counted)
            self._capture.offer_handle(h)
        if h.decode_segments and h.decode_segments[-1][2] is None:
            h.decode_segments[-1][2] = h.t_done
        telemetry.event(
            "request_finished", id=h.id, reason=h.finish_reason,
            prompt_len=int(len(h.request.prompt)), tokens_out=len(h.tokens),
            ttft_s=h.ttft_s, tpot_s=h.tpot_s, queue_wait_s=h.queue_wait_s,
            pool="disagg", handoff_wait_s=h.handoff_wait_s,
            trace_id=h.trace_id,
            **({"tenant": h.request.tenant} if h.request.tenant else {}),
            **({"adapter": h.request.adapter} if h.request.adapter else {}),
            **({"constrained": h.request.grammar.source["kind"]}
               if h.request.grammar is not None else {}),
            **({"stop_seqs": len(h.request.stop)} if h.request.stop
               else {}),
            **({"logprobs": h.request.logprobs} if h.request.logprobs
               else {}))
        # the lifeline: req_queue → req_prefill → req_handoff → one
        # req_decode a residency
        trace.emit_request_lifeline(h)
