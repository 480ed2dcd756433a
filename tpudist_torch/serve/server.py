"""Threaded serving front-end — the PyTorch port of
``tpudist/serve/server.py`` for the serving slices: ingestion, the engine
loop, graceful drain, per-tenant LoRA adapters, speculative decoding and
structured output (grammars and JSON schemas, stop sequences, top-n
logprobs), the serving mesh (``mesh``, ``tp_overlap``) and the runtime
plane: telemetry (``prefill``/``decode_block``/``spec_verify`` spans, the
``request_finished`` events and per-request lifelines, the ``tenant``
label), the live ``/metrics``, ``/healthz`` and ``/statusz`` endpoints
(``TPUDIST_METRICS_PORT``), and SIGTERM → drain through the training
stack's preemption flag; and graceful degradation under overload: the
host-RAM KV tier (``host_tier``: finished session turns and preempted
lanes park in host memory in the handoff wire form and come back without
recompute), priority preemption (``preempt``), SLO-aware load shedding
(``shed``) and per-tenant fair share (``fair_share``), plus the hooks the
fleet router (:mod:`tpudist_torch.serve.router`) drives — ``kill``,
``parked_sessions``, ``export_session`` and ``adopt_session``.  Both
server flavours share that plane through :class:`_Observability`;
:func:`serve_forever` starts the one the config asks for — this server, or
the prefill/decode-disaggregated :class:`~tpudist_torch.serve.disagg.
DisaggServer` when ``ServeConfig.disagg`` is set.

One background thread drives the engine; any number of caller threads
submit.  Each loop iteration admits queued requests into free slots (one
batched prefill), feeds one chunk to every still-prefilling slot, then runs
one fused decode block and streams its tokens.  ``close()`` stops admitting,
finishes everything admitted, and stops the loop.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from tpudist_torch.constrain import GrammarPoolFull
from tpudist_torch.serve.adapters import AdapterMissingError
from tpudist_torch.serve.engine import SlotEngine
from tpudist_torch.serve.scheduler import (AdmissionError, RequestHandle,
                                           Scheduler)

#: poll interval of an idle engine loop (host-side only)
_IDLE_WAIT_S = 0.01

#: ``TPUDIST_SERVE_*`` variables that the JAX ``ServeConfig.from_env``
#: reads and the port has no subsystem for yet: suffix → (what it turns
#: on, its ROADMAP.md queue A item).  Set to a non-empty value, each one
#: raises instead of being dropped.
_UNPORTED_ENV = {
    "AUTO": ("measurement-driven planning (plan/)", "8"),
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpudist_torch yet (ROADMAP.md queue A "
        f"item {item})")


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs; :meth:`from_env` reads the ``TPUDIST_SERVE_*``
    family.  Every engine arm of the JAX server builds, but the defaults
    differ: the port's ``paged``, ``attn_kernel="paged"``,
    ``prefill_kernel`` and ``sample_kernel`` default to the hand-written
    kernels, where the JAX server's default to the dense slot cache, the
    gather decode, the teacher-forced prefill and the unfused sampling
    tail.  ``paged=False, attn_kernel="gather", prefill_kernel=False,
    sample_kernel=False`` — or ``TPUDIST_SERVE_PAGED=0
    TPUDIST_SERVE_SAMPLE_KERNEL=0`` through :meth:`from_env`, where
    ``PAGED=0`` leaves ``ATTN_KERNEL`` and ``PREFILL_KERNEL``, when unset,
    at the dense arms — is the JAX server's default configuration.  The
    kernel arms need the pool: with ``paged=False`` they raise.
    ``prefix_cache_blocks`` sizes the block allocator only, so on a dense
    engine it does nothing (as in JAX).  ``fused_rope``,
    ``lora_kernel``, the adapter knobs and the speculative-decoding knobs
    keep the JAX package's defaults (off; 8 blocks of rank 8; K = 4 with a
    draft tied to half the target's layers), and so do the structured-output
    knobs (off; 4 grammar blocks of 64 states; no logprobs) and the
    graceful-degradation knobs (no host tier, a 1 GiB budget when on,
    preemption on with the tier, no shedding, no fair share) and the
    disaggregation knobs (off; one prefill and one decode worker, the
    prefill pool's slots ``num_slots``, the ``"device"`` handoff, a queue
    of 8, recovery on, no pool resize)."""

    num_slots: int = 4
    queue_limit: int = 64
    max_new: int = 64  # default per-request token budget
    prefill_pad: Optional[int] = None  # chunk size; None: min(max_len, 64)
    deadline_s: Optional[float] = None  # default per-request deadline
    decode_block: int = 8  # max fused decode tokens per dispatch (K)
    paged: bool = True  # block pool + block tables, not the dense cache
    kv_block: int = 16  # tokens per KV block (must divide max_len)
    kv_blocks: Optional[int] = None  # None = num_slots * max_len / kv_block
    kv_int8: bool = False  # int8 KV storage + per-block scales
    prefix_cache_blocks: int = 0  # shared-prefix LRU cache bound (blocks)
    attn_kernel: str = "paged"  # or "gather": decode over a dense view
    prefill_kernel: bool = True  # False: the teacher-forced prefill
    sample_kernel: bool = True  # False: the unfused sampling tail
    fused_rope: bool = False  # fused RoPE+QKV kernel on the kernel arms
    lora_kernel: bool = False  # LoRA gather-matmul (requires adapters)
    # -- per-tenant adapters: per-request ``adapter=`` names decode through
    # base(x) + (x·A)·B with the adapter's factors from a paged pool
    adapters: bool = False
    adapter_blocks: int = 8  # resident-adapter capacity (one block each)
    adapter_rank: int = 8  # LoRA rank r shared by the pool
    # -- speculative decoding (draft-propose / batched target-verify)
    spec: bool = False  # draft proposes K, target verifies in one pass
    spec_k: int = 4  # drafted tokens per speculative block
    # tied-draft depth (the target's first N layers; 0 = half the target
    # depth); a loaded draft (a TransformerLM) in ``spec_draft`` wins
    spec_draft_layers: int = 0
    spec_draft: Optional[object] = None  # a TransformerLM; not env-loadable
    # -- structured output: per-request ``grammar=`` (regex) /
    # ``json_schema=`` asks compile on the host into token automata whose
    # tables live in a fixed device pool, masked by the sampling kernel
    constrain: bool = False
    constrain_blocks: int = 4  # resident-grammar capacity (one block each)
    constrain_states: int = 64  # automaton state cap per compiled grammar
    # engine-wide top-n logprobs width per emitted token (0 = off); a
    # request asks any ``submit(logprobs=n)`` with n <= this
    logprobs: int = 0
    # -- the serving mesh (serve/spmd.py): "DxM" (data × model) or "M";
    # "1" = single device.  Declarative on purpose (AMP-style): a planner
    # searches this field, not the code.
    mesh: Optional[str] = None
    tp_overlap: Optional[str] = None  # off|ring|bidir; None = knob chain
    # -- prefill/decode disaggregation (serve/disagg.py): separate prefill
    # and decode worker pools with a KV handoff between them
    disagg: bool = False
    prefill_workers: int = 1
    decode_workers: int = 1
    prefill_slots: Optional[int] = None  # per prefill worker; None: num_slots
    handoff: str = "device"  # "device" (tensors) | "serial" (wire bytes)
    handoff_queue: int = 8  # bounded pending-handoff packages
    # a dead pool worker's lanes replay onto survivors (stashed handoff
    # packages: one extra copy of each in-flight decode lane's KV); off =
    # any worker death aborts all outstanding work as "shutdown"
    recover: bool = True
    # backpressure pool resize: consecutive loop iterations the handoff
    # queue must stay full before the prefill slot budget shrinks by one
    # (and at most half full before it grows back); 0 = off
    pool_resize: int = 0
    # -- host-RAM KV session tier + overload control
    # (serve/host_tier.py, serve/overload.py)
    host_tier: bool = False  # park idle/preempted lanes in host RAM
    host_tier_bytes: int = 1 << 30  # tier byte budget (LRU spill beyond)
    host_tier_ttl_s: Optional[float] = None  # idle parked-session expiry
    # priority preemption: a higher-priority arrival may preempt a
    # strictly-lower-priority decode lane into the host tier (its resume
    # continues the same stream); effective only with host_tier on
    preempt: bool = True
    # SLO-aware load shedding: when a protected tenant's live attainment
    # gauge (TPUDIST_SLO_* targets) drops below the target, lower-priority
    # work rejects or sheds with reason "shed_load"
    shed: bool = False
    shed_attainment: float = 0.9  # attainment floor that trips shedding
    shed_priority: int = 1  # protected priority class (>= is protected)
    # per-tenant token-rate fairness: reject a tenant drawing more than
    # this multiple of its equal share once the queue is half full
    # (0 = off)
    fair_share: float = 0.0

    def resolve_spec_draft(self, model):
        """The engine-facing ``spec_draft`` (None = spec off): the loaded
        draft if one was given, else the tied layer count."""
        if not self.spec:
            return None
        if self.spec_draft is not None:
            return self.spec_draft
        return int(self.spec_draft_layers
                   or max(1, int(model.n_layers) // 2))

    def mesh_config(self):
        """The engine-facing mesh spec (None when unset/1-device)."""
        if not self.mesh or self.mesh.strip() in ("", "1", "1x1"):
            return None
        from tpudist_torch.serve.spmd import ServeMeshConfig

        return ServeMeshConfig(shape=self.mesh, tp_overlap=self.tp_overlap)

    @classmethod
    def from_env(cls) -> "ServeConfig":
        import os

        from tpudist_torch.utils.envutil import (env_flag, env_int,
                                                 env_positive_float)

        for suffix, (what, item) in _UNPORTED_ENV.items():
            name = f"TPUDIST_SERVE_{suffix}"
            if os.environ.get(name, "").strip():
                raise _not_ported(f"{name} ({what})", item)
        # without a pool the kernel arms that need one default off, as the
        # JAX server's do; set explicitly they raise at the engine
        paged = env_flag("TPUDIST_SERVE_PAGED", True)
        return cls(
            num_slots=env_int("TPUDIST_SERVE_SLOTS", 4) or 4,
            queue_limit=env_int("TPUDIST_SERVE_QUEUE", 64) or 64,
            max_new=env_int("TPUDIST_SERVE_MAX_NEW", 64) or 64,
            prefill_pad=env_int("TPUDIST_SERVE_PREFILL_PAD", None),
            deadline_s=env_positive_float("TPUDIST_SERVE_DEADLINE_S", None),
            decode_block=env_int("TPUDIST_SERVE_DECODE_BLOCK", 8) or 8,
            paged=paged,
            kv_block=env_int("TPUDIST_SERVE_KV_BLOCK", 16) or 16,
            kv_blocks=env_int("TPUDIST_SERVE_KV_BLOCKS", None),
            kv_int8=env_flag("TPUDIST_SERVE_KV_INT8", False),
            prefix_cache_blocks=env_int(
                "TPUDIST_SERVE_PREFIX_CACHE", 0) or 0,
            attn_kernel=os.environ.get(
                "TPUDIST_SERVE_ATTN_KERNEL", "").strip()
            or ("paged" if paged else "gather"),
            prefill_kernel=env_flag("TPUDIST_SERVE_PREFILL_KERNEL", paged),
            sample_kernel=env_flag("TPUDIST_SERVE_SAMPLE_KERNEL", True),
            fused_rope=env_flag("TPUDIST_SERVE_FUSED_ROPE", False),
            lora_kernel=env_flag("TPUDIST_SERVE_LORA_KERNEL", False),
            adapters=env_flag("TPUDIST_SERVE_ADAPTERS", False),
            adapter_blocks=env_int("TPUDIST_SERVE_ADAPTER_BLOCKS", 8) or 8,
            adapter_rank=env_int("TPUDIST_SERVE_ADAPTER_RANK", 8) or 8,
            spec=env_flag("TPUDIST_SERVE_SPEC", False),
            spec_k=env_int("TPUDIST_SERVE_SPEC_K", 4) or 4,
            spec_draft_layers=env_int(
                "TPUDIST_SERVE_SPEC_DRAFT_LAYERS", 0) or 0,
            constrain=env_flag("TPUDIST_SERVE_CONSTRAIN", False),
            constrain_blocks=env_int("TPUDIST_CONSTRAIN_BLOCKS", 4) or 4,
            constrain_states=env_int("TPUDIST_CONSTRAIN_STATES", 64) or 64,
            logprobs=env_int("TPUDIST_SERVE_LOGPROBS", 0) or 0,
            mesh=os.environ.get("TPUDIST_SERVE_MESH", "").strip() or None,
            tp_overlap=os.environ.get(
                "TPUDIST_SERVE_TP_OVERLAP", "").strip() or None,
            disagg=env_flag("TPUDIST_SERVE_DISAGG", False),
            prefill_workers=env_int("TPUDIST_SERVE_PREFILL_WORKERS", 1) or 1,
            decode_workers=env_int("TPUDIST_SERVE_DECODE_WORKERS", 1) or 1,
            prefill_slots=env_int("TPUDIST_SERVE_PREFILL_SLOTS", None),
            handoff=os.environ.get(
                "TPUDIST_SERVE_HANDOFF", "").strip() or "device",
            handoff_queue=env_int("TPUDIST_SERVE_HANDOFF_QUEUE", 8) or 8,
            recover=env_flag("TPUDIST_SERVE_RECOVER", True),
            pool_resize=env_int("TPUDIST_SERVE_POOL_RESIZE", 0) or 0,
            host_tier=env_flag("TPUDIST_SERVE_HOST_TIER", False),
            host_tier_bytes=env_int("TPUDIST_HOST_TIER_BYTES",
                                    1 << 30) or (1 << 30),
            host_tier_ttl_s=env_positive_float(
                "TPUDIST_HOST_TIER_TTL_S", None),
            preempt=env_flag("TPUDIST_SERVE_PREEMPT", True),
            shed=env_flag("TPUDIST_SERVE_SHED", False),
            shed_attainment=env_positive_float(
                "TPUDIST_SERVE_SHED_ATTAINMENT", 0.9) or 0.9,
            # plain env_int: 0 is a meaningful protected class here
            shed_priority=env_int("TPUDIST_SERVE_SHED_PRIORITY", 1),
            fair_share=env_positive_float(
                "TPUDIST_SERVE_FAIR_SHARE", None) or 0.0,
        )


def _compile_grammar_for(ccfg, regex, json_schema, eos_id):
    """The scheduler's grammar compiler: closes over the engine's
    constrain geometry so admission compiles (LRU-cached) and rejects
    synchronously."""
    from tpudist_torch.constrain import compile_grammar

    return compile_grammar(regex=regex, json_schema=json_schema,
                           vocab=ccfg.vocab, eos_id=eos_id,
                           max_states=ccfg.max_states)


class ReplicaKilled(RuntimeError):
    """The engine loop stopped because :meth:`InferenceServer.kill` told it
    to — an intentional hard stop (an operator's kill, the
    ``replica_kill`` fault), recorded like any other death (``loop_error``
    set, ``/healthz`` 503, outstanding work aborted) but not re-raised into
    the threading excepthook."""


class _Observability:
    """What both server flavours share (:class:`InferenceServer` here,
    :class:`~tpudist_torch.serve.disagg.DisaggServer` over its two pools):
    the live plane — ``/healthz`` (the engine thread alive, loop-error-free
    and its heartbeat fresh, not merely "the HTTP thread answered"),
    ``/statusz`` registered against the process endpoint, the
    ``slo_config`` stamp — the hard stop (``kill``), the fleet's session
    hooks, graceful degradation (the host tier, shedding, the parked
    lanes), per-tenant in-flight accounting, the adapter surface,
    broadcast over every engine of the flavour, and the distillation
    capture tap and draft hot-swap."""

    _statusz_name = "serve"


    def _init_observability(self) -> None:
        """State both server constructors share: every attribute the health
        and status methods read lives here."""
        from tpudist_torch.utils.envutil import env_positive_float

        #: the exception that killed the engine loop, if any — /healthz
        #: goes 503 on it
        self.loop_error: Optional[str] = None
        #: engine-loop heartbeat (stamped every iteration, idle included)
        self._beat: Optional[float] = None
        #: /healthz staleness threshold for the heartbeat
        #: (TPUDIST_SERVE_HEALTH_STALE_S).  The default must exceed the
        #: worst dispatch that legitimately blocks an iteration — the first
        #: request's kernel builds — or an orchestrator doing liveness
        #: restarts would kill a starting server in a loop.
        self.health_stale_s = env_positive_float(
            "TPUDIST_SERVE_HEALTH_STALE_S", 300.0)
        #: hard-stop poison (:meth:`kill`): the engine loop raises on its
        #: next iteration when set — the crash twin of drain
        self._die: Optional[str] = None
        self._statusz_names: list = []
        #: tenant → in-flight count (submitted minus finished) for
        #: /statusz; mutated under _tenant_lock (ingestion + engine
        #: threads both write)
        self._tenant_inflight: Dict[str, int] = {}
        self._tenant_lock = threading.Lock()
        #: live-traffic capture ring (tpudist_torch.distill) — both
        #: flavours' ``_note_finished`` offer through it when attached;
        #: None = disarmed (one attribute load + None check on the finish
        #: seam)
        self._capture = None
        #: pending draft hot-swap (tpudist_torch.distill): a cross-thread
        #: ``swap_draft`` posts here and the ENGINE loop applies it
        #: between decode blocks — the slot programs only ever run a
        #: consistent draft
        self._swap_req: Optional[dict] = None
        self._swap_lock = threading.Lock()

    def _start_observability(self) -> None:
        from tpudist_torch import telemetry
        from tpudist_torch.telemetry import metrics, statusz

        targets = metrics.slo_targets()
        if targets["ttft_s"] or targets["tpot_s"]:
            telemetry.event(
                "slo_config",
                **({"ttft_ms": round(targets["ttft_s"] * 1e3, 3)}
                   if targets["ttft_s"] else {}),
                **({"tpot_ms": round(targets["tpot_s"] * 1e3, 3)}
                   if targets["tpot_s"] else {}))
        # static-geometry gauges: a scrape between server start and the
        # first request already answers "what is this process serving"
        if metrics.enabled_from_env():
            reg = metrics.registry()
            for name, value in self._observability_gauges().items():
                reg.gauge(name).set(value)
        srv = statusz.ensure_started()
        if srv is not None:
            self._statusz_names = [
                srv.register_health(self._statusz_name, self._health_check),
                srv.register_status(self._statusz_name, self._statusz_doc),
            ]

    def _stop_observability(self) -> None:
        from tpudist_torch.telemetry import statusz

        srv = statusz.active()
        if srv is not None:
            for name in self._statusz_names:
                srv.unregister(name)
        self._statusz_names = []

    def _health_check(self):
        """(ok, detail) for ``/healthz``.  Unhealthy when the engine loop
        has aborted (``serve_loop_error``), its thread is gone, or its
        heartbeat is stale: liveness of the HTTP thread alone must never
        read as healthy."""
        t = self._thread
        alive = t is not None and t.is_alive()
        beat_age = (None if self._beat is None
                    else time.monotonic() - self._beat)
        stale = beat_age is not None and beat_age > self.health_stale_s
        ok = alive and self.loop_error is None and not stale
        return ok, {
            "engine_thread_alive": alive,
            "loop_error": self.loop_error,
            "beat_age_s": None if beat_age is None else round(beat_age, 3),
            "heartbeat_stale": stale,
            "draining": self._draining,
        }

    def kill(self, reason: str = "killed") -> None:
        """Hard-stop the engine loop now — the crash twin of :meth:`drain`
        (an operator's kill, and what the ``replica_kill`` fault drives at
        fleet scope).  The loop raises :class:`ReplicaKilled` on its next
        iteration: in-flight and queued work aborts ``"shutdown"``,
        ``loop_error`` is set, ``/healthz`` goes 503.  Nothing parks and
        nothing drains; recovery is the caller's (the fleet router re-homes
        onto survivors)."""
        self._die = reason

    def _check_die(self) -> None:
        """The engine loop's poison check (one attribute load alive)."""
        if self._die:
            raise ReplicaKilled(f"replica killed: {self._die}")

    # -- fleet session migration (tpudist_torch.serve.router) ---------------
    # A parked session is also the unit of migration between replicas.  The
    # three hooks are GIL-atomic tier reads and inserts, so a router thread
    # may call them while the engine loop runs.

    def parked_sessions(self) -> list:
        """``(tenant, session)`` of every idle session parked in this
        replica's host tier (empty without a tier)."""
        if self._tier is None:
            return []
        return [(k[1], k[2]) for k in self._tier.session_keys()]

    def export_session(self, tenant, session) -> Optional[dict]:
        """A stashable copy of the package parked under ``(tenant,
        session)`` — the serialized blob plus its covered context — or None
        when nothing is parked there."""
        if self._tier is None or session is None:
            return None
        key = ("sess", tenant if tenant else "default", str(session))
        return self._tier.export_entry(key)

    def adopt_session(self, tenant, session, stash: Optional[dict]) -> bool:
        """Install a session package exported from another replica into
        this tier, so the session's next turn resumes here.  The digest is
        verified where it always is, at the resume's deserialize: a corrupt
        stash degrades to a full re-prefill.  False when this replica has
        no tier, the stash is empty, or the package alone exceeds the
        budget."""
        if self._tier is None or session is None or not stash \
                or not isinstance(stash.get("ser"), dict):
            return False
        key = ("sess", tenant if tenant else "default", str(session))
        stored = self._tier.adopt(key, stash["ser"],
                                  context=stash.get("context"),
                                  kind=stash.get("kind", "turn"))
        return stored is not None

    # -- graceful degradation under overload (host tier + shedding) ---------

    def _init_degradation(self, scheduler) -> None:
        """The host-RAM KV tier (``ServeConfig.host_tier``) and the
        SLO-aware overload controller (``shed`` / ``fair_share``), which
        becomes the scheduler's admission gate."""
        cfg = self.config
        self._tier = None
        if cfg.host_tier:
            from tpudist_torch.serve.host_tier import HostKVTier

            self._tier = HostKVTier(cfg.host_tier_bytes,
                                    ttl_s=cfg.host_tier_ttl_s)
        self._ctrl = None
        if cfg.shed or cfg.fair_share > 0:
            from tpudist_torch.serve.overload import OverloadController

            self._ctrl = OverloadController(
                shed=cfg.shed, shed_attainment=cfg.shed_attainment,
                shed_priority=cfg.shed_priority, fair_share=cfg.fair_share,
                queue_limit=cfg.queue_limit)
            scheduler.admission_gate = self._ctrl.gate
        #: preempted handles parked in the host tier, insertion-ordered
        #: (resume order); their packages live under ``("preempt", id)``
        self._parked: "collections.OrderedDict[int, RequestHandle]" = \
            collections.OrderedDict()
        #: handle id → tokens to drop on re-emission after a re-prefill
        #: fallback (a lane whose parked package was spilled or corrupt
        #: decodes again from its prompt)
        self._skip: Dict[int, int] = {}
        #: handle ids whose preempt package the tier refused as oversize: a
        #: lane's footprint only grows, so it is never exported again
        self._tier_oversize: set = set()
        self.preemptions = 0
        self.tier_resumes = 0
        self.tier_corrupt = 0

    @staticmethod
    def _session_key(req) -> tuple:
        # tenant-scoped: one tenant never resumes another's context
        return ("sess", req.tenant or "default", req.session)

    def _tier_put(self, key: tuple, pkg: dict, **kw):
        """``HostKVTier.put`` and a ``host_tier_spill`` event for any LRU
        spill the put forced (the tier has no telemetry seam)."""
        t = self._tier
        s0 = t.spills
        stored = t.put(key, pkg, **kw)
        if t.spills > s0:
            self._tier_event("host_tier_spill", entries=t.spills - s0)
        return stored

    def _tier_event(self, name: str, **fields) -> None:
        """A host-tier event stamped with the tier's occupancy (the
        metrics feeder turns those fields into the live gauges)."""
        from tpudist_torch import telemetry

        if self._tier is not None:
            fields.setdefault("tier_bytes", self._tier.bytes_resident)
            fields.setdefault("tier_entries", self._tier.entries)
        telemetry.event(name, **fields)

    def _shed_tick(self, now: float) -> None:
        """Refresh the overload controller from the live attainment gauges
        and shed queued lower-priority work while it is active; every flip
        is stamped with the readings that drove it."""
        ctrl = self._ctrl
        if ctrl is None or self._draining:
            return
        if ctrl.tick(now):
            self._tier_event(
                "shed_state", active=ctrl.shed_active,
                target=ctrl.shed_attainment,
                attainment={k: round(v, 4)
                            for k, v in ctrl.last_attainment.items()})
        if ctrl.shed_active:
            shed = self.scheduler.shed(ctrl.shed_predicate)
            ctrl.sheds += len(shed)
            for h in shed:
                self._note_finished(h)

    def _expire_requeue(self, now: float) -> None:
        """Deadline sweep over the re-prefill fallback line."""
        if not self._requeue:
            return
        kept: "collections.deque" = collections.deque()
        while self._requeue:
            h = self._requeue.popleft()
            if h._expired(now):
                h._finish("deadline")
                self._note_finished(h)
            else:
                kept.append(h)
        self._requeue = kept

    def _sweep_parked(self, now: float) -> None:
        """The deadline sweep covers parked lanes too: a preempted request
        expiring while offloaded releases its host bytes and finishes
        ``deadline`` now.  Idle sessions expire by the tier's TTL."""
        if self._tier is None:
            return
        expired = self._tier.sweep_expired(now)
        if expired:
            self._tier_event("session_expired", entries=len(expired))
        for hid in [hid for hid, h in self._parked.items()
                    if h._expired(now)]:
            h = self._parked.pop(hid)
            self._tier.discard(("preempt", hid))
            h._finish("deadline")
            self._note_finished(h)

    def _park_session_lane(self, eng, slot: int, h) -> None:
        """Export a finished turn's lane from ``eng`` and park it under its
        session key with the covered context (prompt + every delivered
        token): the next turn resumes only if its prompt extends that
        exactly."""
        req = h.request
        pkg = eng.export_slot(slot)
        pkg["trace_id"] = h.trace_id
        ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                              np.asarray(h.tokens, np.int32)])
        stored = self._tier_put(self._session_key(req), pkg, context=ctx,
                                kind="turn")
        if stored is not None:
            self._tier_event("session_parked", park_kind="turn",
                             pos=int(pkg["pos"]), bytes=stored,
                             trace_id=h.trace_id)

    def _abort_parked(self) -> None:
        """Hard stop for parked preempted lanes: they finish ``preempted``
        (not ``shutdown``) and release their tier bytes."""
        while self._parked:
            hid, h = self._parked.popitem(last=False)
            if self._tier is not None:
                self._tier.discard(("preempt", hid))
            h._finish("preempted")
            self._note_finished(h)

    def _track_tenant(self, tenant, delta: int) -> None:
        """Per-tenant in-flight accounting for /statusz (None pools under
        ``default``); a count that reaches 0 drops its key."""
        key = tenant if tenant else "default"
        with self._tenant_lock:
            n = self._tenant_inflight.get(key, 0) + delta
            if n <= 0:
                self._tenant_inflight.pop(key, None)
            else:
                self._tenant_inflight[key] = n

    # -- online draft distillation (tpudist_torch.distill) ------------------
    # Shared by both server flavours: one capture tap, one hot-swap surface.
    # The swap itself is per flavour (_swap_now): one engine here, a
    # decode-pool broadcast on the disaggregated coordinator.

    def attach_capture(self, capture) -> None:
        """Attach a :class:`tpudist_torch.distill.CaptureBuffer`: every
        finished request's (prompt, emitted) stream is offered to it from
        ``_note_finished`` (greedy and sampled lanes, tenant/adapter tags
        riding along).  ``start()`` attaches one when
        ``TPUDIST_DISTILL_CAPTURE`` is on."""
        self._capture = capture

    @property
    def capture(self):
        return self._capture

    def draft_ref(self) -> Optional[tuple]:  # per flavour
        """``(draft_model, its current state dict)`` of the serving draft,
        or ``None`` on a non-spec server — what the distillation lane
        warm-starts from and scores against."""
        raise NotImplementedError

    def _swap_now(self, new_params) -> dict:  # per flavour
        raise NotImplementedError

    def swap_draft(self, new_params,
                   timeout: Optional[float] = 60.0) -> dict:
        """Hot-swap the speculative draft's weights — the gated landing.

        Same geometry required (the engine raises on any name/shape/dtype
        mismatch).  Thread-safe: with the engine loop running, the request
        parks in ``_swap_req`` and the LOOP applies it at its next
        iteration top — between decode blocks by construction, so no slot
        program ever runs half-swapped — and this caller blocks until it
        lands (``TimeoutError`` past ``timeout``).  Without a live loop
        (before ``start()``, or tests driving ``step()`` by hand) the swap
        applies directly."""
        t = self._thread
        if t is None or not t.is_alive():
            return self._swap_now(new_params)
        req = {"params": new_params, "done": threading.Event(),
               "result": None, "error": None}
        with self._swap_lock:
            if self._swap_req is not None:
                raise RuntimeError("a draft swap is already pending")
            self._swap_req = req
        if not req["done"].wait(timeout):
            with self._swap_lock:
                if self._swap_req is req:
                    self._swap_req = None
            raise TimeoutError(
                f"draft swap not applied within {timeout}s (engine loop "
                "stalled?)")
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    def _apply_pending_swap(self) -> None:
        """Engine-loop seam (iteration top — between decode blocks): apply
        a parked swap and wake its poster.  One attribute load + None check
        when idle, like every other loop tax."""
        req = self._swap_req
        if req is None:
            return
        try:
            req["result"] = self._swap_now(req["params"])
        except BaseException as e:  # the poster gets the error, the
            req["error"] = e        # serving loop survives it
        finally:
            with self._swap_lock:
                self._swap_req = None
            req["done"].set()

    def _note_swap(self, info: dict) -> None:
        """The ``draft_swap`` event + counter feed, emitted by the flavour
        ``_swap_now`` implementations on an APPLIED swap."""
        from tpudist_torch import telemetry

        telemetry.event("draft_swap",
                        lanes_rearmed=info.get("lanes_rearmed"),
                        swap_s=info.get("swap_s"),
                        draft_swaps=info.get("draft_swaps"),
                        **({"engines": info["engines"]}
                           if "engines" in info else {}))

    def _distill_status(self) -> dict:
        """The ``/statusz`` ``distill`` block (capture attached only): the
        capture ledger — drops counted, never silent."""
        return {"capture": self._capture.stats()}

    def _arm_capture_from_env(self) -> None:
        """``TPUDIST_DISTILL_CAPTURE`` arms the live-traffic tap at the
        same entry the faults grammar arms at (an attached ring stays)."""
        if self._capture is None:
            from tpudist_torch.distill.capture import CaptureBuffer

            self._capture = CaptureBuffer.from_env()

    def _statusz_doc(self) -> dict:  # per flavour
        raise NotImplementedError

    def _observability_gauges(self) -> Dict[str, float]:  # per flavour
        raise NotImplementedError

    def _note_finished(self, h) -> None:  # per flavour
        raise NotImplementedError

    # -- the decode stream (both flavours) ------------------------------------

    @staticmethod
    def _record_block(tele, eng, t0: float, info: dict, occ: float,
                      active: int, **extra) -> None:
        """The ``decode_block`` span of one plain block of ``eng``, or the
        ``spec_verify`` span of a speculative one, with JAX's tags: the
        block's occupancy and size, its dispatch/sync split, the KV gauges
        and the bytes its attention streamed (and the acceptance and the
        draft/verify split of a speculative block), plus ``extra`` (a
        disaggregated block's pool and worker)."""
        kv_occ, kv_resident = eng.kv_gauges()
        tags = {"occupancy": occ, "active": active,
                "k": info["k"], "tokens": info["tokens"],
                "dispatch_s": round(info["dispatch_s"], 9),
                "sync_s": round(info["sync_s"], 9),
                "kv_block_occupancy": kv_occ,
                "kv_bytes_resident": kv_resident,
                "kv_read_bytes": info["kv_read_bytes"], **extra}
        if info.get("spec"):
            tags.update(accepted=info["accepted"], drafted=info["drafted"],
                        rollbacks=info["rollbacks"],
                        draft_s=round(info["draft_s"], 9),
                        verify_s=round(info["verify_s"], 9))
            if info.get("accept_by_adapter"):
                tags["accept_by_adapter"] = info["accept_by_adapter"]
            tele.record_span("spec_verify", t0, time.monotonic() - t0, tags)
        else:
            tele.record_span("decode_block", t0, time.monotonic() - t0,
                             tags)

    @staticmethod
    def _stop_reason(h, tok: int) -> Optional[str]:
        """The finish reason the token just delivered to ``h`` triggers:
        its stop token, a stop sequence (suffix-matched on the delivered
        stream, so a match straddling two blocks is found too) or its
        length budget (a resumed turn's reads ``session_resumed``, so the
        resume path is countable from the finish reasons alone)."""
        req = h.request
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if req.stop and any(len(h.tokens) >= len(s)
                            and tuple(h.tokens[-len(s):]) == s
                            for s in req.stop):
            return "stop_sequence"
        if len(h.tokens) >= req.max_new:
            return "session_resumed" if h.resumed else "length"
        return None

    def _deliver_tokens(self, h, toks, lp, finish) -> None:
        """Stream a token block to ``h``, calling ``finish(reason)`` where
        it ends (the device block runs past a finish by at most the block
        size).  Tokens the lane already delivered before a replay or a
        re-prefill drop by its ``_skip`` count.  ``lp`` is the block's
        top-n logprobs rows aligned with ``toks`` (absent on a
        prefill-sampled first token, which surfaces None).  A constrained
        lane walks its grammar's host shadow automaton per delivered
        token; a token the shadow forbids truncates the stream before
        delivery and finishes ``grammar_violation`` (the device mask makes
        that unreachable unless the pool tables and the shadow
        diverge)."""
        tg = h.request.grammar
        if self._ctrl is not None:
            # the fair-share measurement: delivered tokens/s per tenant
            delivered = max(0, len(toks) - self._skip.get(h.id, 0))
            if delivered:
                self._ctrl.note_tokens(h.request.tenant, delivered)
        for i, tok in enumerate(toks):
            skip = self._skip.get(h.id, 0)
            if skip > 0:
                # a token delivered before: its finish checks and its
                # shadow-automaton step ran then
                if skip == 1:
                    del self._skip[h.id]
                else:
                    self._skip[h.id] = skip - 1
                continue
            if tg is not None:
                if not tg.token_allowed(h.gstate, tok):
                    finish("grammar_violation")
                    return
                h.gstate = tg.advance(h.gstate, tok)
            h._deliver(tok)
            if h.request.logprobs > 0:
                n = h.request.logprobs
                row = lp[i] if lp is not None and i < len(lp) else None
                h.logprobs.append(None if row is None
                                  else (row[0][:n], row[1][:n]))
            self.tokens_out += 1
            reason = self._stop_reason(h, tok)
            if reason is not None:
                finish(reason)
                return

    # -- per-tenant adapters (tpudist_torch.serve.adapters) -----------------
    # One load/unload surface and one event vocabulary for both flavours
    # (adapter_load / adapter_evict feed the live gauges and the report).

    def _adapter_engines(self) -> list:  # per flavour
        raise NotImplementedError

    def _engines_with_adapters(self) -> list:
        engines = self._adapter_engines()
        if not engines or engines[0].adapters is None:
            raise RuntimeError(
                "server built without adapters (ServeConfig.adapters / "
                "TPUDIST_SERVE_ADAPTERS)")
        return engines

    def load_adapter(self, name: str, factors) -> dict:
        """Load ``factors`` under ``name`` into every engine of the server
        (thread-safe; see :meth:`SlotEngine.load_adapter`): a disaggregated
        server's prefill writes the adapted KV the decode pool continues
        from, and a handoff re-binds the name on the importer.  All or
        nothing: a failure on any engine unloads the name from those
        already loaded, so residency never diverges.  Emits one
        ``adapter_load`` (plus ``adapter_evict`` for the first engine's LRU
        victim: the broadcast keeps every engine's LRU line the same)."""
        from tpudist_torch import telemetry

        info, loaded = {}, []
        try:
            for i, eng in enumerate(self._engines_with_adapters()):
                ei = eng.load_adapter(name, factors)
                loaded.append(eng)
                if i == 0:
                    info = ei
        except BaseException:
            for eng in loaded:
                eng.unload_adapter(name)
            raise
        if info.get("evicted"):
            telemetry.event("adapter_evict", adapter=info["evicted"],
                            evict_kind="lru", resident=info["resident"])
        telemetry.event("adapter_load", adapter=name,
                        block=info.get("block"),
                        resident=info.get("resident"))
        return info

    def unload_adapter(self, name: str) -> dict:
        """Unload ``name`` from every engine: frees now when no lane holds
        it, else defers (new requests already reject ``adapter_missing``).
        Emits ``adapter_evict``."""
        from tpudist_torch import telemetry

        info = {}
        for eng in self._engines_with_adapters():
            info = eng.unload_adapter(name)
        if info.get("known"):
            telemetry.event("adapter_evict", adapter=name,
                            evict_kind="unload",
                            freed=bool(info.get("freed")),
                            resident=info.get("resident"))
        return info

    def _stamp_adapter_config(self) -> None:
        """One ``serve_adapters_config`` event at start: the static pool
        geometry the aggregator pairs with the load/evict stream."""
        engines = self._adapter_engines()
        if not engines or engines[0].adapters is None:
            return
        from tpudist_torch import telemetry

        st = engines[0].adapter_stats()
        # "rank" is a RESERVED telemetry key (process rank): the LoRA
        # rank travels as lora_rank
        telemetry.event("serve_adapters_config",
                        blocks=st.get("blocks_total"), lora_rank=st["rank"],
                        block_bytes=st["block_bytes"],
                        pool_bytes=st["pool_bytes"])


class InferenceServer(_Observability):
    """Continuous-batching server over a :class:`TransformerLM`.

    Usage::

        server = InferenceServer(model, ServeConfig(num_slots=8)).start()
        h = server.submit(prompt_ids, max_new=32, on_token=stream_cb)
        h.wait(); print(h.tokens, h.finish_reason)
        server.close()          # graceful drain

    ``device`` defaults to ``"cuda"``; without CUDA the constructor raises
    unless ``device="cpu"`` is passed.  ``install_signal_handler``: SIGTERM
    drains the server as ``close()`` does (a warned no-op when
    :meth:`start` runs off the main thread)."""

    def __init__(self, model, config: Optional[ServeConfig] = None, *,
                 device="cuda", install_signal_handler: bool = True):
        self.config = config or ServeConfig.from_env()
        cfg = self.config
        # structured output: the token vocabulary the grammar compiler
        # lowers against (token id → decoded text) is an engine constant;
        # EOS stays per request (compile_grammar wires its column)
        ccfg = None
        if cfg.constrain:
            from tpudist_torch.constrain import (ConstrainConfig,
                                                 default_vocab)

            ccfg = ConstrainConfig(vocab=default_vocab(int(model.vocab)),
                                   num_blocks=cfg.constrain_blocks,
                                   max_states=cfg.constrain_states)
        self.constrain_cfg = ccfg
        self.engine = SlotEngine(
            model, num_slots=cfg.num_slots, prefill_pad=cfg.prefill_pad,
            decode_block=cfg.decode_block, paged=cfg.paged,
            kv_block=cfg.kv_block, kv_blocks=cfg.kv_blocks,
            kv_int8=cfg.kv_int8, prefix_cache_blocks=cfg.prefix_cache_blocks,
            attn_kernel=cfg.attn_kernel, prefill_kernel=cfg.prefill_kernel,
            sample_kernel=cfg.sample_kernel, fused_rope=cfg.fused_rope,
            lora_kernel=cfg.lora_kernel, adapters=cfg.adapters,
            adapter_blocks=cfg.adapter_blocks,
            adapter_rank=cfg.adapter_rank,
            spec_draft=cfg.resolve_spec_draft(model), spec_k=cfg.spec_k,
            constrain=ccfg, logprobs=cfg.logprobs,
            mesh=cfg.mesh_config(), device=device)
        hasher = None
        if cfg.paged and cfg.prefix_cache_blocks > 0:
            from tpudist_torch.serve.paged_alloc import hash_chain

            bs = self.engine.paged_cfg.block_size
            hasher = lambda prompt: hash_chain(prompt, bs)  # noqa: E731
        self.scheduler = Scheduler(
            queue_limit=cfg.queue_limit,
            check_budget=self.engine.check_budget,
            default_max_new=cfg.max_new,
            default_deadline_s=cfg.deadline_s,
            prefix_hasher=hasher,
            check_adapter=lambda name: (
                None if self.engine.has_adapter(name)
                else "adapter_missing"),
            # compiled outside the scheduler lock; GrammarError subclasses
            # ValueError, so an uncompilable ask rejects synchronously
            compile_grammar_fn=(None if ccfg is None else (
                lambda regex, schema, eos: _compile_grammar_for(
                    ccfg, regex, schema, eos))),
            max_logprobs=self.engine.n_lp)
        self._install_signal = install_signal_handler
        self._installed_preemption = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._draining = False
        self._slot_handles: Dict[int, RequestHandle] = {}
        # counters (engine thread writes, stats() reads)
        self.completed = 0
        self.tokens_out = 0
        self._occupancy_sum = 0.0
        self._steps = 0
        # -- live observability plane (telemetry.statusz) ------------------
        self._init_observability()
        # -- graceful degradation (host tier / preemption / shedding) ------
        self._init_degradation(self.scheduler)
        #: re-prefill fallback line: lanes whose parked package was spilled
        #: or corrupt restart from the prompt ahead of fresh admissions;
        #: the duplicate-drop counter in ``_skip`` keeps their streams whole
        self._requeue: "collections.deque[RequestHandle]" = \
            collections.deque()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "InferenceServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        from tpudist_torch import telemetry
        from tpudist_torch.runtime import faults, preemption

        # chaos harness: arm TPUDIST_FAULT at the serving entry as the
        # training loops do at theirs
        faults.arm_from_env()
        telemetry.ensure_started()
        # one config-stamp event: the static KV geometry the aggregator
        # pairs with the per-block occupancy gauges
        kv = self.engine.kv_stats()
        telemetry.event(
            "serve_kv_config", paged=kv["paged"], quantized=kv["quantized"],
            attn_kernel=kv["attn_kernel"],
            prefill_kernel=kv["prefill_kernel"],
            sample_kernel=kv["sample_kernel"],
            fused_rope=kv["fused_rope"], lora_kernel=kv["lora_kernel"],
            block_size=kv["block_size"], blocks_total=kv["blocks_total"],
            pool_bytes=kv["pool_bytes"], bytes_per_pos=kv["bytes_per_pos"],
            num_slots=self.engine.num_slots, max_len=self.engine.max_len)
        self._stamp_adapter_config()
        if self.engine.has_constrain() or self.engine.n_lp:
            cs = self.engine.constrain_stats()
            telemetry.event(
                "serve_constrain_config", enabled=cs["enabled"],
                blocks=cs.get("blocks"), max_states=cs.get("max_states"),
                pool_bytes=cs.get("pool_bytes"),
                logprobs=self.engine.n_lp)
        self._arm_capture_from_env()
        self._start_observability()
        if self._install_signal:
            # SIGTERM → drain: the same preemption flag the training loop
            # checkpoints on; off the main thread a warned no-op
            self._installed_preemption = preemption.install()
        self._thread = threading.Thread(
            target=self._loop, name="tpudist-torch-serve", daemon=True)
        self._thread.start()
        return self

    def submit(self, prompt, *, max_new: Optional[int] = None,
               temperature: float = 0.0, deadline_s: Optional[float] = None,
               seed: Optional[int] = None, eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               priority: int = 0, adapter: Optional[str] = None,
               spec: Optional[bool] = None, tenant: Optional[str] = None,
               session: Optional[str] = None,
               grammar: Optional[str] = None, json_schema=None, stop=None,
               logprobs: int = 0) -> RequestHandle:
        """Thread-safe ingestion; raises
        :class:`~tpudist_torch.serve.scheduler.AdmissionError` on
        backpressure or budget rejection.  ``adapter`` names a per-tenant
        LoRA adapter loaded with :meth:`load_adapter` (else the request
        rejects ``adapter_missing``).  ``spec=False`` opts the request out
        of speculative decoding on a spec server (its stream is the plain
        engine's).

        Structured output: ``grammar`` (a regex over the decoded text) or
        ``json_schema`` constrains the stream to the grammar's language
        (needs ``ServeConfig.constrain`` and an ``eos_id``; an
        uncompilable ask rejects ``invalid_grammar``).  ``stop`` is a list
        of token-id sequences (a bare int is a one-token sequence) matched
        on the delivered stream; a match finishes ``stop_sequence`` with
        the stop tokens kept.  ``logprobs=n`` attaches the top-n
        ``(token_id, logprob)`` pairs of every token to
        ``handle.logprobs`` (post-mask on constrained lanes; ``n`` at most
        ``ServeConfig.logprobs``).  ``tenant`` labels the request in
        telemetry, the per-tenant metrics and SLO attainment, and the
        ``/statusz`` in-flight counts.  ``priority`` orders the queue and,
        with the host tier on, can preempt a lower class's decode lane;
        ``session`` keys the host-tier multi-turn resume: a prompt that
        extends a parked session's context token for token imports its KV
        instead of prefilling it again.  A rejection is stamped into
        telemetry as ``serve_rejected``."""
        from tpudist_torch import telemetry

        # count the in-flight BEFORE the handle becomes visible to the
        # engine thread, so a fast finish cannot decrement first
        tkey = None if tenant is None else str(tenant)
        self._track_tenant(tkey, +1)
        try:
            return self.scheduler.submit(
                prompt, max_new=max_new, temperature=temperature,
                deadline_s=deadline_s, seed=seed, eos_id=eos_id,
                on_token=on_token, priority=priority, adapter=adapter,
                spec=spec, grammar=grammar, json_schema=json_schema,
                stop=stop, logprobs=logprobs, tenant=tenant,
                session=session)
        except BaseException as e:
            # never admitted: give the +1 back
            self._track_tenant(tkey, -1)
            if isinstance(e, AdmissionError):
                telemetry.event("serve_rejected", reason=e.reason)
            raise

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, finish everything admitted, stop the loop.
        True once the engine thread exited (or never ran); with no live
        loop, queued requests finish ``"shutdown"``."""
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
        return [self.engine]

    def draft_ref(self) -> Optional[tuple]:
        if self.engine.draft_model is None:
            return None
        return (self.engine.draft_model,
                self.engine.draft_model.state_dict())

    def _swap_now(self, new_params) -> dict:
        info = self.engine.swap_draft(new_params)
        self._note_swap(info)
        return info

    def _observability_gauges(self) -> Dict[str, float]:
        kv = self.engine.kv_stats()
        return {
            "tpudist_serve_slots": self.engine.num_slots,
            "tpudist_serve_queue_limit": self.config.queue_limit,
            "tpudist_serve_kv_pool_bytes": kv["pool_bytes"],
        }

    def _statusz_doc(self) -> dict:
        """The ``/statusz`` section: current occupancy, KV residency,
        queue depth, world/generation identity, per-tenant in-flight."""
        from tpudist_torch.utils.envutil import env_int

        eng = self.engine
        kv_occ, kv_resident = eng.kv_gauges()
        kv = eng.kv_stats()
        return {
            "slots": {
                "total": int(eng.num_slots),
                "active": int(eng.num_active),
                "prefilling": len(eng.prefilling_slots()),
                "occupancy": round(float(eng.occupancy), 4),
            },
            "queue": {
                "pending": self.scheduler.pending(),
                "limit": self.config.queue_limit,
                "rejected": self.scheduler.rejected,
            },
            "kv": {
                "paged": bool(kv["paged"]),
                "pool_bytes": kv["pool_bytes"],
                "bytes_resident": int(kv_resident),
                "block_occupancy": (None if kv_occ is None
                                    else round(float(kv_occ), 4)),
            },
            "completed": self.completed,
            "tokens_out": self.tokens_out,
            "tenants_in_flight": dict(self._tenant_inflight),
            # per-tenant adapter pool (absent when off)
            **({"adapters": eng.adapter_stats()}
               if eng.adapters is not None else {}),
            # structured-output grammar pool + logprobs width (absent
            # when both are off)
            **({"constrained": {**eng.constrain_stats(),
                                "logprobs": eng.n_lp}}
               if eng.has_constrain() or eng.n_lp else {}),
            **({"spec": eng.spec_stats()} if eng.spec else {}),
            # the distillation flywheel's capture ledger (absent when off)
            **({"distill": self._distill_status()}
               if self._capture is not None else {}),
            # host-tier occupancy and the overload state (absent when off)
            **({"host_tier": {**self._tier.stats(),
                              "parked_requests": len(self._parked),
                              "preemptions": self.preemptions,
                              "resumes_served": self.tier_resumes,
                              "corrupt": self.tier_corrupt}}
               if self._tier is not None else {}),
            **({"overload": self._ctrl.stats()}
               if self._ctrl is not None else {}),
            "world": env_int("TPUDIST_NUM_PROCESSES", None),
            "generation": env_int("TPUDIST_RESTART_COUNT", 0),
            "draining": self._draining,
            "loop_error": self.loop_error,
        }

    def stats(self) -> dict:
        return {
            "completed": self.completed,
            "rejected": self.scheduler.rejected,
            "tokens_out": self.tokens_out,
            "pending": self.scheduler.pending(),
            "active": self.engine.num_active,
            "prefilling": len(self.engine.prefilling_slots()),
            "occupancy_mean": (self._occupancy_sum / self._steps
                               if self._steps else 0.0),
            "launch_counts": self.engine.launch_counts(),
            "decode": self.engine.decode_stats(),
            "kv": self.engine.kv_stats(),
            "adapters": self.engine.adapter_stats(),
            "spec": self.engine.spec_stats(),
            "spmd": self.engine.spmd_stats(),
            # the grammar pool and the logprobs width (absent when both
            # are off)
            **({"constrained": {**self.engine.constrain_stats(),
                                "logprobs": self.engine.n_lp}}
               if self.engine.has_constrain() or self.engine.n_lp else {}),
            "preemptions": self.preemptions,
            "parked": len(self._parked),
            "host_tier": (None if self._tier is None
                          else self._tier.stats()),
            "overload": (None if self._ctrl is None
                         else self._ctrl.stats()),
            "loop_error": self.loop_error,
        }

    # -- the engine loop ----------------------------------------------------

    def _abort_outstanding(self) -> None:
        """Finish every request that can no longer be served: ``shutdown``,
        parked preempted lanes ``preempted``."""
        for slot in list(self._slot_handles):
            h = self._slot_handles.pop(slot)
            h._finish("shutdown")
            self._note_finished(h)
        self._abort_parked()
        while self._requeue:
            h = self._requeue.popleft()
            h._finish("shutdown")
            self._note_finished(h)
        for h in self.scheduler.take(1 << 30):
            if not h.done:
                h._finish("shutdown")
            self._note_finished(h)

    def _should_drain(self) -> bool:
        if self._stop.is_set():
            return True
        from tpudist_torch.runtime import preemption

        return preemption.requested()

    def _loop(self) -> None:
        from tpudist_torch import telemetry

        try:
            self._run_loop()
        except BaseException as e:
            # the loop must not die silently: every waiter would hang
            self.loop_error = repr(e)  # /healthz goes 503 on this
            telemetry.event("serve_loop_error", error=repr(e))
            if not isinstance(e, ReplicaKilled):
                raise  # the threading excepthook reports the traceback
        finally:
            self.scheduler.refuse_new("draining")
            self._abort_outstanding()

    def _admit(self, now: float) -> None:
        from tpudist_torch import telemetry

        eng, sched = self.engine, self.scheduler
        free = eng.free_slots()
        if not free:
            return
        reserved, pinned = [0], []
        resume_pos: Dict[int, int] = {}

        def _gate(h):
            # one KV-pool gate per candidate within ONE take: ``reserved``
            # and ``pinned`` carry what earlier candidates were promised
            req = h.request
            if (self._tier is not None and req.session is not None
                    and h.id not in self._skip):
                pos = self._tier.match(self._session_key(req), req.prompt)
                if pos is not None:
                    # a session hit reserves its whole footprint (a
                    # resumed lane's context is private)
                    got = eng.kv_admission_probe(
                        len(req.prompt), req.max_new, (),
                        reserve=reserved[0], protect=pinned)
                    if got is None:
                        return False
                    reserved[0] += got[0]
                    resume_pos[h.id] = pos
                    return True
            got = eng.kv_admission_probe(
                len(req.prompt), req.max_new, req.prefix_hashes,
                reserve=reserved[0], protect=pinned)
            if got is None:
                return False
            reserved[0] += got[0]
            pinned.extend(got[1])
            return True

        # re-prefill fallbacks first (admitted long ago), head-of-line on a
        # blocked gate so steady fresh traffic cannot starve them
        batch: List[RequestHandle] = []
        blocked = False
        while self._requeue and len(batch) < len(free):
            if not _gate(self._requeue[0]):
                blocked = True
                break
            batch.append(self._requeue.popleft())
        if not blocked and len(batch) < len(free):
            batch += sched.take(len(free) - len(batch), now, admit=_gate)
        alive = []
        for h in batch:
            if h.done:  # finished in-queue (deadline expired)
                self._note_finished(h)
            elif not eng.has_adapter(h.request.adapter):
                # admitted, but its adapter was unloaded while it queued:
                # finish loudly, never serve base-model output for it
                h._finish("adapter_missing")
                self._note_finished(h)
            else:
                alive.append(h)
        if not alive:
            return
        items, t0 = [], time.monotonic()
        for h, slot in zip(alive, free):
            h.slot = slot
            if h.t_admitted is None:
                h.t_admitted = t0
            # a session hit resumes its parked lane instead of prefilling
            # (a spilled or corrupt package falls back to a fresh prefill)
            if h.id in resume_pos and self._resume_session(slot, h):
                continue
            r = h.request
            items.append((slot, r.prompt, r.temperature, r.seed, r.max_new,
                          r.prefix_hashes, r.spec, r.adapter, r.grammar))
            self._slot_handles[slot] = h
        firsts, deferred = {}, []
        while items:
            try:
                with telemetry.span("prefill", n=len(items)):
                    firsts = eng.start_batch(items)
                break
            except GrammarPoolFull:
                # the batch's grammars need more blocks than running lanes
                # leave free (start_batch rolled the whole dispatch back):
                # the last constrained item waits at the head of the
                # fallback line and the rest retry, so every grammar that
                # fits binds now and the others as lanes free their blocks
                j = max(k for k, it in enumerate(items) if it[8] is not None)
                h = self._slot_handles.pop(items[j][0])
                h.slot = None
                deferred.append(h)
                items = items[:j] + items[j + 1:]
            except AdapterMissingError as e:
                # an unload raced the recheck above (start_batch validated
                # the whole batch first, so nothing changed): finish that
                # adapter's requests, admit the rest
                keep = []
                for it in items:
                    if it[7] == e.adapter:
                        h = self._slot_handles.pop(it[0])
                        h._finish("adapter_missing")
                        self._note_finished(h)
                    else:
                        keep.append(it)
                items = keep
        self._requeue.extendleft(deferred)
        for slot, tok in firsts.items():
            if tok is not None:
                self._deliver_block(slot, [tok])

    def _run_loop(self) -> None:
        from tpudist_torch import telemetry

        eng, sched = self.engine, self.scheduler
        while True:
            self._beat = time.monotonic()  # /healthz heartbeat
            self._check_die()  # hard-stop poison (kill / replica_kill)
            # gated draft hot-swap lands HERE — between decode blocks by
            # construction (the loop is the only decode dispatcher)
            self._apply_pending_swap()
            if not self._draining and self._should_drain():
                self._draining = True
                sched.refuse_new("draining")
                telemetry.event("serve_drain", pending=sched.pending(),
                                active=eng.num_active)
            now = time.monotonic()
            for slot, h in list(self._slot_handles.items()):
                if h._expired(now):
                    self._finish_slot(slot, "deadline")
            for slot in eng.cache_full_slots():
                if slot in self._slot_handles:
                    self._finish_slot(slot, "cache_full")
            for h in sched.expire_queued(now):
                self._note_finished(h)
            # deadlines cover the fallback line and the parked lanes too
            self._expire_requeue(now)
            self._sweep_parked(now)
            # shedding, then preemption and parked-lane resume: all host
            # decisions, all before admission so a freed slot is usable in
            # this same iteration
            self._shed_tick(now)
            self._maybe_preempt()
            self._resume_preempted()
            self._admit(now)
            # chunked prefill: one chunk per prefilling slot per iteration
            if eng.prefilling_slots():
                with telemetry.span("prefill",
                                    chunks=len(eng.prefilling_slots())):
                    done = eng.advance_prefill()
                for slot, tok in done.items():
                    self._deliver_block(slot, [tok])
            if eng.num_active:
                occ = eng.occupancy
                active = eng.num_active
                tele = telemetry.active()
                t0 = time.monotonic()
                info, blocks = eng.decode_auto()
                if tele is not None and info is not None:
                    self._record_block(tele, eng, t0, info, occ, active)
                self._occupancy_sum += occ
                self._steps += 1
                block_lp = (info or {}).get("logprobs") or {}
                for slot, toks in blocks.items():
                    self._deliver_block(slot, toks, block_lp.get(slot))
            elif eng.prefilling_slots():
                pass  # prefill work continues next iteration
            elif (self._draining and sched.pending() == 0
                    and not self._parked and not self._requeue):
                # the drain completes parked and fallback work too
                break
            else:
                sched.wait_for_work(_IDLE_WAIT_S)

    def _deliver_block(self, slot: int, toks: List[int], lp=None) -> None:
        """Stream a token block to the slot's request
        (:meth:`_deliver_tokens`)."""
        self._deliver_tokens(self._slot_handles[slot], toks, lp,
                             lambda why: self._finish_slot(slot, why))

    def _finish_slot(self, slot: int, reason: str) -> None:
        h = self._slot_handles.pop(slot)
        if (self._tier is not None and h.request.session is not None
                and reason in ("length", "eos", "session_resumed")
                and self.engine.exportable(slot, len(h.tokens))):
            # park the finished turn's lane before the evict zeroes it; a
            # lane whose eos fired mid-block holds tokens past the stream
            # and is not exportable
            self._park_session_lane(self.engine, slot, h)
        self.engine.evict(slot)
        h._finish(reason)
        self._note_finished(h)

    def _resume_session(self, slot: int, h: RequestHandle) -> bool:
        """Serve this turn from its parked session lane (import and a
        suffix-only prefill).  False on a missing or corrupt package, or a
        turn the parked lane cannot serve (another adapter, a grammar): the
        caller then prefills fresh."""
        from tpudist_torch.serve.disagg import (HandoffError,
                                                deserialize_package)
        from tpudist_torch.serve.host_tier import HostTierError

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
            self.engine.resume_slot(
                slot, raw, req.prompt, temperature=req.temperature,
                seed=req.seed, max_new=req.max_new, spec=req.spec)
        except AdapterMissingError:
            return False  # unloaded mid-iteration: the fresh prefill
            # then finishes adapter_missing through the same race
        h.resumed = True
        self._slot_handles[slot] = h
        self.tier_resumes += 1
        self._tier_event("session_resumed", park_kind="turn", slot=slot,
                         covered=int(raw["pos"]), trace_id=h.trace_id,
                         import_s=round(time.monotonic() - t0, 6))
        return True

    def _maybe_preempt(self) -> None:
        """Priority preemption: when the queue head outranks a decoding
        lane and cannot admit (no free slot, or its KV footprint does not
        fit), the lowest-priority decoding lane (ties: least progress)
        exports to the host tier and waits — its resume continues the same
        stream, decode being a pure function of the packaged state and
        the per-slot Philox counter."""
        if self._tier is None or not self.config.preempt \
                or self._draining:
            return
        head = self.scheduler.head_info()
        if head is None:
            return
        eng = self.engine
        if eng.free_slots() and eng.can_admit_kv(
                head["prompt_len"], head["max_new"],
                head["prefix_hashes"]):
            return  # the head can already admit
        cands = [(slot, h) for slot, h in self._slot_handles.items()
                 if eng.decoding[slot]
                 and h.request.priority < head["priority"]
                 and h.id not in self._skip
                 and h.id not in self._tier_oversize]
        if not cands:
            return
        slot, victim = min(cands, key=lambda kv: (kv[1].request.priority,
                                                  len(kv[1].tokens)))
        self._preempt_slot(slot, victim, head["priority"])

    def _preempt_slot(self, slot: int, h: RequestHandle, by: int) -> None:
        pkg = self.engine.export_slot(slot)
        pkg["trace_id"] = h.trace_id
        stored = self._tier_put(("preempt", h.id), pkg, pinned=True,
                                kind="preempt")
        if stored is None:
            # the tier cannot hold the lane: admission just waits, and
            # this lane is not exported again
            self._tier_oversize.add(h.id)
            return
        self.engine.evict(slot)
        del self._slot_handles[slot]
        self._parked[h.id] = h
        self.preemptions += 1
        self._tier_event("preempted", id=h.id, slot=slot,
                         priority=h.request.priority, by_priority=by,
                         bytes=stored, trace_id=h.trace_id)

    def _resume_preempted(self) -> None:
        """Parked preempted lanes import again as capacity frees, oldest
        first, unless a strictly higher-priority request is queued.  A
        spilled or corrupt package degrades to a full re-prefill through
        the fallback line, its delivered tokens dropped as duplicates."""
        if self._tier is None or not self._parked:
            return
        from tpudist_torch.serve.disagg import (HandoffError,
                                                deserialize_package)

        eng = self.engine
        while self._parked:
            free = eng.free_slots()
            if not free:
                return
            hid, h = next(iter(self._parked.items()))
            head = self.scheduler.head_info()
            if head is not None and head["priority"] > h.request.priority:
                return  # the higher class admits first
            ser = self._tier.peek(("preempt", hid))
            if ser is None:
                # spilled under byte pressure: full re-prefill fallback
                del self._parked[hid]
                self._skip[h.id] = len(h.tokens)
                self._requeue.append(h)
                continue
            if not eng.can_import(ser):
                return  # blocks not free yet: parked head-of-line
            self._tier.get(("preempt", hid))
            del self._parked[hid]
            try:
                raw = deserialize_package(ser)
            except HandoffError as e:
                self.tier_corrupt += 1
                self._tier_event("host_tier_corrupt", kind="preempt",
                                 error=str(e)[:120], trace_id=h.trace_id)
                self._skip[h.id] = len(h.tokens)
                self._requeue.append(h)
                continue
            slot = free[0]
            try:
                eng.import_slot(slot, raw, spec=h.request.spec)
            except AdapterMissingError:
                # its KV is the unloaded fine-tune's: finish loudly
                h._finish("adapter_missing")
                self._note_finished(h)
                continue
            self._slot_handles[slot] = h
            self.tier_resumes += 1
            self._tier_event("session_resumed", park_kind="preempt",
                             slot=slot, id=h.id, trace_id=h.trace_id)

    def _note_finished(self, h: RequestHandle) -> None:
        from tpudist_torch import telemetry
        from tpudist_torch.telemetry import trace

        # one cleanup point for the duplicate-drop counter and the
        # oversize-preempt memo
        self._skip.pop(h.id, None)
        self._tier_oversize.discard(h.id)
        self.completed += 1
        self._track_tenant(h.request.tenant, -1)
        if self._capture is not None:
            # the distillation flywheel's tap: the finished stream is the
            # training example (bounded ring, drops counted)
            self._capture.offer_handle(h)
        telemetry.event(
            "request_finished", id=h.id, reason=h.finish_reason,
            prompt_len=int(len(h.request.prompt)), tokens_out=len(h.tokens),
            ttft_s=h.ttft_s, tpot_s=h.tpot_s, queue_wait_s=h.queue_wait_s,
            trace_id=h.trace_id,
            **({"tenant": h.request.tenant} if h.request.tenant else {}),
            **({"adapter": h.request.adapter} if h.request.adapter else {}),
            **({"constrained": h.request.grammar.source["kind"]}
               if h.request.grammar is not None else {}),
            **({"stop_seqs": len(h.request.stop)} if h.request.stop
               else {}),
            **({"logprobs": h.request.logprobs} if h.request.logprobs
               else {}))
        # per-request lifeline spans (req_queue/req_prefill/req_decode)
        trace.emit_request_lifeline(h)


def serve_forever(model, config: Optional[ServeConfig] = None, *,
                  device="cuda"):
    """Start a server and return it (the embedding entry; the CLI demo in
    ``__main__`` owns its own loop).  ``config.disagg`` selects the
    prefill/decode-disaggregated coordinator
    (:class:`tpudist_torch.serve.disagg.DisaggServer`): the same
    submit/close surface, two engine pools with a KV handoff behind it.
    ``device`` as :class:`InferenceServer`'s: without CUDA it raises unless
    ``device="cpu"``."""
    cfg = config or ServeConfig.from_env()
    if cfg.disagg:
        from tpudist_torch.serve.disagg import DisaggServer

        return DisaggServer(model, cfg, device=device).start()
    return InferenceServer(model, cfg, device=device).start()
