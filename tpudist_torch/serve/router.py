"""Fleet front door: affinity routing over replicas with health-probed
failover, session migration on replica death, and spill-not-reject
overload — the port of ``tpudist/serve/router.py``, host code over the
port's :class:`~tpudist_torch.serve.server.InferenceServer` API.

This module is the layer above one server: a router over N
``InferenceServer`` replicas that keeps serving when any one of them dies
or saturates.  Routing is a pure host decision riding as data (the router
never touches a kernel or a device tensor):

- **session affinity** — a ``submit(session=)`` resume lands on the
  replica holding the parked KV (the host tier's no-recompute resume
  only helps if the turn arrives where the lane parked);
- **prefix-cache affinity** — requests sharing a prompt prefix hash to
  the same replica (rendezvous hashing on a blake2b prefix digest —
  stable under replica death: only the dead replica's keys move), so
  its shared-prefix LRU block cache actually hits;
- **least-loaded placement** — otherwise, the replica with the lowest
  load score from its scraped live gauges (queue depth, slot/KV
  occupancy, router-side in-flight).

The robustness core, in failure order:

- **health probing** — each replica is probed off its ``/healthz``
  backend (:meth:`InferenceServer._health_check`: engine thread alive,
  loop-error-free, heartbeat fresh) every ``probe_s``; a replica is
  marked DEAD after ``probe_failures`` consecutive failures, and dead
  replicas re-probe on exponential backoff (a flapping replica must not
  eat the probe budget);
- **spill, not reject** — a replica rejecting admission
  (queue/KV/shed backpressure) spills the request to the next-best
  sibling (paying a re-prefill there) while ANY replica has headroom;
  only a whole-fleet rejection surfaces to the caller, with the
  shed-path reason passed through (``shed_load`` wins over transient
  reasons so overload is visible at fleet scope);
- **retries with duplicate-drop** — a request whose replica dies
  mid-serve re-homes onto a survivor with a bounded, backoff-spaced
  retry budget: the full prompt resubmits with identical sampling
  parameters (decode is a pure function of the packaged state and the
  ``fold_in(key, count)`` stream, so the replay is byte-identical) and
  exactly the already-delivered tokens drop as duplicates.  The
  abandoned per-replica attempt is finished ``router_spill`` (visible
  in telemetry); the caller-facing handle finishes with the sibling's
  reason.  Only when no healthy sibling can take the lane within the
  budget does the handle finish ``replica_lost``;
- **session migration** — parked sessions ride the existing
  ``serialize_package`` wire format one level up: after each finished
  turn the router stashes a copy of the parked package
  (``export_session``), and when the owning replica drains or dies the
  stash is adopted into a survivor's host tier (``adopt_session``) so
  the session's next turn RESUMES there.  A missing or corrupt stash
  degrades to a full re-prefill on the survivor — the digest check
  stays where it always was, in the resume path's deserialize — never
  a wrong byte, never a hang.

Chaos: ``TPUDIST_FAULT=replica_kill@nth:N`` kills replica N's engine
loop at the router's probe tick (``faults.inject_replica_kill``) —
the in-process twin of a replica host dying, driving this exact
failover path with zero test-only seams.

Thread contract: any number of ingestion threads call :meth:`submit`;
one router thread runs the probe/failover tick; each replica keeps its
own engine thread.  All router state sits behind one lock.  Token
forwarding runs on replica engine threads but appends through a
generation gate, so an orphaned attempt that keeps streaming (a hung —
not dead — loop) can never interleave duplicates into a re-homed
stream.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tpudist_torch.serve.scheduler import AdmissionError

#: token count of the router-side prefix digest: requests agreeing on
#: their first PREFIX_TOKENS tokens (the shared system prompt) route to
#: the same replica.  Deliberately independent of any replica's KV
#: block size — the router must not reach into engine geometry.
_PREFIX_TOKENS = 16

#: inner finish reasons that mean "the REPLICA failed", not the request
#: — the re-home triggers (a dead loop aborts its work as shutdown; a
#: collapsed pool finishes worker_lost; a parked preempted lane cut off
#: by the crash finishes preempted).
_RETRY_REASONS = ("shutdown", "worker_lost", "preempted")

#: dead-replica re-probe backoff: doubles from probe_s per failed
#: re-probe, capped at this many multiples of probe_s.
_BACKOFF_CAP = 40.0


@dataclasses.dataclass
class RouterConfig:
    """Fleet-router knobs; :meth:`from_env` reads the
    ``TPUDIST_ROUTER_*`` family, as the JAX router does."""

    #: fleet size a launch rig should build (the router itself takes an
    #: explicit replica list; this knob sizes env-driven rigs like the
    #: ``python -m tpudist_torch.serve --replicas`` demo)
    replicas: int = 2
    probe_s: float = 0.05  # health-probe interval per healthy replica
    probe_failures: int = 3  # consecutive failures before marked dead
    retries: int = 2  # per-request re-home budget after replica death
    retry_backoff_s: float = 0.05  # re-home backoff base (doubles)
    spill: bool = True  # overflow to a sibling instead of rejecting
    stash: bool = True  # router-side parked-package stash (migration)
    #: routing policy: "affinity" (session → prefix → least-loaded) or
    #: "rr" (plain round-robin — the bench's comparison arm and an
    #: escape hatch when affinity itself is suspected)
    policy: str = "affinity"

    @classmethod
    def from_env(cls) -> "RouterConfig":
        import os

        from tpudist_torch.utils.envutil import (env_flag, env_int,
                                           env_positive_float)

        return cls(
            replicas=env_int("TPUDIST_ROUTER_REPLICAS", 2) or 2,
            probe_s=env_positive_float("TPUDIST_ROUTER_PROBE_S", 0.05)
            or 0.05,
            probe_failures=env_int("TPUDIST_ROUTER_PROBE_FAILURES", 3) or 3,
            retries=env_int("TPUDIST_ROUTER_RETRIES", 2) or 2,
            retry_backoff_s=env_positive_float(
                "TPUDIST_ROUTER_RETRY_BACKOFF_S", 0.05) or 0.05,
            spill=env_flag("TPUDIST_ROUTER_SPILL", True),
            stash=env_flag("TPUDIST_ROUTER_STASH", True),
            policy=os.environ.get(
                "TPUDIST_ROUTER_POLICY", "").strip() or "affinity",
        )


class _Replica:
    """Router-side view of one replica: health state machine + the
    load gauges scraped from its ``/statusz`` backend."""

    def __init__(self, index: int, server):
        self.index = index
        self.server = server
        self.up = True
        self.draining = False
        self.fails = 0  # consecutive probe failures
        self.next_probe = 0.0
        self.backoff_s: Optional[float] = None
        self.routed = 0  # requests this replica was chosen for
        self.deaths = 0

    def health_ok(self) -> bool:
        """One probe against the replica's ``/healthz`` backend (a
        raising probe counts as a failure — a dead loop may leave any
        state behind)."""
        try:
            return bool(self.server._health_check()[0])
        except Exception:
            return False

    def saturated(self) -> bool:
        """Queue at its bound — the next submit would reject
        ``queue_full`` (prefix affinity yields to the spill path)."""
        try:
            return self.server.scheduler.pending() \
                >= self.server.config.queue_limit
        except Exception:
            return True

    def load_score(self) -> float:
        """Least-loaded placement score off the scraped live gauges:
        queue fraction + slot occupancy + KV block occupancy (flavor-
        tolerant reads — a disaggregated server shapes its sections per
        pool).
        An unreachable scrape sorts last."""
        try:
            doc = self.server._statusz_doc()
        except Exception:
            return float("inf")
        q = doc.get("queue") or {}
        score = float(q.get("pending", 0)) / max(1, int(q.get("limit", 1)))
        slots = doc.get("slots") or {}
        occ = slots.get("occupancy")
        if occ is None:
            pools = doc.get("pools") or {}
            dec = pools.get("decode") or {}
            cap = max(1, int(dec.get("workers", 1))
                      * int(dec.get("slots_per_worker", 1)))
            occ = float(dec.get("active", 0)) / cap if dec else 0.0
        score += float(occ or 0.0)
        kv = doc.get("kv") or {}
        kv_occ = kv.get("block_occupancy")
        if isinstance(kv_occ, (int, float)):
            score += float(kv_occ)
        return score


class RouterHandle:
    """The caller's view of a fleet-routed request: same streamed-token
    / ``done`` / finish-reason surface as ``RequestHandle``, plus the
    routing trail (``replica``, ``attempts``, ``spilled``).  Survives
    re-homing: the handle is stable while inner per-replica attempts
    come and go beneath it."""

    def __init__(self, prompt: np.ndarray, kwargs: dict,
                 on_token: Optional[Callable[[int, int], None]],
                 skey: Optional[tuple], pkey: Optional[str]):
        self.prompt = prompt
        self.kwargs = kwargs  # resubmission parameters, verbatim
        self.on_token = on_token
        self.skey = skey  # (tenant_label, session) or None
        self.pkey = pkey  # router-side prefix digest or None
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self._done = threading.Event()
        now = time.monotonic()
        self.t_submit = now
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.t_done: Optional[float] = None
        #: current inner per-replica attempt (None while parked in the
        #: router's retry line)
        self.inner = None
        self.replica: Optional[int] = None
        #: forwarding generation: bumped on every re-home so an
        #: orphaned attempt's late tokens are ignored, never appended
        self.gen = 0
        self.attempts = 0
        self.retries_used = 0
        self.next_try = 0.0
        self.spilled = False
        self.resumed = False

    # -- caller side --------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        if (self.t_first_token is None or self.t_last_token is None
                or len(self.tokens) < 2):
            return None
        return ((self.t_last_token - self.t_first_token)
                / (len(self.tokens) - 1))

    @property
    def trace_id(self) -> Optional[str]:
        """The CURRENT inner attempt's trace id (each re-home attempt
        mints its own — the per-replica lifelines join on it)."""
        return None if self.inner is None else self.inner.trace_id

    @property
    def logprobs(self) -> list:
        """Per-token top-n logprob rows from the CURRENT inner attempt
        (``submit(logprobs=n)``).  A re-homed attempt re-decodes the
        stream byte-identically from the prompt, so the final attempt's
        rows cover the whole delivered stream."""
        return [] if self.inner is None else list(self.inner.logprobs)

    # -- router side --------------------------------------------------------

    def _expired(self, now: float) -> bool:
        d = self.kwargs.get("deadline_s")
        return d is not None and d > 0 and (now - self.t_submit) > d

    def remaining_deadline(self, now: float) -> Optional[float]:
        """Deadline budget left for a re-homed inner attempt (the outer
        deadline is relative to the ORIGINAL submit).  ``None`` when
        the request carries no deadline; <= 0 means already expired."""
        d = self.kwargs.get("deadline_s")
        if d is None or d <= 0:
            return None
        return d - (now - self.t_submit)

    def _forwarder(self, skip: int) -> Callable[[int, int], None]:
        """Token forwarder for one inner attempt: drops the first
        ``skip`` tokens (the duplicate-drop on a re-homed replay — the
        resubmitted stream is byte-identical, so dropping exactly the
        delivered count keeps the outer stream exact), and ignores
        everything once the handle re-homes again (generation gate)."""
        gen = self.gen
        state = [int(skip)]

        def cb(tok: int, _idx: int) -> None:
            if gen != self.gen:
                return  # orphaned attempt still streaming — ignore
            if state[0] > 0:
                state[0] -= 1
                return
            self._deliver(int(tok))

        return cb

    def _deliver(self, tok: int) -> None:
        now = time.monotonic()
        if self.t_first_token is None:
            self.t_first_token = now
        self.t_last_token = now
        self.tokens.append(tok)
        cb = self.on_token
        if cb is not None:
            try:
                cb(tok, len(self.tokens) - 1)
            except Exception as e:  # a user callback must not kill a loop
                warnings.warn(f"on_token callback raised: {e!r}",
                              RuntimeWarning, stacklevel=2)

    def _finish(self, reason: str) -> None:
        if self._done.is_set():
            return
        self.finish_reason = reason
        self.t_done = time.monotonic()
        self._done.set()


class FleetRouter:
    """Front door over N replicas (module doc has the whole story).

    Usage::

        fleet = [InferenceServer(model, cfg).start() for _ in range(3)]
        router = FleetRouter(fleet, RouterConfig()).start()
        h = router.submit(prompt_ids, session="chat-1", max_new=32)
        h.wait(); print(h.tokens, h.finish_reason, h.replica)
        router.close()      # drains every replica

    The replicas are already-started server objects — the router owns
    routing and failover, not replica construction (a launch rig builds
    the fleet; the ``--replicas`` demo in ``tpudist_torch.serve.__main__`` is
    the in-process version)."""

    def __init__(self, replicas, config: Optional[RouterConfig] = None):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.config = config or RouterConfig.from_env()
        if self.config.policy not in ("affinity", "rr"):
            raise ValueError(
                f"unknown router policy {self.config.policy!r} "
                "(expected 'affinity' or 'rr')")
        self._replicas = [_Replica(i, s) for i, s in enumerate(replicas)]
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closing = False
        self._ticks = 0
        #: (tenant_label, session) -> replica index holding the parked KV
        self._session_home: Dict[tuple, int] = {}
        #: (tenant_label, session) -> exported package stash (migration)
        self._stash: Dict[tuple, dict] = {}
        #: live outer handles, insertion-ordered by id
        self._inflight: Dict[int, RouterHandle] = {}
        self._retry_q: List[RouterHandle] = []
        #: (skey, replica index, give-up time): session turns whose
        #: park had not landed yet when the handle finished (parking
        #: runs on the engine loop just AFTER the done event) — the
        #: tick re-tries the export until it sticks
        self._pending_export: List[tuple] = []
        self._next_id = 0
        # lifetime counters (stats() + the fleet report section)
        self.routed = 0
        self.routes_by_kind: Dict[str, int] = {}
        self.spills = 0
        self.retries = 0
        self.migrations = 0
        self.replica_deaths = 0
        self.lost = 0
        self.errors = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRouter":
        if self._thread is not None:
            raise RuntimeError("router already started")
        from tpudist_torch import telemetry
        from tpudist_torch.runtime import faults

        # the replica_kill chaos kind arms at the router entry, like
        # every serving loop arms at its own
        faults.arm_from_env()
        telemetry.ensure_started()
        telemetry.event(
            "router_config", replicas=len(self._replicas),
            policy=self.config.policy, probe_s=self.config.probe_s,
            probe_failures=self.config.probe_failures,
            retries=self.config.retries, spill=self.config.spill,
            stash=self.config.stash)
        now = time.monotonic()
        for rep in self._replicas:
            self._probe(rep, now)
        self._thread = threading.Thread(
            target=self._loop, name="tpudist-router", daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: Optional[float] = None) -> bool:
        """Graceful fleet shutdown: stop routing, drain every replica
        (in-flight work finishes and propagates), then stop the router
        thread and finish anything still unresolved (``shutdown`` —
        same contract as a single server's hard-stop path)."""
        with self._lock:
            self._closing = True
        ok = True
        for rep in self._replicas:
            try:
                ok = rep.server.close(timeout) and ok
            except Exception:
                ok = False
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            ok = ok and not t.is_alive()
        with self._lock:
            for outer in list(self._inflight.values()):
                inner = outer.inner
                if inner is not None and inner.done and not outer.done:
                    self._finish_outer(outer)
                elif not outer.done:
                    outer._finish("shutdown")
            self._inflight.clear()
            self._retry_q.clear()
        return ok

    def drain_replica(self, index: int,
                      timeout: Optional[float] = None) -> bool:
        """Take one replica out of rotation gracefully: stop routing to
        it, MIGRATE its parked sessions onto survivors through the
        stash-free live path (export from its tier, adopt into the
        target's), then drain it — in-flight work finishes in place.
        The deploy-rollover story at fleet scope."""
        rep = self._replicas[index]
        with self._lock:
            rep.draining = True
            for tenant, session in rep.server.parked_sessions():
                self._migrate_session(
                    (tenant, session),
                    stash=rep.server.export_session(tenant, session),
                    exclude={index}, reason="drain")
        ok = rep.server.close(timeout)
        with self._lock:
            rep.up = False
        return ok

    # -- ingestion ----------------------------------------------------------

    def submit(self, prompt, *, max_new: Optional[int] = None,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None, eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               spec: Optional[bool] = None, tenant: Optional[str] = None,
               priority: int = 0, session: Optional[str] = None,
               adapter: Optional[str] = None,
               grammar: Optional[str] = None, json_schema=None,
               stop=None, logprobs: int = 0) -> RouterHandle:
        """Route and admit one request; raises :class:`AdmissionError`
        only when the WHOLE fleet rejects (the sheddiest reason passes
        through — ``shed_load`` wins so fleet saturation is
        distinguishable from one replica's bad moment).  Structured
        output (``grammar``/``json_schema``/``stop``/``logprobs``)
        passes through verbatim — each replica compiles/validates in
        its own scheduler, and a failover resubmission carries the ask
        unchanged."""
        if self._closing:
            raise AdmissionError("draining")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        skey = (None if session is None
                else (tenant if tenant else "default", str(session)))
        pkey = None
        if len(prompt):
            head = prompt[:_PREFIX_TOKENS]
            pkey = hashlib.blake2b(head.tobytes(),
                                   digest_size=8).hexdigest()
        kwargs = dict(max_new=max_new, temperature=temperature,
                      deadline_s=deadline_s, seed=seed, eos_id=eos_id,
                      spec=spec, tenant=tenant, priority=priority,
                      session=session, adapter=adapter,
                      grammar=grammar, json_schema=json_schema,
                      stop=stop, logprobs=logprobs)
        outer = RouterHandle(prompt, kwargs, on_token, skey, pkey)
        with self._lock:
            outer.id = self._next_id
            self._next_id += 1
            if skey is not None:
                home = self._session_home.get(skey)
                if home is not None and not self._replicas[home].up:
                    # home replica died since the last turn: re-home
                    # the parked package from the stash now (lazy twin
                    # of the eager migration at death — covers races)
                    self._rehome_session(skey)
            self._route_and_submit(outer, skip=0)
            self._inflight[outer.id] = outer
        return outer

    # -- routing ------------------------------------------------------------

    def _ups(self, exclude=()) -> List[_Replica]:
        return [r for r in self._replicas
                if r.up and not r.draining and r.index not in exclude]

    @staticmethod
    def _rendezvous(pkey: str, index: int) -> str:
        # highest-random-weight hashing: each (prefix, replica) pair
        # gets a stable score — a dead replica reshuffles ONLY its own
        # keys, every other prefix keeps its cache-warm home
        return hashlib.blake2b(f"{pkey}|{index}".encode(),
                               digest_size=8).hexdigest()

    def _pick(self, skey, pkey, exclude=()) -> Tuple[Optional[_Replica],
                                                     Optional[str]]:
        """(replica, affinity kind) or (None, None) when no healthy
        replica remains.  Order: session home → prefix rendezvous
        (yielding to the spill path when saturated) → least-loaded;
        ``policy="rr"`` replaces the whole ladder with round-robin."""
        ups = self._ups(exclude)
        if not ups:
            return None, None
        if self.config.policy == "rr":
            # rr REPLACES all three affinity keys (the bench comparison
            # arm must not quietly keep session stickiness)
            r = ups[self.routed % len(ups)]
            return r, "rr"
        if skey is not None:
            home = self._session_home.get(skey)
            for r in ups:
                if r.index == home:
                    return r, "session"
        if pkey is not None:
            best = max(ups, key=lambda r: self._rendezvous(pkey, r.index))
            if not best.saturated():
                return best, "prefix"
            # the cache-warm target is full: pre-emptive spill to the
            # least-loaded sibling (paying its re-prefill) rather than
            # bouncing off a known-full queue
            rest = [r for r in ups if r is not best] or ups
            chosen = min(rest, key=lambda r: r.load_score())
            return chosen, ("spill" if chosen is not best else "prefix")
        return min(ups, key=lambda r: r.load_score()), "least_loaded"

    def _route_and_submit(self, outer: RouterHandle, skip: int) -> None:
        """One fleet-wide placement attempt: pick, submit, spill to the
        next-best sibling on rejection while any replica has headroom.
        Raises :class:`AdmissionError` with the passthrough reason when
        the whole fleet rejects."""
        from tpudist_torch import telemetry

        tried: List[int] = []
        last_reason: Optional[str] = None
        shed_seen = False
        while True:
            rep, kind = self._pick(outer.skey, outer.pkey, exclude=tried)
            if rep is None:
                if shed_seen:
                    raise AdmissionError("shed_load")
                raise AdmissionError(last_reason or "no_healthy_replica")
            try:
                self._submit_to(rep, outer, skip)
            except AdmissionError as e:
                last_reason = e.reason
                shed_seen = shed_seen or e.reason.startswith("shed_load")
                tried.append(rep.index)
                if not self.config.spill:
                    raise
                continue
            if tried or kind == "spill":
                # landed on a sibling off the affinity target — either
                # pre-emptively (its queue was known-full) or after it
                # rejected — the spill, paying a re-prefill there
                outer.spilled = True
                self.spills += 1
                telemetry.event("router_spill", replica=rep.index,
                                rejected=tried, reason=last_reason)
                kind = "spill"
            self.routed += 1
            rep.routed += 1
            self.routes_by_kind[kind] = self.routes_by_kind.get(kind, 0) + 1
            if outer.skey is not None:
                self._session_home[outer.skey] = rep.index
            # route_kind, not kind: ``kind`` is a reserved record field
            telemetry.event("router_route", replica=rep.index,
                            route_kind=kind, id=outer.id)
            return

    def _submit_to(self, rep: _Replica, outer: RouterHandle,
                   skip: int) -> None:
        now = time.monotonic()
        deadline = outer.remaining_deadline(now)
        if deadline is not None and deadline <= 0:
            outer._finish("deadline")
            return
        kw = dict(outer.kwargs)
        if kw.get("deadline_s") is not None:
            kw["deadline_s"] = deadline
        outer.gen += 1
        inner = rep.server.submit(outer.prompt, on_token=outer._forwarder(skip), **kw)
        outer.inner = inner
        outer.replica = rep.index
        outer.attempts += 1

    # -- the router tick (probe / watch / retry) ----------------------------

    def _loop(self) -> None:
        from tpudist_torch import telemetry

        while not self._stop.wait(self.config.probe_s):
            try:
                with self._lock:
                    self._tick(time.monotonic())
            except Exception as e:  # the tick must never die silently
                self.errors += 1
                telemetry.event("router_error", error=repr(e)[:200])

    def _tick(self, now: float) -> None:
        from tpudist_torch.runtime import faults

        self._ticks += 1
        # chaos: a due replica_kill hard-stops that replica's engine
        # loop — the probe/failover machinery below takes it from there
        idx = faults.inject_replica_kill(self._ticks)
        if idx is not None and 0 <= idx < len(self._replicas):
            self._replicas[idx].server.kill("replica_kill fault")
        for rep in self._replicas:
            if not rep.draining and now >= rep.next_probe:
                self._probe(rep, now)
        for item in list(self._pending_export):
            skey, idx, give_up = item
            rep = self._replicas[idx]
            stash = None
            if rep.up:
                try:
                    stash = rep.server.export_session(*skey)
                except Exception:
                    stash = None
            if stash is not None:
                self._stash[skey] = stash
                self._session_home[skey] = idx
            if stash is not None or now > give_up or not rep.up:
                self._pending_export.remove(item)
        self._watch(now)
        self._run_retries(now)

    def _probe(self, rep: _Replica, now: float) -> bool:
        from tpudist_torch import telemetry

        ok = rep.health_ok()
        if ok:
            if not rep.up:
                rep.up = True
                telemetry.event("replica_health", replica=rep.index,
                                up=True, ups=len(self._ups()))
            rep.fails = 0
            rep.backoff_s = None
            rep.next_probe = now + self.config.probe_s
            return True
        rep.fails += 1
        if rep.up and rep.fails >= self.config.probe_failures:
            self._mark_down(rep, now)
        if rep.up:
            rep.next_probe = now + self.config.probe_s
        else:
            # exponential backoff on re-probing a dead replica
            base = rep.backoff_s or self.config.probe_s
            rep.backoff_s = min(base * 2.0,
                                _BACKOFF_CAP * self.config.probe_s)
            rep.next_probe = now + rep.backoff_s
        return False

    def _mark_down(self, rep: _Replica, now: float) -> None:
        """Replica declared dead: re-home its parked sessions from the
        stash and queue every in-flight lane it held for re-homing onto
        survivors (duplicate-drop keeps their streams byte-identical)."""
        from tpudist_torch import telemetry

        rep.up = False
        rep.deaths += 1
        rep.backoff_s = self.config.probe_s
        rep.next_probe = now + rep.backoff_s
        self.replica_deaths += 1
        telemetry.event("replica_health", replica=rep.index, up=False,
                        fails=rep.fails, ups=len(self._ups()))
        for skey, home in list(self._session_home.items()):
            if home == rep.index:
                self._rehome_session(skey)
        for outer in list(self._inflight.values()):
            if outer.replica == rep.index and not outer.done:
                inner = outer.inner
                if inner is not None and not inner.done:
                    # the orphaned attempt: mark it loudly (its replica
                    # may be hung, not dead — a zombie delivery is
                    # filtered by the outer's generation gate)
                    inner._finish("router_spill")
                if outer.inner is not None:
                    outer.inner = None
                    outer.gen += 1
                    self._queue_retry(outer, now, immediate=True)

    def _watch(self, now: float) -> None:
        """Propagate finished inner attempts to their outer handles —
        or re-home them when the finish was the replica's death, not
        the request's own."""
        for outer in list(self._inflight.values()):
            inner = outer.inner
            if inner is None or not inner.done:
                continue
            reason = inner.finish_reason
            rep = self._replicas[outer.replica]
            if reason in _RETRY_REASONS and not self._closing:
                # crash-shaped finish: confirm against the replica's
                # health NOW (no waiting for the probe cadence — and a
                # gracefully-drained replica stays healthy, so its
                # shutdowns propagate instead of looping)
                if rep.up and not rep.health_ok():
                    self._mark_down(rep, now)
                if not rep.up:
                    if outer.inner is not None:
                        outer.inner = None
                        outer.gen += 1
                        self._queue_retry(outer, now, immediate=True)
                    continue
            self._finish_outer(outer)

    def _finish_outer(self, outer: RouterHandle) -> None:
        inner = outer.inner
        outer.resumed = outer.resumed or bool(getattr(inner, "resumed",
                                                      False))
        outer._finish(inner.finish_reason)
        self._inflight.pop(outer.id, None)
        if outer in self._retry_q:
            self._retry_q.remove(outer)
        # refresh the migration stash with the just-parked turn (the
        # finished lane parked BEFORE the handle finished, so the
        # export below sees it)
        if (self.config.stash and outer.skey is not None
                and outer.finish_reason in ("length", "eos",
                                            "session_resumed")):
            rep = self._replicas[outer.replica]
            tenant, session = outer.skey
            try:
                stash = rep.server.export_session(tenant, session)
            except Exception:
                stash = None
            if stash is not None:
                self._stash[outer.skey] = stash
                self._session_home[outer.skey] = rep.index
            else:
                # the park is still in flight on the engine loop —
                # re-export from the tick until it lands (bounded; a
                # never-parking lane just ages out)
                self._pending_export.append(
                    (outer.skey, rep.index, time.monotonic() + 2.0))

    def _queue_retry(self, outer: RouterHandle, now: float,
                     immediate: bool = False) -> None:
        if outer not in self._retry_q:
            outer.next_try = now if immediate else (
                now + self.config.retry_backoff_s)
            self._retry_q.append(outer)

    def _run_retries(self, now: float) -> None:
        from tpudist_torch import telemetry

        for outer in list(self._retry_q):
            if outer.done:
                self._retry_q.remove(outer)
                self._inflight.pop(outer.id, None)
                continue
            if now < outer.next_try:
                continue
            if outer._expired(now):
                outer._finish("deadline")
                self._retry_q.remove(outer)
                self._inflight.pop(outer.id, None)
                continue
            skip = len(outer.tokens)
            try:
                self._route_and_submit(outer, skip=skip)
            except AdmissionError as e:
                outer.retries_used += 1
                no_ups = not self._ups()
                if outer.retries_used > self.config.retries or no_ups:
                    # fleet-level passthrough: the shed reason
                    # survives the hop; everything else is the fleet
                    # failing this lane
                    self._retry_q.remove(outer)
                    self._inflight.pop(outer.id, None)
                    self.lost += 1
                    if e.reason.startswith("shed_load"):
                        outer._finish("shed_load")
                    else:
                        outer._finish("replica_lost")
                else:
                    outer.next_try = now + (self.config.retry_backoff_s
                                            * (2 ** outer.retries_used))
                continue
            if outer.done:
                # _submit_to expired it (deadline) without an attempt
                self._retry_q.remove(outer)
                self._inflight.pop(outer.id, None)
                continue
            self._retry_q.remove(outer)
            self.retries += 1
            telemetry.event("router_retry", id=outer.id,
                            replica=outer.replica, skip=skip,
                            attempt=outer.attempts)

    # -- session migration --------------------------------------------------

    def _rehome_session(self, skey: tuple) -> None:
        """Dead-home path: adopt the stashed package into a survivor
        (or forget the home — the next turn re-prefills fresh there)."""
        home = self._session_home.get(skey)
        stash = self._stash.get(skey) if self.config.stash else None
        self._migrate_session(
            skey, stash=stash,
            exclude=() if home is None else {home}, reason="death")

    def _migrate_session(self, skey: tuple, stash: Optional[dict],
                         exclude, reason: str) -> None:
        from tpudist_torch import telemetry

        target, _ = self._pick(None, None, exclude=exclude)
        ok = False
        if target is not None and stash is not None:
            tenant, session = skey
            try:
                ok = target.server.adopt_session(tenant, session, stash)
            except Exception:
                ok = False
        if ok:
            self._session_home[skey] = target.index
            self.migrations += 1
            telemetry.event("session_migrated", to_replica=target.index,
                            migrate_reason=reason, ok=True)
        else:
            # no stash / no survivor / tier refused: the session's next
            # turn re-prefills fresh wherever routing lands it —
            # degraded, never wrong, never hung
            self._session_home.pop(skey, None)
            telemetry.event("session_migrated", ok=False,
                            migrate_reason=reason)

    # -- accounting ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": len(self._replicas),
                "replicas_up": len(self._ups()),
                "routed": self.routed,
                "routes_by_kind": dict(self.routes_by_kind),
                "per_replica": [r.routed for r in self._replicas],
                "spills": self.spills,
                "retries": self.retries,
                "migrations": self.migrations,
                "replica_deaths": self.replica_deaths,
                "lost": self.lost,
                "inflight": len(self._inflight),
                "sessions_homed": len(self._session_home),
                "stash_entries": len(self._stash),
                "ticks": self._ticks,
                "errors": self.errors,
            }
