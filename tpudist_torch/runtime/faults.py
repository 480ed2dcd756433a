"""Deterministic fault injection for chaos testing the tpudist_torch
runtime — a copy of :mod:`tpudist.runtime.faults` (the grammar, the gating
and every injection point), whose rank gate reads the port's process group.
The port calls the training and runtime seams (``kill``, ``sigterm``,
``ckpt_corrupt``, ``host_delay``, ``init_fail``); the serving, handoff,
host-tier, replica and draft kinds parse and wait for their subsystems.

The failure paths (preemption saves, ``tpurun`` restarts, degraded-mode
checkpoint restore, init retry) are only as trustworthy as their tests,
and none of them can be exercised without a way to *cause* the failure on
demand.  This registry injects faults at four seams — the train loop, the
host fabric, checkpoint saves, and distributed init — driven by one env
var so chaos tests (and operators reproducing an incident) need no code
changes::

    TPUDIST_FAULT=kill@step:7,rank:1        # SIGKILL rank 1 at step 7
    TPUDIST_FAULT=sigterm@step:5            # preemption drill at step 5
    TPUDIST_FAULT=ckpt_corrupt@step:10      # garble the save at/after step 10
    TPUDIST_FAULT=host_delay@ms:500         # stall every host collective 500ms
    TPUDIST_FAULT=init_fail@attempts:2      # fail the first 2 init attempts
    TPUDIST_FAULT=ckpt_corrupt@step:16;kill@step:19   # compose with ';'
    TPUDIST_FAULT=serve_worker_kill@call:8,pool:1,worker:0
                                            # kill decode worker 0 at its
                                            # 8th engine call (disagg loop)
    TPUDIST_FAULT=handoff_corrupt@nth:2     # garble the 2nd serialized
                                            # KV-handoff package in flight
    TPUDIST_FAULT=host_tier_corrupt@nth:1   # garble the 1st package PARKED
                                            # in the host-RAM KV tier
    TPUDIST_FAULT=replica_kill@nth:1        # kill fleet replica 1's engine
                                            # loop at the router's next
                                            # probe tick (tick:K delays it)
    TPUDIST_FAULT=draft_swap_corrupt@nth:1  # garble the 1st distillation
                                            # candidate's params pre-gate
                                            # (held-out eval must reject)

Grammar: ``kind@key:int[,key:int][;kind@...]``.  Common keys: ``rank``
restricts the fault to one process (default: all); ``attempt`` fires only
on that ``TPUDIST_RESTART_COUNT`` (default 0 for the one-shot kinds, so a
``tpurun``-restarted group is NOT re-killed — the whole point of the
kill→restart→resume chaos test).

Cost when disarmed (production): every injection point is one module
attribute load and a ``None`` check — no parsing, no env reads.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ENV_VAR = "TPUDIST_FAULT"

# kind -> (required params, allowed params)
_SCHEMA: Dict[str, tuple] = {
    "kill": ({"step"}, {"step", "rank", "attempt"}),
    "sigterm": ({"step"}, {"step", "rank", "attempt"}),
    "ckpt_corrupt": ({"step"}, {"step", "rank", "attempt"}),
    "host_delay": ({"ms"}, {"ms", "rank"}),
    "init_fail": ({"attempts"}, {"attempts", "rank"}),
    # serve-side chaos (tpudist.serve.disagg): kill a pool worker at its
    # Nth engine call (pool: 0=prefill, 1=decode [default]; worker
    # default 0), or garble the Nth serialized KV-handoff package —
    # recovery drives through the SAME grammar as the training faults.
    "serve_worker_kill": ({"call"}, {"call", "pool", "worker", "rank"}),
    "handoff_corrupt": ({"nth"}, {"nth", "rank"}),
    # host-RAM KV tier (tpudist.serve.host_tier): garble the Nth PARKED
    # package after its digest is stamped — a corrupt parked blob must
    # degrade to a full re-prefill (host_tier_corrupt event), never
    # crash and never import wrong bytes.
    "host_tier_corrupt": ({"nth"}, {"nth", "rank"}),
    # fleet router (tpudist.serve.router): kill the Nth replica's engine
    # loop at router scope — the router's probe tick consults this and
    # hard-stops that replica (its loop raises, in-flight work aborts,
    # /healthz goes 503), driving the SAME failover path a real replica
    # crash would: re-home in-flight lanes onto survivors, resume parked
    # sessions from the router-side stash.  `tick` delays the kill to
    # the router's Nth probe tick (default 1 = the first tick after
    # arming).
    "replica_kill": ({"nth"}, {"nth", "tick", "rank"}),
    # online draft distillation (tpudist_torch.distill): garble the Nth
    # distillation round's CANDIDATE params pre-gate — the held-out
    # eval must reject it and the serving draft stays untouched (a
    # wrong draft can only cost speed, never bytes, but the gate
    # letting one through would quietly regress acceptance).
    "draft_swap_corrupt": ({"nth"}, {"nth", "rank"}),
}


class FaultSpecError(ValueError):
    """Malformed ``TPUDIST_FAULT`` value."""


class TransientInitError(RuntimeError):
    """Injected coordinator-init failure (``init_fail``) — shaped like the
    transient connect errors the bootstrap retry loop exists to absorb."""


@dataclasses.dataclass
class FaultSpec:
    kind: str
    params: Dict[str, int]
    fired: int = 0
    #: events observed by a counting injection point (e.g. serialized
    #: handoff packages seen by ``handoff_corrupt``) — distinct from
    #: ``fired`` so "the Nth occurrence" gating composes with fire-once.
    seen: int = 0

    def param(self, key: str, default: Optional[int] = None) -> Optional[int]:
        return self.params.get(key, default)


def parse(spec: str) -> List[FaultSpec]:
    """Parse the ``TPUDIST_FAULT`` grammar; raises :class:`FaultSpecError`
    on unknown kinds/keys or non-integer values (fail loud: a typo'd chaos
    spec silently doing nothing would defeat the test that armed it)."""
    out: List[FaultSpec] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, sep, rest = part.partition("@")
        kind = kind.strip()
        if kind not in _SCHEMA:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} in {part!r} "
                f"(known: {sorted(_SCHEMA)})")
        required, allowed = _SCHEMA[kind]
        params: Dict[str, int] = {}
        if sep:
            for kv in rest.split(","):
                key, sep2, val = kv.partition(":")
                key = key.strip()
                if not sep2 or key not in allowed:
                    raise FaultSpecError(
                        f"bad param {kv!r} for fault {kind!r} "
                        f"(allowed: {sorted(allowed)})")
                try:
                    params[key] = int(val)
                except ValueError as e:
                    raise FaultSpecError(
                        f"param {key!r} of fault {kind!r} must be an "
                        f"integer, got {val!r}") from e
        missing = required - params.keys()
        if missing:
            raise FaultSpecError(
                f"fault {kind!r} missing required param(s) {sorted(missing)}")
        out.append(FaultSpec(kind=kind, params=params))
    if not out:
        raise FaultSpecError(f"empty fault spec {spec!r}")
    return out


# -- arming -----------------------------------------------------------------

_PLAN: Optional[List[FaultSpec]] = None
_SOURCE: Optional[str] = None  # "env" | "explicit"
_ENV_SPEC: Optional[str] = None  # the env string _PLAN was parsed from


def arm(spec: str) -> List[FaultSpec]:
    """Arm the registry from an explicit spec string (tests)."""
    global _PLAN, _SOURCE, _ENV_SPEC
    _PLAN = parse(spec)
    _SOURCE = "explicit"
    _ENV_SPEC = None
    return _PLAN


def arm_from_env() -> bool:
    """Arm from ``TPUDIST_FAULT`` if set (idempotent; re-parses only when
    the env value changed).  Called by ``run_training`` and
    ``runtime.bootstrap.initialize`` so the grammar works with zero code
    changes in the job.  An explicit :func:`arm` is never clobbered, and an
    unset env var disarms only an env-armed plan."""
    global _PLAN, _SOURCE, _ENV_SPEC
    spec = os.environ.get(ENV_VAR)
    if not spec:
        if _SOURCE == "env":
            disarm()
        return False
    if _SOURCE == "explicit":
        return False
    if _SOURCE == "env" and spec == _ENV_SPEC:
        return True
    _PLAN = parse(spec)
    _SOURCE = "env"
    _ENV_SPEC = spec
    return True


def disarm() -> None:
    global _PLAN, _SOURCE, _ENV_SPEC
    _PLAN = None
    _SOURCE = None
    _ENV_SPEC = None


def armed() -> bool:
    return _PLAN is not None


# -- gating helpers ---------------------------------------------------------

def _restart_count() -> int:
    from tpudist_torch.utils.envutil import env_int

    return env_int("TPUDIST_RESTART_COUNT", 0)


def _current_rank() -> int:
    from tpudist_torch.utils.envutil import env_rank

    rank = env_rank()
    if rank is not None:
        return rank
    if "torch" in sys.modules:  # never import torch just to gate a fault
        try:
            from tpudist_torch.runtime.bootstrap import process_index

            return process_index()
        except Exception:
            pass
    return 0


def _rank_matches(spec: FaultSpec) -> bool:
    rank = spec.param("rank")
    return rank is None or rank == _current_rank()


def _one_shot_due(spec: FaultSpec, step: int) -> bool:
    """kill/sigterm/ckpt_corrupt: fire once, at the first injection point
    whose step is >= the spec's, on the matching restart attempt/rank."""
    return (
        spec.fired == 0
        and step >= spec.params["step"]
        and spec.param("attempt", 0) == _restart_count()
        and _rank_matches(spec)
    )


def _log(msg: str) -> None:
    print(f"[tpudist.faults] {msg}", file=sys.stderr, flush=True)


# -- injection points -------------------------------------------------------

def inject_step(step: int) -> None:
    """Train-loop injection point (called once per iteration/window)."""
    if _PLAN is None:
        return
    for spec in _PLAN:
        if spec.kind in ("kill", "sigterm") and _one_shot_due(spec, step):
            spec.fired += 1
            signum = signal.SIGKILL if spec.kind == "kill" else signal.SIGTERM
            _log(f"injecting {spec.kind} at step {step} "
                 f"(rank {_current_rank()}, attempt {_restart_count()})")
            # Stamp + flush the telemetry stream first: a SIGKILL gives no
            # second chance, and the merged report joins this marker with
            # the restart gap it causes (lost_restart attribution).
            from tpudist_torch import telemetry

            telemetry.event("fault_injected", fault=spec.kind, step=step)
            telemetry.flush()
            os.kill(os.getpid(), signum)


def inject_host() -> None:
    """Host-fabric injection point (``host_allreduce_sum`` / ``barrier``)."""
    if _PLAN is None:
        return
    for spec in _PLAN:
        if spec.kind == "host_delay" and _rank_matches(spec):
            spec.fired += 1
            time.sleep(spec.params["ms"] / 1000.0)


def inject_init(attempt: int) -> None:
    """Distributed-init injection point: raises :class:`TransientInitError`
    for the first ``attempts`` calls (exercises the bootstrap retry loop).
    ``attempt`` is informational (logged)."""
    if _PLAN is None:
        return
    for spec in _PLAN:
        if (spec.kind == "init_fail" and _rank_matches(spec)
                and spec.fired < spec.params["attempts"]):
            spec.fired += 1
            _log(f"injecting init failure "
                 f"({spec.fired}/{spec.params['attempts']}, "
                 f"attempt {attempt})")
            raise TransientInitError(
                f"injected transient init failure "
                f"{spec.fired}/{spec.params['attempts']}")


def inject_ckpt_save(step: int, step_dir: os.PathLike,
                     wait: Optional[Callable[[], None]] = None) -> bool:
    """Checkpoint-save injection point: after a (possibly async) save of
    ``step``, a due ``ckpt_corrupt`` fault waits for the write to finish
    and garbles the step's payload in place.  Returns whether it fired."""
    if _PLAN is None:
        return False
    for spec in _PLAN:
        if spec.kind == "ckpt_corrupt" and _one_shot_due(spec, step):
            spec.fired += 1
            if wait is not None:
                wait()
            n = corrupt_checkpoint(step_dir)
            _log(f"corrupted checkpoint step {step} "
                 f"({n} files garbled under {os.fspath(step_dir)})")
            from tpudist_torch import telemetry

            telemetry.event("fault_injected", fault="ckpt_corrupt",
                            step=step, files=n)
            return True
    return False


def inject_serve_worker(pool: int, worker: int, ncalls: int) -> bool:
    """Disagg-loop injection point, consulted before every engine
    interaction of pool worker ``(pool, worker)`` (``pool``: 0=prefill,
    1=decode; ``ncalls`` = that worker's cumulative engine-call count).
    Returns True when a due ``serve_worker_kill`` says THIS call must
    die — the serving loop raises in response, driving the SAME
    worker-lost recovery path a real engine failure would."""
    if _PLAN is None:
        return False
    for spec in _PLAN:
        if (spec.kind == "serve_worker_kill" and spec.fired == 0
                and spec.param("pool", 1) == pool
                and spec.param("worker", 0) == worker
                and ncalls >= spec.params["call"]
                and _rank_matches(spec)):
            spec.fired += 1
            _log(f"injecting serve worker kill: pool "
                 f"{'decode' if pool else 'prefill'} worker {worker} at "
                 f"engine call {ncalls}")
            return True
    return False


def inject_handoff(ser: dict) -> bool:
    """Handoff-transport injection point: a due ``handoff_corrupt``
    garbles the ``nth`` serialized KV package in place (first blob
    leaf's leading bytes flipped — the integrity digest then rejects it
    at deserialize, the detectable-wire-corruption scenario).  Returns
    whether it fired."""
    if _PLAN is None:
        return False
    for spec in _PLAN:
        if (spec.kind == "handoff_corrupt" and spec.fired == 0
                and _rank_matches(spec)):
            spec.seen += 1
            if spec.seen < spec.params["nth"]:
                continue
            blob = ser.get("blob")
            if not blob:
                continue
            b, dt, shape = blob[0]
            blob[0] = (bytes(x ^ 0xFF for x in b[:8]) + b[8:], dt, shape)
            spec.fired += 1
            _log(f"corrupted handoff package #{spec.seen} "
                 f"({len(b)} B leaf garbled)")
            from tpudist_torch import telemetry

            telemetry.event("fault_injected", fault="handoff_corrupt",
                            nth=spec.seen)
            return True
    return False


def inject_host_tier(ser: dict) -> bool:
    """Host-tier injection point (:meth:`tpudist.serve.host_tier.
    HostKVTier.put`): a due ``host_tier_corrupt`` garbles the ``nth``
    PARKED serialized package in place, after its digest stamp — the
    resume path's deserialize then detects the mismatch and degrades to
    a full re-prefill instead of importing garbage KV.  Returns whether
    it fired."""
    if _PLAN is None:
        return False
    for spec in _PLAN:
        if (spec.kind == "host_tier_corrupt" and spec.fired == 0
                and _rank_matches(spec)):
            spec.seen += 1
            if spec.seen < spec.params["nth"]:
                continue
            blob = ser.get("blob")
            if not blob:
                continue
            b, dt, shape = blob[0]
            blob[0] = (bytes(x ^ 0xFF for x in b[:8]) + b[8:], dt, shape)
            spec.fired += 1
            _log(f"corrupted parked host-tier package #{spec.seen} "
                 f"({len(b)} B leaf garbled)")
            from tpudist_torch import telemetry

            telemetry.event("fault_injected", fault="host_tier_corrupt",
                            nth=spec.seen)
            return True
    return False


def inject_replica_kill(tick: int) -> Optional[int]:
    """Fleet-router injection point, consulted once per router probe
    tick (``tick`` = the router's cumulative tick count).  A due
    ``replica_kill`` fires once and returns the replica index to
    hard-stop (``nth``); ``None`` otherwise.  The router responds by
    killing that replica's engine loop — the in-process twin of a
    replica host dying — and its probe/failover machinery takes it from
    there with zero test-only seams."""
    if _PLAN is None:
        return None
    for spec in _PLAN:
        if (spec.kind == "replica_kill" and spec.fired == 0
                and tick >= spec.param("tick", 1)
                and _rank_matches(spec)):
            spec.fired += 1
            idx = spec.params["nth"]
            _log(f"injecting replica_kill: replica {idx} at router "
                 f"tick {tick}")
            from tpudist_torch import telemetry

            telemetry.event("fault_injected", fault="replica_kill",
                            replica=idx, tick=tick)
            return idx
    return None


def inject_draft_swap(round_idx: int) -> bool:
    """Distillation-round injection point (:func:`tpudist_torch.distill.
    swap.maybe_corrupt_candidate`), consulted once per round with the
    candidate in hand: a due ``draft_swap_corrupt`` fires on its
    ``nth`` offered candidate and returns True — the CALLER garbles
    the candidate's weights (this module stays torch-free), and the
    held-out gate must then reject it (the chaos test's assertion).
    ``round_idx`` is informational (logged)."""
    if _PLAN is None:
        return False
    for spec in _PLAN:
        if (spec.kind == "draft_swap_corrupt" and spec.fired == 0
                and _rank_matches(spec)):
            spec.seen += 1
            if spec.seen < spec.params["nth"]:
                continue
            spec.fired += 1
            _log(f"corrupting draft-swap candidate #{spec.seen} "
                 f"(distill round {round_idx})")
            from tpudist_torch import telemetry

            telemetry.event("fault_injected", fault="draft_swap_corrupt",
                            nth=spec.seen, round=round_idx)
            return True
    return False


def corrupt_checkpoint(step_dir: os.PathLike) -> int:
    """Garble every payload file under a step directory (or the step's one
    file, the port's ``step_<N>.pt``), keeping the step *listed* (its
    commit metadata survives) so restore has to detect the corruption the
    hard way — the scenario degraded-mode restore exists for.  Returns the
    number of files garbled."""
    root = Path(step_dir)
    n = 0
    for f in ([root] if root.is_file() else sorted(root.rglob("*"))):
        if not f.is_file() or "_CHECKPOINT_METADATA" in f.name:
            continue
        try:
            f.write_bytes(b"tpudist-fault-injected-corruption")
            n += 1
        except OSError:
            pass
    return n
