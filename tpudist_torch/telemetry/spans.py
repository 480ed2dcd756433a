"""Per-step span tracing: the recording half of the telemetry subsystem.

A *span* is a named wall-clock interval (``step``, ``compile``,
``data_wait``, ``ckpt_save``, ``host_collective``, ``init``); an *event*
is a zero-duration tagged marker (``fault_injected``, ``watchdog_stall``,
``retry``).  Each process records into

1. a bounded in-memory ring (``TPUDIST_TELEMETRY_RING`` entries, for
   in-process inspection and post-mortem dumps), and
2. a line-buffered per-rank, per-generation JSONL file
   ``<dir>/rank<R>_gen<G>.jsonl`` — the generation is
   ``TPUDIST_RESTART_COUNT`` (stamped by ``tpurun``), which is what lets
   the aggregator attribute the wall-clock gap between a killed process
   and its restarted successor as ``lost_restart`` time.

Record schema (one JSON object per line; reserved keys below, arbitrary
extra tags allowed)::

    {"kind": "span"|"event", "name": str, "t": wall_start_s,
     "dur": seconds, "rank": int, "gen": int, "parent": str?, ...tags}

``t`` is wall-clock (``time.time`` epoch) so records from different
processes/generations merge on one axis; durations are measured with
``time.monotonic`` and mapped onto the wall axis through one clock-pair
read at session start (span math never mixes clock reads).

Hot-path cost: disarmed (``TPUDIST_TELEMETRY=0`` or no session) every
site pays one module-attribute load + ``None`` check; armed, a span is
two ``monotonic()`` reads, a small dict, and one buffered ``write``.
Telemetry must never take a job down: I/O errors drop records — but no
longer SILENTLY: stream write failures, and ring evictions when the
session is RING-ONLY (the stream never opened, so an evicted record
exists nowhere), are counted in the session's ``dropped`` dict
(surfaced in ``/statusz``, stamped as a ``telemetry_dropped`` event at
close for the aggregate report, and warned once per session), so a
truncated report announces itself.  Ring rotation on a healthy stream
is the ring's designed behavior, not a drop.

Live plane: every emitted record is also offered to the metrics sink
(:func:`tpudist.telemetry.metrics.feed_record`) when armed
(``TPUDIST_METRICS``), which is what keeps the scrapeable registry
current without touching any instrumented site.

Dependency-free (no jax import): rank and generation resolve from the
launcher env contract via :mod:`tpudist.utils.envutil`, so the watchdog
and fault registry — which must stay importable without jax — can emit.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional

ENV_ENABLE = "TPUDIST_TELEMETRY"
ENV_DIR = "TPUDIST_TELEMETRY_DIR"
ENV_RING = "TPUDIST_TELEMETRY_RING"
DEFAULT_DIR = os.path.join("runs", "telemetry")
DEFAULT_RING = 4096

#: Keys every record carries; tags may not override them.
RESERVED_KEYS = ("kind", "name", "t", "dur", "rank", "gen", "parent")


def enabled_from_env() -> bool:
    """Telemetry is armed by default; ``TPUDIST_TELEMETRY=0`` (or
    false/off/no) disarms it."""
    from tpudist_torch.utils.envutil import env_flag

    return env_flag(ENV_ENABLE, True)


class TelemetrySession:
    """One process generation's recording session: ring + JSONL stream.

    One telemetry dir describes ONE run: a new session for the same
    (rank, generation) truncates the previous stream, so a re-run into
    the same dir reports itself, not a merge of unrelated runs.  Restart
    generations (distinct ``gen``) coexist — that is the cross-restart
    join the aggregator builds ``lost_restart`` from."""

    def __init__(
        self,
        directory: "str | os.PathLike",
        *,
        rank: Optional[int] = None,
        generation: Optional[int] = None,
        ring_size: Optional[int] = None,
    ):
        from tpudist_torch.utils.envutil import env_int, env_rank

        self.rank = env_rank(0) if rank is None else int(rank)
        self.generation = (
            (env_int("TPUDIST_RESTART_COUNT", 0) or 0)
            if generation is None else int(generation)
        )
        #: this generation's world size (launch contract) — stamped on
        #: ``session_start`` so the aggregator can tell an ELASTIC
        #: relaunch (world changed → the inter-generation gap is
        #: ``resize`` time) from a fixed-size restart (``lost_restart``).
        self.world = env_int("TPUDIST_NUM_PROCESSES", None)
        if ring_size is None:
            ring_size = env_int(ENV_RING, DEFAULT_RING) or DEFAULT_RING
        self.ring: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, int(ring_size)))
        self.directory = Path(directory)
        self.path = (self.directory
                     / f"rank{self.rank}_gen{self.generation}.jsonl")
        self._tls = threading.local()
        self._write_lock = threading.Lock()
        self._closed = False
        #: drop accounting (never silent — module doc): ``ring`` = ring
        #: evictions on a RING-ONLY session (stream never opened, so an
        #: evicted record exists nowhere), ``write`` = stream
        #: write/encode failures.  Surfaced in /statusz, stamped as a
        #: ``telemetry_dropped`` event at close, warned once.
        self.dropped: Dict[str, int] = {"ring": 0, "write": 0}
        self._drop_warned = False
        # One clock-pair read: wall-clock for any monotonic stamp is
        # t0_wall + (mono - t0_mono), so a span's t and dur come from the
        # same monotonic reads (never a second time.time() call).
        self._t0_wall = time.time()
        self._t0_mono = time.monotonic()
        self._file = None
        try:
            self.directory.mkdir(parents=True, exist_ok=True)
            self._file = open(self.path, "w", buffering=1)  # line buffered
        except OSError:
            pass  # ring-only session: recording must not take the job down
        # arm the live-metrics sink (TPUDIST_METRICS gates it) so every
        # session — worker, trainer, tpurun agent — feeds the scrapeable
        # registry without site changes
        try:
            from tpudist_torch.telemetry import metrics as _metrics

            _metrics.arm_from_env()
        except Exception:
            pass
        self.event("session_start", pid=os.getpid(),
                   **({"world": self.world} if self.world else {}))

    # -- recording ----------------------------------------------------------

    def _wall(self, mono: float) -> float:
        return self._t0_wall + (mono - self._t0_mono)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def record_span(self, name: str, t0_mono: float, dur_s: float,
                    tags: Optional[Dict] = None, *,
                    parent: Optional[str] = None) -> None:
        """Record a completed span from explicit ``monotonic()`` stamps —
        the zero-allocation-on-disarm form the hot loops use::

            if tele is not None: t0 = time.monotonic()
            ...work...
            if tele is not None:
                tele.record_span("step", t0, time.monotonic() - t0)

        ``parent``: explicit parent override (the per-request lifeline
        spans in :mod:`tpudist.telemetry.trace` pass ``"request"`` so
        the goodput accounting treats them as detail, never a second
        copy of the wall-clock they re-describe)."""
        rec = {
            "kind": "span",
            "name": name,
            "t": round(self._wall(t0_mono), 6),
            "dur": round(dur_s, 9),
            "rank": self.rank,
            "gen": self.generation,
        }
        if parent is not None:
            rec["parent"] = parent
        else:
            st = self._stack()
            if st:
                rec["parent"] = st[-1]
        if tags:
            for k, v in tags.items():
                if k not in RESERVED_KEYS:
                    rec[k] = v
        self._emit(rec)

    def event(self, name: str, **tags) -> None:
        rec = {
            "kind": "event",
            "name": name,
            "t": round(time.time(), 6),
            "dur": 0.0,
            "rank": self.rank,
            "gen": self.generation,
        }
        for k, v in tags.items():
            if k not in RESERVED_KEYS:
                rec[k] = v
        self._emit(rec)

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        """Nested-aware span bracket: while the body runs, inner spans
        record this one as their ``parent`` (per-thread stack, so the
        prefetch thread's spans never claim a trainer-thread parent)."""
        st = self._stack()
        t0 = time.monotonic()
        st.append(name)
        try:
            yield self
        finally:
            st.pop()
            self.record_span(name, t0, time.monotonic() - t0, tags or None)

    def _emit(self, rec: dict) -> None:
        if self._closed:
            return
        if self._file is None and len(self.ring) == self.ring.maxlen:
            # RING-ONLY session (the stream never opened): the deque
            # eviction is real data loss — nothing else holds the
            # record.  With a live stream, rotation past the bound is
            # the ring's designed behavior, not a drop (the JSONL has
            # every record; counting it would make every long healthy
            # run's report falsely announce incompleteness).
            self.dropped["ring"] += 1
        self.ring.append(rec)
        sink = _SINK
        if sink is not None:
            try:
                sink(rec)  # live-metrics feed (tpudist.telemetry.metrics)
            except Exception:
                pass  # the registry must never take the emitter down
        f = self._file
        if f is None:
            return
        try:
            line = json.dumps(rec) + "\n"
        except (TypeError, ValueError):
            self._count_write_drop()
            return  # unserializable tag: drop the record, not the job
        try:
            with self._write_lock:
                f.write(line)
        except (OSError, ValueError):
            self._count_write_drop()

    def _count_write_drop(self) -> None:
        self.dropped["write"] += 1
        if not self._drop_warned:
            self._drop_warned = True
            warnings.warn(
                f"tpudist.telemetry: dropping records (stream write "
                f"failure on {self.path}) — the post-hoc report for this "
                f"run will be incomplete; counts surface in /statusz and "
                f"the telemetry_dropped event", RuntimeWarning,
                stacklevel=3)

    # -- lifecycle ----------------------------------------------------------

    def flush(self) -> None:
        """Push buffered lines to the OS and fsync — called before
        deliberate aborts (watchdog ``os._exit``, injected SIGKILL) so the
        record that *explains* the death survives it."""
        f = self._file
        if f is None:
            return
        try:
            with self._write_lock:
                f.flush()
                os.fsync(f.fileno())
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        if self._closed:
            return
        if any(self.dropped.values()):
            # best-effort last word: if the stream recovered, the
            # aggregate report learns exactly how much it is missing
            self.event("telemetry_dropped", **self.dropped)
        self.event("session_end")
        self._closed = True
        f, self._file = self._file, None
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
                f.close()
            except (OSError, ValueError):
                pass

    @property
    def closed(self) -> bool:
        return self._closed


# -- module-level API (the one-branch-per-site surface) ----------------------

_ACTIVE: Optional[TelemetrySession] = None
_lock = threading.Lock()

#: Live-metrics sink: every emitted record is offered to this callable
#: (``tpudist.telemetry.metrics.feed_record`` when armed; ``None``
#: disarmed — one attribute load + None check per record).  Installed by
#: :func:`tpudist.telemetry.metrics.arm_from_env`.
_SINK: Optional[Callable[[dict], None]] = None


# Shared no-op context manager: the disarmed ``span()`` return
# (nullcontext is stateless, so one instance serves every site).
_NULL_SPAN = contextlib.nullcontext()


def active() -> Optional[TelemetrySession]:
    """The live session, or ``None`` — hot loops hoist this once and guard
    each site with one ``is not None`` check."""
    return _ACTIVE


def span(name: str, **tags):
    """``with telemetry.span("ckpt_save", step=7): ...`` — records on the
    active session; a shared no-op context manager when disarmed."""
    s = _ACTIVE
    if s is None:
        return _NULL_SPAN
    return s.span(name, **tags)


def event(name: str, **tags) -> None:
    s = _ACTIVE
    if s is not None:
        s.event(name, **tags)


def flush() -> None:
    s = _ACTIVE
    if s is not None:
        s.flush()


def start(
    directory: "str | os.PathLike | None" = None,
    *,
    rank: Optional[int] = None,
    generation: Optional[int] = None,
    ring_size: Optional[int] = None,
) -> TelemetrySession:
    """Start a session (closing any active one), explicit-args form for
    tests and embedding callers.  Directory: explicit >
    ``TPUDIST_TELEMETRY_DIR`` > ``runs/telemetry``."""
    global _ACTIVE
    with _lock:
        if _ACTIVE is not None:
            _ACTIVE.close()
        _ACTIVE = TelemetrySession(
            directory or os.environ.get(ENV_DIR) or DEFAULT_DIR,
            rank=rank, generation=generation, ring_size=ring_size,
        )
        return _ACTIVE


def ensure_started() -> Optional[TelemetrySession]:
    """Idempotent arm-from-env: start a session if telemetry is enabled
    and none is active.  Called from the runtime seams
    (``bootstrap.initialize``, ``run_training``) so every run records
    without code changes; returns ``None`` when disarmed."""
    if _ACTIVE is not None:
        return _ACTIVE
    if not enabled_from_env():
        return None
    return start()


def abandon() -> None:
    """Drop the active session WITHOUT closing it — the SIGKILL
    simulation hook for chaos tests: a killed process writes no
    ``session_end``, its stream just stops mid-line.  The buffered tail
    is flushed (matching the real pre-kill ``flush()`` the fault
    registry performs) but the file stays un-finalized."""
    global _ACTIVE
    with _lock:
        s = _ACTIVE
        _ACTIVE = None
    if s is not None:
        s.flush()


def finish(write_report: bool = True) -> Optional[dict]:
    """Close the active session; on rank 0 (the aggregation rank) also
    merge every rank/generation JSONL in the session directory into
    ``report.json`` + ``report.md``.  Returns the report dict (rank 0,
    ``write_report=True``) or ``None``.  Never raises — a failed report
    must not fail the run it measured."""
    global _ACTIVE
    with _lock:
        s = _ACTIVE
        _ACTIVE = None
    if s is None:
        return None
    s.close()
    if not (write_report and s.rank == 0):
        return None
    try:
        from tpudist_torch.telemetry.aggregate import write_reports

        report, _paths = write_reports(s.directory)
        return report
    except Exception:
        return None
