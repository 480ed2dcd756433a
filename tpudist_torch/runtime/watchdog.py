"""Hang watchdog: convert a wedged step into a fast, diagnosable restart
(a copy of :mod:`tpudist.runtime.watchdog`; the crash record goes through
:func:`tpudist_torch.utils.record.write_error_record`).

A hung collective (one rank dead in a way the coordination service hasn't
noticed, a deadlocked host callback, a wedged device tunnel) leaves every
process alive but advancing nothing — the worst failure mode on a managed
allocation, because ``tpurun``'s restart loop only reacts to *exits* and
the scheduler only reclaims the job at its own (hour-scale) timeout.

The watchdog is a daemon thread the train loop pets once per iteration
(or scan window).  When no pet arrives within the stall deadline it:

1. dumps every thread's stack into the structured crash-record file
   (``tpudist.utils.record`` — the same file ``tpurun`` surfaces as the
   first failure, so the hang is *diagnosable* post-mortem), and
2. hard-aborts the process with :data:`WATCHDOG_EXIT_CODE` via
   ``os._exit`` — deliberately not ``sys.exit``, which a wedged main
   thread would never run — so the agent's whole-group restart re-admits
   the job instead of burning the allocation.

Arm it via ``TrainLoopConfig.watchdog_timeout_s`` or the
``TPUDIST_WATCHDOG_S`` env var (unset/<=0 = disabled).  Size the deadline
above the slowest legitimate gap between pets — on the first iteration
that gap includes XLA compilation, which ``first_deadline_s`` can extend
separately.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
import weakref
from typing import Callable, Dict, Optional

#: Process exit code on a stall abort (the ``timeout(1)`` convention, so
#: operators' existing "what does 124 mean" reflex applies).
WATCHDOG_EXIT_CODE = 124

TIMEOUT_ENV = "TPUDIST_WATCHDOG_S"


def timeout_from_env(default: Optional[float] = None) -> Optional[float]:
    """Resolve the stall deadline from ``TPUDIST_WATCHDOG_S``; unset,
    unparseable, or <= 0 means disabled (returns ``default``)."""
    from tpudist_torch.utils.envutil import env_positive_float

    return env_positive_float(TIMEOUT_ENV, default)


#: Running watchdogs, for the ``/healthz`` freshness check
#: (:mod:`tpudist.telemetry.statusz`): weak so a dropped watchdog never
#: pins itself in the health report.
_LIVE: "weakref.WeakSet[Watchdog]" = weakref.WeakSet()


def freshness() -> Dict[str, dict]:
    """Heartbeat freshness of every RUNNING watchdog: seconds since the
    last pet vs the current stall deadline.  Empty when none is armed —
    the health check treats that as vacuously healthy."""
    out: Dict[str, dict] = {}
    for dog in list(_LIVE):
        if dog._thread is None:
            continue  # built but not started / already stopped
        age = time.monotonic() - dog._last
        deadline = dog._deadline()
        out[dog.name] = {
            "age_s": round(age, 3),
            "deadline_s": round(deadline, 3),
            "fresh": age <= deadline,
        }
    return out


def dump_all_stacks() -> Dict[str, str]:
    """Formatted stacks of every live thread, keyed by thread name."""
    frames = sys._current_frames()
    out: Dict[str, str] = {}
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        if frame is None:
            continue
        label = f"{t.name} (ident {t.ident}{', daemon' if t.daemon else ''})"
        out[label] = "".join(traceback.format_stack(frame))
    return out


class Watchdog:
    """Heartbeat-or-abort supervisor for a loop that must keep advancing.

    ``abort`` is injectable for tests; production uses ``os._exit`` (see
    module docstring for why graceful shutdown is the wrong move here).
    """

    def __init__(
        self,
        stall_timeout_s: float,
        *,
        name: str = "train_loop",
        poll_interval_s: Optional[float] = None,
        first_deadline_s: Optional[float] = None,
        abort: Optional[Callable[[int], None]] = None,
    ):
        if stall_timeout_s <= 0:
            raise ValueError(f"stall_timeout_s must be > 0, got {stall_timeout_s}")
        self.stall_timeout_s = float(stall_timeout_s)
        self.name = name
        self._poll = poll_interval_s or min(1.0, self.stall_timeout_s / 4)
        # extra slack before the FIRST pet only (covers XLA compile)
        self._first_extra = max(0.0, (first_deadline_s or 0.0) - self.stall_timeout_s)
        self._abort = abort if abort is not None else os._exit
        self._stop = threading.Event()
        self._petted = False
        self._last = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        self.stalled = False  # post-mortem flag for injectable-abort tests

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._stop.clear()  # restartable: stop() leaves the event set
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name=f"tpudist-watchdog[{self.name}]", daemon=True
        )
        self._thread.start()
        _LIVE.add(self)  # visible to the /healthz freshness check
        return self

    def pet(self) -> None:
        """Heartbeat: the supervised loop made progress.

        Order matters: ``_last`` is refreshed BEFORE ``_petted`` collapses
        the first-deadline slack, so a supervisor that observes the tight
        deadline necessarily also observes the fresh timestamp (the
        reverse order could pair a collapsed deadline with a stale
        ``_last`` and spuriously abort a healthy process)."""
        self._last = time.monotonic()
        self._petted = True

    def stop(self) -> None:
        self._stop.set()
        _LIVE.discard(self)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- supervisor thread --------------------------------------------------

    def _deadline(self) -> float:
        extra = 0.0 if self._petted else self._first_extra
        return self.stall_timeout_s + extra

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            # Deadline snapshot FIRST, timestamp second (mirror of pet()'s
            # write order): a pet racing this read can only make the
            # deadline larger than needed or the stall smaller — never a
            # collapsed deadline judged against a stale timestamp.
            deadline = self._deadline()
            stalled_for = time.monotonic() - self._last
            if stalled_for > deadline:
                self._on_stall(stalled_for, deadline)
                return

    def _on_stall(self, stalled_for: float, deadline: float) -> None:
        self.stalled = True
        # Tag the stall in the telemetry stream and flush BEFORE the
        # abort: os._exit skips every atexit/buffer path, and the merged
        # report needs this event to attribute the restart's lost time.
        # Best-effort with a hard deadline — the wedged thread this abort
        # exists to kill may itself hold the telemetry write lock (hung
        # filesystem), and blocking here would defeat the whole watchdog.
        from tpudist_torch import telemetry

        def _stamp():
            telemetry.event("watchdog_stall", watchdog=self.name,
                            stalled_for_s=round(stalled_for, 3),
                            deadline_s=round(deadline, 3))
            telemetry.flush()

        stamp = threading.Thread(target=_stamp, daemon=True,
                                 name="tpudist-watchdog-telemetry")
        stamp.start()
        stamp.join(2.0)
        message = (
            f"watchdog: no heartbeat from '{self.name}' for "
            f"{stalled_for:.1f}s (deadline {deadline:.1f}s) — "
            f"dumping stacks and aborting with exit {WATCHDOG_EXIT_CODE} "
            f"so the launcher can restart the group"
        )
        stacks = dump_all_stacks()
        # Same structured record the launcher surfaces for crashes, written
        # atomically (a torn record would be silently skipped).
        from tpudist_torch.utils.record import write_error_record

        write_error_record({
            "exc_type": "WatchdogStall",
            "message": message,
            "traceback": "\n".join(
                f"--- {label} ---\n{stack}" for label, stack in stacks.items()
            ),
            "stacks": stacks,
            "stall_timeout_s": self.stall_timeout_s,
            "stalled_for_s": stalled_for,
        })
        print(f"[tpudist.watchdog] {message}", file=sys.stderr, flush=True)
        for label, stack in stacks.items():
            print(f"[tpudist.watchdog] --- {label} ---\n{stack}",
                  file=sys.stderr, flush=True)
        self._abort(WATCHDOG_EXIT_CODE)


def from_config(timeout_s: Optional[float] = None, **kwargs) -> Optional[Watchdog]:
    """Build (not start) a watchdog from an explicit timeout or the env;
    ``None`` when disabled — callers guard each ``pet()`` on that."""
    t = timeout_s if timeout_s is not None else timeout_from_env()
    if t is None or t <= 0:
        return None
    return Watchdog(t, **kwargs)
