"""Preemption-safe shutdown: SIGTERM → checkpoint at a step boundary (a
copy of :mod:`tpudist.runtime.preemption`; the host reduce is the port's
gloo group).

SLURM (and every cloud TPU scheduler) delivers SIGTERM ahead of a
preemption/requeue; the reference's jobs simply died and its launcher
provisioned checkpoint directories it never wrote (SURVEY.md §5.4).
tpudist closes the loop: install the handler once per process, and
``run_training`` (``tpudist/train/loop.py``) checks the flag at its sync
boundaries — when ANY process was signaled, all processes save a final
checkpoint at the same boundary (meta carries ``preempted: true``), tear
down in the reference's ordering, and return.  A later run with
``--resume`` picks up at the exact iteration (the loop's deterministic
fast-forward).

Any-semantics is deliberate, and skew-tolerant: SLURM delivers SIGTERM to
ranks at slightly different times, and an Orbax save is collective —
everyone must save at the SAME step.  ``check_all()`` OR-reduces the
local flags over the host fabric (Gloo-group analog), so the first
boundary after the first signal lands the whole job on one common save.

Usage (the demos and Trainer do this automatically)::

    from tpudist_torch.runtime import preemption
    preemption.install()
    run_training(..., ckpt=manager)   # loop handles the rest
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable

import numpy as np

_flag = threading.Event()
_installed: list = []  # (signum, previous handler) for uninstall/tests
_last_run_preempted = False  # sticky: survives reset() (callers consult it)


def install(signals: Iterable[int] = (signal.SIGTERM,)) -> bool:
    """Install the preemption handler (idempotent).  Returns whether
    anything NEW was installed — the caller that got True owns the matching
    :func:`reset` (``run_training`` restores handlers on exit so SIGTERM
    terminates the process again once training is done).

    CPython restricts ``signal.signal`` to the main thread; called off it
    (Trainer under a threaded test runner), this degrades to a no-op
    returning ``False`` with a one-line warning — the caller still trains,
    just without preemption saves — instead of crashing with ValueError."""
    new = []
    for signum in signals:
        if any(s == signum for s, _ in _installed):
            continue
        try:
            prev = signal.signal(signum, _handle)
        except ValueError:
            # Roll back what THIS call installed: a False return means the
            # caller will never own reset(), so nothing may stay behind.
            for s, p in reversed(new):
                try:
                    signal.signal(s, p)
                except (ValueError, OSError):
                    pass
                _installed.remove((s, p))
            import warnings

            warnings.warn(
                "tpudist.runtime.preemption.install() could not install a "
                "signal handler (not on the main thread, or an invalid "
                "signal); preemption-save handling disabled for this run",
                RuntimeWarning, stacklevel=2,
            )
            return False
        _installed.append((signum, prev))
        new.append((signum, prev))
    return bool(new)


def _handle(signum, frame):  # noqa: ARG001
    _flag.set()


def requested() -> bool:
    """This process received a preemption signal."""
    return _flag.is_set()


def check_all() -> bool:
    """True when ANY process was signaled — reduced over the host fabric
    so every rank takes the same save-and-exit decision at the same
    boundary (single-process: just the local flag)."""
    from tpudist_torch.runtime.bootstrap import process_count

    if process_count() == 1:
        return _flag.is_set()
    from tpudist_torch.comm.collectives import host_allreduce_sum

    total = host_allreduce_sum(np.float64(1.0 if _flag.is_set() else 0.0))
    return float(total) > 0.0


def note_run_preempted() -> None:
    """Called by the train loop when it exits early on preemption — the
    sticky record callers consult AFTER the loop returns (reset() clears
    the live flag but not this)."""
    global _last_run_preempted
    _last_run_preempted = True


def last_run_preempted() -> bool:
    """Did the most recent training loop exit early on preemption?  A
    partially-trained run must be distinguishable from a completed one
    (the loop's return signature carries no status)."""
    return _last_run_preempted


def clear_last_run_preempted() -> None:
    global _last_run_preempted
    _last_run_preempted = False


def reset() -> None:
    """Clear the live flag and restore previous handlers (loop exit,
    tests).  The sticky :func:`last_run_preempted` record is NOT cleared."""
    _flag.clear()
    while _installed:
        signum, prev = _installed.pop()
        try:
            signal.signal(signum, prev)
        except (ValueError, OSError):  # non-main thread / closed interp
            pass
