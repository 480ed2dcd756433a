"""Profiling / trace capture — the counterpart of
:mod:`tpudist.utils.profiling`.

The reference has no tracing at all (SURVEY.md §5.1).  :func:`trace` is a
``torch.profiler`` window (host ops, plus the card's kernels where CUDA is
available) written per process as a Chrome trace, readable in Perfetto or
``chrome://tracing``; :class:`StageTimer` times host phases.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

from tpudist_torch.runtime.bootstrap import process_index

#: the trace file of a window, under ``<profile_dir>/process_<rank>/``
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``<profile_dir>/process_<rank>/trace.json`` (no-op when ``None``).
    Each process writes its own subdirectory, so traces from all hosts land
    side by side on shared storage."""
    if profile_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = Path(profile_dir) / f"process_{process_index()}"
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path / TRACE_FILE))


class StageTimer:
    """Wall-clock phase timer (the host-side analog of the reference's
    ``time tar`` staging timing) — records named phase durations and
    publishes them with :meth:`emit`: one committed metrics row
    (``stage/<name>``) plus one telemetry ``stage`` event per phase, which
    the goodput report surfaces in its "Host stages" section."""

    def __init__(self):
        self.durations: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name] = self.durations.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def emit(self, logger=None, *, prefix: str = "stage/",
             session=None) -> dict:
        """Publish the phase durations: telemetry ``stage`` events (into
        ``session``, default the active session) and, with a
        :class:`~tpudist_torch.utils.metrics.MetricsLogger`, one committed
        ``stage/<name>`` row.  Returns the durations; call it before the
        logger is finished."""
        from tpudist_torch import telemetry

        sess = session if session is not None else telemetry.active()
        if sess is not None:
            for name, dur in self.durations.items():
                sess.event("stage", stage=name, dur_s=round(dur, 6))
        if logger is not None and self.durations:
            logger.log(
                {f"{prefix}{k}": v for k, v in self.durations.items()},
                commit=True,
            )
        return dict(self.durations)
