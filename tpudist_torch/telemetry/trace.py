"""Per-request cross-pool tracing: one ``trace_id`` per request, minted
at ``submit()`` and threaded through everything the request touches —
admission, prefill slots, the serialized KV-handoff package
(``schema_version`` 3 carries it on the wire), decode lanes, recovery
replays, and ``request_finished`` — so the post-hoc aggregator can JOIN
a request's records across pools and processes, and a Perfetto-loadable
timeline can show one request's lifeline crossing
prefill pool → handoff queue → decode pool (and, after a worker death,
the replay jumping to the survivor).

Recording model: the serving loops already hold every per-request
timestamp on the :class:`~tpudist.serve.scheduler.RequestHandle`
(submit/admit/prefill-done/decode-start/first-token/done, plus the
per-worker decode segments the disagg recovery path appends).  At
finish time :func:`emit_request_lifeline` turns those stamps into a
handful of ``req_*`` spans tagged with the trace_id:

- ``req_queue``     submit → admission (the queue wait)
- ``req_prefill``   admission → prompt done (token 0 sampled)
- ``req_handoff``   prefill done → decode slot installed (disagg only)
- ``req_decode``    one span PER DECODE SEGMENT — a lane that replayed
  onto a survivor after ``worker_lost`` gets one span per worker, which
  is exactly the visible "jump" in the exported timeline

Every lifeline span carries ``parent="request"`` so the goodput
accounting keeps treating them as detail (they re-describe wall-clock
the ``prefill``/``decode_block`` spans already account); old streams
without them aggregate byte-identically.

``TPUDIST_TRACE=0`` disarms lifeline emission (trace_ids still mint —
a 16-hex id per request is noise-level); the observability bench
measures the armed cost (``BENCH_OBS``).

:func:`export_chrome_trace` renders the joined records as Chrome
trace-event JSON (Perfetto/chrome://tracing loadable): one process row
per (rank, pool), one thread row per worker, complete ("X") events for
the lifeline spans, instant events for ``lane_recovered``, and flow
arrows ("s"/"t"/"f") stitching each trace_id across rows.

Stdlib-only; importable without jax.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ENV_TRACE = "TPUDIST_TRACE"


def enabled_from_env() -> bool:
    """Lifeline emission is armed by default whenever telemetry is;
    ``TPUDIST_TRACE=0`` disarms just the per-request spans."""
    from tpudist_torch.utils.envutil import env_flag

    return env_flag(ENV_TRACE, True)


#: Cached arm flag — the emitter runs on the serving loop's finish path
#: and must not re-read the environment per request (the metrics._SLO
#: discipline).  Refreshed by :func:`arm_from_env`, which
#: ``metrics.arm_from_env`` (and through it every session construction)
#: calls.
_ARMED = True


def arm_from_env() -> bool:
    global _ARMED
    _ARMED = enabled_from_env()
    return _ARMED


def new_trace_id() -> str:
    """16 hex chars of OS entropy — unique across processes/pools
    without coordination (the property the cross-pool join needs)."""
    return os.urandom(8).hex()


# -- lifeline emission (called by the serving loops at request finish) -------

def emit_request_lifeline(handle) -> None:
    """Emit the ``req_*`` spans for a finished request from its
    handle's timestamps (module doc).  No-op when telemetry is
    disarmed, ``TPUDIST_TRACE=0``, or the handle never got admitted.
    Never raises — observability must not take the serving loop down."""
    from tpudist_torch.telemetry import spans

    s = spans.active()
    if s is None or not _ARMED:
        return
    try:
        _emit_lifeline(s, handle)
    except Exception:
        pass


def _emit_lifeline(s, h) -> None:
    tid = getattr(h, "trace_id", None)
    if not tid:
        return
    req = h.request
    base = {"trace_id": tid}
    tenant = getattr(req, "tenant", None)
    if tenant:
        base["tenant"] = tenant

    def span(name: str, t0: Optional[float], t1: Optional[float], **tags):
        if t0 is None or t1 is None:
            return
        tags = {k: v for k, v in tags.items() if v is not None}
        s.record_span(name, t0, max(0.0, t1 - t0), {**base, **tags},
                      parent="request")

    span("req_queue", h.t_submit, h.t_admitted)
    if h.t_prefill_done is not None:
        # disaggregated path: prefill pool → handoff → decode pool
        span("req_prefill", h.t_admitted, h.t_prefill_done,
             worker=getattr(h, "prefill_worker", None))
        span("req_handoff", h.t_prefill_done,
             h.t_decode_start if h.t_decode_start is not None else h.t_done)
        segs = getattr(h, "decode_segments", None) or []
        for worker, t0, t1 in segs:
            span("req_decode", t0, t1 if t1 is not None else h.t_done,
                 worker=worker)
    else:
        # single-pool path: prefill ends at token 0
        span("req_prefill", h.t_admitted, h.t_first_token)
        span("req_decode", h.t_first_token, h.t_done)


# -- cross-pool join ----------------------------------------------------------

def join_traces(records: List[dict]) -> Dict[str, List[dict]]:
    """Group records by ``trace_id`` (spans AND events — the recovery
    ``lane_recovered`` markers ride along), each trace's records sorted
    on the shared wall-clock axis.  This is the aggregator-side join:
    records from different ranks/pools/generations land in one lifeline
    because the trace_id crossed the process boundary in the handoff
    package."""
    by: Dict[str, List[dict]] = {}
    for r in records:
        tid = r.get("trace_id")
        if isinstance(tid, str) and tid:
            by.setdefault(tid, []).append(r)
    for recs in by.values():
        recs.sort(key=lambda r: float(r.get("t", 0.0)))
    return by


# -- Chrome trace export ------------------------------------------------------

#: Track (pid) assignment: the lifeline names map onto the pool a
#: request was in at that moment.
_POOL_OF_SPAN = {
    "req_queue": "admission queue",
    "req_prefill": "prefill pool",
    "req_handoff": "handoff queue",
    "req_decode": "decode pool",
}


def to_chrome_trace(records: List[dict]) -> dict:
    """Render joined per-request records as Chrome trace-event JSON
    (module doc).  Only trace_id-tagged records contribute; a stream
    without any yields an empty (but still loadable) trace."""
    traces = join_traces(records)
    events: List[dict] = []
    pids: Dict[Tuple[int, str], int] = {}
    tids_named = set()

    def pid_of(rank: int, pool: str) -> int:
        key = (rank, pool)
        if key not in pids:
            pids[key] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[key], "tid": 0,
                           "args": {"name": f"{pool} (rank {rank})"}})
        return pids[key]

    def tid_of(pid: int, worker) -> int:
        tid = int(worker) if isinstance(worker, int) else 0
        if (pid, tid) not in tids_named:
            tids_named.add((pid, tid))
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tid,
                           "args": {"name": f"worker {tid}"}})
        return tid

    for tid_hex, recs in sorted(traces.items()):
        flow_id = int(tid_hex[:8], 16) or 1
        slices = []
        for r in recs:
            rank = int(r.get("rank", 0))
            ts_us = float(r.get("t", 0.0)) * 1e6
            if r.get("kind") == "span" and r.get("name") in _POOL_OF_SPAN:
                pid = pid_of(rank, _POOL_OF_SPAN[r["name"]])
                tid = tid_of(pid, r.get("worker"))
                args = {k: v for k, v in r.items()
                        if k not in ("kind", "t", "dur", "parent")}
                events.append({
                    "ph": "X", "name": r["name"], "cat": "request",
                    "pid": pid, "tid": tid, "ts": ts_us,
                    "dur": max(0.001, float(r.get("dur", 0.0)) * 1e6),
                    "args": args,
                })
                slices.append((ts_us, pid, tid))
            elif r.get("kind") == "event" and r.get("name") == "lane_recovered":
                pool = r.get("pool")
                pool = f"{pool} pool" if isinstance(pool, str) else "decode pool"
                pid = pid_of(rank, pool)
                tid = tid_of(pid, r.get("worker"))
                events.append({
                    "ph": "i", "name": "lane_recovered", "cat": "recovery",
                    "pid": pid, "tid": tid, "ts": ts_us, "s": "p",
                    "args": {k: v for k, v in r.items()
                             if k not in ("kind", "t", "dur")},
                })
        # flow arrows: stitch the lifeline across tracks in slice order
        for i, (ts_us, pid, tid) in enumerate(slices):
            ph = "s" if i == 0 else ("f" if i == len(slices) - 1 else "t")
            if len(slices) < 2:
                break
            ev = {"ph": ph, "name": "request", "cat": "request",
                  "id": flow_id, "pid": pid, "tid": tid,
                  # land the flow binding INSIDE the slice it decorates
                  "ts": ts_us + 0.0005}
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"tool": "tpudist.telemetry.trace",
                          "traces": len(traces)}}


def export_chrome_trace(run_dir: "str | Path",
                        out_path: "str | Path | None" = None) -> Path:
    """Aggregate a run's telemetry JSONL and write the Perfetto-loadable
    Chrome trace next to it (default ``<telemetry dir>/trace.json``).
    Returns the written path."""
    from tpudist_torch.telemetry.aggregate import find_telemetry_dir, load_records

    tdir = find_telemetry_dir(run_dir)
    records = load_records(tdir)
    trace = to_chrome_trace(records)
    out = Path(out_path) if out_path is not None else tdir / "trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(trace) + "\n")
    return out
