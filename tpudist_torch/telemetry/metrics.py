"""Live metrics: the ONLINE half of the telemetry subsystem.

The spans/aggregate pipeline is post-hoc — per-rank JSONL becomes a
report after the run ends.  This module is the in-process registry a
LIVE consumer reads mid-run: the ``/metrics`` scrape endpoint
(:mod:`tpudist.telemetry.statusz`), the SLO attainment gauges the
admission controller (ROADMAP item 2) will consult, and the serving
report's own sanity check (live percentiles must agree with the
post-hoc aggregator within the sketch resolution — tested).

Three metric kinds, all label-aware (``pool=``, ``tenant=``,
``generation=``, arbitrary):

- :class:`Counter` — monotone float (requests finished, tokens out,
  telemetry drops);
- :class:`Gauge` — last-write-wins float (slot occupancy, KV bytes
  resident, SLO attainment);
- :class:`Histogram` — a **mergeable fixed log-bucket quantile sketch**:
  values land in geometric buckets (``GROWTH`` per bucket, 8 per
  octave), so merging two sketches is elementwise count addition —
  EXACT, which is what makes cross-rank/cross-pool aggregation a sum
  rather than an approximation-of-approximations.  Quantiles come back
  as the geometric midpoint of the bucket holding the nearest-rank
  order statistic, so any quantile agrees with the exact nearest-rank
  percentile (``tpudist.telemetry.aggregate._percentile``) within the
  relative bound :data:`QUANTILE_REL_ERROR` (≈4.4%) for values in
  [:data:`BUCKET_LO`, ~3900 s] — the quoted resolution the tests pin.

Concurrency contract (lock-light): writers take one tiny per-metric
lock per update; ``snapshot()`` and ``render_prometheus()`` are
WAIT-FREE for readers — they copy the registry dict (atomic under the
GIL) and read plain ints/floats without acquiring anything, so a
scrape can never stall the engine thread behind it.

Feeding: the registry is populated from the EXISTING span/event seams —
:mod:`tpudist.telemetry.spans` calls :func:`feed_record` (when armed)
for every record it emits, so the instrumented sites (``decode_block``,
``prefill``, ``kv_handoff``, ``request_finished``, ``ckpt_save``,
``step``) did not change.  ``TPUDIST_METRICS=0`` disarms the feed;
disarmed cost at the span site is one module-attribute load + None
check (the telemetry discipline).

SLO layer: declared targets (``TPUDIST_SLO_TTFT_MS`` /
``TPUDIST_SLO_TPOT_MS``) turn every ``request_finished`` into per-tenant
ok/total counters and a live ``tpudist_slo_attainment`` gauge — the
measurement surface SLO-aware admission reads.

Dependency-free (stdlib only), importable without jax.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# -- sketch geometry ----------------------------------------------------------

#: Geometric bucket growth: 8 buckets per octave.
GROWTH = 2.0 ** 0.125
#: Upper edge of bucket 0 (values at or below land there): 1 µs.
BUCKET_LO = 1e-6
#: Bucket count; the top regular bucket edge is
#: ``BUCKET_LO * GROWTH**(NBUCKETS-1)`` ≈ 3.9e3 s.
NBUCKETS = 256
#: Quoted quantile agreement bound vs the exact nearest-rank percentile:
#: a quantile from the sketch is the geometric midpoint of the bucket
#: holding the exact order statistic, so ``|sketch - exact| <=
#: QUANTILE_REL_ERROR * exact`` for exact values in
#: ``[BUCKET_LO, BUCKET_LO * GROWTH**(NBUCKETS-1)]``.
QUANTILE_REL_ERROR = GROWTH ** 0.5 - 1.0

_LOG_GROWTH = math.log(GROWTH)
_LOG_LO = math.log(BUCKET_LO)

ENV_METRICS = "TPUDIST_METRICS"
ENV_SLO_TTFT = "TPUDIST_SLO_TTFT_MS"
ENV_SLO_TPOT = "TPUDIST_SLO_TPOT_MS"


def bucket_index(v: float) -> int:
    """Bucket of value ``v``: 0 holds ``(-inf, BUCKET_LO]``; bucket i>0
    holds ``(BUCKET_LO*GROWTH**(i-1), BUCKET_LO*GROWTH**i]``; the top
    bucket is open-ended."""
    if v <= BUCKET_LO:
        return 0
    idx = 1 + int(math.floor((math.log(v) - _LOG_LO) / _LOG_GROWTH))
    # float-edge guard: a value sitting exactly on a bucket edge must
    # land in the bucket whose upper edge it is
    if v <= BUCKET_LO * GROWTH ** (idx - 1):
        idx -= 1
    return min(max(idx, 0), NBUCKETS - 1)


def bucket_value(idx: int) -> float:
    """Representative (geometric midpoint) of bucket ``idx`` — what a
    quantile query returns."""
    if idx <= 0:
        return BUCKET_LO
    return BUCKET_LO * GROWTH ** (idx - 0.5)


class Counter:
    """Monotone counter.  ``inc`` takes the per-metric lock; ``value``
    is a wait-free read."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins value (occupancy, attainment, queue depth) —
    a single GIL-atomic assignment, no lock (no read-modify-write)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Mergeable fixed log-bucket quantile sketch (module doc).

    ``observe`` is the writer path (one lock); ``quantile``/``summary``
    read the bucket array without locking — a reader racing a writer
    sees a sketch at most one observation stale, never a torn one
    (list-of-int reads are atomic under the GIL)."""

    __slots__ = ("_lock", "buckets", "count", "sum", "min", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self.buckets = [0] * NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float, n: int = 1) -> None:
        """Record ``v`` (``n`` times — a scanned train window covering
        K steps observes its per-step mean with weight K, matching the
        post-hoc aggregator's window weighting at one bucket update)."""
        v = float(v)
        idx = bucket_index(v)
        with self._lock:
            self.buckets[idx] += n
            self.count += n
            self.sum += v * n
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def merge(self, other: "Histogram") -> None:
        """Elementwise bucket addition — EXACT (the log-bucket layout is
        shared by construction, so cross-rank/cross-pool merge loses
        nothing the individual sketches had)."""
        # snapshot the source under ITS lock first (sequential acquire,
        # never nested — no ordering deadlock): merging a LIVE sketch
        # must not tear count away from the bucket totals, or quantile()
        # walks past every bucket and reports the top edge
        with other._lock:
            ob = list(other.buckets)
            ocount, osum = other.count, other.sum
            omin, omax = other.min, other.max
        with self._lock:
            for i in range(NBUCKETS):
                self.buckets[i] += ob[i]
            self.count += ocount
            self.sum += osum
            self.min = min(self.min, omin)
            self.max = max(self.max, omax)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile (``aggregate._percentile``'s index
        convention, so the chosen bucket CONTAINS the exact order
        statistic) returned as the bucket's geometric midpoint — within
        :data:`QUANTILE_REL_ERROR` of the exact value."""
        count = self.count
        if count <= 0:
            return 0.0
        rank = int(round(q / 100.0 * (count - 1)))
        rank = max(0, min(count - 1, rank))
        seen = 0
        for i, c in enumerate(self.buckets):
            seen += c
            if seen > rank:
                return bucket_value(i)
        return bucket_value(NBUCKETS - 1)

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": round(self.sum, 9),
            "mean": round(self.sum / self.count, 9),
            "min": round(self.min, 9),
            "max": round(self.max, 9),
            "p50": round(self.quantile(50), 9),
            "p95": round(self.quantile(95), 9),
            "p99": round(self.quantile(99), 9),
        }


_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: _LabelKey, extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(key) + ([extra] if extra else [])
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt_value(v: float) -> str:
    """Exposition-format a sample value: integral values as bare ints,
    floats at full precision (repr) — ``%g``'s 6 significant digits
    would freeze a counter past ~1e6 (small increments invisible
    between scrapes, so ``rate()`` reads 0 then spikes)."""
    f = float(v)
    if f.is_integer() and abs(f) < 2 ** 63:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Name+labels → metric instance.  Creation takes the registry
    lock once per NEW (name, labels) pair; the common path (metric
    exists) is a dict read.  ``snapshot``/``render_prometheus`` copy
    the dict (atomic under the GIL) and read without locks."""

    def __init__(self):
        self._lock = threading.Lock()
        #: (kind, name, label_key) → metric
        self._metrics: Dict[Tuple[str, str, _LabelKey], object] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict[str, object]):
        key = (kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls()
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def clear(self) -> None:
        """Drop every metric (tests; a long-lived process keeps its
        registry across telemetry sessions on purpose)."""
        with self._lock:
            self._metrics = {}
        _TENANTS_SEEN.clear()
        _ADAPTERS_SEEN.clear()

    # -- readers (wait-free) ------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-safe view of everything: counters/gauges as floats,
        histograms as count/sum/min/max/p50/p95/p99.  Never blocks a
        writer and is never blocked by one."""
        metrics = dict(self._metrics)  # atomic copy under the GIL
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, lkey), m in sorted(metrics.items(),
                                            key=lambda kv: kv[0]):
            label = name + _fmt_labels(lkey)
            if kind == "counter":
                out["counters"][label] = m.value
            elif kind == "gauge":
                out["gauges"][label] = m.value
            else:
                out["histograms"][label] = m.summary()
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4).  Counters and
        gauges one line each; histograms render as SUMMARY metrics
        (quantile series + ``_sum``/``_count``) — 5 lines instead of
        256 cumulative buckets per sketch."""
        metrics = dict(self._metrics)
        by_name: Dict[Tuple[str, str], List[Tuple[_LabelKey, object]]] = {}
        for (kind, name, lkey), m in metrics.items():
            by_name.setdefault((kind, name), []).append((lkey, m))
        lines: List[str] = []
        for (kind, name) in sorted(by_name):
            rows = sorted(by_name[(kind, name)], key=lambda kv: kv[0])
            if kind in ("counter", "gauge"):
                lines.append(f"# TYPE {name} {kind}")
                for lkey, m in rows:
                    lines.append(
                        f"{name}{_fmt_labels(lkey)} {_fmt_value(m.value)}")
            else:
                lines.append(f"# TYPE {name} summary")
                for lkey, m in rows:
                    for q in (0.5, 0.95, 0.99):
                        lines.append(
                            f"{name}{_fmt_labels(lkey, ('quantile', f'{q:g}'))}"
                            f" {_fmt_value(m.quantile(q * 100))}")
                    lines.append(f"{name}_sum{_fmt_labels(lkey)} "
                                 f"{_fmt_value(m.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(lkey)} {m.count}")
        return "\n".join(lines) + "\n"


#: The process-wide registry every feeder/scraper shares.  Long-lived on
#: purpose: a restarting telemetry session does not zero the gauges a
#: live scraper is watching.
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


# -- SLO targets --------------------------------------------------------------

def slo_targets() -> Dict[str, Optional[float]]:
    """Declared latency targets in SECONDS from the ``TPUDIST_SLO_*_MS``
    knobs (unset / <= 0 = no target for that metric)."""
    from tpudist_torch.utils.envutil import env_positive_float

    ttft_ms = env_positive_float(ENV_SLO_TTFT, None)
    tpot_ms = env_positive_float(ENV_SLO_TPOT, None)
    return {
        "ttft_s": ttft_ms / 1e3 if ttft_ms else None,
        "tpot_s": tpot_ms / 1e3 if tpot_ms else None,
    }


#: Cached targets, resolved once at arm time (the feeder runs on hot
#: paths; it must not re-read the environment per request).
_SLO: Dict[str, Optional[float]] = {"ttft_s": None, "tpot_s": None}


def slo_attainment() -> Dict[Tuple[str, str], float]:
    """The LIVE per-tenant SLO attainment gauges, as ``(metric, tenant)
    -> value`` — the read surface the SLO-aware admission controller
    (:mod:`tpudist.serve.overload`) acts on.  Wait-free like every
    registry read (one GIL-atomic dict copy, no locks)."""
    out: Dict[Tuple[str, str], float] = {}
    for (kind, name, lkey), m in dict(_REGISTRY._metrics).items():
        if kind == "gauge" and name == "tpudist_slo_attainment":
            lab = dict(lkey)
            out[(lab.get("metric", "?"),
                 lab.get("tenant", "default"))] = m.value
    return out


# -- the span/event → metrics feeder -----------------------------------------

def _pool_label(rec: dict) -> Dict[str, str]:
    p = rec.get("pool")
    return {"pool": p} if isinstance(p, str) else {}


#: Distinct-tenant label bound: tenant strings are CALLER data, and each
#: new label set allocates sketches that live for the process — a client
#: passing per-user UUIDs as tenants would grow memory and scrape size
#: without limit.  Tenants past the cap pool under ``"other"`` (their
#: requests still count; only the per-tenant split saturates).
TENANT_LABEL_CAP = 64
_TENANTS_SEEN: set = set()


def _tenant_label(rec: dict) -> Dict[str, str]:
    t = rec.get("tenant")
    t = t if isinstance(t, str) and t else "default"
    if t not in _TENANTS_SEEN:
        if len(_TENANTS_SEEN) >= TENANT_LABEL_CAP:
            return {"tenant": "other"}
        _TENANTS_SEEN.add(t)
    return {"tenant": t}


#: Distinct-adapter label bound (the TENANT_LABEL_CAP rule applied to
#: adapter names): resident adapters are bounded by the pool, but the
#: set of names EVER loaded is not — overflow pools under "other".
ADAPTER_LABEL_CAP = 64
_ADAPTERS_SEEN: set = set()


def _adapter_label(rec: dict) -> Dict[str, str]:
    a = rec.get("adapter")
    a = a if isinstance(a, str) and a else "?"
    if a not in _ADAPTERS_SEEN:
        if len(_ADAPTERS_SEEN) >= ADAPTER_LABEL_CAP:
            return {"adapter": "other"}
        _ADAPTERS_SEEN.add(a)
    return {"adapter": a}


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) else None


def feed_record(rec: dict) -> None:
    """Map one telemetry record (the spans.py schema) onto the registry.
    Called from ``TelemetrySession._emit`` when armed — the instrumented
    sites themselves did not change for the live plane.  Must never
    raise into the emitter (defensive isinstance checks, and the caller
    guards anyway)."""
    r = _REGISTRY
    kind = rec.get("kind")
    name = rec.get("name")
    if kind == "span":
        dur = _num(rec.get("dur")) or 0.0
        if name == "step":
            n = _num(rec.get("steps"))
            n = max(1, int(n)) if n else 1
            r.counter("tpudist_train_steps_total").inc(n)
            # per-step mean, weighted by the steps the window covered —
            # the aggregator's _step_stats convention
            r.histogram("tpudist_step_seconds").observe(dur / n, n)
        elif name in ("decode_block", "decode_step", "spec_verify"):
            lab = _pool_label(rec)
            r.counter("tpudist_decode_blocks_total", **lab).inc()
            toks = rec.get("tokens")
            if isinstance(toks, (int, float)):
                r.counter("tpudist_decode_tokens_total", **lab).inc(int(toks))
            r.histogram("tpudist_decode_block_seconds", **lab).observe(dur)
            occ = rec.get("occupancy")
            if isinstance(occ, (int, float)):
                r.gauge("tpudist_slot_occupancy", **lab).set(float(occ))
            kvb = rec.get("kv_bytes_resident")
            if isinstance(kvb, (int, float)):
                r.gauge("tpudist_kv_bytes_resident", **lab).set(float(kvb))
            if name == "spec_verify":
                acc = rec.get("accepted")
                if isinstance(acc, (int, float)):
                    r.counter("tpudist_spec_accepted_total", **lab).inc(int(acc))
                drafted = rec.get("drafted")
                if isinstance(drafted, (int, float)) and drafted:
                    r.counter("tpudist_spec_drafted_total",
                              **lab).inc(int(drafted))
                    # live acceptance — the SAME number the distill
                    # swap gate reads, cumulative over the counters so
                    # a scrape and the gate can never disagree
                    a = r.counter("tpudist_spec_accepted_total",
                                  **lab).value
                    d = r.counter("tpudist_spec_drafted_total",
                                  **lab).value
                    if d:
                        r.gauge("tpudist_spec_accept_rate",
                                **lab).set(a / d)
                by_ad = rec.get("accept_by_adapter")
                if isinstance(by_ad, dict):
                    # per-adapter labeled acceptance (bounded like the
                    # adapter residency gauges — the label-cap rule)
                    for ad, pair in by_ad.items():
                        if not (isinstance(pair, (list, tuple))
                                and len(pair) == 2):
                            continue
                        alab = _adapter_label({"adapter": ad})
                        ca = r.counter("tpudist_spec_accepted_total",
                                       **alab)
                        cd = r.counter("tpudist_spec_drafted_total",
                                       **alab)
                        ca.inc(int(pair[0]))
                        cd.inc(int(pair[1]))
                        if cd.value:
                            r.gauge("tpudist_spec_accept_rate",
                                    **alab).set(ca.value / cd.value)
        elif name == "prefill":
            lab = _pool_label(rec)
            r.counter("tpudist_prefill_dispatches_total", **lab).inc()
            r.histogram("tpudist_prefill_seconds", **lab).observe(dur)
        elif name in ("ckpt_save", "ckpt_restore", "ckpt_wait"):
            r.histogram("tpudist_ckpt_seconds", op=name[5:]).observe(dur)
        elif name == "data_wait":
            r.histogram("tpudist_data_wait_seconds").observe(dur)
        return
    # events
    if name == "request_finished":
        tlab = _tenant_label(rec)
        reason = str(rec.get("reason"))
        r.counter("tpudist_requests_finished_total",
                  reason=reason, **tlab).inc()
        toks = rec.get("tokens_out")
        if isinstance(toks, (int, float)):
            r.counter("tpudist_tokens_out_total", **tlab).inc(int(toks))
        for key, metric in (("ttft_s", "tpudist_ttft_seconds"),
                            ("tpot_s", "tpudist_tpot_seconds"),
                            ("queue_wait_s", "tpudist_queue_wait_seconds"),
                            ("handoff_wait_s", "tpudist_handoff_wait_seconds")):
            v = rec.get(key)
            if isinstance(v, (int, float)):
                r.histogram(metric, **tlab).observe(float(v))
        # SLO attainment: per declared target, per tenant — the live
        # gauge the admission controller (ROADMAP item 2) reads
        for key, slo_name in (("ttft_s", "ttft"), ("tpot_s", "tpot")):
            target = _SLO.get(key)
            v = rec.get(key)
            if target is None or not isinstance(v, (int, float)):
                continue
            total = r.counter(f"tpudist_slo_{slo_name}_total", **tlab)
            ok = r.counter(f"tpudist_slo_{slo_name}_ok_total", **tlab)
            total.inc()
            if float(v) <= target:
                ok.inc()
            r.gauge("tpudist_slo_attainment", metric=slo_name,
                    **tlab).set(ok.value / total.value)
    elif name == "serve_rejected":
        reason = str(rec.get("reason", "")).split(":")[0] or "unknown"
        r.counter("tpudist_requests_rejected_total", reason=reason).inc()
    elif name == "kv_handoff":
        r.counter("tpudist_kv_handoffs_total").inc()
        imp = rec.get("import_s")
        if isinstance(imp, (int, float)):
            r.histogram("tpudist_handoff_import_seconds").observe(float(imp))
    elif name in ("adapter_load", "adapter_evict"):
        # per-tenant adapter pool (tpudist.serve.adapters): load/evict
        # counters, a per-adapter residency gauge, and the total-
        # resident gauge riding ON the events.  The per-adapter label
        # is CAPPED like tenants: only the pool's RESIDENT set is
        # bounded — a long-lived server churning thousands of names
        # through load→evict would otherwise grow one dead 0-gauge per
        # historical name without limit
        alab = _adapter_label(rec)
        if name == "adapter_load":
            r.counter("tpudist_adapter_loads_total").inc()
            r.gauge("tpudist_adapter_resident", **alab).set(1.0)
        else:
            r.counter("tpudist_adapter_evicts_total",
                      kind=str(rec.get("evict_kind", "?"))).inc()
            r.gauge("tpudist_adapter_resident", **alab).set(0.0)
        v = rec.get("resident")
        if isinstance(v, (int, float)):
            r.gauge("tpudist_serve_adapters_resident").set(float(v))
    elif name == "draft_swap":
        # online draft distillation: one count per APPLIED gated swap
        # (rejected candidates never get here — the distill_round
        # event stream carries those)
        r.counter("tpudist_draft_swaps_total").inc()
    elif name == "worker_lost":
        r.counter("tpudist_workers_lost_total", **_pool_label(rec)).inc()
    elif name == "lane_recovered":
        r.counter("tpudist_lanes_recovered_total", **_pool_label(rec)).inc()
    elif name == "pool_resize":
        r.counter("tpudist_pool_resizes_total", **_pool_label(rec)).inc()
    elif name == "telemetry_dropped":
        for k in ("ring", "write"):
            v = rec.get(k)
            if isinstance(v, (int, float)) and v:
                r.counter("tpudist_telemetry_dropped_total", kind=k).inc(v)
    # host-RAM KV tier + overload control (tpudist.serve.host_tier /
    # .overload): park/resume/spill/corruption counters, plus the
    # occupancy gauges riding ON the events (the tier has no feed of
    # its own — the server stamps tier_bytes/tier_entries into each
    # park/resume event, so a scrape tracks occupancy with zero new
    # instrumentation seams)
    elif name in ("session_parked", "session_resumed", "host_tier_spill",
                  "session_expired", "host_tier_corrupt", "preempted",
                  "shed_state"):
        kind_lab = ({"kind": str(rec["park_kind"])}
                    if isinstance(rec.get("park_kind"), str) else {})
        if name == "session_parked":
            r.counter("tpudist_host_tier_parks_total", **kind_lab).inc()
        elif name == "session_resumed":
            r.counter("tpudist_host_tier_resumes_total", **kind_lab).inc()
        elif name == "host_tier_spill":
            r.counter("tpudist_host_tier_spills_total").inc(
                int(rec.get("entries", 1) or 1))
        elif name == "session_expired":
            r.counter("tpudist_host_tier_expired_total").inc(
                int(rec.get("entries", 1) or 1))
        elif name == "host_tier_corrupt":
            r.counter("tpudist_host_tier_corrupt_total").inc()
        elif name == "preempted":
            r.counter("tpudist_requests_preempted_total").inc()
        elif name == "shed_state":
            r.gauge("tpudist_shed_active").set(
                1.0 if rec.get("active") else 0.0)
        for key, gname in (("tier_bytes", "tpudist_host_tier_bytes"),
                           ("tier_entries", "tpudist_host_tier_entries")):
            v = rec.get(key)
            if isinstance(v, (int, float)):
                r.gauge(gname).set(float(v))
    # fleet router (tpudist.serve.router): routing/failover counters +
    # the replicas-up gauge riding ON the replica_health events (the
    # router has no feed of its own — same zero-new-seams discipline as
    # the host tier above)
    elif name == "router_config":
        v = rec.get("replicas")
        if isinstance(v, (int, float)):
            r.gauge("tpudist_router_replicas").set(float(v))
    elif name == "router_route":
        r.counter("tpudist_router_routed_total",
                  kind=str(rec.get("route_kind", "?"))).inc()
    elif name == "router_spill":
        r.counter("tpudist_router_spills_total").inc()
    elif name == "router_retry":
        r.counter("tpudist_router_retries_total").inc()
    elif name == "replica_health":
        if not rec.get("up"):
            r.counter("tpudist_router_replica_deaths_total").inc()
        v = rec.get("ups")
        if isinstance(v, (int, float)):
            r.gauge("tpudist_router_replicas_up").set(float(v))
    elif name == "session_migrated":
        r.counter("tpudist_router_sessions_migrated_total",
                  ok=str(bool(rec.get("ok"))).lower()).inc()


def set_train_gauges(iteration: int, values: Dict[str, float]) -> None:
    """Publish training progress to the live registry (no-op when the
    feed is disarmed): the ``tpudist_train_iteration`` gauge plus one
    ``tpudist_train_<key>`` gauge per logged metric, keys sanitized to
    the Prometheus charset.  The one naming/sanitization rule for BOTH
    training flush paths (per-step and scanned — see train/loop.py)."""
    if not armed():
        return
    r = _REGISTRY
    r.gauge("tpudist_train_iteration").set(iteration)
    for k, v in values.items():
        name = "".join(c if c.isalnum() or c == "_" else "_"
                       for c in str(k))
        r.gauge(f"tpudist_train_{name}").set(float(v))


# -- arming -------------------------------------------------------------------

def enabled_from_env() -> bool:
    """The feed is armed by default whenever telemetry is;
    ``TPUDIST_METRICS=0`` disarms just the live registry."""
    from tpudist_torch.utils.envutil import env_flag

    return env_flag(ENV_METRICS, True)


def armed() -> bool:
    from tpudist_torch.telemetry import spans

    return spans._SINK is not None


def arm_from_env() -> bool:
    """Install :func:`feed_record` as the span/event sink (idempotent)
    and cache the SLO targets.  Called by every
    :class:`~tpudist.telemetry.spans.TelemetrySession` construction, so
    any armed process feeds the live registry with zero site changes.
    Also refreshes the trace module's cached arm flag — one arming
    entry point for the whole live plane."""
    from tpudist_torch.telemetry import spans, trace

    global _SLO
    trace.arm_from_env()
    if not enabled_from_env():
        spans._SINK = None
        return False
    _SLO = slo_targets()
    spans._SINK = feed_record
    return True


def disarm() -> None:
    from tpudist_torch.telemetry import spans

    spans._SINK = None
