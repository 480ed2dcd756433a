"""SLO-aware admission control: measure, then schedule against the
measurement.  The port of ``tpudist/serve/overload.py``, copied whole: it
is framework-free (``math``, ``time``) and reads the port's live gauges
(:func:`tpudist_torch.telemetry.metrics.slo_attainment`).

The live observability plane turned every ``request_finished``
into per-tenant SLO-attainment gauges (``tpudist_slo_attainment``, fed
from the declared ``TPUDIST_SLO_TTFT_MS``/``TPUDIST_SLO_TPOT_MS``
targets).  This module is the consumer those gauges were built for —
the serving loops' reject-with-reason gate stops guessing and acts on
what the registry measured (the AMP lesson: a measured cost model beats
heuristics; the DDP/FSDP-characterization lesson: schedule against the
measurement):

- **load shedding** — a *protected* priority class is declared
  (``shed_priority``; a tenant is protected while it has recent traffic
  at or above it).  When any protected tenant's LIVE attainment gauge
  falls below ``shed_attainment``, shedding activates: new
  lower-priority submits reject with reason ``"shed_load"`` and queued
  lower-priority work is finished with the same reason — overload
  degrades the bulk class explicitly instead of degrading everyone's
  SLO silently.  Every flip emits a ``shed_state`` event carrying the
  gauge values that drove it, so the decision is auditable from the
  telemetry stream alone;
- **per-tenant token-rate fairness** — an EWMA tokens/s rate per tenant;
  once the queue is under pressure (more than half full), a tenant
  drawing more than ``fair_share ×`` its equal share of the total
  measured rate rejects with reason ``"fair_share"`` (``0`` disables —
  the default).

Both gates are consulted synchronously at submit (under the scheduler
lock) and must stay cheap: the attainment read is a cached flag
refreshed by :meth:`OverloadController.tick` from the engine loop, and
the rate update is two float ops.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

#: Shed-state refresh cadence: gauge reads per tick are cheap, but the
#: engine loop can spin at kHz while idle — no need to rescan faster.
_TICK_EVERY_S = 0.05

#: A tenant stays "protected" this long after its last at-or-above-
#: protect-priority submit (a gold tenant that pauses between turns must
#: not lose its protection mid-conversation).
_PROTECT_WINDOW_S = 30.0


class OverloadController:
    """The SLO-aware shed + fair-share gate (module doc).

    Thread contract: ``gate``/``note_submit`` run under the scheduler
    lock from submit threads; ``tick``/``note_tokens`` from the engine
    loop.  Shared state is plain floats/dicts mutated GIL-atomically —
    a stale-by-one-tick read is fine, a lock on the submit path is not.
    """

    def __init__(self, *, shed: bool = True, shed_attainment: float = 0.9,
                 shed_priority: int = 1, fair_share: float = 0.0,
                 rate_window_s: float = 5.0, queue_limit: int = 64):
        self.queue_limit = int(queue_limit)
        self.shed = bool(shed)
        self.shed_attainment = float(shed_attainment)
        self.shed_priority = int(shed_priority)
        self.fair_share = float(fair_share)
        self.rate_window_s = float(rate_window_s)
        self.shed_active = False
        #: the gauge readings that drove the last flip (audit trail)
        self.last_attainment: Dict[str, float] = {}
        self.sheds = 0          # queued requests shed (server increments)
        self.shed_rejects = 0   # submits rejected "shed_load"
        self.fair_rejects = 0   # submits rejected "fair_share"
        self.flips = 0
        self._protected: Dict[str, float] = {}  # tenant -> last seen t
        self._rates: Dict[str, list] = {}  # tenant -> [ewma_tps, last_t]
        self._last_tick = 0.0
        #: fair-share threshold cache, refreshed by tick(): (per-tenant
        #: equal share × multiplier, active tenant count).  gate() runs
        #: under the scheduler lock on every submit — it must read two
        #: cached floats, never rebuild an O(#tenants) dict there.
        self._fair_threshold = 0.0
        self._fair_tenants = 0

    # -- submit-side (under the scheduler lock) ------------------------------

    def note_submit(self, priority: int, tenant: Optional[str],
                    now: Optional[float] = None) -> None:
        if priority >= self.shed_priority:
            self._protected[tenant or "default"] = \
                time.monotonic() if now is None else now

    def gate(self, req, pending: int) -> Optional[str]:
        """The scheduler's ``admission_gate``: a machine-readable reject
        reason, or ``None`` to admit.  Protected-class requests are
        never shed (that is the point); fair-share applies to everyone
        once the queue is under pressure."""
        self.note_submit(req.priority, req.tenant)
        if (self.shed and self.shed_active
                and req.priority < self.shed_priority):
            self.shed_rejects += 1
            return "shed_load"
        if (self.fair_share > 0 and pending * 2 >= self.queue_limit
                and self._fair_tenants > 1 and self._fair_threshold > 0):
            r = self._rates.get(req.tenant or "default")
            if r is not None and r[0] > self._fair_threshold:
                self.fair_rejects += 1
                return (f"fair_share: tenant {req.tenant or 'default'} "
                        f"at {r[0]:.1f} tok/s > {self.fair_share:.1f}x "
                        f"equal share over {self._fair_tenants} tenants")
        return None

    # -- engine-loop side ----------------------------------------------------

    def note_tokens(self, tenant: Optional[str], n: int,
                    now: Optional[float] = None) -> None:
        """Fold ``n`` delivered tokens into the tenant's EWMA tokens/s
        (half-life ``rate_window_s``) — the fairness gate's measurement."""
        now = time.monotonic() if now is None else now
        r = self._rates.get(tenant or "default")
        if r is None:
            self._rates[tenant or "default"] = [n / self.rate_window_s, now]
            return
        dt = max(now - r[1], 1e-6)
        decay = math.exp(-dt / self.rate_window_s)
        r[0] = r[0] * decay + n / self.rate_window_s
        r[1] = now

    def shed_predicate(self, handle) -> bool:
        """Queued-work shed rule: everything below the protected class."""
        return handle.request.priority < self.shed_priority

    def tick(self, now: Optional[float] = None) -> bool:
        """Refresh ``shed_active`` from the LIVE per-tenant attainment
        gauges (:func:`tpudist_torch.telemetry.metrics.slo_attainment`) —
        called from the engine loop every iteration, rescans at most
        every ``_TICK_EVERY_S``.  Returns True when the state flipped
        (the server emits the ``shed_state`` event with the readings
        that drove it).  Also the upkeep point for the bounded
        controller state and the fair-share threshold cache — those
        refresh whether or not shedding is enabled."""
        now = time.monotonic() if now is None else now
        if now - self._last_tick < _TICK_EVERY_S:
            return False
        self._last_tick = now
        from tpudist_torch.telemetry import metrics

        cutoff = now - _PROTECT_WINDOW_S
        # bounded state, the TENANT_LABEL_CAP discipline: stale
        # protection entries and fully-decayed rates prune here, so a
        # per-user-UUID tenant stream cannot grow the controller (or
        # the under-lock gate) without limit
        for t, ts in list(self._protected.items()):
            if ts < cutoff:
                del self._protected[t]
        for t, r in list(self._rates.items()):
            if r[0] < 1e-3 and now - r[1] > self.rate_window_s:
                del self._rates[t]
        live = [r[0] for r in self._rates.values() if r[0] > 0]
        self._fair_tenants = len(live)
        self._fair_threshold = (self.fair_share * sum(live) / len(live)
                                if live else 0.0)
        if not self.shed:
            return False
        protected = set(self._protected)
        gauges = metrics.slo_attainment()
        readings: Dict[str, float] = {}
        for (metric, tenant), value in gauges.items():
            if tenant in protected:
                readings[f"{metric}/{tenant}"] = value
        # past the registry's TENANT_LABEL_CAP, overflow tenants pool
        # under the "other" label — a protected tenant with NO gauge of
        # its own must read the pooled one, or its protection silently
        # evaporates at exactly the many-tenant scale this layer targets
        gauge_tenants = {t for _, t in gauges}
        if any(t not in gauge_tenants for t in protected):
            for (metric, tenant), value in gauges.items():
                if tenant == "other":
                    readings.setdefault(f"{metric}/other", value)
        worst = min(readings.values()) if readings else None
        want = worst is not None and worst < self.shed_attainment
        flipped = want != self.shed_active
        if flipped:
            self.shed_active = want
            self.last_attainment = dict(readings)
            self.flips += 1
        return flipped

    def stats(self) -> Dict[str, object]:
        return {
            "shed_enabled": self.shed,
            "shed_active": self.shed_active,
            "shed_attainment_target": self.shed_attainment,
            "shed_priority": self.shed_priority,
            "sheds": self.sheds,
            "shed_rejects": self.shed_rejects,
            "fair_rejects": self.fair_rejects,
            "flips": self.flips,
            "last_attainment": dict(self.last_attainment),
            "tenant_rates_tps": {t: round(r[0], 3)
                                 for t, r in self._rates.items()},
        }
