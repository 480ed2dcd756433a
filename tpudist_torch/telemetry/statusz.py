"""Scrape endpoints: ``/metrics``, ``/healthz``, ``/statusz`` over a
stdlib HTTP server — the fleet-facing face of the live observability
plane.

Arm with ``TPUDIST_METRICS_PORT`` (unset = off; ``0`` = ephemeral port,
the CI/smoke-test mode — read the bound port back from
``active().port``).  Binds loopback by default — the documents below
carry process internals with no auth, so serving them beyond the host
is an explicit operator decision (``TPUDIST_METRICS_ADDR=0.0.0.0`` for
a fleet scraper).  One endpoint per process, shared by every component
that registers into it:

- ``/metrics`` — Prometheus text exposition (format 0.0.4) of the
  process-wide registry (:mod:`tpudist.telemetry.metrics`): request
  latency sketches, token counters, occupancy/KV gauges, SLO
  attainment, telemetry-drop counters;
- ``/healthz`` — liveness that actually means something: every
  registered health check must pass (engine-thread alive AND no
  ``serve_loop_error`` AND a fresh loop heartbeat; watchdog freshness
  when a watchdog is armed), else **503** with the failing check named
  in the JSON body.  An HTTP thread that answers while the engine loop
  is dead is precisely the failure mode this refuses to hide;
- ``/statusz`` — one JSON document of current state from every
  registered provider: slot occupancy, KV pool bytes/occupancy,
  handoff queue depth, world size + generation, per-tenant in-flight,
  telemetry drop counts.

Registration: components call :func:`register_health` /
:func:`register_status` with a name and a zero-arg callable (health
returns ``(ok, detail_dict)``; status returns a JSON-safe dict) and
:func:`unregister` on close.  Names deduplicate (``serve``,
``serve-2``, …) so multiple servers in one process — a test rig, a
disagg coordinator next to a trainer — coexist on one port.

Failure posture: observability must never take the job down.  A busy
port warns and disables the endpoint; a provider that raises reports
``{"error": ...}`` for its section (and fails its health check) instead
of 500ing the scrape.

Stdlib-only (``http.server`` + daemon thread); importable without jax.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

ENV_PORT = "TPUDIST_METRICS_PORT"
#: Bind address; defaults to loopback — the endpoint serves process
#: internals (paths, tenants, topology) with no auth, so exposing it
#: beyond the host is an explicit operator decision ("0.0.0.0" for a
#: real Prometheus scraper on the fleet network).
ENV_ADDR = "TPUDIST_METRICS_ADDR"
DEFAULT_ADDR = "127.0.0.1"

#: health check: () -> (ok, JSON-safe detail dict)
HealthFn = Callable[[], Tuple[bool, dict]]
#: status provider: () -> JSON-safe dict
StatusFn = Callable[[], dict]


class _Handler(BaseHTTPRequestHandler):
    server_version = "tpudist-statusz"

    def log_message(self, fmt, *args):  # noqa: D102 — silence per-scrape logs
        pass

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        owner: "StatuszServer" = self.server.owner  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            from tpudist_torch.telemetry import metrics

            body = metrics.registry().render_prometheus().encode()
            self._reply(200, body, "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            code, doc = owner.healthz()
            self._reply(code, (json.dumps(doc, indent=1) + "\n").encode(),
                        "application/json")
        elif path in ("/statusz", "/"):
            doc = owner.statusz()
            self._reply(200, (json.dumps(doc, indent=1, default=str)
                              + "\n").encode(), "application/json")
        else:
            self._reply(404, b"not found\n", "text/plain")

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (OSError, ValueError):
            pass  # client went away mid-scrape: not our problem


class StatuszServer:
    """The endpoint: a ThreadingHTTPServer on a daemon thread plus the
    named health/status provider registries."""

    def __init__(self, port: int, host: Optional[str] = None):
        if host is None:
            host = os.environ.get(ENV_ADDR, "").strip() or DEFAULT_ADDR
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.owner = self  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        #: the BOUND port (differs from the request when port=0)
        self.port: int = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._health: Dict[str, HealthFn] = {}
        self._status: Dict[str, StatusFn] = {}
        self._t0 = time.monotonic()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "StatuszServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name=f"tpudist-statusz[:{self.port}]", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            self._httpd.shutdown()
            t.join(timeout=5.0)
        self._httpd.server_close()

    # -- registration -------------------------------------------------------

    def _dedup(self, table: Dict[str, object], name: str) -> str:
        if name not in table:
            return name
        i = 2
        while f"{name}-{i}" in table:
            i += 1
        return f"{name}-{i}"

    def register_health(self, name: str, fn: HealthFn) -> str:
        """Add a health check; returns the (possibly deduplicated) name
        to pass to :meth:`unregister`."""
        with self._lock:
            name = self._dedup(self._health, name)
            self._health[name] = fn
            return name

    def register_status(self, name: str, fn: StatusFn) -> str:
        with self._lock:
            name = self._dedup(self._status, name)
            self._status[name] = fn
            return name

    def unregister(self, name: str) -> None:
        """Remove ``name`` from both registries (idempotent)."""
        with self._lock:
            self._health.pop(name, None)
            self._status.pop(name, None)

    # -- documents ----------------------------------------------------------

    def healthz(self) -> Tuple[int, dict]:
        """(status_code, body): 200 only when EVERY registered check
        passes; a raising check counts as failed, named in the body."""
        checks: Dict[str, dict] = {}
        ok = True
        for name, fn in sorted(dict(self._health).items()):
            try:
                good, detail = fn()
            except Exception as e:  # a broken check is an unhealthy check
                good, detail = False, {"error": repr(e)}
            ok &= bool(good)
            checks[name] = {"ok": bool(good), **(detail or {})}
        return (200 if ok else 503), {"ok": ok, "checks": checks}

    def statusz(self) -> dict:
        doc: Dict[str, dict] = {}
        for name, fn in sorted(dict(self._status).items()):
            try:
                doc[name] = fn()
            except Exception as e:
                doc[name] = {"error": repr(e)}
        return doc


# -- module-level singleton ---------------------------------------------------

_SERVER: Optional[StatuszServer] = None
_lock = threading.Lock()


def active() -> Optional[StatuszServer]:
    return _SERVER


def ensure_started(port: Optional[int] = None) -> Optional[StatuszServer]:
    """Start the process's endpoint if ``TPUDIST_METRICS_PORT`` (or an
    explicit ``port``) says so; idempotent — later callers get the same
    instance and just register their providers.  Returns ``None`` when
    the endpoint is off or could not bind (warned, never fatal)."""
    global _SERVER
    with _lock:
        if _SERVER is not None:
            return _SERVER
        if port is None:
            raw = os.environ.get(ENV_PORT)
            if raw is None or not raw.strip():
                return None
            try:
                port = int(raw)
            except ValueError:
                warnings.warn(
                    f"{ENV_PORT}={raw!r} is not an integer; scrape "
                    f"endpoint disabled", RuntimeWarning, stacklevel=2)
                return None
        try:
            srv = StatuszServer(port).start()
        except OSError as e:
            warnings.warn(
                f"tpudist.telemetry.statusz: could not bind port {port} "
                f"({e}); scrape endpoint disabled", RuntimeWarning,
                stacklevel=2)
            return None
        _register_defaults(srv)
        _SERVER = srv
        return srv


def _register_defaults(srv: StatuszServer) -> None:
    """Built-in providers every process gets: process identity/uptime,
    watchdog freshness (when a watchdog is armed), and telemetry
    session drop accounting."""
    def _process() -> dict:
        from tpudist_torch.utils.envutil import env_int, env_rank

        return {
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - srv._t0, 3),
            "rank": env_rank(0),
            "world": env_int("TPUDIST_NUM_PROCESSES", None),
            "generation": env_int("TPUDIST_RESTART_COUNT", 0),
        }

    def _telemetry() -> dict:
        from tpudist_torch.telemetry import spans

        s = spans.active()
        if s is None:
            return {"session": None}
        return {
            "session": str(s.path),
            "rank": s.rank,
            "generation": s.generation,
            "ring_len": len(s.ring),
            "dropped": dict(s.dropped),
        }

    def _watchdog_health() -> Tuple[bool, dict]:
        from tpudist_torch.runtime import watchdog

        fresh = watchdog.freshness()
        ok = all(v["fresh"] for v in fresh.values())  # vacuously healthy
        return ok, {"watchdogs": fresh}

    srv.register_status("process", _process)
    srv.register_status("telemetry", _telemetry)
    srv.register_health("watchdog", _watchdog_health)


def stop() -> None:
    """Tear the singleton down (tests / embedding callers)."""
    global _SERVER
    with _lock:
        srv, _SERVER = _SERVER, None
    if srv is not None:
        srv.stop()
