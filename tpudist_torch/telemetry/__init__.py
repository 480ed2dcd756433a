"""Telemetry & goodput subsystem — a copy of :mod:`tpudist.telemetry`
(stdlib only; the same record schema, env knobs and report), so a port
run's stream reads with either package's tools.  The CLI here is
``python -m tpudist_torch.telemetry report|trace <run_dir>``.

Production TPU training lives or dies on goodput accounting: what fraction
of wall-clock went to useful step compute versus compilation, data stalls,
checkpoint I/O, and restart overhead.  This package makes the framework
attribute its own wall-clock:

- :mod:`tpudist.telemetry.spans` — a low-overhead span/event API
  (``span("step")``, ``span("ckpt_save")``, ``event("watchdog_stall")``)
  recording monotonic start/duration per rank into a bounded in-memory
  ring and streaming to a per-rank, per-generation ``telemetry`` JSONL.
- :mod:`tpudist.telemetry.aggregate` — merges every rank's (and every
  restarted process generation's) JSONL into ``report.json`` +
  ``report.md``: step-time p50/p95/max, a goodput breakdown
  (step / compile / data / ckpt / comm / init / other / idle /
  lost_restart) that sums to wall-clock, per-rank stragglers, and the
  joined fault/watchdog/restart event log.
- ``python -m tpudist.telemetry report <run_dir>`` — the post-hoc CLI.

The LIVE half (this is what a fleet scrapes mid-run):

- :mod:`tpudist.telemetry.metrics` — lock-light in-process registry of
  counters, gauges, and mergeable log-bucket quantile sketches, fed
  from the same span/event seams (``TPUDIST_METRICS`` gates the feed),
  plus SLO attainment from declared ``TPUDIST_SLO_TTFT_MS`` /
  ``TPUDIST_SLO_TPOT_MS`` targets;
- :mod:`tpudist.telemetry.trace` — per-request ``trace_id`` lifelines
  joined across pools/processes, exported as a Perfetto-loadable
  Chrome trace (``python -m tpudist.telemetry trace <run_dir>``);
- :mod:`tpudist.telemetry.statusz` — ``/metrics`` (Prometheus text),
  ``/healthz`` (engine-loop liveness + watchdog freshness), and
  ``/statusz`` (JSON state) on ``TPUDIST_METRICS_PORT``.

Armed by default; ``TPUDIST_TELEMETRY=0`` disarms it — the disarmed cost
at every span site is one module-attribute load and a ``None`` check
(same discipline as :mod:`tpudist.runtime.faults`).  The whole package is
importable without jax (rank/generation come from the launcher env
contract), so the watchdog and fault registry can emit events from any
process state.
"""

from tpudist_torch.telemetry.spans import (  # noqa: F401
    DEFAULT_DIR,
    ENV_DIR,
    ENV_ENABLE,
    ENV_RING,
    TelemetrySession,
    abandon,
    active,
    enabled_from_env,
    ensure_started,
    event,
    finish,
    flush,
    span,
    start,
)
from tpudist_torch.telemetry.aggregate import (  # noqa: F401
    aggregate_run,
    load_records,
    render_markdown,
    write_reports,
)

# The live plane (metrics/trace/statusz) is imported lazily by its
# consumers — `from tpudist.telemetry import metrics` etc. — so the
# spans hot path never pays for modules it is not using.
