"""Cross-rank/cross-generation aggregation: JSONL → goodput report.

Reads every ``rank<R>_gen<G>.jsonl`` a run's processes streamed (all
ranks, all restart generations), and produces

- ``report.json`` — machine-readable: wall-clock, step-time
  p50/p95/max, a goodput breakdown whose components sum to wall-clock
  (step / compile / data / ckpt / comm / init / other / idle /
  lost_restart), per-rank rows for straggler hunting, the StageTimer
  phase durations, and the joined fault/watchdog/retry event log;
- ``report.md`` — the same, human-readable.

Attribution rules (the math the tests pin down):

- Only TOP-LEVEL spans (no ``parent``) enter the goodput sum — a
  ``host_collective`` nested inside ``metric_flush`` is detail, not a
  second copy of the same wall-clock.
- Per rank: ``wall = last record end − first record start`` across all
  generations; ``lost_restart = Σ gaps`` between one generation's last
  record and the next generation's first (the time a killed process's
  successor spent being re-launched, re-admitted, and re-initialized
  before it recorded anything); ``idle = wall − Σ busy − lost``
  (clamped at 0; clamped amount reported as ``overlap_s`` so
  double-counted spans are visible, not silently absorbed).
- The run's goodput components are the across-rank MEANS, so they sum
  to the mean rank wall-clock (``wall_clock_s``); the envelope from the
  earliest record of any rank to the latest (``run_span_s``) is
  reported alongside.

Dependency-free (stdlib only) so post-hoc report generation —
``python -m tpudist.telemetry report <dir>`` — needs no jax.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: span name → goodput component; unmapped top-level spans land in "other".
#: ``metric_flush`` counts as step time on purpose: a jitted step's span
#: brackets only the async dispatch, and the device compute it ran ahead
#: of surfaces in the next blocking loss fetch — attributing that wait to
#: anything but step would make the headline step%% read near-zero on
#: compute-bound runs.
COMPONENT_OF = {
    "step": "step",
    "metric_flush": "step",
    "compile": "compile",
    "data_wait": "data",
    "ckpt_save": "ckpt",
    "ckpt_restore": "ckpt",
    "ckpt_wait": "ckpt",
    "host_collective": "comm",
    "init": "init",
    # serving (tpudist.serve): device work of the engine loop — prefill
    # teacher-forcing and fused decode blocks are the serving analog of
    # a train step.  The first decode_block/prefill dispatch blocks on
    # XLA compilation like any first dispatch; the serving section's
    # TTFT percentiles surface that separately.  decode_step is the
    # pre-block name, still recognized so old streams aggregate.
    "prefill": "step",
    "decode_step": "step",
    "decode_block": "step",
    # speculative decode: one draft-propose + batched-verify block (the
    # decode work of a spec engine's iteration)
    "spec_verify": "step",
}

#: Every component of the breakdown, in report order.  The accounted ones
#: (all but idle/resize/lost_restart) come from spans; idle is the
#: per-rank remainder; the inter-generation gaps split into ``resize``
#: (the next generation launched at a DIFFERENT world size — an elastic
#: relaunch, classified from the ``world`` stamp each session carries)
#: and ``lost_restart`` (a fixed-size restart of the same world).
COMPONENTS = ("step", "compile", "data", "ckpt", "comm", "init", "other",
              "idle", "resize", "lost_restart")

#: Event names surfaced in the report's event log (joined across ranks and
#: generations on the wall-clock axis).
_REPORTED_EVENTS = ("fault_injected", "watchdog_stall", "retry",
                    "prefetch_stats", "serve_drain", "serve_loop_error",
                    "serve_disagg_config", "restart_exhausted",
                    "world_resized", "worker_lost", "lane_recovered",
                    "handoff_rejected", "pool_resize",
                    "adapter_load", "adapter_evict",
                    "replica_health", "session_migrated", "router_error",
                    "distill_round", "draft_swap",
                    "telemetry_dropped", "plan_selected")


def find_telemetry_dir(run_dir: "str | Path") -> Path:
    """Accept either the telemetry dir itself or a run dir containing a
    ``telemetry/`` subdirectory."""
    d = Path(run_dir)
    if list(d.glob("rank*_gen*.jsonl")):
        return d
    sub = d / "telemetry"
    if sub.is_dir() and list(sub.glob("rank*_gen*.jsonl")):
        return sub
    return d


def load_records(run_dir: "str | Path") -> List[dict]:
    """Parse every per-rank/per-generation JSONL under ``run_dir``.
    Torn trailing lines (SIGKILL mid-write) are skipped, not fatal."""
    recs: List[dict] = []
    for p in sorted(find_telemetry_dir(run_dir).glob("rank*_gen*.jsonl")):
        try:
            text = p.read_text()
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn write at the kill point
            if isinstance(rec, dict) and "t" in rec and "name" in rec:
                recs.append(rec)
    return recs


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (stdlib-only)."""
    if not sorted_vals:
        return 0.0
    idx = int(round(q / 100.0 * (len(sorted_vals) - 1)))
    return sorted_vals[max(0, min(len(sorted_vals) - 1, idx))]


def _rank_breakdown(rank_recs: List[dict]) -> dict:
    """One rank's wall-clock accounting across all its generations."""
    by_gen: Dict[int, List[dict]] = {}
    for r in rank_recs:
        by_gen.setdefault(int(r.get("gen", 0)), []).append(r)
    gens = sorted(by_gen)
    t0 = min(float(r["t"]) for r in rank_recs)
    t1 = max(float(r["t"]) + float(r.get("dur", 0.0)) for r in rank_recs)
    wall = max(0.0, t1 - t0)

    # Per-generation world size (the session_start stamp) — what lets a
    # gap be attributed as resize vs lost_restart below.
    world_of: Dict[int, Optional[int]] = {}
    for g in gens:
        world_of[g] = next(
            (int(r["world"]) for r in by_gen[g]
             if r.get("name") == "session_start"
             and isinstance(r.get("world"), int)), None)

    # Inter-generation gaps: the successor process's spawn/re-admit/
    # re-init dead time.  A gap into a generation whose world size
    # CHANGED is ``resize`` (the elastic relaunch shrinking/growing the
    # group); same (or unknown) world is ``lost_restart``.
    lost, resize = 0.0, 0.0
    for a, b in zip(gens, gens[1:]):
        end_a = max(float(r["t"]) + float(r.get("dur", 0.0))
                    for r in by_gen[a])
        start_b = min(float(r["t"]) for r in by_gen[b])
        gap = max(0.0, start_b - end_a)
        wa, wb = world_of.get(a), world_of.get(b)
        if wa is not None and wb is not None and wa != wb:
            resize += gap
        else:
            lost += gap

    comp = {c: 0.0 for c in COMPONENTS}
    comp["lost_restart"] = lost
    comp["resize"] = resize
    for r in rank_recs:
        if r.get("kind") != "span" or "parent" in r:
            continue  # nested spans are detail, not additional wall-clock
        comp[COMPONENT_OF.get(r["name"], "other")] += float(r.get("dur", 0.0))
    busy = sum(comp[c] for c in COMPONENTS
               if c not in ("idle", "resize", "lost_restart"))
    idle = wall - busy - lost - resize
    comp["idle"] = max(0.0, idle)
    return {
        "rank": int(rank_recs[0].get("rank", 0)),
        "generations": len(gens),
        "worlds": {str(g): world_of[g] for g in gens
                   if world_of[g] is not None},
        "wall_s": wall,
        "t0": t0,
        "t1": t1,
        "components_s": comp,
        # double-counted span time (overlapping top-level spans) surfaces
        # here instead of silently shrinking idle below zero.
        "overlap_s": max(0.0, -idle),
    }


def _step_stats(records: List[dict], num_ranks: int = 1) -> dict:
    """Per-step time distribution.  A scanned window span carries a
    ``steps`` tag; it contributes its per-step mean once per step so the
    percentiles weight windows by the iterations they covered.
    Percentiles pool every rank's samples, but ``count``/``total_s`` are
    per-rank means — all ranks run the same loop, and summing their
    parallel time would overstate the run by the rank count."""
    vals: List[float] = []
    total = 0.0
    count = 0
    for r in records:
        if r.get("kind") != "span" or r.get("name") != "step":
            continue
        dur = float(r.get("dur", 0.0))
        n = int(r.get("steps", 1) or 1)
        total += dur
        count += n
        vals.extend([dur / n] * min(n, 100_000))
    vals.sort()
    ranks = max(1, num_ranks)
    total /= ranks
    count = round(count / ranks)
    return {
        "count": count,
        "total_s": total,
        "p50_s": _percentile(vals, 50),
        "p95_s": _percentile(vals, 95),
        "max_s": vals[-1] if vals else 0.0,
        "steps_per_s": (count / total) if total > 0 else 0.0,
    }


def _slo_summary(fins: List[dict], slo_config: dict) -> dict:
    """Post-hoc SLO attainment vs the declared targets — the exact
    numbers the live ``tpudist_slo_attainment`` gauges track mid-run,
    recomputed from the ``request_finished`` events so live and post-hoc
    views can be cross-checked.  Per-tenant (requests without a tenant
    tag pool under ``"default"``) plus the overall row."""
    targets: Dict[str, float] = {}
    for key, tag in (("ttft_s", "ttft_ms"), ("tpot_s", "tpot_ms")):
        v = slo_config.get(tag)
        if isinstance(v, (int, float)) and v > 0:
            targets[key] = float(v) / 1e3

    def _attain(group: List[dict]) -> dict:
        out: Dict[str, object] = {"requests": len(group)}
        fracs = []
        for key, target in targets.items():
            vals = [float(r[key]) for r in group
                    if isinstance(r.get(key), (int, float))]
            label = key[:-2] + "_attainment"  # ttft_attainment / tpot_...
            if not vals:
                out[label] = None
                continue
            frac = sum(1 for v in vals if v <= target) / len(vals)
            out[label] = round(frac, 4)
            fracs.append(frac)
        # the headline: worst per-metric attainment (an SLO with two
        # clauses is met only as often as its weakest clause)
        out["attainment"] = round(min(fracs), 4) if fracs else None
        return out

    by_tenant: Dict[str, List[dict]] = {}
    for r in fins:
        t = r.get("tenant")
        by_tenant.setdefault(
            t if isinstance(t, str) and t else "default", []).append(r)
    return {
        "targets_ms": {
            ("ttft_ms" if k == "ttft_s" else "tpot_ms"): round(v * 1e3, 3)
            for k, v in targets.items()},
        "overall": _attain(fins),
        "per_tenant": {t: _attain(g) for t, g in sorted(by_tenant.items())},
    }


def _serving_summary(records: List[dict]) -> Optional[dict]:
    """Serving-goodput section from the serve subsystem's records:
    per-request ``request_finished`` events (TTFT/TPOT/queue-wait
    percentiles, finish-reason counts) plus the ``decode_block`` spans'
    occupancy gauge (duration-weighted — a long low-occupancy stretch
    must weigh what it cost) and their dispatch/host-sync attribution
    (the per-token overhead split — ``decode_step`` is the pre-block
    span name, still folded in).  ``None`` when the run never served."""
    fins = [r for r in records if r.get("kind") == "event"
            and r.get("name") == "request_finished"]
    rejects = sum(1 for r in records if r.get("kind") == "event"
                  and r.get("name") == "serve_rejected")
    # declared SLO targets (slo_config event, stamped at server start
    # when TPUDIST_SLO_*_MS is set) — last one wins across restarts
    slo_config = None
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "slo_config":
            slo_config = r
    occ_w, occ_dur, occ_max, decode_s, prefill_s = 0.0, 0.0, 0.0, 0.0, 0.0
    serve_spans = 0
    decode_blocks, decode_tokens = 0, 0
    dispatch_s, sync_s = 0.0, 0.0
    # KV residency gauges (paged-cache PR): block occupancy duration-
    # weighted like the batch occupancy, peak resident bytes, and the
    # attention's streamed bytes (→ decode bytes/token)
    kv_occ_w, kv_occ_dur, kv_occ_max = 0.0, 0.0, 0.0
    kv_resident_peak, kv_read_bytes = 0, 0
    kv_config = None
    # speculative decoding (spec_verify spans): per-block acceptance →
    # accepted-tokens-per-pass percentiles, the draft/verify wall
    # split, and rollback counts.  Streams without spec events (every
    # pre-spec run, and non-spec engines) skip the whole section.
    spec_blocks, spec_tokens, spec_accepted, spec_drafted = 0, 0, 0, 0
    spec_rollbacks = 0
    spec_draft_s, spec_verify_s = 0.0, 0.0
    spec_per_pass: List[float] = []
    # disaggregated serving (tpudist.serve.disagg): spans tagged with
    # their pool; TTFT belongs to the prefill pool (token 0 is sampled
    # there) and TPOT to the decode pool, with the coordinator's
    # handoff-wait gap in between.
    pool_s: Dict[str, float] = {}
    pool_spans: Dict[str, int] = {}
    handoffs = 0
    handoff_import_s: List[float] = []
    disagg_config = None
    # fleet recovery (self-healing disagg): dead workers, lanes replayed
    # onto survivors, and backpressure-driven pool resizes
    workers_lost, lanes_recovered, pool_resizes = 0, 0, 0
    # host-RAM KV tier + overload control (tpudist.serve.host_tier /
    # .overload): park/resume/spill/corruption counts, preemptions, and
    # the shed-state flips — absent entirely from old streams, so the
    # section below is purely additive
    tier_parks, tier_spills, tier_corrupt, tier_expired = 0, 0, 0, 0
    tier_resumes: Dict[str, int] = {}
    tier_bytes_peak = 0
    preempted_events, shed_flips = 0, 0
    shed_last: Optional[dict] = None
    # per-tenant adapters (tpudist.serve.adapters): pool geometry stamp,
    # load/evict churn, peak residency — absent entirely from old
    # streams, so the section below is purely additive
    ad_config: Optional[dict] = None
    ad_loads, ad_evicts = 0, 0
    ad_evict_kinds: Dict[str, int] = {}
    ad_resident_peak = 0
    # structured output (tpudist.constrain): the serve_constrain_config
    # stamp, per-request constrained/stop/logprobs tags on
    # request_finished, and pool-full admission deferrals — absent
    # entirely from old streams, so the section below is purely additive
    cn_config: Optional[dict] = None
    cn_deferred = 0
    # fleet router (tpudist.serve.router): routing split, spills,
    # re-home retries, replica deaths, session migrations — absent
    # entirely from single-replica streams, so the section below is
    # purely additive
    rt_config: Optional[dict] = None
    rt_routes: Dict[str, int] = {}
    rt_spills, rt_retries, rt_deaths, rt_errors = 0, 0, 0, 0
    rt_migrations: Dict[str, int] = {}
    # online draft distillation (tpudist.distill): distill_round /
    # draft_swap events — absent entirely from old streams, so the
    # section below is purely additive
    di_rounds, di_swaps = 0, 0
    di_reasons: Dict[str, int] = {}
    di_swap_s: List[float] = []
    di_gain: List[float] = []
    di_last: Optional[dict] = None
    for r in records:
        if (r.get("kind") == "event"
                and r.get("name") == "serve_kv_config"):
            kv_config = r  # last one wins (restart/regeneration)
            continue
        if (r.get("kind") == "event"
                and r.get("name") == "serve_adapters_config"):
            ad_config = r
            continue
        if r.get("kind") == "event" \
                and r.get("name") in ("adapter_load", "adapter_evict"):
            if r.get("name") == "adapter_load":
                ad_loads += 1
            else:
                ad_evicts += 1
                k = str(r.get("evict_kind", "?"))
                ad_evict_kinds[k] = ad_evict_kinds.get(k, 0) + 1
            if isinstance(r.get("resident"), (int, float)):
                ad_resident_peak = max(ad_resident_peak,
                                       int(r["resident"]))
            continue
        if (r.get("kind") == "event"
                and r.get("name") == "serve_constrain_config"):
            cn_config = r  # last one wins (restart/regeneration)
            continue
        if (r.get("kind") == "event"
                and r.get("name") == "constrain_deferred"):
            cn_deferred += int(r.get("n", 1) or 0)
            continue
        if (r.get("kind") == "event"
                and r.get("name") == "serve_disagg_config"):
            disagg_config = r
            continue
        if r.get("kind") == "event" and r.get("name") == "kv_handoff":
            handoffs += 1
            if isinstance(r.get("import_s"), (int, float)):
                handoff_import_s.append(float(r["import_s"]))
            continue
        if r.get("kind") == "event" \
                and r.get("name") in ("distill_round", "draft_swap"):
            if r.get("name") == "distill_round":
                di_rounds += 1
                k = str(r.get("reason", "?"))
                di_reasons[k] = di_reasons.get(k, 0) + 1
                ca, b = r.get("candidate_acceptance"), r.get("baseline")
                if (r.get("swapped") and isinstance(ca, (int, float))
                        and isinstance(b, (int, float))):
                    di_gain.append(float(ca) - float(b))
                di_last = r
            else:
                di_swaps += 1
                if isinstance(r.get("swap_s"), (int, float)):
                    di_swap_s.append(float(r["swap_s"]))
            continue
        if r.get("kind") == "event" and r.get("name") == "worker_lost":
            workers_lost += 1
            continue
        if r.get("kind") == "event" and r.get("name") == "lane_recovered":
            lanes_recovered += 1
            continue
        if r.get("kind") == "event" and r.get("name") == "pool_resize":
            pool_resizes += 1
            continue
        if r.get("kind") == "event" and r.get("name") in (
                "router_config", "router_route", "router_spill",
                "router_retry", "replica_health", "session_migrated",
                "router_error"):
            name = r.get("name")
            if name == "router_config":
                rt_config = r  # last one wins (restart/regeneration)
            elif name == "router_route":
                k = str(r.get("route_kind", "?"))
                rt_routes[k] = rt_routes.get(k, 0) + 1
            elif name == "router_spill":
                rt_spills += 1
            elif name == "router_retry":
                rt_retries += 1
            elif name == "replica_health":
                if not r.get("up"):
                    rt_deaths += 1
            elif name == "session_migrated":
                k = "ok" if r.get("ok") else "degraded"
                rt_migrations[k] = rt_migrations.get(k, 0) + 1
            elif name == "router_error":
                rt_errors += 1
            continue
        if r.get("kind") == "event":
            name = r.get("name")
            if name in ("session_parked", "session_resumed",
                        "host_tier_spill", "session_expired",
                        "host_tier_corrupt", "preempted", "shed_state"):
                if name == "session_parked":
                    tier_parks += 1
                elif name == "session_resumed":
                    kind = str(r.get("park_kind", "turn"))
                    tier_resumes[kind] = tier_resumes.get(kind, 0) + 1
                elif name == "host_tier_spill":
                    tier_spills += int(r.get("entries", 1) or 1)
                elif name == "session_expired":
                    tier_expired += int(r.get("entries", 1) or 1)
                elif name == "host_tier_corrupt":
                    tier_corrupt += 1
                elif name == "preempted":
                    preempted_events += 1
                elif name == "shed_state":
                    shed_flips += 1
                    shed_last = {"active": bool(r.get("active")),
                                 "target": r.get("target"),
                                 "attainment": r.get("attainment")}
                if isinstance(r.get("tier_bytes"), (int, float)):
                    tier_bytes_peak = max(tier_bytes_peak,
                                          int(r["tier_bytes"]))
                continue
        if r.get("kind") != "span":
            continue
        pool = r.get("pool")
        if isinstance(pool, str):
            pool_s[pool] = pool_s.get(pool, 0.0) + float(r.get("dur", 0.0))
            pool_spans[pool] = pool_spans.get(pool, 0) + 1
        if r.get("name") in ("decode_block", "decode_step", "spec_verify"):
            serve_spans += 1
            decode_blocks += 1
            dur = float(r.get("dur", 0.0))
            decode_s += dur
            decode_tokens += int(r.get("tokens", 0) or 0)
            dispatch_s += float(r.get("dispatch_s", 0.0) or 0.0)
            sync_s += float(r.get("sync_s", 0.0) or 0.0)
            if r.get("name") == "spec_verify":
                spec_blocks += 1
                toks = int(r.get("tokens", 0) or 0)
                spec_tokens += toks
                spec_accepted += int(r.get("accepted", 0) or 0)
                spec_drafted += int(r.get("drafted", 0) or 0)
                spec_rollbacks += int(r.get("rollbacks", 0) or 0)
                spec_draft_s += float(r.get("draft_s", 0.0) or 0.0)
                spec_verify_s += float(r.get("verify_s", 0.0) or 0.0)
                active = int(r.get("active", 0) or 0)
                if active > 0:
                    spec_per_pass.append(toks / active)
            occ = r.get("occupancy")
            if isinstance(occ, (int, float)):
                occ_w += float(occ) * dur
                occ_dur += dur
                occ_max = max(occ_max, float(occ))
            kocc = r.get("kv_block_occupancy")
            if isinstance(kocc, (int, float)):
                kv_occ_w += float(kocc) * dur
                kv_occ_dur += dur
                kv_occ_max = max(kv_occ_max, float(kocc))
            if isinstance(r.get("kv_bytes_resident"), (int, float)):
                kv_resident_peak = max(kv_resident_peak,
                                       int(r["kv_bytes_resident"]))
            kv_read_bytes += int(r.get("kv_read_bytes", 0) or 0)
        elif r.get("name") == "prefill":
            serve_spans += 1
            prefill_s += float(r.get("dur", 0.0))
    if not fins and not serve_spans and not rejects:
        return None

    def _pcts(key):
        vals = sorted(float(r[key]) for r in fins
                      if isinstance(r.get(key), (int, float)))
        if not vals:
            return None
        return {"p50_s": round(_percentile(vals, 50), 6),
                "p95_s": round(_percentile(vals, 95), 6),
                "max_s": round(vals[-1], 6)}

    reasons: Dict[str, int] = {}
    for r in fins:
        reasons[str(r.get("reason"))] = reasons.get(str(r.get("reason")), 0) + 1
    tokens_out = sum(int(r.get("tokens_out", 0)) for r in fins)
    busy = decode_s + prefill_s
    # host-tier occupancy rides in the kv section (it IS kv — the tier
    # below the pool); resume-TTFT quotes the no-recompute claim
    # directly from the finish-reason split
    tier_any = (tier_parks or tier_resumes or tier_spills or tier_corrupt
                or tier_expired or preempted_events)
    host_tier: Optional[dict] = None
    if tier_any:
        resumed_ttft = sorted(
            float(r["ttft_s"]) for r in fins
            if r.get("reason") == "session_resumed"
            and isinstance(r.get("ttft_s"), (int, float)))
        host_tier = {
            "parks": tier_parks,
            "resumes": dict(tier_resumes),
            "spills": tier_spills,
            "corrupt": tier_corrupt,
            "expired": tier_expired,
            "bytes_peak": tier_bytes_peak or None,
            "preemptions": preempted_events,
            "resume_ttft": ({
                "p50_s": round(_percentile(resumed_ttft, 50), 6),
                "p95_s": round(_percentile(resumed_ttft, 95), 6),
                "max_s": round(resumed_ttft[-1], 6)}
                if resumed_ttft else None),
        }
    overload: Optional[dict] = None
    if shed_flips or reasons.get("shed_load"):
        overload = {
            "shed_state_changes": shed_flips,
            "last_shed_state": shed_last,
            "shed_finished": reasons.get("shed_load", 0),
        }
    kv: Optional[dict] = None
    if kv_config is not None or kv_occ_dur > 0 or kv_read_bytes \
            or host_tier is not None:
        kv = {
            # static geometry from the serve_kv_config stamp
            **({"paged": kv_config.get("paged"),
                "quantized": kv_config.get("quantized"),
                # which decode-attention path produced read_bytes —
                # live-KV accounting (paged kernel) vs pool-geometry
                # accounting (gather/dense) are different quantities
                "attn_kernel": kv_config.get("attn_kernel"),
                "block_size": kv_config.get("block_size"),
                "blocks_total": kv_config.get("blocks_total"),
                "pool_bytes": kv_config.get("pool_bytes"),
                "bytes_per_pos": kv_config.get("bytes_per_pos")}
               if kv_config is not None else {}),
            # measured residency/bandwidth gauges
            "block_occupancy_mean": (round(kv_occ_w / kv_occ_dur, 4)
                                     if kv_occ_dur > 0 else None),
            "block_occupancy_max": (round(kv_occ_max, 4)
                                    if kv_occ_dur > 0 else None),
            "bytes_resident_peak": kv_resident_peak or None,
            "read_bytes": kv_read_bytes or None,
            # decode bytes/token: what the attention streamed per
            # emitted token — the int8 path halves-or-betters this
            "read_bytes_per_token": (round(kv_read_bytes / decode_tokens, 1)
                                     if decode_tokens and kv_read_bytes
                                     else None),
            **({"host_tier": host_tier} if host_tier is not None else {}),
        }
    adapters: Optional[dict] = None
    if ad_config is not None or ad_loads or ad_evicts \
            or any(r.get("adapter") for r in fins):
        by_adapter: Dict[str, int] = {}
        for r in fins:
            a = r.get("adapter")
            if isinstance(a, str) and a:
                by_adapter[a] = by_adapter.get(a, 0) + 1
        adapters = {
            **({"blocks": ad_config.get("blocks"),
                # "rank" is reserved on the wire (process rank); the
                # LoRA rank rides as lora_rank
                "rank": ad_config.get("lora_rank"),
                "block_bytes": ad_config.get("block_bytes"),
                "pool_bytes": ad_config.get("pool_bytes")}
               if ad_config is not None else {}),
            "loads": ad_loads,
            "evicts": ad_evicts,
            **({"evict_kinds": ad_evict_kinds} if ad_evict_kinds else {}),
            "resident_peak": ad_resident_peak or None,
            # per-adapter served-request split (the multi-tenant story:
            # which fine-tunes the traffic actually hit)
            "requests": by_adapter,
            "base_only_requests": len(fins) - sum(by_adapter.values()),
            "missing_finished": reasons.get("adapter_missing", 0),
        }
    constrained: Optional[dict] = None
    if cn_config is not None or cn_deferred \
            or any(r.get("constrained") for r in fins):
        by_kind: Dict[str, int] = {}
        lp_requests = 0
        for r in fins:
            k = r.get("constrained")
            if isinstance(k, str) and k:
                by_kind[k] = by_kind.get(k, 0) + 1
            if r.get("logprobs"):
                lp_requests += 1
        constrained = {
            **({"blocks": cn_config.get("blocks"),
                "max_states": cn_config.get("max_states"),
                "pool_bytes": cn_config.get("pool_bytes"),
                "logprobs_width": cn_config.get("logprobs")}
               if cn_config is not None else {}),
            # per-grammar-kind served-request split (regex vs schema)
            "requests": by_kind,
            "free_requests": len(fins) - sum(by_kind.values()),
            "deferred": cn_deferred,
            # both should stay 0 in healthy runs: violations mean the
            # device mask and the host shadow diverged; stop_sequence
            # is here because the stop satellite shares the section
            "violations_finished": reasons.get("grammar_violation", 0),
            "stop_finished": reasons.get("stop_sequence", 0),
            "logprobs_requests": lp_requests,
        }
    spec: Optional[dict] = None
    if spec_blocks:
        pp = sorted(spec_per_pass)
        spec = {
            "blocks": spec_blocks,
            "tokens": spec_tokens,
            "accepted": spec_accepted,
            "drafted": spec_drafted,
            "acceptance_rate": (round(spec_accepted / spec_drafted, 4)
                                if spec_drafted else None),
            "rollbacks": spec_rollbacks,
            # emitted tokens per verify pass PER LANE — the
            # fewer-target-passes-per-token headline (1.0 = no better
            # than plain decode; the pass emits accepted + 1)
            "accepted_per_pass": ({
                "mean": round(sum(pp) / len(pp), 4),
                "p50": round(_percentile(pp, 50), 4),
                "p95": round(_percentile(pp, 95), 4),
                "max": round(pp[-1], 4)} if pp else None),
            "draft_s": round(spec_draft_s, 6),
            "verify_s": round(spec_verify_s, 6),
        }
    distill: Optional[dict] = None
    if di_rounds or di_swaps:
        sw = sorted(di_swap_s)
        distill = {
            "rounds": di_rounds,
            "swaps": di_swaps,
            # why each round did / didn't swap — "measured_win" is the
            # happy path, everything else is the gate holding the line
            "round_reasons": di_reasons,
            # holdout acceptance gain of APPLIED candidates over the
            # gate baseline (max(serving-on-holdout, live rate))
            "acceptance_gain": ({
                "mean": round(sum(di_gain) / len(di_gain), 4),
                "max": round(max(di_gain), 4)} if di_gain else None),
            "swap_s": ({
                "p50": round(_percentile(sw, 50), 6),
                "max": round(sw[-1], 6)} if sw else None),
            **({"capture": {
                k: di_last[k] for k in
                ("capture_streams", "capture_tokens", "capture_evicted")
                if k in di_last}} if di_last is not None else {}),
        }
    pools: Optional[dict] = None
    if (pool_s or disagg_config is not None or handoffs
            or workers_lost or lanes_recovered):
        hwaits = sorted(float(r["handoff_wait_s"]) for r in fins
                        if isinstance(r.get("handoff_wait_s"), (int, float)))
        pools = {
            **({"config": {k: v for k, v in disagg_config.items()
                           if k not in ("kind", "name", "t", "dur",
                                        "rank", "gen")}}
               if disagg_config is not None else {}),
            "prefill": {
                "span_s": round(pool_s.get("prefill", 0.0), 6),
                "spans": pool_spans.get("prefill", 0),
                # token 0 is sampled in the prefill pool: TTFT is ITS
                # latency number (queue wait included)
                "ttft": _pcts("ttft_s"),
            },
            "decode": {
                "span_s": round(pool_s.get("decode", 0.0), 6),
                "spans": pool_spans.get("decode", 0),
                "tpot": _pcts("tpot_s"),
            },
            "handoffs": handoffs,
            "handoff_wait": ({
                "p50_s": round(_percentile(hwaits, 50), 6),
                "p95_s": round(_percentile(hwaits, 95), 6),
                "max_s": round(hwaits[-1], 6)} if hwaits else None),
            "handoff_import": ({
                "p50_s": round(_percentile(sorted(handoff_import_s), 50), 6),
                "max_s": round(max(handoff_import_s), 6)}
                if handoff_import_s else None),
            "workers_lost": workers_lost,
            "lanes_recovered": lanes_recovered,
            "pool_resizes": pool_resizes,
        }
    fleet: Optional[dict] = None
    if rt_config is not None or rt_routes or rt_spills or rt_retries \
            or rt_deaths or rt_migrations:
        fleet = {
            **({"replicas": rt_config.get("replicas"),
                "policy": rt_config.get("policy")}
               if rt_config is not None else {}),
            # routing split by affinity kind (session/prefix/
            # least_loaded/spill/rr) — the affinity-hit headline
            "routes": dict(rt_routes),
            "spills": rt_spills,
            "retries": rt_retries,
            "replica_deaths": rt_deaths,
            # re-home retries that replayed a stream: the per-request
            # failover count (replica_lost in finish_reasons is the
            # budget-exhausted tail)
            "lost_finished": reasons.get("replica_lost", 0),
            **({"migrations": dict(rt_migrations)}
               if rt_migrations else {}),
            **({"router_errors": rt_errors} if rt_errors else {}),
        }
    return {
        "requests_finished": len(fins),
        "requests_rejected": rejects,
        "finish_reasons": reasons,
        "tokens_out": tokens_out,
        "decode_s": round(decode_s, 6),
        "prefill_s": round(prefill_s, 6),
        "decode_blocks": decode_blocks,
        "decode_tokens": decode_tokens,
        "tokens_per_dispatch": (round(decode_tokens / decode_blocks, 3)
                                if decode_blocks else None),
        "dispatch_s": round(dispatch_s, 6),
        "host_sync_s": round(sync_s, 6),
        "tokens_per_s_busy": round(tokens_out / busy, 3) if busy > 0 else None,
        "ttft": _pcts("ttft_s"),
        "tpot": _pcts("tpot_s"),
        "queue_wait": _pcts("queue_wait_s"),
        "occupancy_mean": round(occ_w / occ_dur, 4) if occ_dur > 0 else None,
        "occupancy_max": round(occ_max, 4) if occ_dur > 0 else None,
        **({"kv": kv} if kv is not None else {}),
        **({"adapters": adapters} if adapters is not None else {}),
        # constrained section only when structured output ran — old
        # streams aggregate byte-identically without it
        **({"constrained": constrained} if constrained is not None else {}),
        **({"spec": spec} if spec is not None else {}),
        # distill section only when the flywheel ran — old streams (and
        # capture-off runs) aggregate byte-identically without it
        **({"distill": distill} if distill is not None else {}),
        **({"pools": pools} if pools is not None else {}),
        **({"overload": overload} if overload is not None else {}),
        # fleet section only when a router ran — single-replica streams
        # (every pre-router run) aggregate byte-identically without it
        **({"fleet": fleet} if fleet is not None else {}),
        # SLO section only when targets were declared — old streams (and
        # target-less runs) aggregate byte-identically without it
        **({"slo": _slo_summary(fins, slo_config)}
           if slo_config is not None else {}),
    }


def aggregate_run(run_dir: "str | Path") -> dict:
    """Merge a run's telemetry into the report dict (see module doc)."""
    records = load_records(run_dir)
    if not records:
        return {"error": f"no telemetry records under {run_dir}",
                "num_records": 0}

    by_rank: Dict[int, List[dict]] = {}
    for r in records:
        by_rank.setdefault(int(r.get("rank", 0)), []).append(r)
    # Event-only streams (e.g. the tpurun agent's staging events) carry
    # no wall-clock to account — they contribute events/stages below but
    # must not enter the per-rank goodput means as phantom zero-wall ranks.
    span_ranks = sorted(
        k for k, rs in by_rank.items()
        if any(r.get("kind") == "span" for r in rs)) or sorted(by_rank)
    per_rank = [_rank_breakdown(by_rank[k]) for k in span_ranks]

    n = len(per_rank)
    wall_mean = sum(p["wall_s"] for p in per_rank) / n
    goodput = {}
    for c in COMPONENTS:
        s = sum(p["components_s"][c] for p in per_rank) / n
        goodput[c] = {
            "s": round(s, 6),
            "frac": round(s / wall_mean, 6) if wall_mean > 0 else 0.0,
        }
    goodput_sum = sum(v["s"] for v in goodput.values())

    # Straggler view: the rank spending the most step time and the one
    # idling the most, with the spread that makes it a straggler.
    step_per_rank = {p["rank"]: p["components_s"]["step"] for p in per_rank}
    max_rank = max(step_per_rank, key=step_per_rank.get)
    min_rank = min(step_per_rank, key=step_per_rank.get)

    stages: Dict[str, float] = {}
    events: List[dict] = []
    for r in records:
        if r.get("kind") != "event":
            continue
        if r.get("name") == "stage" and "stage" in r:
            stages[r["stage"]] = stages.get(r["stage"], 0.0) + float(
                r.get("dur_s", 0.0))
        elif r.get("name") in _REPORTED_EVENTS:
            events.append(r)
    events.sort(key=lambda e: e.get("t", 0.0))

    # Telemetry self-accounting: sessions that dropped records (ring
    # eviction past the bound, stream write failures) say so at close —
    # totaled here so a truncated report ANNOUNCES its truncation.
    # Absent entirely (not zero) for streams without the event, keeping
    # old-stream aggregation byte-identical.
    dropped = {"ring": 0, "write": 0}
    have_drops = False
    for e in events:
        if e.get("name") == "telemetry_dropped":
            have_drops = True
            for k in ("ring", "write"):
                v = e.get(k)
                if isinstance(v, (int, float)):
                    dropped[k] += int(v)

    # Generation-stamped world sizes merged across ranks (the elastic
    # story: gen → how many processes that generation ran with).
    world_sizes: Dict[str, int] = {}
    for p in per_rank:
        for g, w in p.get("worlds", {}).items():
            world_sizes[g] = max(world_sizes.get(g, 0), int(w))

    report = {
        "num_records": len(records),
        "num_ranks": n,
        "generations": max(p["generations"] for p in per_rank),
        **({"world_sizes": {g: world_sizes[g]
                            for g in sorted(world_sizes, key=int)}}
           if world_sizes else {}),
        "wall_clock_s": round(wall_mean, 6),
        "run_span_s": round(
            max(p["t1"] for p in per_rank) - min(p["t0"] for p in per_rank),
            6),
        "step": _step_stats(records, num_ranks=n),
        "goodput": goodput,
        "goodput_sum_s": round(goodput_sum, 6),
        "stragglers": {
            "max_step_rank": max_rank,
            "max_step_s": round(step_per_rank[max_rank], 6),
            "min_step_rank": min_rank,
            "min_step_s": round(step_per_rank[min_rank], 6),
        },
        "per_rank": [
            {
                "rank": p["rank"],
                "generations": p["generations"],
                "wall_s": round(p["wall_s"], 6),
                "overlap_s": round(p["overlap_s"], 6),
                **{c: round(p["components_s"][c], 6) for c in COMPONENTS},
            }
            for p in per_rank
        ],
        "stages": {k: round(v, 6) for k, v in sorted(stages.items())},
        "events": events,
        **({"telemetry_dropped": dropped} if have_drops else {}),
    }
    serving = _serving_summary(records)
    if serving is not None:
        report["serving"] = serving
    # Measurement-driven planner (tpudist.plan): the plan_selected
    # stamps auto mode emitted — prediction next to the measured step/
    # TPOT numbers above.  Additive: absent entirely for streams
    # without the event (old-stream reports stay byte-identical).
    plans = [
        {k: e[k] for k in ("workload", "chosen", "predicted_s",
                           "predicted_ttft_s", "n_candidates",
                           "measured_components",
                           "extrapolated_components", "artifact_rounds",
                           "error_band_frac") if k in e}
        for e in events if e.get("name") == "plan_selected"
    ]
    if plans:
        report["plan"] = plans
    return report


def render_markdown(report: dict) -> str:
    """The human-readable twin of ``report.json``."""
    if report.get("num_records", 0) == 0:
        return f"# tpudist run report\n\n{report.get('error', 'no data')}\n"
    lines = ["# tpudist run report", ""]
    lines.append(
        f"- wall-clock (mean over {report['num_ranks']} rank"
        f"{'s' if report['num_ranks'] != 1 else ''}): "
        f"**{report['wall_clock_s']:.3f} s** "
        f"(run envelope {report['run_span_s']:.3f} s, "
        f"{report['generations']} process generation"
        f"{'s' if report['generations'] != 1 else ''})")
    if report.get("world_sizes"):
        lines.append(
            "- world size by generation: "
            + ", ".join(f"gen {g} → {w}"
                        for g, w in report["world_sizes"].items()))
    st = report["step"]
    lines.append(
        f"- steps: {st['count']} in {st['total_s']:.3f} s "
        f"({st['steps_per_s']:.1f} steps/s) — "
        f"p50 {st['p50_s'] * 1e3:.2f} ms, p95 {st['p95_s'] * 1e3:.2f} ms, "
        f"max {st['max_s'] * 1e3:.2f} ms")
    lines += ["", "## Goodput breakdown", "",
              "| component | seconds | % of wall |",
              "|---|---:|---:|"]
    for c in COMPONENTS:
        v = report["goodput"][c]
        lines.append(f"| {c} | {v['s']:.3f} | {v['frac'] * 100:.1f}% |")
    lines.append(f"| **total** | {report['goodput_sum_s']:.3f} | "
                 f"{report['goodput_sum_s'] / report['wall_clock_s'] * 100:.1f}% |"
                 if report["wall_clock_s"] > 0 else "| **total** | 0 | - |")
    sg = report["stragglers"]
    lines += ["", "## Per-rank", "",
              f"straggler: rank {sg['max_step_rank']} spent "
              f"{sg['max_step_s']:.3f} s in steps vs rank "
              f"{sg['min_step_rank']}'s {sg['min_step_s']:.3f} s", "",
              "| rank | gens | wall s | step | compile | data | ckpt | comm "
              "| init | other | idle | resize | lost_restart |",
              "|---:|---:|---:|---:|---:|---:|---:|---:|---:|---:|---:|---:"
              "|---:|"]
    for p in report["per_rank"]:
        lines.append(
            f"| {p['rank']} | {p['generations']} | {p['wall_s']:.3f} | "
            + " | ".join(f"{p[c]:.3f}" for c in COMPONENTS) + " |")
    if report.get("serving"):
        sv = report["serving"]
        lines += ["", "## Serving", ""]
        lines.append(
            f"- requests: {sv['requests_finished']} finished "
            f"({sv['finish_reasons']}), {sv['requests_rejected']} rejected")
        lines.append(
            f"- tokens out: {sv['tokens_out']} — decode {sv['decode_s']:.3f} s"
            f" + prefill {sv['prefill_s']:.3f} s"
            + (f" → {sv['tokens_per_s_busy']:.1f} tok/s busy"
               if sv["tokens_per_s_busy"] else ""))
        if sv.get("decode_blocks"):
            lines.append(
                f"- decode dispatch overhead: {sv['decode_blocks']} blocks, "
                f"{sv['tokens_per_dispatch']} tok/dispatch, host sync "
                f"{sv['host_sync_s']:.3f} s of {sv['decode_s']:.3f} s decode")
        for label, key in (("TTFT", "ttft"), ("TPOT", "tpot"),
                           ("queue wait", "queue_wait")):
            v = sv.get(key)
            if v:
                lines.append(
                    f"- {label}: p50 {v['p50_s'] * 1e3:.1f} ms, "
                    f"p95 {v['p95_s'] * 1e3:.1f} ms, "
                    f"max {v['max_s'] * 1e3:.1f} ms")
        if sv.get("occupancy_mean") is not None:
            lines.append(
                f"- batch occupancy: mean {sv['occupancy_mean']:.2f}, "
                f"max {sv['occupancy_max']:.2f}")
        if sv.get("slo"):
            slo = sv["slo"]
            tgt = ", ".join(f"{k.replace('_ms', '')} ≤ {v:g} ms"
                            for k, v in slo["targets_ms"].items())
            ov = slo["overall"]
            bits = [f"targets: {tgt}"]
            if ov.get("attainment") is not None:
                bits.append(f"overall attainment "
                            f"{ov['attainment'] * 100:.1f}%")
            for t, row in slo["per_tenant"].items():
                if row.get("attainment") is not None:
                    bits.append(f"{t}: {row['attainment'] * 100:.1f}% "
                                f"({row['requests']} reqs)")
            lines.append("- SLO: " + "; ".join(bits))
        if sv.get("adapters"):
            ad = sv["adapters"]
            bits = []
            if ad.get("blocks") is not None:
                bits.append(f"pool {ad['blocks']} blocks × rank "
                            f"{ad['rank']}")
            bits.append(f"{ad['loads']} loads / {ad['evicts']} evicts")
            if ad.get("resident_peak"):
                bits.append(f"peak resident {ad['resident_peak']}")
            if ad.get("requests"):
                served = ", ".join(f"{n}: {c}" for n, c in
                                   sorted(ad["requests"].items()))
                bits.append(f"requests by adapter ({served}; base "
                            f"{ad['base_only_requests']})")
            if ad.get("missing_finished"):
                bits.append(f"{ad['missing_finished']} adapter_missing")
            lines.append("- adapters: " + "; ".join(bits))
        if sv.get("constrained"):
            cn = sv["constrained"]
            bits = []
            if cn.get("blocks") is not None:
                bits.append(f"pool {cn['blocks']} blocks × "
                            f"{cn['max_states']} states")
            if cn.get("requests"):
                served = ", ".join(f"{k}: {c}" for k, c in
                                   sorted(cn["requests"].items()))
                bits.append(f"constrained requests ({served}; free "
                            f"{cn['free_requests']})")
            if cn.get("deferred"):
                bits.append(f"{cn['deferred']} pool-full deferrals")
            if cn.get("violations_finished"):
                bits.append(f"{cn['violations_finished']} "
                            "grammar_violation")
            if cn.get("stop_finished"):
                bits.append(f"{cn['stop_finished']} stop_sequence")
            if cn.get("logprobs_requests"):
                bits.append(f"{cn['logprobs_requests']} logprobs "
                            f"requests (width {cn.get('logprobs_width')})")
            lines.append("- constrained: " + "; ".join(bits))
        if sv.get("spec"):
            sp = sv["spec"]
            app = sp.get("accepted_per_pass") or {}
            bits = [f"{sp['blocks']} verify passes",
                    f"{sp['accepted']}/{sp['drafted']} drafts accepted"
                    + (f" ({sp['acceptance_rate'] * 100:.0f}%)"
                       if sp.get("acceptance_rate") is not None else ""),
                    f"{sp['rollbacks']} rollbacks"]
            if app:
                bits.append(f"tokens/pass p50 {app['p50']:.2f} / "
                            f"p95 {app['p95']:.2f}")
            bits.append(f"draft {sp['draft_s']:.3f} s vs verify "
                        f"{sp['verify_s']:.3f} s")
            lines.append("- speculative decode: " + "; ".join(bits))
        if sv.get("distill"):
            di = sv["distill"]
            bits = [f"{di['rounds']} rounds", f"{di['swaps']} swaps"]
            if di.get("round_reasons"):
                why = ", ".join(f"{k}: {c}" for k, c in
                                sorted(di["round_reasons"].items()))
                bits.append(f"gate ({why})")
            if di.get("acceptance_gain"):
                bits.append("acceptance gain mean "
                            f"{di['acceptance_gain']['mean']:+.3f}")
            if di.get("swap_s"):
                bits.append(f"swap p50 {di['swap_s']['p50'] * 1e3:.1f} ms")
            lines.append("- draft distillation: " + "; ".join(bits))
        if sv.get("pools"):
            pp = sv["pools"]
            bits = [f"prefill {pp['prefill']['span_s']:.3f} s "
                    f"({pp['prefill']['spans']} spans)",
                    f"decode {pp['decode']['span_s']:.3f} s "
                    f"({pp['decode']['spans']} spans)",
                    f"{pp['handoffs']} KV handoffs"]
            hw = pp.get("handoff_wait")
            if hw:
                bits.append(f"handoff wait p50 {hw['p50_s'] * 1e3:.1f} ms / "
                            f"p95 {hw['p95_s'] * 1e3:.1f} ms")
            if pp.get("workers_lost"):
                bits.append(f"{pp['workers_lost']} worker(s) lost, "
                            f"{pp['lanes_recovered']} lane(s) recovered")
            if pp.get("pool_resizes"):
                bits.append(f"{pp['pool_resizes']} backpressure resize(s)")
            lines.append("- disaggregated pools: " + "; ".join(bits))
            for label, pool, key in (("TTFT", "prefill", "ttft"),
                                     ("TPOT", "decode", "tpot")):
                v = pp[pool].get(key)
                if v:
                    lines.append(
                        f"  - {pool}-pool {label}: p50 "
                        f"{v['p50_s'] * 1e3:.1f} ms, "
                        f"p95 {v['p95_s'] * 1e3:.1f} ms")
        if sv.get("kv"):
            kv = sv["kv"]
            bits = []
            if kv.get("paged"):
                bits.append(
                    f"paged ({kv.get('blocks_total')} × "
                    f"{kv.get('block_size')}-token blocks"
                    + (", int8" if kv.get("quantized") else "") + ")")
            elif kv.get("paged") is False:
                bits.append("dense arena")
            if kv.get("block_occupancy_mean") is not None:
                bits.append(f"block occupancy mean "
                            f"{kv['block_occupancy_mean']:.2f} / max "
                            f"{kv['block_occupancy_max']:.2f}")
            if kv.get("bytes_resident_peak"):
                bits.append(f"peak resident "
                            f"{kv['bytes_resident_peak']:,} B")
            if kv.get("read_bytes_per_token"):
                # which attention path produced the number: live-KV
                # accounting (paged kernel) vs pool-geometry (gather)
                via = (f" via {kv['attn_kernel']}"
                       if kv.get("attn_kernel") else "")
                bits.append(f"decode streams "
                            f"{kv['read_bytes_per_token']:,.0f} B/token"
                            f"{via}")
            lines.append("- KV cache: " + "; ".join(bits))
            if kv.get("host_tier"):
                ht = kv["host_tier"]
                res = ht.get("resumes") or {}
                bits = [f"{ht['parks']} parks",
                        f"{sum(res.values())} resumes ({res})" if res
                        else "0 resumes",
                        f"{ht['spills']} spills",
                        f"{ht['preemptions']} preemptions"]
                if ht.get("corrupt"):
                    bits.append(f"{ht['corrupt']} corrupt (re-prefilled)")
                if ht.get("expired"):
                    bits.append(f"{ht['expired']} expired")
                if ht.get("bytes_peak"):
                    bits.append(f"peak {ht['bytes_peak']:,} B host RAM")
                rt = ht.get("resume_ttft")
                if rt:
                    bits.append(f"resume TTFT p50 {rt['p50_s'] * 1e3:.1f} "
                                f"ms / p95 {rt['p95_s'] * 1e3:.1f} ms")
                lines.append("- KV host tier: " + "; ".join(bits))
        if sv.get("overload"):
            ov = sv["overload"]
            last = ov.get("last_shed_state") or {}
            state = ("active" if last.get("active") else "inactive")
            lines.append(
                f"- overload control: {ov['shed_finished']} shed, "
                f"{ov['shed_state_changes']} shed-state change(s), "
                f"last {state}"
                + (f" at attainment {last.get('attainment')}"
                   if last.get("attainment") else ""))
        if sv.get("fleet"):
            fl = sv["fleet"]
            routes = ", ".join(f"{k}: {c}" for k, c in
                               sorted(fl.get("routes", {}).items()))
            bits = []
            if fl.get("replicas") is not None:
                bits.append(f"{fl['replicas']} replicas "
                            f"({fl.get('policy', '?')})")
            if routes:
                bits.append(f"routes by kind ({routes})")
            bits.append(f"{fl['spills']} spill(s), {fl['retries']} "
                        f"re-home retry(ies)")
            if fl.get("replica_deaths"):
                mig = fl.get("migrations", {})
                bits.append(f"{fl['replica_deaths']} replica death(s), "
                            f"{mig.get('ok', 0)} session(s) migrated, "
                            f"{fl.get('lost_finished', 0)} lost")
            lines.append("- fleet router: " + "; ".join(bits))
    if report.get("plan"):
        lines += ["", "## Plan (auto mode)", ""]
        for p in report["plan"]:
            bits = [f"chose **{p.get('chosen', '?')}** "
                    f"of {p.get('n_candidates', '?')} candidates",
                    f"predicted {p.get('predicted_s', 0) * 1e3:.3f} ms"]
            if p.get("predicted_ttft_s") is not None:
                bits.append(f"TTFT {p['predicted_ttft_s'] * 1e3:.1f} ms")
            bits.append(f"{p.get('measured_components', 0)} measured / "
                        f"{p.get('extrapolated_components', 0)} "
                        "extrapolated components")
            if p.get("error_band_frac") is not None:
                bits.append(f"error band ±{p['error_band_frac'] * 100:.1f}%")
            lines.append(f"- {p.get('workload', '?')}: " + "; ".join(bits))
            if p.get("artifact_rounds"):
                lines.append(f"  - artifacts: {p['artifact_rounds']}")
    if report.get("telemetry_dropped"):
        td = report["telemetry_dropped"]
        lines += ["", f"**⚠ telemetry dropped records** — ring evictions: "
                      f"{td.get('ring', 0)}, stream write failures: "
                      f"{td.get('write', 0)} (this report is incomplete)"]
    if report.get("stages"):
        lines += ["", "## Host stages (StageTimer)", ""]
        for k, v in report["stages"].items():
            lines.append(f"- {k}: {v:.3f} s")
    if report.get("events"):
        lines += ["", "## Events", ""]
        for e in report["events"]:
            tags = {k: v for k, v in e.items()
                    if k not in ("kind", "name", "t", "dur")}
            lines.append(f"- t={e.get('t', 0.0):.3f} **{e['name']}** {tags}")
    lines.append("")
    return "\n".join(lines)


def write_reports(run_dir: "str | Path",
                  out_dir: "str | Path | None" = None
                  ) -> Tuple[dict, Dict[str, Optional[Path]]]:
    """Aggregate ``run_dir`` and write ``report.json`` + ``report.md``
    (into ``out_dir``, default: the telemetry dir itself).  Returns
    ``(report, {"json": path, "md": path})``; paths are ``None`` for
    files that could not be written (the report dict is still returned)."""
    tdir = find_telemetry_dir(run_dir)
    report = aggregate_run(tdir)
    out = Path(out_dir) if out_dir is not None else tdir
    paths: Dict[str, Optional[Path]] = {"json": None, "md": None}
    try:
        out.mkdir(parents=True, exist_ok=True)
        jp = out / "report.json"
        jp.write_text(json.dumps(report, indent=2) + "\n")
        paths["json"] = jp
        mp = out / "report.md"
        mp.write_text(render_markdown(report))
        paths["md"] = mp
    except OSError:
        pass
    return report, paths
