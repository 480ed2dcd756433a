"""The port's telemetry package (``tpudist_torch/telemetry``) against the
JAX package's: the same seeded record streams give equal reports (the
``aggregate_run`` dict and the ``render_markdown`` text), equal sketches
(``bucket_index``/``bucket_value``), equal Prometheus text and equal
Chrome traces; and the port's live session writes the schema JAX reads.
Stdlib only on both sides: no model, no device."""

import json

import numpy as np
import pytest

from tpudist import telemetry as jax_telemetry
from tpudist.telemetry import aggregate as jax_aggregate
from tpudist.telemetry import metrics as jax_metrics
from tpudist.telemetry import trace as jax_trace
from tpudist_torch import telemetry
from tpudist_torch.telemetry import aggregate, metrics, trace


def _stream(seed: int) -> dict:
    """A seeded run: two ranks of generation 0 training (init, compile,
    steps, data waits, checkpoints, host collectives) and serving (prefill,
    plain and speculative decode blocks, finished and rejected requests
    with their lifelines), a fault and a watchdog stall, then rank 0's
    restarted generation 1.  ``{file name: [record, ...]}``."""
    r = np.random.default_rng(seed)
    files = {}
    t_base = 1.7e9 + seed

    def rec(kind, name, t, dur=0.0, rank=0, gen=0, **tags):
        out = {"kind": kind, "name": name, "t": round(t, 6),
               "dur": round(dur, 9), "rank": rank, "gen": gen}
        out.update(tags)
        return out

    for rank, gen, t0 in ((0, 0, t_base), (1, 0, t_base + 0.01),
                          (0, 1, t_base + 30.0)):
        t = t0
        out = [rec("event", "session_start", t, rank=rank, gen=gen,
                   pid=1000 + rank, world=2)]
        d = float(r.uniform(0.5, 2.0))
        out.append(rec("span", "init", t, d, rank, gen, world=2,
                       source="torchrun"))
        t += d
        if gen == 1:
            d = float(r.uniform(0.1, 0.4))
            out.append(rec("span", "ckpt_restore", t, d, rank, gen, step=6))
            t += d
        d = float(r.uniform(1.0, 3.0))
        out.append(rec("span", "compile", t, d, rank, gen))
        t += d
        for i in range(int(r.integers(8, 14))):
            d = float(r.uniform(0.0, 0.02))
            out.append(rec("span", "data_wait", t, d, rank, gen))
            t += d
            d = float(r.uniform(0.05, 0.09))
            tags = {"steps": 4} if i % 3 == 0 else {}
            out.append(rec("span", "step", t, d, rank, gen, **tags))
            t += d + float(r.uniform(0.0, 0.005))
            if i % 4 == 3:
                d = float(r.uniform(0.01, 0.2))
                out.append(rec("span", "ckpt_save", t, d, rank, gen,
                               step=i + 1, blocking=False))
                t += d
                d = float(r.uniform(0.001, 0.01))
                out.append(rec("span", "host_collective", t, d, rank, gen,
                               op="barrier[checkpoint_save]"))
                t += d
            if i % 5 == 4:
                d = float(r.uniform(0.001, 0.02))
                out.append(rec("span", "metric_flush", t, d, rank, gen,
                               rows=5))
                t += d
        out.append(rec("event", "stage", t, rank=rank, gen=gen,
                       stage="load", dur_s=round(float(r.uniform(0, 1)), 6)))
        out.append(rec("event", "prefetch_stats", t, rank=rank, gen=gen,
                       producer_wait_s=0.5, consumer_wait_s=0.01,
                       batches=12))
        if rank == 0:
            out.append(rec("event", "serve_kv_config", t, rank=rank,
                           gen=gen, paged=True, quantized=False,
                           attn_kernel="paged", prefill_kernel=True,
                           sample_kernel=True, fused_rope=False,
                           lora_kernel=False, block_size=16,
                           blocks_total=64, pool_bytes=1 << 20,
                           bytes_per_pos=256, num_slots=4, max_len=128))
            out.append(rec("event", "slo_config", t, rank=rank, gen=gen,
                           ttft_ms=50.0, tpot_ms=10.0))
            for j in range(int(r.integers(6, 10))):
                tid = "%016x" % int(r.integers(0, 2 ** 62))
                tenant = ["acme", "beta", None][j % 3]
                tq = float(r.uniform(0.0, 0.01))
                tp = float(r.uniform(0.01, 0.05))
                td = float(r.uniform(0.05, 0.3))
                lab = {"trace_id": tid, **({"tenant": tenant}
                                           if tenant else {})}
                out.append(rec("span", "prefill", t, tp, rank, gen, n=1))
                for name, a, b in (("req_queue", 0.0, tq),
                                   ("req_prefill", tq, tq + tp),
                                   ("req_decode", tq + tp, tq + tp + td)):
                    out.append(rec("span", name, t + a, b - a, rank, gen,
                                   parent="request", **lab))
                spec = j % 2 == 1
                tags = {"occupancy": float(r.uniform(0.2, 1.0)),
                        "active": int(r.integers(1, 5)), "k": 4,
                        "tokens": 8, "dispatch_s": 0.001, "sync_s": 0.002,
                        "kv_block_occupancy": 0.3,
                        "kv_bytes_resident": 4096, "kv_read_bytes": 65536}
                if spec:
                    tags.update(accepted=int(r.integers(0, 5)), drafted=4,
                                rollbacks=1, draft_s=0.001, verify_s=0.002)
                out.append(rec("span", "spec_verify" if spec
                               else "decode_block", t + tq + tp, td, rank,
                               gen, **tags))
                n_out = int(r.integers(2, 17))
                out.append(rec("event", "request_finished",
                               t + tq + tp + td, rank=rank, gen=gen,
                               id=j, reason=["length", "eos"][j % 2],
                               prompt_len=int(r.integers(1, 30)),
                               tokens_out=n_out, ttft_s=tq + tp,
                               tpot_s=td / max(1, n_out - 1),
                               queue_wait_s=tq, **lab))
                t += tq + tp + td
            out.append(rec("event", "serve_rejected", t, rank=rank, gen=gen,
                           reason="queue_full"))
            out.append(rec("event", "serve_drain", t, rank=rank, gen=gen,
                           pending=0, active=1))
        if gen == 0 and rank == 0:
            out.append(rec("event", "fault_injected", t, rank=rank, gen=gen,
                           fault="sigterm", step=6))
            out.append(rec("event", "retry", t, rank=rank, gen=gen,
                           what="init", attempt=0, error="RuntimeError",
                           backoff_s=0.5))
        if gen == 0 and rank == 1:
            out.append(rec("event", "watchdog_stall", t, rank=rank, gen=gen,
                           watchdog="train_loop", stalled_for_s=3.0,
                           deadline_s=2.0))
        d = float(r.uniform(0.01, 0.1))
        out.append(rec("span", "ckpt_wait", t, d, rank, gen))
        t += d
        out.append(rec("event", "session_end", t, rank=rank, gen=gen))
        files[f"rank{rank}_gen{gen}.jsonl"] = out
    return files


def _write(tmp_path, files):
    for name, recs in files.items():
        (tmp_path / name).write_text(
            "".join(json.dumps(x) + "\n" for x in recs))
    return tmp_path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_equals_jax(tmp_path, seed):
    """The same seeded stream: equal ``aggregate_run`` dicts and equal
    ``render_markdown`` text, and the report's goodput components sum to
    its wall-clock."""
    run = _write(tmp_path, _stream(seed))
    got, want = aggregate.aggregate_run(run), jax_aggregate.aggregate_run(run)
    assert got == want
    assert aggregate.render_markdown(got) == \
        jax_aggregate.render_markdown(want)
    assert got["serving"]["requests_finished"] >= 6
    assert got["generations"] == 2 and got["goodput"]["lost_restart"]["s"] > 0
    assert got["goodput_sum_s"] == pytest.approx(got["wall_clock_s"],
                                                 rel=1e-2)


def test_sketch_buckets_equal_jax():
    """The log-bucket sketch's index and representative value over seeded
    values spanning its range, zero and negatives included."""
    r = np.random.default_rng(3)
    vals = np.concatenate([[0.0, -1.0, 1e-12, 1e12],
                           10.0 ** r.uniform(-9, 6, 500)])
    for v in vals.tolist():
        i = metrics.bucket_index(v)
        assert i == jax_metrics.bucket_index(v)
        assert metrics.bucket_value(i) == jax_metrics.bucket_value(i)


def test_prometheus_and_chrome_trace_equal_jax(tmp_path, monkeypatch):
    """Every record of a seeded stream fed to both registries renders the
    same Prometheus text and snapshot; the Chrome trace of the stream is
    the same document, one lifeline a request."""
    from tpudist.telemetry import spans as jax_spans
    from tpudist_torch.telemetry import spans

    files = _stream(4)
    records = [x for recs in files.values() for x in recs]
    # both feeds armed, whatever sessions earlier tests left in the process
    monkeypatch.setattr(spans, "_SINK", metrics.feed_record)
    monkeypatch.setattr(jax_spans, "_SINK", jax_metrics.feed_record)
    metrics.registry().clear()
    jax_metrics.registry().clear()
    try:
        for x in records:
            metrics.feed_record(dict(x))
            jax_metrics.feed_record(dict(x))
        metrics.set_train_gauges(12, {"lm": 2.5})
        jax_metrics.set_train_gauges(12, {"lm": 2.5})
        got = metrics.registry().render_prometheus()
        assert got == jax_metrics.registry().render_prometheus()
        assert "tpudist_decode_tokens_total" in got
        assert metrics.registry().snapshot() == \
            jax_metrics.registry().snapshot()
    finally:
        metrics.registry().clear()
        jax_metrics.registry().clear()
    mine, theirs = trace.to_chrome_trace(records), \
        jax_trace.to_chrome_trace(records)
    assert mine == theirs
    n_req = sum(x["name"] == "request_finished" for x in records)
    assert mine["otherData"]["traces"] == n_req


def test_live_session_stream_reads_in_jax(tmp_path, monkeypatch):
    """The port's session (spans, events, the lifeline of a finished
    handle) writes the schema JAX's loader and aggregator read: the two
    reports of its directory are equal, and ``TPUDIST_TELEMETRY=0``
    disarms it."""
    monkeypatch.setenv("TPUDIST_RESTART_COUNT", "0")
    monkeypatch.delenv("TPUDIST_RANK", raising=False)
    s = telemetry.start(tmp_path)
    try:
        with telemetry.span("compile"):
            pass
        for _ in range(3):
            with telemetry.span("step"):
                with telemetry.span("data_wait"):
                    pass

        class _Req:
            tenant = "acme"

        class _Handle:
            request, trace_id = _Req(), trace.new_trace_id()
            t_submit, t_admitted, t_first_token = 1.0, 1.5, 2.0
            t_prefill_done = t_decode_start = None
            t_done = 3.0

        trace.emit_request_lifeline(_Handle())
        telemetry.event("fault_injected", fault="sigterm", step=2)
    finally:
        report = telemetry.finish()
    assert s.path == tmp_path / "rank0_gen0.jsonl"
    recs = jax_telemetry.load_records(tmp_path)
    assert [x["name"] for x in recs if x["kind"] == "span"] == [
        "compile", "data_wait", "step", "data_wait", "step", "data_wait",
        "step", "req_queue", "req_prefill", "req_decode"]
    assert recs[-4]["parent"] == "request" and recs[-4]["tenant"] == "acme"
    assert report == jax_aggregate.aggregate_run(tmp_path)
    monkeypatch.setenv("TPUDIST_TELEMETRY", "0")
    assert telemetry.ensure_started() is None


@pytest.mark.parametrize("sync", [False, True], ids=["dispatch", "synced"])
def test_after_step_bracket(tmp_path, monkeypatch, sync):
    """The loops' shared step bracket: the first step closes a
    ``compile`` span, a later one a ``step`` span with its tags; each pets
    the watchdog, a save point pets it again; the first step, and a later
    one with ``sync``, wait for the result before the span closes."""
    import time

    import torch

    from tpudist_torch.train import loop

    monkeypatch.setenv("TPUDIST_RESTART_COUNT", "0")
    monkeypatch.delenv("TPUDIST_RANK", raising=False)
    waits, pets, saves = [], [], []
    monkeypatch.setattr(loop, "block_until_ready", waits.append)

    class _Watchdog:
        def pet(self):
            pets.append(len(saves))

    class _Ckpt:
        def maybe_save(self, iteration, states, meta):
            saves.append((iteration, meta))

    s = telemetry.start(tmp_path)
    try:
        out = torch.zeros(())
        for i in range(3):
            loop.after_step(s, _Watchdog(), time.monotonic(), i == 0, out,
                            sync=sync, tags={"steps": 1})
            loop.save_point(_Ckpt(), _Watchdog(), i + 1, {},
                            {"iteration": i + 1})
        loop.after_step(None, None, None, False, out, sync=True)
    finally:
        telemetry.finish(write_report=False)
    recs = [json.loads(x) for x in (tmp_path / "rank0_gen0.jsonl").open()]
    spans = [(x["name"], x["steps"]) for x in recs if x["kind"] == "span"]
    assert spans == [("compile", 1), ("step", 1), ("step", 1)]
    assert len(waits) == (3 if sync else 1)
    assert pets == [0, 1, 1, 2, 2, 3]
    assert saves == [(i, {"iteration": i}) for i in (1, 2, 3)]
