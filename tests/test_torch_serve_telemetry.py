"""The port's serving runtime plane against the JAX server's: the same
small model and requests through both servers emit the same record names
and request counts; ``/healthz``, ``/statusz`` and ``/metrics`` answer on
``TPUDIST_METRICS_PORT``, ``/healthz`` going 503 on a loop abort and on a
stale heartbeat; SIGTERM drains the server; ``--telemetry-dir`` writes the
report and ``python -m tpudist_torch.telemetry trace`` one lifeline a
request."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from torch_cases import settled_torch_cpu
from tpudist import telemetry as jax_telemetry
from tpudist.models import create_transformer as jax_create
from tpudist.serve import InferenceServer as JaxServer
from tpudist.serve import ServeConfig as JaxServeConfig
from tpudist_torch import telemetry
from tpudist_torch.models import TransformerLM
from tpudist_torch.models.convert import params_from_flax
from tpudist_torch.runtime import preemption
from tpudist_torch.serve import AdmissionError, InferenceServer, ServeConfig
from tpudist_torch.serve.__main__ import main as serve_main
from tpudist_torch.telemetry import metrics, statusz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_len=32)
#: the JAX server's default engine arms, on both servers
ARMS = dict(paged=False, attn_kernel="gather", prefill_kernel=False,
            sample_kernel=False, num_slots=2, prefill_pad=8, decode_block=2,
            max_new=6)
N_REQ = 5


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(scope="module")
def models():
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, **BASE)
    model = TransformerLM(**BASE)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return (jmod, jparams), model.requires_grad_(False)


@pytest.fixture(autouse=True)
def serve_env(monkeypatch):
    for name in [n for n in os.environ if n.startswith("TPUDIST_SERVE_")]:
        monkeypatch.delenv(name)
    for name in ("TPUDIST_METRICS_PORT", "TPUDIST_FAULT",
                 "TPUDIST_RESTART_COUNT", "TPUDIST_TELEMETRY"):
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    statusz.stop()
    preemption.reset()


def _prompts():
    r = np.random.default_rng(0)
    return [r.integers(0, BASE["vocab"], size=int(n)).astype(np.int32)
            for n in r.integers(2, 12, size=N_REQ)]


def _records(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def _serve(server, tenant=None):
    server.start()
    hs = [server.submit(p, tenant=tenant) for p in _prompts()]
    for h in hs:
        assert h.wait(120)
    server.close(60)
    return hs


def test_records_equal_jax(models, tmp_path):
    """The same requests through the JAX and the port server (the JAX
    server's default arms): the same record names, one
    ``request_finished`` and one lifeline a request, the same tenant
    labels and token counts."""
    (jmod, jparams), model = models
    jax_telemetry.start(tmp_path / "jax")
    try:
        jh = _serve(JaxServer(jmod, jparams, JaxServeConfig(**ARMS),
                              install_signal_handler=False), "acme")
    finally:
        jax_telemetry.finish(write_report=False)
    telemetry.start(tmp_path / "port")
    try:
        ph = _serve(InferenceServer(model, ServeConfig(**ARMS), device="cpu",
                                    install_signal_handler=False), "acme")
    finally:
        telemetry.finish(write_report=False)
    want = _records(tmp_path / "jax" / "rank0_gen0.jsonl")
    got = _records(tmp_path / "port" / "rank0_gen0.jsonl")
    assert {r["name"] for r in got} == {r["name"] for r in want}
    for name in ("request_finished", "req_queue", "req_prefill",
                 "req_decode", "serve_kv_config", "serve_drain"):
        assert sum(r["name"] == name for r in got) == \
            sum(r["name"] == name for r in want), name
    fin = [r for r in got if r["name"] == "request_finished"]
    assert len(fin) == N_REQ and {r["tenant"] for r in fin} == {"acme"}
    assert sorted(r["tokens_out"] for r in fin) == sorted(
        r["tokens_out"] for r in want if r["name"] == "request_finished")
    assert [h.tokens for h in ph] == [h.tokens for h in jh]
    kv = [r for r in got if r["name"] == "serve_kv_config"][0]
    kv_want = [r for r in want if r["name"] == "serve_kv_config"][0]
    assert set(kv) == set(kv_want)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait_for(pred, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = pred()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError("condition not reached")


def test_endpoints_and_healthz_on_abort(models, tmp_path, serve_env):
    """``/healthz`` 200 while the loop runs, ``/statusz`` with the KV
    gauges and tenant counts, ``/metrics`` with the token counter and the
    TTFT/TPOT sketches; an engine error aborts the loop, ``/healthz`` goes
    503 and names it."""
    serve_env.setenv("TPUDIST_METRICS_PORT", "0")
    serve_env.setenv("TPUDIST_TELEMETRY_DIR", str(tmp_path / "t"))
    metrics.registry().clear()
    _, model = models
    server = InferenceServer(model, ServeConfig(**ARMS), device="cpu",
                             install_signal_handler=False).start()
    port = statusz.active().port
    try:
        assert _get(port, "/healthz")[0] == 200
        for h in [server.submit(p, tenant="acme") for p in _prompts()]:
            assert h.wait(60)
        doc = json.loads(_get(port, "/statusz")[1])["serve"]
        assert doc["kv"]["bytes_resident"] >= 0 and doc["completed"] == N_REQ
        assert doc["tenants_in_flight"] == {}
        text = _get(port, "/metrics")[1]
        for name in ("tpudist_tokens_out_total", "tpudist_ttft_seconds",
                     "tpudist_tpot_seconds"):
            assert name in text, name

        def boom():
            raise RuntimeError("device lost")

        server.engine.decode_auto = boom
        server.submit(_prompts()[0])
        code, body = _wait_for(lambda: (lambda c: c if c[0] == 503 else None)(
            _get(port, "/healthz")))
        assert "device lost" in json.loads(body)["checks"]["serve"][
            "loop_error"]
    finally:
        server.close(30)
        telemetry.finish(write_report=False)


def test_healthz_on_a_stale_heartbeat(models, tmp_path, serve_env):
    """A loop that stops beating past ``TPUDIST_SERVE_HEALTH_STALE_S``
    reads 503 ``heartbeat_stale`` though its thread lives."""
    serve_env.setenv("TPUDIST_METRICS_PORT", "0")
    serve_env.setenv("TPUDIST_SERVE_HEALTH_STALE_S", "0.2")
    serve_env.setenv("TPUDIST_TELEMETRY", "0")
    _, model = models
    server = InferenceServer(model, ServeConfig(**ARMS), device="cpu",
                             install_signal_handler=False)
    server.scheduler.wait_for_work = lambda timeout: time.sleep(1.0)
    server.start()
    port = statusz.active().port
    try:
        code, body = _wait_for(lambda: (lambda c: c if c[0] == 503 else None)(
            _get(port, "/healthz")))
        check = json.loads(body)["checks"]["serve"]
        assert check["heartbeat_stale"] and check["engine_thread_alive"]
    finally:
        server.close(30)


def test_sigterm_drains_the_server(models, tmp_path, serve_env):
    """SIGTERM to the process drains as JAX's server does: ``serve_drain``
    is emitted, new submits are refused ``draining``, the requests in
    flight finish by their budget."""
    _, model = models
    telemetry.start(tmp_path / "t")
    server = InferenceServer(model, ServeConfig(**ARMS), device="cpu")
    try:
        server.engine  # built
        server.start()
        assert server._installed_preemption
        hs = [server.submit(p, max_new=6) for p in _prompts()]
        os.kill(os.getpid(), signal.SIGTERM)
        _wait_for(lambda: server._draining)
        with pytest.raises(AdmissionError, match="draining"):
            server.submit(_prompts()[0])
        for h in hs:
            assert h.wait(60) and h.finish_reason == "length"
    finally:
        server.close(30)
        telemetry.finish(write_report=False)
    names = [r["name"] for r in _records(tmp_path / "t" / "rank0_gen0.jsonl")]
    assert "serve_drain" in names and "serve_rejected" in names
    assert names.count("request_finished") == N_REQ


def test_telemetry_dir_and_trace_cli(tmp_path):
    """``python -m tpudist_torch.serve --telemetry-dir`` writes the report;
    ``python -m tpudist_torch.telemetry trace`` one lifeline a request."""
    out = tmp_path / "tele"
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve_main(["--device", "cpu", "--requests", "3",
                           "--max-new", "4", "--telemetry-dir",
                           str(out)]) == 0
    assert json.loads(buf.getvalue())["telemetry_report"] is True
    assert (out / "report.json").exists() and (out / "report.md").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.telemetry", "trace", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert "3 request lifelines" in proc.stdout
    trace = json.loads((out / "trace.json").read_text())
    assert trace["otherData"]["traces"] == 3
