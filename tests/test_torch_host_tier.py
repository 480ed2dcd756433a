"""Graceful degradation under overload on the port
(``tpudist_torch/serve/{host_tier,overload,disagg}.py``, the server's
preemption and session paths) against the JAX package on the CPU.

- the same put/match/spill/TTL/fault sequences give ``HostKVTier`` stats
  equal to JAX's (byte counts included: the port's wire form carries the
  same leaf bytes);
- the wire round trip preserves the bytes of f32, bf16 and int8 lanes; a
  flipped byte raises ``HandoffError("corrupt")``, a bad version
  ``"schema"``;
- the priority queue, ``head_info``, ``shed`` and the admission gate, and
  the same event scripts through ``OverloadController``, decide as JAX's;
- with weights carried across, the port server's greedy streams equal the
  JAX ``InferenceServer``'s under priority preemption and across a session
  resume (and ``generate()``'s); sampled streams equal the port's own
  unpreempted or fresh run; a corrupt park re-prefills to the same stream;
- a lane exported from a decoding slot and imported into another slot
  and into a fresh engine — through ``serialize_package`` or not —
  continues bit for bit, on the dense cache, the kernel arm, the int8
  pool (on one place and over a ``1x2`` serving mesh) and a spec engine
  (through ``draft_arm``); the importer holds the
  exported bytes (a paged lane's blocks as stored, int8 and scales
  included).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models import create_transformer as jax_create
from tpudist.models import generate as jax_generate
from tpudist.runtime import faults as jax_faults
from tpudist.serve import InferenceServer as JaxServer
from tpudist.serve import ServeConfig as JaxServeConfig
from tpudist.serve.disagg import serialize_package as jax_serialize
from tpudist.serve.host_tier import HostKVTier as JaxTier
from tpudist.serve.overload import OverloadController as JaxController
from tpudist.serve.scheduler import Scheduler as JaxScheduler
from tpudist.telemetry import metrics as jax_metrics
from torch_cases import settled_torch_cpu
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.runtime import faults
from tpudist_torch.serve import (HandoffError, HostKVTier, HostTierError,
                                 InferenceServer, OverloadController,
                                 ServeConfig, SlotEngine,
                                 deserialize_package, serialize_package)
from tpudist_torch.serve.scheduler import (AdmissionError, Request,
                                           RequestHandle, Scheduler)
from tpudist_torch.telemetry import metrics

CFG = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=64)
#: the port server's geometry in these drives (the paged kernel arms, run
#: by their plain versions on the CPU)
PORT_KW = dict(prefill_pad=8, kv_block=8)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def carried_models(**extra):
    """The JAX model (module, params) and the port's TransformerLM with the
    same weights."""
    cfg = dict(CFG, **extra)
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, **cfg)
    model = TransformerLM(**cfg)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return (jmod, jparams), model.requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    return carried_models(rope=True)


def prompt_of(plen, seed, vocab=CFG["vocab"]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=plen).astype(np.int32)


def reference(jax_model, prompt, max_new):
    module, params = jax_model
    out = jax_generate(module, params, jnp.asarray(prompt)[None], max_new)
    return np.asarray(out)[0, len(prompt):].tolist()


def wait_for(pred, timeout=30.0, msg="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.005)


def _fake_pkg(n=64, jax_side=False):
    """JAX's ``_fake_pkg``: the same leaf bytes in either framework."""
    if jax_side:
        return {"paged": False, "pos": 3, "counts": 1, "budget": 8,
                "lane": {"k": jnp.arange(n, dtype=jnp.float32)},
                "state": {"last": jnp.asarray(7, jnp.int32)}}
    return {"paged": False, "pos": 3, "counts": 1, "budget": 8,
            "lane": {"k": torch.arange(n, dtype=torch.float32)},
            "state": {"last": torch.tensor(7, dtype=torch.int32)}}


def _both_tiers(budget=1 << 20, **kw):
    return HostKVTier(budget, **kw), JaxTier(budget, **kw)


# -- the host tier: the same scripts, the same stats --------------------------

def _script_lru(tier, jax_side):
    tier.put(("preempt", 1), _fake_pkg(jax_side=jax_side), pinned=True)
    tier.put(("sess", "t", "b"), _fake_pkg(jax_side=jax_side))
    tier.put(("sess", "t", "c"), _fake_pkg(jax_side=jax_side),
             context=np.arange(4, dtype=np.int32))
    tier.byte_budget = tier.bytes_resident + 10
    tier.put(("sess", "t", "d"), _fake_pkg(jax_side=jax_side))
    return [tier.contains(k) for k in (("preempt", 1), ("sess", "t", "b"),
                                       ("sess", "t", "c"))]


def _script_pinned_last(tier, jax_side):
    tier.put(("preempt", 1), _fake_pkg(jax_side=jax_side), pinned=True)
    tier.byte_budget = tier.bytes_resident + 10
    tier.put(("sess", "t", "x"), _fake_pkg(jax_side=jax_side))
    return [tier.contains(("preempt", 1)), tier.contains(("sess", "t", "x"))]


def _script_oversize(tier, jax_side):
    tier.byte_budget = 64
    return [tier.put(("sess", "t", "a"), _fake_pkg(jax_side=jax_side))]


def _script_ttl(tier, jax_side):
    tier.ttl_s = 10.0
    now = 1000.0
    tier.put(("sess", "t", "a"), _fake_pkg(jax_side=jax_side), now=now)
    tier.put(("preempt", 1), _fake_pkg(jax_side=jax_side), pinned=True,
             now=now)
    return [tier.sweep_expired(now + 5), tier.sweep_expired(now + 11),
            tier.contains(("preempt", 1))]


def _script_match(tier, jax_side):
    ctx = np.asarray([3, 1, 4, 1, 5], np.int32)
    tier.put(("sess", "t", "a"), _fake_pkg(jax_side=jax_side), context=ctx)
    tier.put(("sess", "t", "b"), _fake_pkg(jax_side=jax_side), context=ctx)
    out = [tier.match(("sess", "t", "a"), np.asarray([3, 1, 4, 1, 5, 9])),
           tier.match(("sess", "t", "b"), ctx[:3]),
           tier.match(("sess", "t", "a"), np.asarray([3, 1, 4, 2, 5, 9])),
           tier.contains(("sess", "t", "a")),
           tier.contains(("sess", "t", "b"))]
    tier.get(("sess", "t", "b"))
    out.append(tier.session_keys())
    return out


def _script_migrate(tier, jax_side):
    """export_entry → adopt into a sibling tier of the same budget."""
    tier.put(("sess", "t", "a"), _fake_pkg(jax_side=jax_side),
             context=np.arange(3, dtype=np.int32))
    stash = tier.export_entry(("sess", "t", "a"))
    sibling = type(tier)(tier.byte_budget)
    stored = sibling.adopt(("sess", "t", "a"), stash["ser"],
                           context=stash["context"], kind=stash["kind"])
    return [stored, tier.export_entry(("sess", "t", "zz")),
            sibling.stats()]


@pytest.mark.parametrize("script", [
    _script_lru, _script_pinned_last, _script_oversize, _script_ttl,
    _script_match, _script_migrate],
    ids=["lru", "pinned_last", "oversize", "ttl", "match", "migrate"])
def test_tier_scripts_match_jax(script):
    """Each put/match/spill/TTL/migrate script leaves the port's tier with
    JAX's decisions and stats (``bytes`` included)."""
    port, jaxt = _both_tiers()
    assert script(port, False) == script(jaxt, True)
    assert port.stats() == jaxt.stats()


def test_tier_put_get_round_trip_and_missing():
    tier = HostKVTier(1 << 20)
    stored = tier.put(("sess", "t", "a"), _fake_pkg(),
                      context=np.arange(4, dtype=np.int32))
    assert stored and tier.entries == 1 and tier.bytes_resident == stored
    out = deserialize_package(tier.get(("sess", "t", "a")))
    assert torch.equal(out["lane"]["k"], torch.arange(64.0))
    assert tier.entries == 0 and tier.bytes_resident == 0
    with pytest.raises(HostTierError) as ei:
        tier.get(("sess", "t", "a"))
    assert ei.value.reason == "missing"


def test_host_tier_corrupt_fault_garbles_nth_parked():
    """``host_tier_corrupt@nth:2`` garbles the second park after its
    digest stamp, once — as on the JAX tier."""
    got = {}
    for name, tier, fl, jax_side in (
            ("port", HostKVTier(1 << 20), faults, False),
            ("jax", JaxTier(1 << 20), jax_faults, True)):
        fl.arm("host_tier_corrupt@nth:2")
        try:
            seen = []
            for key in "abc":
                tier.put(("sess", "t", key), _fake_pkg(jax_side=jax_side))
                ser = tier.get(("sess", "t", key))
                seen.append(ser["digest"] == (
                    _digest_port(ser) if name == "port"
                    else _digest_jax(ser)))
        finally:
            fl.disarm()
        got[name] = (seen, tier.stats())
    assert got["port"] == got["jax"]
    assert got["port"][0] == [True, False, True]


def _digest_port(ser):
    from tpudist_torch.serve.disagg import _blob_digest

    return _blob_digest(ser["blob"])


def _digest_jax(ser):
    from tpudist.serve.disagg import _blob_digest

    return _blob_digest(ser["blob"])


# -- the wire form ------------------------------------------------------------

def _lane_pkg(dtype):
    g = torch.Generator().manual_seed(3)
    k = torch.randn(2, 2, 16, 8, generator=g)
    if dtype == torch.int8:
        k = (k * 40).round().clamp(-127, 127)
    k = k.to(dtype)
    from tpudist_torch.models.generate import SlotState

    row = SlotState(*(torch.tensor(v, dtype=d) for v, d in (
        (5, torch.int32), (True, torch.bool), (9, torch.int32),
        (4, torch.int32), (0.8, torch.float32), (2 ** 32 - 1, torch.int64),
        (1, torch.int32), (2, torch.int32), (3, torch.int32))))
    return {"paged": True, "pos": 9, "counts": 4, "budget": 12,
            "trace_id": "t0", "adapter": "a1",
            "grammar": {"source": {"kind": "regex", "src": "ab"},
                        "eos_id": 1},
            "lane": (k, k.flip(2), torch.tensor(9, dtype=torch.int32)),
            "state": row}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
def test_wire_round_trip_preserves_bytes(dtype):
    pkg = _lane_pkg(dtype)
    ser = serialize_package(pkg)
    assert ser["schema_version"] == 5 and len(ser["digest"]) == 32
    assert ser["bytes"] == sum(len(b) for b, _, _ in ser["blob"])
    out = deserialize_package(ser)
    for a, b in zip(pkg["lane"] + tuple(pkg["state"]),
                    out["lane"] + tuple(out["state"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8)
                           if a.dtype != torch.bool else a,
                           b.reshape(-1).view(torch.uint8)
                           if b.dtype != torch.bool else b)
    assert type(out["state"]).__name__ == "SlotState"
    for key in ("paged", "pos", "counts", "budget", "trace_id", "adapter",
                "grammar"):
        assert out[key] == pkg[key]


def test_wire_digest_and_schema_are_jax_s():
    """The same leaf bytes give JAX's digest and byte count."""
    port = serialize_package(_fake_pkg())
    theirs = jax_serialize(_fake_pkg(jax_side=True))
    assert (port["digest"], port["bytes"], port["schema_version"]) == (
        theirs["digest"], theirs["bytes"], theirs["schema_version"])


def test_wire_rejects_flipped_byte_and_bad_schema():
    ser = serialize_package(_lane_pkg(torch.bfloat16))
    b, dt, shape = ser["blob"][0]
    bad = dict(ser, blob=[(bytes([b[0] ^ 0x01]) + b[1:], dt, shape)]
               + ser["blob"][1:])
    with pytest.raises(HandoffError) as ei:
        deserialize_package(bad)
    assert ei.value.reason == "corrupt"
    for ver in (None, 1, 6, "5"):
        with pytest.raises(HandoffError) as ei:
            deserialize_package(dict(ser, schema_version=ver))
        assert ei.value.reason == "schema"
    old = dict(ser, schema_version=2)
    for key in ("trace_id", "adapter", "grammar"):
        old.pop(key)
    out = deserialize_package(old)
    assert (out["trace_id"], out["adapter"], out["grammar"]) == (None,) * 3


# -- the priority scheduler surface and the overload controller --------------

def _sched_script(sched_cls):
    s = sched_cls(queue_limit=8, check_budget=lambda p, m: None)
    a = s.submit([1], priority=0)
    b = s.submit([2, 2], priority=2, session="x", max_new=5)
    c = s.submit([3], priority=1)
    d = s.submit([4], priority=2)
    head = s.head_info()
    shed = [h.id for h in s.shed(lambda h: h.request.priority < 1)]
    order = [h.id for h in s.take(4)]
    s.admission_gate = lambda req, pending: (
        "shed_load" if req.priority < 1 else None)
    s.submit([1], priority=1)
    try:
        s.submit([2], priority=0)
        gate = None
    except Exception as e:  # AdmissionError of either package
        gate = e.reason
    return ([x.id for x in (a, b, c, d)], head, shed, a.finish_reason,
            order, gate, s.rejected, s.pending())


def test_scheduler_surface_matches_jax():
    assert _sched_script(Scheduler) == _sched_script(JaxScheduler)


class _R:
    priority, tenant = 0, "bulk"


def _ctrl_script(ctrl_cls, reg):
    """One controller through submits, gauges, ticks and gates: its
    decisions and its stats."""
    out = []
    ctrl = ctrl_cls(shed_attainment=0.9, shed_priority=1, fair_share=1.5,
                    queue_limit=8)
    now = 1000.0
    ctrl.note_submit(2, "gold", now)
    ctrl.note_submit(0, "bulk", now)
    reg.gauge("tpudist_slo_attainment", metric="ttft",
              tenant="gold").set(0.5)
    reg.gauge("tpudist_slo_attainment", metric="ttft",
              tenant="bulk").set(0.2)
    out.append((ctrl.tick(now + 1.0), ctrl.shed_active,
                dict(ctrl.last_attainment)))
    for prio, tenant in ((0, "bulk"), (1, "gold"), (2, "gold")):
        r = type("R", (), {"priority": prio, "tenant": tenant})
        out.append(ctrl.gate(r, 0))
    for _ in range(50):
        ctrl.note_tokens("hog", 100, now + 1.0)
    ctrl.note_tokens("mouse", 1, now + 1.0)
    reg.gauge("tpudist_slo_attainment", metric="ttft",
              tenant="gold").set(0.95)
    out.append((ctrl.tick(now + 2.0), ctrl.shed_active))
    for tenant, pending in (("hog", 1), ("hog", 4), ("mouse", 4)):
        r = type("R", (), {"priority": 0, "tenant": tenant})
        g = ctrl.gate(r, pending)
        out.append(None if g is None else g.split(":")[0])
    h = type("H", (), {"request": _R})
    out.append(ctrl.shed_predicate(h))
    out.append(ctrl.stats())
    return out


def test_overload_controller_matches_jax():
    """The same event script (protected submits, gauge drops and recovery,
    token rates, gates) gives JAX's decisions and stats."""
    metrics.registry().clear()
    jax_metrics.registry().clear()
    try:
        got = _ctrl_script(OverloadController, metrics.registry())
        want = _ctrl_script(JaxController, jax_metrics.registry())
    finally:
        metrics.registry().clear()
        jax_metrics.registry().clear()
    assert got == want
    assert got[0][:2] == (True, True) and got[1] == "shed_load"


def test_protected_tenant_past_label_cap_reads_pooled_gauge():
    metrics.registry().clear()
    try:
        ctrl = OverloadController(shed_attainment=0.9, shed_priority=1)
        ctrl.note_submit(2, "gold-overflow", 0.0)
        metrics.registry().gauge("tpudist_slo_attainment", metric="ttft",
                                 tenant="other").set(0.3)
        assert ctrl.tick(1.0) and ctrl.shed_active
        assert ctrl.last_attainment == {"ttft/other": 0.3}
    finally:
        metrics.registry().clear()


# -- the server: preemption and session resume --------------------------------

def _port_server(model, **kw):
    cfg = ServeConfig(**{**PORT_KW, **kw})
    return InferenceServer(model, cfg, device="cpu",
                           install_signal_handler=False).start()


def _preempt_drive(srv, plow, phigh, temperature=0.0, seed=5):
    """The low lane's third token submits the high-priority request from
    the engine thread, so it always arrives mid-stream."""
    high = []

    def arrive(_tok, idx):
        if idx == 2:
            high.append(srv.submit(phigh, max_new=4, priority=2))

    hlow = srv.submit(plow, max_new=40, priority=0,
                      temperature=temperature, seed=seed, on_token=arrive)
    assert hlow.wait(120) and len(high) == 1 and high[0].wait(120)
    return hlow, high[0]


def test_preemption_greedy_equals_jax_server(models):
    """A high-priority arrival preempts the one decoding lane into the
    tier; both streams equal the JAX server's and ``generate()``'s."""
    jax_model, model = models
    plow, phigh = prompt_of(4, 10), prompt_of(4, 11)
    srv = _port_server(model, num_slots=1, max_new=48, host_tier=True,
                       decode_block=1)
    try:
        hlow, hhigh = _preempt_drive(srv, plow, phigh)
        assert srv.preemptions >= 1 and srv.tier_resumes >= 1
        st = srv.stats()
        assert st["parked"] == 0 and st["host_tier"]["entries"] == 0
    finally:
        srv.close(30)
    jcfg = JaxServeConfig(num_slots=1, max_new=48, host_tier=True,
                          prefill_pad=8, decode_block=1)
    jsrv = JaxServer(*jax_model, jcfg, install_signal_handler=False).start()
    try:
        jlow, jhigh = _preempt_drive(jsrv, plow, phigh)
        assert jsrv.preemptions >= 1
    finally:
        jsrv.close(30)
    assert hlow.finish_reason == jlow.finish_reason == "length"
    assert hlow.tokens == jlow.tokens == reference(jax_model, plow, 40)
    assert hhigh.tokens == jhigh.tokens == reference(jax_model, phigh, 4)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_preemption_sampled_equals_unpreempted(models, paged):
    """A sampled lane preempted mid-stream and resumed draws its
    unpreempted twin's stream (the Philox counter rides the package)."""
    _, model = models
    plow, phigh = prompt_of(4, 20), prompt_of(4, 21)
    kw = dict(num_slots=1, max_new=48, decode_block=1, paged=paged)
    if not paged:
        kw.update(attn_kernel="gather", prefill_kernel=False)
    srv = _port_server(model, host_tier=True, **kw)
    try:
        hlow, _ = _preempt_drive(srv, plow, phigh, temperature=0.8)
        assert srv.preemptions >= 1
    finally:
        srv.close(30)
    twin = _port_server(model, **kw)
    try:
        t = twin.submit(plow, max_new=40, temperature=0.8, seed=5)
        assert t.wait(120)
    finally:
        twin.close(30)
    assert hlow.tokens == t.tokens


def _session_drive(srv, p1, extra, temperature=0.0):
    h1 = srv.submit(p1, max_new=6, session="s1", tenant="alice",
                    temperature=temperature, seed=3)
    assert h1.wait(120) and h1.finish_reason == "length"
    wait_for(lambda: srv._tier.parks >= 1, msg="park landed")
    p2 = np.concatenate([p1, np.asarray(h1.tokens, np.int32), extra])
    h2 = srv.submit(p2, max_new=6, session="s1", tenant="alice",
                    temperature=temperature, seed=4)
    assert h2.wait(120)
    return h1, h2, p2


def test_session_resume_greedy_equals_jax_server(models):
    """Turn 2 resumes its parked lane (suffix-only prefill) and its stream
    equals the JAX server's resumed turn and ``generate()``'s."""
    jax_model, model = models
    p1, extra = prompt_of(5, 0), prompt_of(4, 1)
    srv = _port_server(model, num_slots=2, max_new=6, host_tier=True)
    try:
        _, h2, p2 = _session_drive(srv, p1, extra)
        assert h2.finish_reason == "session_resumed" and h2.resumed
        assert srv.tier_resumes == 1
        assert srv.parked_sessions() == [("alice", "s1")]
    finally:
        srv.close(30)
    jcfg = JaxServeConfig(num_slots=2, max_new=6, host_tier=True,
                          prefill_pad=8)
    jsrv = JaxServer(*jax_model, jcfg, install_signal_handler=False).start()
    try:
        _, j2, _ = _session_drive(jsrv, p1, extra)
        assert j2.resumed
    finally:
        jsrv.close(30)
    assert h2.tokens == j2.tokens == reference(jax_model, p2, 6)


def test_session_resume_sampled_equals_fresh_serve(models):
    """A sampled resumed turn draws what a fresh serve of its whole prompt
    at the same seed draws (the row is re-armed as ``start_batch`` arms
    a new one)."""
    _, model = models
    p1, extra = prompt_of(5, 50), prompt_of(4, 51)
    srv = _port_server(model, num_slots=2, max_new=6, host_tier=True)
    try:
        _, h2, p2 = _session_drive(srv, p1, extra, temperature=0.7)
        assert h2.resumed
    finally:
        srv.close(30)
    twin = _port_server(model, num_slots=2, max_new=6)
    try:
        t = twin.submit(p2, max_new=6, temperature=0.7, seed=4)
        assert t.wait(120)
    finally:
        twin.close(30)
    assert h2.tokens == t.tokens


def test_corrupt_park_and_other_tenant_reprefill(models):
    """A park garbled by ``host_tier_corrupt`` re-prefills (one corrupt
    count, the right stream); another tenant's turn never resumes the
    session."""
    jax_model, model = models
    srv = _port_server(model, num_slots=2, max_new=6, host_tier=True)
    faults.arm("host_tier_corrupt@nth:1")
    try:
        p1 = prompt_of(5, 4)
        _, h2, p2 = _session_drive(srv, p1, prompt_of(3, 5))
        assert h2.finish_reason == "length" and not h2.resumed
        assert srv.tier_corrupt == 1
        assert h2.tokens == reference(jax_model, p2, 6)
        h1 = srv.submit(p1, max_new=4, session="shared", tenant="alice")
        assert h1.wait(120)
        wait_for(lambda: srv._tier.contains(("sess", "alice", "shared")),
                 msg="park landed")
        p3 = np.concatenate([p1, np.asarray(h1.tokens, np.int32)])
        h3 = srv.submit(p3, max_new=4, session="shared", tenant="bob")
        assert h3.wait(120) and not h3.resumed
        assert srv._tier.contains(("sess", "alice", "shared"))
    finally:
        faults.disarm()
        srv.close(30)


def test_spill_event_and_parked_deadline(models):
    """A put that forces a spill emits ``host_tier_spill``; a preempted
    request expiring while parked finishes ``deadline`` and releases its
    tier bytes now."""
    _, model = models
    srv = InferenceServer(model, ServeConfig(num_slots=1, host_tier=True,
                                             **PORT_KW), device="cpu",
                          install_signal_handler=False)
    events = []
    srv._tier_event = lambda name, **f: events.append((name, f))
    assert srv._tier_put(("sess", "t", "a"), _fake_pkg()) is not None
    srv._tier.byte_budget = srv._tier.bytes_resident + 10
    assert srv._tier_put(("sess", "t", "b"), _fake_pkg()) is not None
    assert events == [("host_tier_spill", {"entries": 1})]
    h = RequestHandle(Request(prompt=prompt_of(3, 12), max_new=8,
                              deadline_s=0.5), 77)
    assert srv._tier.put(("preempt", 77), _fake_pkg(), pinned=True)
    srv._parked[77] = h
    srv._sweep_parked(h.t_submit + 0.2)
    assert not h.done and srv._tier.contains(("preempt", 77))
    srv._sweep_parked(h.t_submit + 1.0)
    assert h.done and h.finish_reason == "deadline"
    assert not srv._tier.contains(("preempt", 77)) and not srv._parked


def test_shed_and_fair_share_on_the_server(models, monkeypatch):
    """The controller is the server's admission gate: with a protected
    tenant's attainment under target, queued bulk work finishes
    ``shed_load`` and bulk submits reject with it; ``fair_share`` rejects
    the heavy tenant once the queue is half full."""
    _, model = models
    metrics.registry().clear()
    try:
        srv = InferenceServer(model, ServeConfig(
            num_slots=1, queue_limit=4, max_new=8, shed=True,
            fair_share=1.5, **PORT_KW), device="cpu", install_signal_handler=False)
        bulk = srv.submit(prompt_of(4, 1), priority=0, tenant="bulk")
        srv.submit(prompt_of(4, 2), priority=1, tenant="gold")
        metrics.registry().gauge("tpudist_slo_attainment", metric="ttft",
                                 tenant="gold").set(0.4)
        srv._shed_tick(time.monotonic() + 1.0)
        assert srv._ctrl.shed_active
        assert bulk.done and bulk.finish_reason == "shed_load"
        with pytest.raises(AdmissionError) as ei:
            srv.submit(prompt_of(4, 3), priority=0, tenant="bulk")
        assert ei.value.reason == "shed_load"
        st = srv.stats()
        assert st["overload"]["sheds"] == 1 and srv.completed == 1
        now = time.monotonic()
        for _ in range(50):
            srv._ctrl.note_tokens("hog", 100, now)
        srv._ctrl.note_tokens("gold", 1, now)
        srv._ctrl.tick(now + 2.0)
        srv.submit(prompt_of(4, 4), priority=1, tenant="gold")
        with pytest.raises(AdmissionError) as ei:
            srv.submit(prompt_of(4, 5), priority=1, tenant="hog")
        assert ei.value.reason.startswith("fair_share")
        assert srv.close(30)
    finally:
        metrics.registry().clear()


# -- the lane transfer on the engine ------------------------------------------

LANE_ARMS = {
    "dense": dict(paged=False, attn_kernel="gather", prefill_kernel=False),
    "kernel": dict(paged=True),
    "int8": dict(paged=True, kv_int8=True),
    "mesh-int8": dict(paged=True, kv_int8=True, mesh="1x2"),
    "spec": dict(paged=True, spec_draft=1, spec_k=2),
}


def _engine(model, arm):
    return SlotEngine(model, num_slots=3, prefill_pad=8, kv_block=8,
                      decode_block=2, device="cpu", **LANE_ARMS[arm])


def _run_out(eng, slot, n):
    toks = []
    while len(toks) < n:
        _, out = eng.decode_auto()
        toks += out.get(slot, [])
    return toks[:n]


@pytest.mark.parametrize("wire", [False, True], ids=["raw", "wire"])
@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_export_import_continues_bit_for_bit(models, arm, wire):
    """A decoding lane exported after a block and imported into another
    slot of the same engine and into a fresh engine (through the wire form
    or not) continues the unbroken run's tokens, greedy and sampled."""
    _, model = models
    # the sampled lane opts out of speculation: a cold draft changes a
    # sampled lane's speculative draws (never their distribution), while
    # its plain stream rides the spec programs unchanged
    items = [(0, prompt_of(13, 1), 0.0, 11, 20, (), True),
             (1, prompt_of(6, 2), 0.9, 12, 20, (), False)]
    spec = {0: True, 1: False}
    base = _engine(model, arm)
    base.start_batch(items)
    while base.prefilling_slots():
        base.advance_prefill()
    base.decode_auto()
    pkgs = {s: base.export_slot(s) for s in (0, 1)}
    want = {s: [] for s in (0, 1)}
    while len(want[0]) < 6 or len(want[1]) < 6:
        _, out = base.decode_auto()
        for s in (0, 1):
            want[s] += out.get(s, [])
    for s, pkg in pkgs.items():
        if wire:
            pkg = deserialize_package(serialize_package(pkg))
        for eng, dst in ((_engine(model, arm), 2),):
            eng.import_slot(dst, pkg, spec=spec[s])
            assert eng.exportable(dst, pkg["counts"])
            # the importer holds the lane's bytes: a paged lane's blocks
            # (int8 and its scales included) at its own block ids
            again = eng.export_slot(dst)["lane"]
            for a, b in zip(pkg["lane"], again):
                n = a.shape[1] if a.dim() > 1 else None
                assert torch.equal(a, b if n is None else b[:, :n]), arm
            assert _run_out(eng, dst, 6) == want[s][:6], (arm, s)
    # into another slot of an engine that holds other lanes
    eng = _engine(model, arm)
    eng.start_batch([(0, prompt_of(9, 7), 0.0, 3, 20)])
    while eng.prefilling_slots():
        eng.advance_prefill()
    pkg = pkgs[1]
    if wire:
        pkg = deserialize_package(serialize_package(pkg))
    eng.import_slot(2, pkg, spec=False)
    assert _run_out(eng, 2, 6) == want[1][:6]
