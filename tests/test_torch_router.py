"""The fleet router on the port (``tpudist_torch/serve/router.py``) against
the JAX package's on the CPU.

- over the same prefix keys and replica sets (and after a replica dies),
  the rendezvous scores and the ``_pick`` placements equal JAX's
  ``FleetRouter``'s; the round-robin arm and the saturation yield too;
- the probe state machine (strikes, backoff, recovery) and the spill
  placement (sibling spill, whole-fleet ``shed_load`` passthrough) move as
  JAX's on the same fake replicas;
- over port servers with weights carried across: routed greedy streams
  equal ``generate()``'s, a session's turn 2 resumes on its home replica, a
  drained replica's parked session migrates and resumes on the survivor,
  and a ``replica_kill`` mid-serve re-homes the in-flight lane onto the
  survivor with no duplicated and no missing token (greedy and sampled,
  against an unkilled twin) while a corrupt stash degrades to a re-prefill.
"""

import time

import numpy as np
import pytest
import torch

from test_torch_host_tier import (carried_models, prompt_of, reference,
                                  wait_for)
from tpudist.serve import FleetRouter as JaxRouter
from tpudist.serve import RouterConfig as JaxRouterConfig
from torch_cases import settled_torch_cpu
from tpudist_torch.runtime import faults
from tpudist_torch.serve import (AdmissionError, FleetRouter,
                                 InferenceServer, RouterConfig, ServeConfig)
from tpudist_torch.serve.router import RouterHandle


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(scope="module")
def models():
    return carried_models(rope=True)


class _FakeScheduler:
    def __init__(self):
        self.n = 0

    def pending(self):
        return self.n


class _FakeConfig:
    queue_limit = 4


class _FakeServer:
    """The surface the router touches: health, gauges, submit."""

    def __init__(self, reject_cls=AdmissionError):
        self.healthy = True
        self.scheduler = _FakeScheduler()
        self.config = _FakeConfig()
        self.load = 0.0
        self.reject = None
        self.reject_cls = reject_cls
        self.submitted = []

    def _health_check(self):
        return self.healthy, {}

    def _statusz_doc(self):
        return {"queue": {"pending": self.scheduler.n,
                          "limit": self.config.queue_limit},
                "slots": {"occupancy": self.load}}

    def submit(self, prompt, **kw):
        if self.reject:
            raise self.reject_cls(self.reject)
        self.submitted.append(kw)

        class _H:
            done = False
            finish_reason = None
            resumed = False
            trace_id = "fake"
        return _H()

    def parked_sessions(self):
        return []

    def export_session(self, tenant, session):
        return None

    def adopt_session(self, tenant, session, stash):
        return True

    def kill(self, reason="killed"):
        self.healthy = False

    def close(self, timeout=None):
        return True


def _pair(n=3, **kw):
    """The port's and JAX's routers over fake replicas (never started)."""
    from tpudist.serve import AdmissionError as JaxAdmissionError

    return (FleetRouter([_FakeServer() for _ in range(n)],
                        RouterConfig(**kw)),
            JaxRouter([_FakeServer(JaxAdmissionError) for _ in range(n)],
                      JaxRouterConfig(**kw)))


def _picks(r, keys, skey=None):
    out = []
    for k in keys:
        rep, kind = r._pick(skey, k)
        out.append(None if rep is None else (rep.index, kind))
    return out


KEYS = [f"{i:08x}" for i in range(64)]


def test_rendezvous_and_picks_match_jax():
    """Rendezvous scores and prefix placements equal JAX's at 1-4
    replicas, and after each replica in turn goes down only that
    replica's keys move (in both)."""
    for n in (1, 2, 3, 4):
        port, jaxr = _pair(n)
        assert [port._rendezvous(k, i) for k in KEYS for i in range(n)] \
            == [JaxRouter._rendezvous(k, i) for k in KEYS for i in range(n)]
        home = _picks(port, KEYS)
        assert home == _picks(jaxr, KEYS)
        for dead in range(n):
            for r in (port, jaxr):
                for rep in r._replicas:
                    rep.up = rep.index != dead
            moved = _picks(port, KEYS)
            assert moved == _picks(jaxr, KEYS)
            assert all(h[0] == dead for h, m in zip(home, moved) if h != m)


def test_session_rr_saturation_and_empty_fleet_match_jax():
    port, jaxr = _pair(3)
    for r in (port, jaxr):
        r._session_home[("t", "s")] = 2
    assert _picks(port, KEYS[:4], ("t", "s")) \
        == _picks(jaxr, KEYS[:4], ("t", "s")) == [(2, "session")] * 4
    port, jaxr = _pair(2)
    for r in (port, jaxr):
        target = r._pick(None, "cafecafe")[0]
        target.server.scheduler.n = _FakeConfig.queue_limit
        r._replicas[1 - target.index].server.load = 0.1
    assert _picks(port, ["cafecafe"]) == _picks(jaxr, ["cafecafe"])
    assert _picks(port, ["cafecafe"])[0][1] == "spill"
    port, jaxr = _pair(3, policy="rr")
    seq = []
    for r in (port, jaxr):
        s = []
        for _ in range(6):
            rep, kind = r._pick(None, "abcd1234")
            s.append((rep.index, kind))
            r.routed += 1
        seq.append(s)
    assert seq[0] == seq[1] == [(i % 3, "rr") for i in range(6)]
    port, jaxr = _pair(2)
    for r in (port, jaxr):
        for rep in r._replicas:
            rep.up = False
    assert port._pick(None, None) == jaxr._pick(None, None) == (None, None)
    with pytest.raises(ValueError):
        FleetRouter([_FakeServer()], RouterConfig(policy="random"))


def test_router_config_from_env_matches_jax(monkeypatch):
    for name, value in (("TPUDIST_ROUTER_REPLICAS", "5"),
                        ("TPUDIST_ROUTER_PROBE_FAILURES", "7"),
                        ("TPUDIST_ROUTER_SPILL", "0"),
                        ("TPUDIST_ROUTER_POLICY", "rr"),
                        ("TPUDIST_ROUTER_RETRY_BACKOFF_S", "0.2")):
        monkeypatch.setenv(name, value)
    got, want = RouterConfig.from_env(), JaxRouterConfig.from_env()
    assert got.__dict__ == want.__dict__
    assert (got.replicas, got.probe_failures, got.spill, got.policy) == (
        5, 7, False, "rr")


def _probe_trace(r, script):
    rep = r._replicas[0]
    out = []
    for healthy, now in script:
        rep.server.healthy = healthy
        ok = r._probe(rep, now)
        out.append((ok, rep.up, rep.fails, rep.backoff_s,
                    round(rep.next_probe - now, 9)))
    return out


@pytest.mark.parametrize("kw,script", [
    (dict(probe_s=0.1, probe_failures=3), [(False, 100.0)] * 11),
    (dict(probe_failures=1), [(False, 0.0), (True, 1.0)]),
    (dict(probe_failures=3), [(False, 0.0), (True, 1.0), (False, 2.0)]),
], ids=["strikes_and_backoff", "recovery", "transient"])
def test_probe_state_machine_matches_jax(kw, script):
    port, jaxr = _pair(1, **kw)
    got, want = _probe_trace(port, script), _probe_trace(jaxr, script)
    assert got == want
    if kw.get("probe_s") == 0.1:
        gaps = [g for *_, g in got[3:]]
        assert gaps == sorted(gaps) and gaps[-1] <= 40.0 * 0.1 + 1e-9


def _outer(pkey=None):
    h = RouterHandle(np.zeros(4, np.int32), {"deadline_s": None},
                     on_token=None, skey=None, pkey=pkey)
    h.id = 0
    return h


def test_spill_placement_and_passthrough():
    r = FleetRouter([_FakeServer() for _ in range(2)], RouterConfig())
    h = _outer("cafecafe")
    target = r._pick(None, "cafecafe")[0]
    target.server.reject = "queue_full"
    r._route_and_submit(h, skip=0)
    assert h.replica == 1 - target.index and r.spills == 1 and h.spilled
    for rep in r._replicas:
        rep.server.reject = "queue_full"
    r._replicas[0].server.reject = "shed_load: tenant over share"
    with pytest.raises(AdmissionError) as ei:
        r._route_and_submit(_outer(), skip=0)
    assert ei.value.reason == "shed_load"
    r = FleetRouter([_FakeServer() for _ in range(2)],
                    RouterConfig(spill=False))
    r._pick(None, "cafecafe")[0].server.reject = "queue_full"
    with pytest.raises(AdmissionError) as ei:
        r._route_and_submit(_outer("cafecafe"), skip=0)
    assert ei.value.reason == "queue_full"


# -- routed serving over port servers -----------------------------------------

def _fleet(model, n, cfg=None, **router_kw):
    cfg = cfg or ServeConfig(num_slots=2, max_new=8, prefill_pad=8,
                             kv_block=8, host_tier=True)
    reps = [InferenceServer(model, cfg, device="cpu",
                            install_signal_handler=False).start()
            for _ in range(n)]
    router_kw.setdefault("probe_s", 0.02)
    return reps, FleetRouter(reps, RouterConfig(**router_kw)).start()


def test_routed_streams_and_session_home(models):
    """Greedy streams through 2 replicas equal ``generate()``'s; a shared
    16-token prefix lands on one replica; a session's turn 2 resumes on its
    home replica."""
    jax_model, model = models
    reps, router = _fleet(model, 2)
    try:
        hs = [router.submit(prompt_of(6, i), max_new=8, seed=i)
              for i in range(4)]
        base = prompt_of(16, 1)
        same = [router.submit(np.concatenate([base, prompt_of(2, 10 + i)]),
                              max_new=4) for i in range(3)]
        for i, h in enumerate(hs):
            assert h.wait(120) and h.finish_reason == "length"
            assert h.tokens == reference(jax_model, prompt_of(6, i), 8)
        assert all(h.wait(120) for h in same)
        assert len({h.replica for h in same}) == 1
        p1 = prompt_of(5, 30)
        h1 = router.submit(p1, max_new=4, session="aff", tenant="t")
        assert h1.wait(120)
        wait_for(lambda: router.stats()["stash_entries"] >= 1,
                 msg="stash export")
        p2 = np.concatenate([p1, np.asarray(h1.tokens, np.int32)])
        h2 = router.submit(p2, max_new=4, session="aff", tenant="t")
        assert h2.wait(120)
        assert h2.replica == h1.replica and h2.resumed
        assert h2.tokens == reference(jax_model, p2, 4)
        assert sum(router.stats()["per_replica"]) == 9
    finally:
        router.close(30)


def test_drain_replica_migrates_sessions_live(models):
    jax_model, model = models
    reps, router = _fleet(model, 2)
    try:
        p1 = prompt_of(5, 40)
        h1 = router.submit(p1, max_new=4, session="mv")
        assert h1.wait(120)
        home = h1.replica
        wait_for(lambda: router._session_home.get(("default", "mv"))
                 == home, msg="session homed")
        wait_for(lambda: reps[home].parked_sessions(), msg="park landed")
        assert router.drain_replica(home, timeout=30)
        assert router.stats()["migrations"] >= 1
        p2 = np.concatenate([p1, np.asarray(h1.tokens, np.int32)])
        h2 = router.submit(p2, max_new=4, session="mv")
        assert h2.wait(120)
        assert h2.replica != home and h2.resumed
        assert h2.tokens == reference(jax_model, p2, 4)
    finally:
        router.close(30)


@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "sampled"])
def test_mid_serve_kill_rehomes_without_duplicates(models, temperature):
    """``replica_kill`` on the session's home replica mid-stream: the
    in-flight lane re-homes onto the survivor and its stream equals an
    unkilled twin's (no token duplicated or missing); the parked session
    migrates through the stash and resumes there."""
    _, model = models
    cfg = ServeConfig(num_slots=2, max_new=48, prefill_pad=8, kv_block=8,
                      decode_block=1, host_tier=True)
    reps, router = _fleet(model, 2, cfg=cfg, retry_backoff_s=0.01)
    try:
        p_sess = prompt_of(5, 60)
        hs1 = router.submit(p_sess, max_new=4, session="ch",
                            temperature=temperature, seed=9)
        assert hs1.wait(120)
        wait_for(lambda: router.stats()["stash_entries"] >= 1,
                 msg="stash export")
        victim = router._session_home[("default", "ch")]
        survivor = 1 - victim
        p_long = prompt_of(6, 61)
        with router._lock:
            router._session_home[("default", "pin")] = victim
        hl = router.submit(p_long, max_new=40, session="pin",
                           temperature=temperature, seed=7,
                           on_token=lambda tok, i: time.sleep(0.005))
        assert hl.replica == victim
        faults.arm(f"replica_kill@nth:{victim}")
        try:
            assert hl.wait(180), "in-flight lane hung after kill"
            wait_for(lambda: router.stats()["replica_deaths"] >= 1,
                     timeout=60, msg="death detected")
        finally:
            faults.disarm()
        assert hl.finish_reason == "length"
        assert hl.replica == survivor and hl.attempts >= 2
        assert router.stats()["retries"] >= 1
        assert reps[victim].loop_error is not None
        p2 = np.concatenate([p_sess, np.asarray(hs1.tokens, np.int32)])
        h2 = router.submit(p2, max_new=4, session="ch",
                           temperature=temperature, seed=10)
        assert h2.wait(120)
        assert h2.replica == survivor and h2.resumed
        st = router.stats()
        assert st["replicas_up"] == 1 and st["migrations"] >= 1
    finally:
        router.close(30)
    twin = InferenceServer(model, ServeConfig(
        num_slots=2, max_new=48, prefill_pad=8, kv_block=8,
        decode_block=1), device="cpu", install_signal_handler=False).start()
    try:
        tl = twin.submit(p_long, max_new=40, temperature=temperature,
                         seed=7)
        t2 = twin.submit(p2, max_new=4, temperature=temperature, seed=10)
        assert tl.wait(180) and t2.wait(120)
    finally:
        twin.close(30)
    assert hl.tokens == tl.tokens, "re-homed stream diverged"
    assert h2.tokens == t2.tokens, "migrated session diverged"


def test_corrupt_stash_and_fleet_death(models):
    """A stash garbled before its adoption re-prefills on the survivor (the
    right stream, no resume); killing every replica finishes the handle
    ``replica_lost`` or ``shutdown``, never a hang."""
    jax_model, model = models
    reps, router = _fleet(model, 2, retry_backoff_s=0.01)
    try:
        p1 = prompt_of(5, 70)
        h1 = router.submit(p1, max_new=4, session="bad")
        assert h1.wait(120)
        wait_for(lambda: router.stats()["stash_entries"] >= 1,
                 msg="stash export")
        skey = ("default", "bad")
        with router._lock:
            stash = router._stash[skey]
            ser = dict(stash["ser"])
            ser["blob"] = [(bytes(len(b)), dt, shp)
                           for b, dt, shp in ser["blob"]]
            router._stash[skey] = dict(stash, ser=ser)
        victim = router._session_home[skey]
        reps[victim].kill("test")
        wait_for(lambda: router.stats()["replica_deaths"] >= 1,
                 timeout=60, msg="death detected")
        p2 = np.concatenate([p1, np.asarray(h1.tokens, np.int32)])
        h2 = router.submit(p2, max_new=4, session="bad")
        assert h2.wait(120) and not h2.resumed
        assert h2.tokens == reference(jax_model, p2, 4)
        assert reps[1 - victim].tier_corrupt == 1
        h = router.submit(prompt_of(6, 90), max_new=40)
        wait_for(lambda: len(h.tokens) >= 2, msg="decoding")
        reps[1 - victim].kill("test")
        assert h.wait(120), "fleet collapse must not hang the handle"
        assert h.finish_reason in ("replica_lost", "shutdown")
        wait_for(lambda: router.stats()["replicas_up"] == 0, timeout=60,
                 msg="fleet down")
    finally:
        router.close(30)


def test_serve_demo_with_replicas(capsys, monkeypatch, tmp_path):
    """``python -m tpudist_torch.serve --device cpu --replicas 2`` serves
    its burst through the router over two host-tier replicas."""
    import json

    from tpudist_torch.serve.__main__ import main

    monkeypatch.setenv("TPUDIST_TELEMETRY_DIR", str(tmp_path))
    assert main(["--device", "cpu", "--replicas", "2", "--requests", "4",
                 "--max-new", "4", "--max-len", "32", "--d-model",
                 "32"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert [r["reason"] for r in report["requests"]] == ["length"] * 4
    assert {r["replica"] for r in report["requests"]} <= {0, 1}
    assert report["stats"]["replicas"] == 2
    assert sum(report["stats"]["per_replica"]) == 4
