"""Prefill/decode disaggregation on the port (``tpudist_torch/serve/
disagg.py`` ``DisaggServer``, ``serve_forever``) against the JAX package on
the CPU, with the weights carried across by ``params_from_flax``.

- greedy streams through 1+1 and 2+2 workers, both handoff modes, on the
  dense cache (decode block 4: the dense arm is schedule-free) and on the
  paged kernel arms (run by their plain versions; decode block 1, where a
  handed-off lane's block boundaries are those of one server) equal JAX's
  ``generate()``; sampled streams equal the port's ``InferenceServer`` at
  the same seeds;
- ``max_new=1`` finishes in the prefill pool; a drain finishes everything;
  the aggregated report splits the pools (prefill TTFT, decode TPOT, the
  handoff wait);
- the recovery bookkeeping of ``tests/test_serve_recovery.py``
  (``_lose_worker``'s routing, the replay-skip arithmetic) driven
  directly, and its drives: a decode or prefill worker killed through
  ``serve_worker_kill`` (streams equal the run without the kill, greedy and
  sampled, after one loss and after two), a corrupt package, the decode
  pool's collapse, the backpressure resize;
- a session resumed and a lane preempted through the pools, a spec decode
  pool whose cold draft does not move the greedy output, a ``1x2``
  serving mesh, and the fleet router over two disaggregated replicas.

The JAX ``DisaggServer`` drives run in the slow lane, so the port is held
against ``generate()`` and its own single-pool server instead.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models import create_transformer as jax_create
from tpudist.models import generate as jax_generate
from torch_cases import settled_torch_cpu
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.runtime import faults
from tpudist_torch.serve import (DisaggServer, FleetRouter, InferenceServer,
                                 RouterConfig, ServeConfig, serve_forever)
from tpudist_torch.serve.scheduler import (AdmissionError, Request,
                                           RequestHandle)

CFG = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=64,
           rope=True)
#: the serving arms: the paged kernel arms (their plain versions here) at
#: decode block 1, and the JAX server's default dense arms at decode block 4
ARMS = {
    "kernel": dict(prefill_pad=8, kv_block=8, decode_block=1),
    "dense": dict(paged=False, attn_kernel="gather", prefill_kernel=False,
                  sample_kernel=False, prefill_pad=8, decode_block=4),
}
#: (prompt length, seed, max_new): two prompts a length so that one batched
#: ``generate()`` a length gives the references; 12 is past the chunk of 8
REQS = ((3, 0, 8), (3, 1, 6), (5, 2, 8), (5, 3, 7), (12, 4, 6), (12, 5, 5))


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def prompt_of(plen, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["vocab"], size=plen).astype(np.int32)


PROMPTS = [prompt_of(n, s) for n, s, _ in REQS]


@pytest.fixture(scope="module")
def models():
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, **CFG)
    model = TransformerLM(**CFG)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return (jmod, jparams), model.requires_grad_(False)


@pytest.fixture(scope="module")
def reference(models):
    """``reference(prompt, max_new)``: JAX ``generate()``'s greedy stream,
    cached; ``REQS`` come from one batched call a prompt length."""
    module, params = models[0]

    def run(prompts, max_new):
        out = np.asarray(jax_generate(module, params,
                                      jnp.asarray(np.stack(prompts)),
                                      max_new))
        return [row[len(prompts[0]):].tolist() for row in out]

    cache = {}
    for plen in sorted({n for n, _, _ in REQS}):
        idx = [i for i, (n, _, _) in enumerate(REQS) if n == plen]
        rows = run([PROMPTS[i] for i in idx], max(REQS[i][2] for i in idx))
        for i, row in zip(idx, rows):
            cache[(tuple(PROMPTS[i]), REQS[i][2])] = row[:REQS[i][2]]

    @functools.lru_cache(maxsize=None)
    def _one(key, max_new):
        return run([np.asarray(key, np.int32)], max_new)[0]

    def ref(prompt, max_new):
        key = (tuple(int(t) for t in prompt), int(max_new))
        return cache[key] if key in cache else _one(*key)

    return ref


def disagg(model, arm="kernel", **kw):
    cfg = ServeConfig(disagg=True, **{"num_slots": 2, **ARMS[arm], **kw})
    return DisaggServer(model, cfg, device="cpu",
                        install_signal_handler=False)


def serve(server, reqs, temps=None, **kw):
    """Submit ``reqs`` ``(prompt, max_new)`` (seed = index) to a started
    server and wait for them all."""
    temps = temps or [0.0] * len(reqs)
    hs = [server.submit(p, max_new=n, temperature=t, seed=i, **kw)
          for i, ((p, n), t) in enumerate(zip(reqs, temps))]
    for h in hs:
        assert h.wait(120), "request timed out"
    return hs


def base_reqs(n=len(REQS)):
    return [(PROMPTS[i], REQS[i][2]) for i in range(n)]


# -- the oracle ---------------------------------------------------------------

@pytest.mark.parametrize("handoff", ["serial", "device"])
@pytest.mark.parametrize("workers", [(1, 1), (2, 2)], ids=["1+1", "2+2"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_greedy_streams_equal_generate(models, reference, arm, workers,
                                       handoff):
    _, model = models
    cfg = ServeConfig(disagg=True, num_slots=2, prefill_slots=2,
                      prefill_workers=workers[0], decode_workers=workers[1],
                      handoff=handoff, **ARMS[arm])
    server = serve_forever(model, cfg, device="cpu")
    assert isinstance(server, DisaggServer)
    try:
        hs = serve(server, base_reqs())
        st = server.stats()
    finally:
        assert server.close(30)
    for h, (p, n) in zip(hs, base_reqs()):
        assert h.finish_reason == "length"
        assert h.tokens == reference(p, n)
        assert h.handoff_wait_s is not None and h.handoff_wait_s >= 0
        assert h.t_prefill_done <= h.t_decode_start
    assert st["handoffs"] == len(REQS)
    assert (st["handoff_bytes"] > 0) == (handoff == "serial")
    assert st["decode_pool"]["workers"] == workers[1]
    assert st["decode_pool"]["kv"]["paged"] == (arm == "kernel")
    # the prefill pool never decodes
    assert not any(e.n_decode_blocks for e in server.prefill_pool)
    assert sum(e.n_decode_blocks for e in server.decode_pool) > 0


@pytest.mark.parametrize("handoff", ["serial", "device"])
def test_sampled_streams_equal_inference_server(models, handoff):
    """Token 0 is drawn on the prefill worker at count 0 and the decode
    pool goes on at the carried counts: a sampled stream is the single
    server's at the same seed."""
    _, model = models
    reqs = base_reqs()
    temps = [0.8 if i % 2 else 0.0 for i in range(len(reqs))]
    server = disagg(model, prefill_slots=1, decode_workers=2,
                    handoff=handoff).start()
    try:
        got = serve(server, reqs, temps)
    finally:
        assert server.close(30)
    single = InferenceServer(model, ServeConfig(num_slots=2,
                                                **ARMS["kernel"]),
                             device="cpu", install_signal_handler=False)
    single.start()
    try:
        want = serve(single, reqs, temps)
    finally:
        assert single.close(30)
    assert [h.tokens for h in got] == [h.tokens for h in want]
    assert len({tuple(h.tokens) for h in got[1::2]}) > 1


def test_max_new_one_finishes_in_the_prefill_pool(models, reference):
    _, model = models
    server = disagg(model).start()
    try:
        h = server.submit(PROMPTS[0], max_new=1)
        assert h.wait(60)
        st = server.stats()
    finally:
        assert server.close(30)
    assert h.finish_reason == "length"
    assert h.tokens == reference(PROMPTS[0], REQS[0][2])[:1]
    assert st["handoffs"] == 0 and h.t_decode_start is None
    assert h.handoff_wait_s is None


def test_drain_finishes_everything_length(models):
    """``close()`` right after the burst: nothing admitted is cut off."""
    _, model = models
    server = disagg(model, handoff_queue=1).start()
    hs = [server.submit(p, max_new=n) for p, n in base_reqs()]
    assert server.close(60)
    assert [h.finish_reason for h in hs] == ["length"] * len(hs)
    with pytest.raises(AdmissionError, match="draining"):
        server.submit(PROMPTS[0], max_new=2)


def test_report_splits_the_pools(models, tmp_path):
    from tpudist_torch import telemetry
    from tpudist_torch.telemetry.aggregate import aggregate_run

    _, model = models
    telemetry.start(tmp_path)
    try:
        server = disagg(model, handoff="serial").start()
        serve(server, base_reqs())
        assert server.close(30)
    finally:
        telemetry.finish(write_report=False)
    report = aggregate_run(tmp_path)
    pools = report["serving"]["pools"]
    assert pools["config"]["handoff"] == "serial"
    assert pools["prefill"]["ttft"] is not None
    assert pools["decode"]["tpot"] is not None
    assert pools["handoffs"] == len(REQS)
    assert pools["handoff_wait"]["p50_s"] >= 0
    assert report["serving"]["finish_reasons"] == {"length": len(REQS)}


def test_needs_cuda_unless_cpu(models, monkeypatch):
    """No CUDA and no ``device="cpu"``: construction raises, nothing falls
    back to the CPU."""
    _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ServeConfig(disagg=True, num_slots=2, **ARMS["kernel"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DisaggServer(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_forever(model, cfg)
    with pytest.raises(ValueError, match="handoff"):
        DisaggServer(model, ServeConfig(disagg=True, handoff="rdma"),
                     device="cpu")
    single = serve_forever(model, ServeConfig(num_slots=2, **ARMS["kernel"]),
                           device="cpu")
    assert type(single) is InferenceServer and single.close(30)


# -- the recovery bookkeeping, driven directly (never started) ---------------

@pytest.fixture()
def srv(models):
    _, model = models
    return disagg(model, prefill_slots=2, prefill_workers=2,
                  decode_workers=2, handoff="serial")


def _handle(hid, ntoks=0, max_new=99):
    h = RequestHandle(Request(prompt=prompt_of(3, hid), max_new=max_new),
                      hid)
    for t in range(ntoks):
        h._deliver(t)
    return h


def test_decode_loss_requeues_stash_with_skip(srv):
    h = _handle(1, ntoks=4)  # token 0 + 3 decoded since the import
    srv._slot_handles[("decode", 0, 0)] = h
    srv._import_pkg[(0, 0)] = ({"pkg": "sentinel"}, 1)
    srv._lose_worker("decode", 0, RuntimeError("boom"))
    assert 0 in srv._dead["decode"] and srv.workers_lost == 1
    assert not h.done
    assert list(srv._handoff) == [(h, {"pkg": "sentinel"})]
    assert srv._skip[h.id] == 3
    assert ("decode", 0, 0) not in srv._slot_handles


def test_deliver_block_drops_exactly_skip_tokens(srv):
    h = _handle(2, ntoks=2)
    srv._slot_handles[("decode", 1, 0)] = h
    srv._skip[h.id] = 2
    srv._deliver_block(1, 0, [10, 11, 12])
    assert h.tokens == [0, 1, 12] and h.id not in srv._skip
    srv._deliver_block(1, 0, [13])
    assert h.tokens == [0, 1, 12, 13]


def test_prefill_loss_requeues_for_replay(srv):
    h = _handle(3, ntoks=1)  # token 0 out, its export stalled
    srv._slot_handles[("prefill", 0, 1)] = h
    srv._lose_worker("prefill", 0, RuntimeError("boom"))
    assert list(srv._requeue) == [h] and srv._skip[h.id] == 1
    assert not h.done


def test_no_survivor_finishes_worker_lost(srv):
    srv._dead["decode"].add(1)
    h = _handle(4, ntoks=2)
    srv._slot_handles[("decode", 0, 0)] = h
    srv._import_pkg[(0, 0)] = ({"pkg": "x"}, 1)
    srv._lose_worker("decode", 0, RuntimeError("boom"))
    assert h.done and h.finish_reason == "worker_lost"
    assert not srv._handoff


def test_recover_off_reraises(models):
    _, model = models
    s = disagg(model, handoff="serial", recover=False)
    with pytest.raises(RuntimeError, match="boom"):
        s._lose_worker("decode", 0, RuntimeError("boom"))


def test_mid_batch_export_death_spares_sibling_completions(srv):
    """A worker dying in the first lane's export must not crash the sibling
    completions of the same admission batch: every lane lives on,
    requeued or exported from the surviving worker."""
    faults.arm("serve_worker_kill@call:2,pool:0,worker:0")
    try:
        hs = [srv.submit(prompt_of(3 + i, i), max_new=6) for i in range(2)]
        # tick 1 = start_batch, tick 2 = the first completion's export
        srv._admit_prefill(time.monotonic())
    finally:
        faults.disarm()
    assert srv.workers_lost == 1 and 0 in srv._dead["prefill"]
    assert all(not h.done for h in hs)
    assert (len(srv._requeue) + len(srv._handoff)
            + len(srv._slot_handles)) == 2


def test_blocked_replay_head_stops_fresh_admissions(srv, monkeypatch):
    blocked = _handle(77)
    srv._requeue.append(blocked)
    monkeypatch.setattr(type(srv.prefill_pool[0]), "kv_admission_probe",
                        lambda self, *a, **k: None)
    fresh = srv.submit(prompt_of(3, 1), max_new=4)
    srv._admit_prefill(time.monotonic())
    assert list(srv._requeue) == [blocked]
    assert srv.scheduler.pending() == 1
    assert not fresh.done and not srv._slot_handles


def test_outstanding_counts_requeue_and_abort_flushes_it(srv):
    h = _handle(5)
    srv._requeue.append(h)
    srv._skip[h.id] = 2
    assert srv._outstanding() == 1
    srv._abort_outstanding()
    assert h.done and h.finish_reason == "shutdown"
    assert srv._outstanding() == 0 and h.id not in srv._skip


def test_finish_key_completes_handle_even_if_evict_kills_worker(
        srv, monkeypatch):
    srv.recover = False
    h = _handle(6, ntoks=4, max_new=4)
    srv._slot_handles[("decode", 0, 1)] = h
    monkeypatch.setattr(
        srv.decode_pool[0], "evict",
        lambda slot: (_ for _ in ()).throw(RuntimeError("evict boom")))
    with pytest.raises(RuntimeError, match="evict boom"):
        srv._finish_key(("decode", 0, 1), "length")
    assert h.done and h.finish_reason == "length"


# -- the chaos drives ---------------------------------------------------------

def _run(model, reqs, fault=None, temps=None, **kw):
    if fault:
        faults.arm(fault)
    try:
        server = disagg(model, **{**dict(prefill_slots=2, handoff="serial",
                                         decode_block=2), **kw}).start()
        try:
            hs = serve(server, reqs, temps)
            st = server.stats()
        finally:
            assert server.close(60)
    finally:
        faults.disarm()
    return hs, st


def test_decode_worker_kill_lanes_finish_identical(models, reference,
                                                   tmp_path):
    from tpudist_torch import telemetry
    from tpudist_torch.telemetry.aggregate import aggregate_run

    _, model = models
    reqs = base_reqs(4)
    telemetry.start(tmp_path)
    try:
        hs, st = _run(model, reqs, "serve_worker_kill@call:3,pool:1,worker:0",
                      decode_workers=2)
    finally:
        telemetry.finish(write_report=False)
    for h, (p, n) in zip(hs, reqs):
        assert h.finish_reason == "length"
        assert h.tokens == reference(p, n)
    assert st["workers_lost"] == 1 and st["lanes_recovered"] >= 1
    assert st["decode_pool"]["dead"] == [0]
    report = aggregate_run(tmp_path)
    pools = report["serving"]["pools"]
    assert pools["workers_lost"] == 1 and pools["lanes_recovered"] >= 1
    names = {e["name"] for e in report["events"]}
    assert {"worker_lost", "lane_recovered"} <= names
    assert "shutdown" not in report["serving"]["finish_reasons"]


def test_decode_worker_kill_sampled_streams_identical(models):
    _, model = models
    reqs, temps = base_reqs(2), [0.8, 0.8]
    want, _ = _run(model, reqs, temps=temps, decode_workers=2)
    got, st = _run(model, reqs, "serve_worker_kill@call:4,pool:1,worker:0",
                   temps=temps, decode_workers=2)
    assert st["workers_lost"] == 1
    assert [h.tokens for h in got] == [h.tokens for h in want]


def test_double_decode_loss_still_identical(models, reference):
    """A lane recovered once and lost again before its replay skip is
    spent still continues bit for bit: the stash records the delivered
    count net of the pending skip."""
    _, model = models
    reqs = [(PROMPTS[0], 8), (PROMPTS[2], 8)]
    hs, st = _run(model, reqs,
                  "serve_worker_kill@call:4,pool:1,worker:0;"
                  "serve_worker_kill@call:3,pool:1,worker:1",
                  decode_workers=3)
    assert st["workers_lost"] == 2
    for h, (p, n) in zip(hs, reqs):
        assert h.finish_reason == "length" and h.tokens == reference(p, n)


def test_prefill_worker_kill_replays_on_survivor(models, reference):
    _, model = models
    reqs = [(PROMPTS[4], 6), (PROMPTS[2], 8)]  # one chunked mid-kill
    hs, st = _run(model, reqs, "serve_worker_kill@call:2,pool:0,worker:0",
                  prefill_slots=1, prefill_workers=2)
    for h, (p, n) in zip(hs, reqs):
        assert h.finish_reason == "length" and h.tokens == reference(p, n)
    assert st["workers_lost"] == 1 and st["prefill_pool"]["dead"] == [0]


def test_corrupt_handoff_finishes_with_reason_server_survives(
        models, reference, tmp_path):
    from tpudist_torch import telemetry
    from tpudist_torch.telemetry.aggregate import aggregate_run

    _, model = models
    reqs = base_reqs(3)
    telemetry.start(tmp_path)
    faults.arm("handoff_corrupt@nth:2")
    try:
        server = disagg(model, handoff="serial", decode_block=2).start()
        try:
            hs = serve(server, reqs)
            reasons = [h.finish_reason for h in hs]
            assert reasons.count("handoff_corrupt") == 1
            for h, (p, n) in zip(hs, reqs):
                if h.finish_reason == "length":
                    assert h.tokens == reference(p, n)
            # the server serves on after the rejection
            h2 = server.submit(PROMPTS[5], max_new=REQS[5][2])
            assert h2.wait(60) and h2.finish_reason == "length"
            assert h2.tokens == reference(PROMPTS[5], REQS[5][2])
        finally:
            assert server.close(30)
    finally:
        faults.disarm()
        telemetry.finish(write_report=False)
    report = aggregate_run(tmp_path)
    assert any(e["name"] == "handoff_rejected" for e in report["events"])
    assert report["serving"]["finish_reasons"]["handoff_corrupt"] == 1


def test_decode_pool_collapse_finishes_loudly_never_hangs(models):
    _, model = models
    faults.arm("serve_worker_kill@call:2,pool:1,worker:0")
    try:
        server = disagg(model, prefill_slots=2, handoff="serial",
                        decode_block=2).start()
        try:
            hs = serve(server, [(prompt_of(3 + i, i), 8) for i in range(4)])
            assert [h.finish_reason for h in hs] == ["worker_lost"] * 4
            with pytest.raises(AdmissionError, match="worker_lost"):
                server.submit(prompt_of(3, 9), max_new=4)
        finally:
            assert server.close(30)
    finally:
        faults.disarm()


def test_backpressure_shrinks_then_grows_prefill_cap(models, tmp_path):
    from tpudist_torch import telemetry
    from tpudist_torch.telemetry.aggregate import aggregate_run

    _, model = models
    telemetry.start(tmp_path)
    try:
        hs, st = _run(model, [(prompt_of(3 + i % 3, i), 20)
                              for i in range(5)],
                      prefill_slots=4, decode_block=1, handoff_queue=1,
                      pool_resize=4)
    finally:
        telemetry.finish(write_report=False)
    assert st["pool_resizes"] >= 2
    assert all(h.finish_reason == "length" for h in hs)
    assert st["prefill_pool"]["slot_cap"] >= 2
    report = aggregate_run(tmp_path)
    dirs = [e.get("direction") for e in report["events"]
            if e["name"] == "pool_resize"]
    assert "shrink" in dirs and "grow" in dirs
    assert report["serving"]["pools"]["pool_resizes"] >= 2


# -- degradation, spec, the mesh and the fleet through the pools -------------

@pytest.mark.parametrize("handoff", ["serial", "device"])
def test_session_resume_through_the_pools(models, reference, handoff):
    """A session's next turn resumes its parked lane on a prefill worker
    (the suffix alone teacher-forced) and hands off like any lane."""
    _, model = models
    server = disagg(model, num_slots=1, max_new=6, host_tier=True,
                    handoff=handoff, decode_block=2).start()
    try:
        p1 = prompt_of(5, 60)
        h1 = server.submit(p1, max_new=6, session="d1", tenant="t")
        assert h1.wait(60)
        t0 = time.monotonic()
        while server._tier.parks < 1:
            assert time.monotonic() - t0 < 30, "the turn never parked"
            time.sleep(0.005)
        p2 = np.concatenate([p1, np.asarray(h1.tokens, np.int32),
                             prompt_of(4, 61)])
        h2 = server.submit(p2, max_new=6, session="d1", tenant="t")
        assert h2.wait(60)
        st = server.stats()
    finally:
        assert server.close(30)
    assert h2.finish_reason == "session_resumed" and h2.resumed
    assert h2.tokens == reference(p2, 6)
    assert st["handoffs"] == 2


@pytest.mark.parametrize("corrupt", [False, True], ids=["park", "lost"])
def test_decode_preemption_and_resume(models, reference, corrupt):
    """A priority-2 arrival preempts the one decode lane into the host
    tier; the preempted sampled lane resumes to the stream of a run
    without preemption — also when its parked package fails its digest
    (``host_tier_corrupt``): it prefills again, and the tokens it had
    delivered drop as duplicates."""
    _, model = models
    plow, phigh = prompt_of(4, 62), prompt_of(4, 63)
    server = disagg(model, num_slots=1, max_new=48, host_tier=True,
                    handoff="serial").start()
    high = []

    def arrive(tok, i):
        # on the engine thread, once the low lane has 3 tokens
        if i == 2:
            high.append(server.submit(phigh, max_new=4, priority=2))

    if corrupt:
        faults.arm("host_tier_corrupt@nth:1")
    try:
        hlow = server.submit(plow, max_new=48, priority=0, temperature=0.6,
                             seed=8, on_token=arrive)
        assert hlow.wait(120) and high and high[0].wait(120)
        preemptions, tier_corrupt = server.preemptions, server.tier_corrupt
    finally:
        faults.disarm()
        assert server.close(30)
    assert preemptions >= 1 and tier_corrupt == int(corrupt)
    assert high[0].tokens == reference(phigh, 4)
    twin = disagg(model, num_slots=1, max_new=48, handoff="serial").start()
    try:
        want = twin.submit(plow, max_new=48, temperature=0.6, seed=8)
        assert want.wait(120)
    finally:
        assert twin.close(30)
    assert hlow.finish_reason == "length" and hlow.tokens == want.tokens


def test_spec_decode_pool_cold_draft_keeps_greedy_output(models, reference):
    """The decode pool owns the draft; an imported lane's draft starts
    cold, which moves acceptance, never the greedy output."""
    _, model = models
    server = disagg(model, "dense", handoff="serial", spec=True, spec_k=4,
                    spec_draft_layers=1).start()
    try:
        hs = serve(server, base_reqs())
        st = server.stats()
    finally:
        assert server.close(30)
    for h, (p, n) in zip(hs, base_reqs()):
        assert h.tokens == reference(p, n)
    assert st["decode_pool"]["spec"]["blocks"] > 0
    assert not server.prefill_pool[0].spec and server.decode_pool[0].spec


def test_serving_mesh_1x2_pools(models, reference):
    _, model = models
    server = disagg(model, handoff="device", mesh="1x2").start()
    try:
        hs = serve(server, base_reqs())
        st = server.stats()
    finally:
        assert server.close(30)
    for h, (p, n) in zip(hs, base_reqs()):
        assert h.tokens == reference(p, n)
    assert st["spmd"]["mesh"] == {"data": 1, "model": 2}
    assert all(e.mesh is not None for e in server._adapter_engines())


def test_fleet_router_over_disagg_replicas(models, reference):
    """Two disaggregated replicas behind the router: greedy streams equal
    ``generate()``'s, and a session's turn 2 resumes on its home replica."""
    _, model = models
    reps = [disagg(model, host_tier=True, handoff="serial").start()
            for _ in range(2)]
    router = FleetRouter(reps, RouterConfig(probe_s=0.02)).start()
    try:
        hs = serve(router, base_reqs())
        for h, (p, n) in zip(hs, base_reqs()):
            assert h.finish_reason == "length" and h.tokens == reference(p, n)
        p1 = prompt_of(5, 30)
        h1 = router.submit(p1, max_new=4, session="aff", tenant="t")
        assert h1.wait(60)
        t0 = time.monotonic()
        while router.stats()["stash_entries"] < 1:
            assert time.monotonic() - t0 < 30, "no stash export"
            time.sleep(0.005)
        p2 = np.concatenate([p1, np.asarray(h1.tokens, np.int32)])
        h2 = router.submit(p2, max_new=4, session="aff", tenant="t")
        assert h2.wait(60)
        assert h2.replica == h1.replica and h2.resumed
        assert h2.tokens == reference(p2, 4)
        assert sum(router.stats()["per_replica"]) == len(REQS) + 2
    finally:
        router.close(30)
