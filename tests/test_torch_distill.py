"""Online draft distillation on the port (``tpudist_torch/distill/``, the
hot-swap seams of ``serve/engine.py``, ``serve/server.py`` and
``serve/disagg.py``) against the JAX package on the CPU, with the weights
carried across by ``params_from_flax``.

- the capture ring: the same offers give JAX's ledger, snapshot, holdout
  split, heaviest adapter and env gating;
- ``pack_streams`` and ``gate_swap`` (on a grid of inputs) equal JAX's;
  ``score_holdout`` equals JAX's, every position whose argmax differs named
  with its top-2 gap (which must be under 1e-5);
- ``distill_streams`` through the port's Trainer: the final loss of a
  5-step f32 round within rtol 1e-4 of the JAX Trainer's, the candidate in
  the serving draft's names, shapes and dtypes; ``distill_draft`` from
  JAX's seed-initialized draft carried across, its loss and weights;
- the engine swap: the geometry ``ValueError``, the non-spec
  ``RuntimeError``, two swaps landed with requests in flight on the plain
  arms (greedy streams byte-identical, the target's weights bit-equal, the
  slot programs the same object); the disaggregated broadcast (2 decode
  workers in lockstep);
- ``DistillLoop``: the ``min_tokens`` skip, a full round and its record,
  the server's telemetry session surviving a round (and no SIGTERM
  handler installed, and a process group the process holds left up),
  capture armed from the env, the background thread, and a
  ``draft_swap_corrupt`` round rejected with the serving draft untouched.
"""

import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist import distill as jd
from tpudist.models import create_transformer as jax_create
from tpudist.models import tied_draft as jax_tied_draft
from torch_cases import settled_torch_cpu
from tpudist_torch import distill as pd
from tpudist_torch import telemetry
from tpudist_torch.models import (TransformerLM, params_from_flax,
                                  tied_draft)
from tpudist_torch.runtime import faults
from tpudist_torch.serve import (DisaggServer, InferenceServer, ServeConfig,
                                 SlotEngine)

CFG = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=64,
           rope=True)
SERVE_KW = dict(num_slots=2, queue_limit=16, prefill_pad=8, kv_block=8,
                decode_block=2, spec=True, spec_draft_layers=1, spec_k=4)
DENSE = dict(paged=False, attn_kernel="gather", prefill_kernel=False,
             sample_kernel=False)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """The round's Trainer rows land under the test's tmp."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture
def events(monkeypatch):
    """The telemetry events of the test, recorded on their way to the
    session (``telemetry.event`` wrapped)."""
    got, orig = [], telemetry.event

    def event(name, **fields):
        got.append(dict(fields, name=name))
        return orig(name, **fields)

    monkeypatch.setattr(telemetry, "event", event)
    return got


@pytest.fixture(scope="module")
def models():
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, **CFG)
    model = TransformerLM(**CFG)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return (jmod, jparams), model.requires_grad_(False)


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab"], size=plen).astype(np.int32)


def _streams(n=6, seed=0):
    """Seeded token streams of several lengths (prompt + emitted), half
    greedy, two adapter tags."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(2, 6))
        toks = rng.integers(0, CFG["vocab"], size=plen + int(
            rng.integers(4, 12))).astype(np.int32)
        out.append((toks, plen, i % 2 == 0, f"t{i % 3}",
                    ("a", "b", None)[i % 3]))
    return out


def _both(streams):
    """The same streams as JAX's and the port's ``CapturedStream``."""
    return ([jd.CapturedStream(tokens=t, prompt_len=p, greedy=g, tenant=te,
                               adapter=a) for t, p, g, te, a in streams],
            [pd.CapturedStream(tokens=t, prompt_len=p, greedy=g, tenant=te,
                               adapter=a) for t, p, g, te, a in streams])


# ---------------------------------------------------------------------------
# the capture ring, packing, the gate


@pytest.mark.parametrize("budget,every", [(20, 1), (64, 2), (4096, 1),
                                          (40, 3)])
def test_capture_ring_equals_jax(budget, every):
    rng = np.random.default_rng(budget + every)
    bufs = (jd.CaptureBuffer(budget, every), pd.CaptureBuffer(budget, every))
    for i in range(14):
        plen, emit = int(rng.integers(1, 10)), int(rng.integers(0, 9))
        if i == 5:
            plen = budget + 3  # oversize
        prompt = rng.integers(0, 16, plen)
        emitted = rng.integers(0, 16, emit)
        kw = dict(greedy=bool(i % 2), tenant=(None, "x", "y")[i % 3],
                  adapter=(None, "a", "b", "a")[i % 4])
        kept = [b.offer(prompt, emitted, **kw) for b in bufs]
        assert kept[0] == kept[1]
    j, p = bufs
    assert p.stats() == j.stats()
    snap_j, snap_p = j.snapshot(), p.snapshot()
    assert [dataclasses.astuple(s)[1:] for s in snap_p] == \
        [dataclasses.astuple(s)[1:] for s in snap_j]
    for a, b in zip(snap_j, snap_p):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert [len(s) for s in p.snapshot("a", only_adapter=True)] == \
        [len(s) for s in j.snapshot("a", only_adapter=True)]
    for ms in (1, 2, 3):
        assert p.heaviest_adapter(ms) == j.heaviest_adapter(ms)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 12, 16])
@pytest.mark.parametrize("frac", [0.01, 0.25, 0.5, 0.9])
def test_split_holdout_equals_jax(n, frac):
    js, ps = _both(_streams(n, seed=n))
    tj, hj = jd.CaptureBuffer.split_holdout(js, frac)
    tp, hp = pd.CaptureBuffer.split_holdout(ps, frac)
    for a, b in ((tj, tp), (hj, hp)):
        assert [list(s.tokens) for s in a] == [list(s.tokens) for s in b]


def test_capture_from_env_equals_jax(monkeypatch):
    monkeypatch.delenv("TPUDIST_DISTILL_CAPTURE", raising=False)
    assert pd.CaptureBuffer.from_env() is None
    assert jd.CaptureBuffer.from_env() is None
    monkeypatch.setenv("TPUDIST_DISTILL_CAPTURE", "1")
    monkeypatch.setenv("TPUDIST_DISTILL_BUFFER_TOKENS", "123")
    monkeypatch.setenv("TPUDIST_DISTILL_SAMPLE", "3")
    j, p = jd.CaptureBuffer.from_env(), pd.CaptureBuffer.from_env()
    assert (p.budget_tokens, p.sample_every) == (j.budget_tokens,
                                                 j.sample_every) == (123, 3)
    with pytest.raises(ValueError):
        pd.CaptureBuffer(0)


def test_pack_streams_equals_jax():
    js, ps = _both(_streams(5))
    for kw in ({}, {"pad_to": 20}, {"pad_rows_to": 8},
               {"pad_to": 19, "pad_rows_to": 3}):
        np.testing.assert_array_equal(pd.pack_streams(ps, **kw),
                                      jd.pack_streams(js, **kw))
    raw = [np.arange(3), np.arange(5)]
    np.testing.assert_array_equal(pd.pack_streams(raw),
                                  jd.pack_streams(raw))
    for fn in (pd.pack_streams, jd.pack_streams):
        with pytest.raises(ValueError):
            fn([])
        with pytest.raises(ValueError):
            fn(ps, pad_to=2)


def test_gate_swap_equals_jax_on_a_grid():
    vals = (None, 0.0, 0.3, 0.5, 0.52, 0.9)
    for c in vals:
        for s in vals:
            for live in vals:
                for margin in (-1.0, 0.0, 0.02, 0.1):
                    args = ({"acceptance": c}, {"acceptance": s}, live)
                    assert pd.gate_swap(*args, margin=margin) == \
                        jd.gate_swap(*args, margin=margin)


def test_score_holdout_equals_jax(models):
    """The draft scored on seeded streams and on the target's own greedy
    continuations (the calibration: acceptance 1.0 for the target as its
    own draft).  A position whose argmax differs must be a near tie of
    JAX's logits, and is named."""
    (jmod, jparams), model = models
    jdm, jdp = jax_tied_draft(jmod, jparams, 1)
    draft = tied_draft(model, 1)
    cont = pd.continuations_from_target(model, [_prompt(4, 7),
                                                _prompt(6, 8)], 8)
    jcont = jd.continuations_from_target(jmod, jparams, [_prompt(4, 7),
                                                         _prompt(6, 8)], 8)
    for a, b in zip(cont, jcont):
        np.testing.assert_array_equal(a, b)
    js, ps = _both(_streams(6) + [(c, 4 + 2 * i, True, None, None)
                                  for i, c in enumerate(cont)])
    for (jm, jp), pm in (((jdm, jdp), draft), ((jmod, jparams), model)):
        for k in (1, 4):
            got = pd.score_holdout(pm, pm.state_dict(), ps, spec_k=k)
            want = jd.score_holdout(jm, jp, js, spec_k=k)
            if got != want:
                toks = pd.pack_streams(ps)
                lj = np.asarray(jm.apply(jp, jnp.maximum(
                    jnp.asarray(toks), 0)))
                with torch.no_grad():
                    lp = pm(torch.from_numpy(toks).clamp_min(0)).numpy()
                where = np.argwhere(lj.argmax(-1) != lp.argmax(-1))
                top = np.sort(lj, -1)
                gaps = {tuple(w): float(top[tuple(w)][-1]
                                        - top[tuple(w)][-2]) for w in where}
                assert gaps and all(g < 1e-5 for g in gaps.values()), gaps
    self_score = pd.score_holdout(model, model.state_dict(),
                                  ps[-2:], spec_k=4)
    assert self_score["match"] == 1.0 and self_score["acceptance"] == 1.0
    assert pd.score_holdout(draft, draft.state_dict(), [])["streams"] == 0


# ---------------------------------------------------------------------------
# the round's training


def test_distill_streams_equals_jax(models):
    """One 5-step f32 round through each package's Trainer from the same
    tied draft on the same streams: the final losses within rtol 1e-4,
    the candidates' weights close, the candidate in the serving draft's
    geometry, the serving draft (the target's own tensors) untouched."""
    (jmod, jparams), model = models
    jdm, jdp = jax_tied_draft(jmod, jparams, 1)
    draft = tied_draft(model, 1)
    target = {k: v.clone() for k, v in model.state_dict().items()}
    js, ps = _both(_streams(6, seed=3))
    jcand, jloss = jd.distill_streams(jdm, jdp, js, steps=5)
    cand, loss = pd.distill_streams(draft, draft.state_dict(), ps, steps=5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    ref = draft.state_dict()
    assert list(cand) == list(ref)
    assert all(cand[k].shape == ref[k].shape and cand[k].dtype == ref[k].dtype
               for k in ref)
    want = params_from_flax(jax.tree.map(np.asarray, jcand))
    for k in ref:
        err = float((cand[k] - want[k]).norm() / want[k].norm())
        assert err < 1e-3, (k, err)
    assert all(torch.equal(v, target[k])
               for k, v in model.state_dict().items())


def test_distill_streams_casts_back_to_the_serving_dtype(models):
    """A bf16 serving draft trains on f32 masters and comes back bf16."""
    _, model = models
    bf = TransformerLM(dtype=torch.bfloat16, **CFG)
    bf.load_state_dict(model.state_dict())
    draft = tied_draft(bf.requires_grad_(False), 1)
    cand, loss = pd.distill_streams(draft, draft.state_dict(),
                                    _both(_streams(4))[1], steps=2)
    assert np.isfinite(loss)
    ref = draft.state_dict()
    assert {k: t.dtype for k, t in cand.items()} == \
        {k: t.dtype for k, t in ref.items()}
    assert cand["blocks.0.qkv"].dtype == torch.bfloat16
    assert cand["ln_f"].dtype == torch.float32  # the norms stay f32


def test_distill_draft_equals_jax(models, monkeypatch):
    """``distill_draft`` from JAX's seed-initialized draft carried across
    (the port draws its own from ``torch.Generator(seed)``): the final
    loss within rtol 1e-4 and the trained weights close."""
    (jmod, jparams), model = models
    pool = [_prompt(4, 11), _prompt(6, 12), _prompt(3, 13)]
    jdm, jdp, jloss = jd.distill_draft(jmod, jparams, 1, pool, 5, 6,
                                       seed=11)
    jdraft, _ = jax_tied_draft(jmod, jparams, 1)
    init = jdraft.init(jax.random.PRNGKey(11), jnp.zeros((1, 8), jnp.int32))
    import tpudist_torch.distill.train as dtrain

    real = dtrain.create_transformer
    seeds = []

    def carried(seed, **kw):
        seeds.append(seed)
        m = real(seed, **kw)
        m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, init)))
        return m

    monkeypatch.setattr(dtrain, "create_transformer", carried)
    draft, sd, loss = pd.distill_draft(model, 1, pool, 5, 6, seed=11)
    assert seeds == [11] and draft.n_layers == 1
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    want = params_from_flax(jax.tree.map(np.asarray, jdp))
    for k, v in sd.items():
        err = float((v - want[k]).norm() / want[k].norm())
        assert err < 1e-3, (k, err)


# ---------------------------------------------------------------------------
# the engine swap and the servers


def _server(model, flavor="server", **extra):
    cfg = ServeConfig(**{**SERVE_KW, **extra})
    if flavor == "disagg":
        cfg = dataclasses.replace(cfg, disagg=True, decode_workers=2,
                                  handoff="serial")
        return DisaggServer(model, cfg, device="cpu",
                            install_signal_handler=False).start()
    return InferenceServer(model, cfg, device="cpu",
                           install_signal_handler=False).start()


POOL = [_prompt(3 + i, 20 + i) for i in range(4)]


def _noised(sd, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.05 * torch.randn(v.shape, generator=g)
            for k, v in sd.items()}


def test_swap_geometry_and_non_spec_refusals(models):
    _, model = models
    srv = _server(model)
    try:
        _, sd = srv.draft_ref()
        with pytest.raises(ValueError, match="geometry"):
            srv.swap_draft({k: torch.zeros(tuple(d + 1 for d in v.shape))
                            for k, v in sd.items()})
        with pytest.raises(ValueError, match="geometry"):
            srv.swap_draft({"not": next(iter(sd.values()))})
        with pytest.raises(ValueError, match="geometry"):
            srv.swap_draft({k: v.double() for k, v in sd.items()})
        assert srv.engine.draft_swaps == 0  # nothing landed
    finally:
        srv.close(60)
    plain = InferenceServer(model, ServeConfig(num_slots=2, prefill_pad=8),
                            device="cpu",
                            install_signal_handler=False).start()
    try:
        assert plain.draft_ref() is None
        with pytest.raises(RuntimeError):
            plain.swap_draft({})
    finally:
        plain.close(60)
    with pytest.raises(RuntimeError):
        SlotEngine(model, num_slots=2, device="cpu").swap_draft({})


@pytest.mark.parametrize("arms", ["kernel", "dense"])
def test_two_swaps_under_churn(models, arms):
    """Two noised same-geometry candidates landed with requests in flight:
    greedy streams byte-identical to the pre-swap oracle, the target's
    weights bit-equal, the slot programs the same object, the draft the
    last candidate, lanes re-armed."""
    _, model = models
    target = {k: v.clone() for k, v in model.state_dict().items()}
    srv = _server(model, **(DENSE if arms == "dense" else {}))
    ref = {}
    try:
        for p in POOL:
            h = srv.submit(p, max_new=6)
            assert h.wait(120)
            ref[p.tobytes()] = h.tokens
        fns = srv.engine.fns
        _, sd = srv.draft_ref()
        rearmed = 0
        for i in range(2):
            cand = _noised(sd, 99 + i)
            handles = [srv.submit(p, max_new=6) for p in POOL]
            info = srv.swap_draft(cand)
            assert info["swapped"]
            rearmed += info["lanes_rearmed"]
            for p, h in zip(POOL, handles):
                assert h.wait(120)
                assert h.tokens == ref[p.tobytes()], f"swap {i}"
            assert all(torch.equal(v, cand[k]) for k, v in
                       srv.engine.draft_model.state_dict().items())
        assert srv.engine.draft_swaps == 2
        assert srv.stats()["spec"]["draft_swaps"] == 2
        assert srv.engine.fns is fns
        for p in POOL:
            h = srv.submit(p, max_new=6)
            assert h.wait(120)
            assert h.tokens == ref[p.tobytes()]
    finally:
        srv.close(60)
    assert all(torch.equal(v, target[k])
               for k, v in model.state_dict().items())


def test_swap_on_a_mesh_recuts_the_draft_places(models):
    """Under a 1x2 mesh the tied draft's places are the target's views; a
    swap gives the draft places of its own and leaves the target's."""
    _, model = models
    eng = SlotEngine(model, num_slots=2, prefill_pad=8, kv_block=8,
                     mesh="1x2", spec_draft=1, device="cpu")
    tplaces = [dict(pw) for pw in eng.places.blocks]
    cand = _noised(eng.draft_model.state_dict(), 5)
    eng.swap_draft(cand)
    dp = eng._draft_places
    assert dp.blocks[0]["qkv"][0] is not tplaces[0]["qkv"][0]
    assert all(eng.places.blocks[i]["qkv"][0] is tplaces[i]["qkv"][0]
               for i in range(len(tplaces)))
    want = cand["blocks.0.qkv"][:8]
    assert torch.equal(dp.blocks[0]["qkv"][0][:8], want)


def test_disagg_broadcast(models):
    _, model = models
    srv = _server(model, "disagg")
    ref = {}
    try:
        for p in POOL:
            h = srv.submit(p, max_new=5)
            assert h.wait(120)
            ref[p.tobytes()] = h.tokens
        _, sd = srv.draft_ref()
        handles = [srv.submit(p, max_new=5) for p in POOL]
        info = srv.swap_draft({k: v * 0.9 for k, v in sd.items()})
        assert info["swapped"] and info["engines"] == 2
        assert [e.draft_swaps for e in srv.decode_pool] == [1, 1]
        assert srv.stats()["decode_pool"]["spec"]["draft_swaps"] == 1
        for p, h in zip(POOL, handles):
            assert h.wait(120)
            assert h.tokens == ref[p.tobytes()]
    finally:
        srv.close(60)


# ---------------------------------------------------------------------------
# the loop


def _loaded(model, n=6, **extra):
    srv = _server(model, **extra)
    srv.attach_capture(pd.CaptureBuffer(budget_tokens=4096))
    for i in range(n):
        h = srv.submit(_prompt(4, 30 + i), max_new=6)
        assert h.wait(120)
    return srv


def test_round_skips_below_min_tokens(models):
    _, model = models
    srv = _server(model)
    srv.attach_capture(pd.CaptureBuffer(budget_tokens=4096))
    loop = pd.DistillLoop(srv, srv.capture, steps=1, min_tokens=10_000)
    try:
        r = loop.run_once()
        assert not r["swapped"] and r["reason"] == "min_tokens"
        assert loop.rounds == 1 and loop.swaps == 0
    finally:
        srv.close(60)


def test_full_round_audited_inside_the_server(models, events):
    """A round's record carries the gate's inputs and lands a swap; the
    Trainer inside the serving process neither finishes the server's
    telemetry session nor installs a SIGTERM handler; the statusz block and
    the ``draft_swap`` counter follow."""
    _, model = models
    target = {k: v.clone() for k, v in model.state_dict().items()}
    srv = _loaded(model)
    session = telemetry.active()
    handler = signal.getsignal(signal.SIGTERM)
    loop = pd.DistillLoop(srv, srv.capture, steps=4, min_tokens=16,
                          holdout=0.25, margin=-1.0)  # always-win gate
    try:
        r = loop.run_once()
        assert r["swapped"] and srv.engine.draft_swaps == 1
        for key in ("candidate_acceptance", "baseline", "loss",
                    "train_streams", "holdout_streams", "round_s",
                    "swap_s", "lanes_rearmed", "capture_tokens"):
            assert key in r, key
        assert telemetry.active() is session is not None
        assert signal.getsignal(signal.SIGTERM) is handler
        assert srv._statusz_doc()["distill"]["capture"]["streams"] == 6
        assert loop.stats()["swaps"] == 1 and loop.last_round is r
        h = srv.submit(POOL[0], max_new=4)
        assert h.wait(120) and h.finish_reason == "length"
    finally:
        srv.close(60)
    assert all(torch.equal(v, target[k])
               for k, v in model.state_dict().items())
    rounds = [e for e in events if e["name"] == "distill_round"]
    swaps = [e for e in events if e["name"] == "draft_swap"]
    assert len(rounds) == 1 and rounds[0]["swapped"]
    assert len(swaps) == 1 and swaps[0]["draft_swaps"] == 1


def test_round_keeps_a_held_process_group(models, monkeypatch):
    """A round's Trainer inside a process that already holds a process
    group (world 1 over gloo) joins it: the group is the same after."""
    import torch.distributed as dist

    from tpudist_torch.runtime import bootstrap
    from tpudist_torch.runtime.bootstrap import find_free_port

    _, model = models
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(find_free_port()))
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            + str(find_free_port()), world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        draft = tied_draft(model, 1)
        cand, loss = pd.distill_streams(draft, draft.state_dict(),
                                        _both(_streams(3))[1], steps=2)
        assert np.isfinite(loss)
        assert dist.is_initialized() and dist.group.WORLD is group
        dist.barrier()
    finally:
        bootstrap._INITIALIZED_CTX = None
        dist.destroy_process_group()


def test_capture_from_env_and_the_thread(models, monkeypatch, events):
    """``TPUDIST_DISTILL_CAPTURE=1`` arms the tap at ``start()`` on both
    flavours; the loop's thread runs rounds beside the serving loop and
    stops; greedy streams stay the oracle's."""
    _, model = models
    monkeypatch.setenv("TPUDIST_DISTILL_CAPTURE", "1")
    for flavor in ("server", "disagg"):
        srv = _server(model, flavor)
        try:
            assert srv.capture is not None
            ref = []
            for p in POOL:
                h = srv.submit(p, max_new=6)
                assert h.wait(120)
                ref.append(h.tokens)
            assert srv.capture.stats()["captured"] == len(POOL)
            loop = pd.DistillLoop(srv, srv.capture, steps=2, min_tokens=8,
                                  interval_s=0.01, margin=-1.0)
            loop.start()
            with pytest.raises(RuntimeError):
                loop.start()
            handles = [srv.submit(p, max_new=6) for p in POOL]
            for h, want in zip(handles, ref):
                assert h.wait(120) and h.tokens == want
            import time

            deadline = time.monotonic() + 60
            while loop.swaps < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert loop.stop(60)
            assert loop.swaps >= 1 and loop.rounds >= 1
            h = srv.submit(POOL[1], max_new=6)
            assert h.wait(120) and h.tokens == ref[1]
        finally:
            srv.close(60)
    rounds = [e for e in events if e["name"] == "distill_round"]
    assert rounds and not [e for e in rounds if e["reason"] == "error"]


def test_corrupt_round_rejected(models):
    _, model = models
    srv = _loaded(model)
    loop = pd.DistillLoop(srv, srv.capture, steps=2, min_tokens=16,
                          margin=0.0)
    before = {k: v.clone()
              for k, v in srv.engine.draft_model.state_dict().items()}
    faults.arm("draft_swap_corrupt@nth:1")
    try:
        r = loop.run_once()
    finally:
        faults.disarm()
        srv.close(60)
    assert r.get("fault") == "draft_swap_corrupt"
    assert not r["swapped"] and loop.corrupt_rejected == 1
    assert srv.engine.draft_swaps == 0
    assert all(torch.equal(v, before[k]) for k, v in
               srv.engine.draft_model.state_dict().items())
