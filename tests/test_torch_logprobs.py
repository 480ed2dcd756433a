"""Logprobs, the speculative verify's grammar path and the server's
structured-output surface in the port, against the JAX package on the CPU.

- ``top_logprobs`` equals the JAX ``_top_lp`` (``log_softmax`` and
  ``lax.top_k``) on grammar-masked rows — entries at f32's lowest value, a
  row where EOS alone is allowed, ties — ids exactly, values within ``rtol
  1e-5, atol 1e-5``;
- the port's speculative engine (the tied draft, K 4) with
  ``constrain`` and ``logprobs=3`` gives the JAX spec engine's greedy
  streams, ``gidx`` / ``gstate`` after every block, logprobs and acceptance
  counters on a mixed constrained and free batch; a grammar-forbidden draft
  whose masked target probability underflows to zero is rejected by
  ``tok_ok`` where ``u · pd <= pt`` alone would accept it;
- the server: constrained greedy streams with logprobs, free lanes and stop
  sequences (one token, and two tokens straddling a decode-block boundary)
  equal the JAX server's tokens, finish reasons and logprobs rows; every
  rejection reason equals JAX's for the same ask; ``stop_sequence`` and
  ``grammar_violation`` are registered as JAX registers them; tables that
  diverge from the host shadow truncate ``grammar_violation``; a free
  sampled lane is the same alone and beside constrained lanes; a
  constrained request waits while every grammar block is pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_constrain as tc
from tpudist.serve import InferenceServer as JaxServer
from tpudist.serve import ServeConfig as JaxServeConfig
from tpudist.serve.scheduler import AdmissionError as JaxAdmissionError
from tpudist.serve.scheduler import FINISH_REASONS as JAX_FINISH_REASONS
from torch_cases import settled_torch_cpu
from tpudist_torch.constrain import compile_grammar
from tpudist_torch.models.generate import (_trajectory_mask, spec_accept,
                                           top_logprobs)
from tpudist_torch.serve import (FINISH_REASONS, AdmissionError,
                                 InferenceServer, ServeConfig, SlotEngine)

CFG, EOS, VOCAB, N_LP = tc.CFG, tc.EOS, tc.VOCAB, tc.N_LP
SERVE_KW = dict(num_slots=4, prefill_pad=8, kv_block=4, decode_block=4,
                max_new=10)
STRUCTURED = dict(constrain=True, constrain_blocks=2, constrain_states=32,
                  logprobs=N_LP)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(scope="module")
def models():
    return tc._models()


# ---------------------------------------------------------------------------
# top-n logprobs of masked rows


def _jax_top_lp(logits, n):
    """The JAX engine's ``_top_lp``."""
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    vals, ids = jax.lax.top_k(lp, n)
    return np.asarray(ids), np.asarray(vals)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_top_logprobs_equal_jax_on_masked_rows(n):
    (_, pr), (_, ps) = tc._grammars()
    r = np.random.default_rng(n)
    logits = r.normal(size=(6, CFG["vocab"])).astype(np.float32) * 3
    logits[5, 10:20] = logits[5, 3]  # ties
    states = [0, 1, 2, 4, 0, 0]  # state 4 of the regex: EOS alone
    allow = np.stack([pr.allowed[s] for s in states[:4]]
                     + [ps.allowed[0], np.ones(CFG["vocab"], bool)])
    assert allow[3].sum() == 1 and allow[3, EOS]
    masked = np.where(allow, logits, np.finfo(np.float32).min)
    ids, vals = top_logprobs(torch.from_numpy(masked), n)
    want_ids, want_vals = _jax_top_lp(masked, n)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(vals.numpy(), want_vals, rtol=1e-5,
                               atol=1e-5)
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    assert float(vals[3, 0]) == 0.0
    if n > 1:
        assert float(vals[3, 1]) < -1e30


# ---------------------------------------------------------------------------
# the speculative verify


def test_spec_streams_states_logprobs_equal_jax(models, k=4):
    (jr, pr), (js, ps) = tc._grammars()
    jeng, eng = tc._engines(models, spec_draft=1, spec_k=k)
    which = range(4)
    streams, _ = tc._lockstep(jeng, eng, tc._items(jr, js, which),
                              tc._items(pr, ps, which))
    assert eng.spec_stats() == {**eng.spec_stats(),
                                **{n: jeng.spec_stats()[n] for n in
                                   ("accepted", "drafted", "blocks",
                                    "tokens")}}
    assert eng.spec_stats()["blocks"] > 0
    assert pr.walk(tc._trim(streams[0])) is not None
    assert ps.walk(tc._trim(streams[2])) is not None


def test_forbidden_draft_is_rejected(models):
    """A sampled constrained lane whose first draft is forbidden and has
    zero draft probability: its masked target probability underflows to 0,
    so ``u · pd <= pt`` holds (0 <= 0) and only ``tok_ok`` rejects it.
    The verify emits one allowed token and the automaton stays right."""
    _, model = models
    (_, pr), _ = tc._grammars()
    eng = SlotEngine(model, **tc.ENGINE_KW, constrain=tc._ccfgs()[1],
                     spec_draft=1, spec_k=2, device="cpu")
    eng.start_batch([
        (0, tc._prompt(5, 0), 0.8, 3, 12, (), True, None, pr),
        (1, tc._prompt(6, 1), 0.8, 4, 12, (), True, None, None)])
    fns, gp = eng.fns, eng.gpool
    dkv, drafts, dlogits = fns.draft_propose(eng.state, eng.dcache, 2,
                                             sampled=True)
    bad = int(np.nonzero(~pr.allowed[int(eng.state.gstate[0])])[0][-1])
    drafts[0, 0] = bad
    dlogits[0, 0, bad] = torch.finfo(torch.float32).min
    logits = torch.randn(4, 3, CFG["vocab"])
    masked, tok_ok = _trajectory_mask(gp, eng.state, logits, drafts)
    assert not bool(tok_ok[0, 0]) and bool(tok_ok[1:].all())
    on, rem = torch.ones(4, dtype=torch.bool), torch.full((4,), 9)
    free = spec_accept(eng.state, masked, drafts, dlogits, on, rem, True)
    held = spec_accept(eng.state, masked, drafts, dlogits, on, rem, True,
                       tok_ok)
    assert int(free[1][0]) >= 1 and int(held[1][0]) == 0
    assert bool(pr.allowed[int(eng.state.gstate[0]), int(held[0][0])])
    # the same through the program: the forbidden draft is never emitted
    g0 = int(eng.state.gstate[0])
    state, _, dkv, packed = fns.spec_verify(
        eng.state, eng.cache, dkv, drafts, dlogits, on, rem, sampled=True,
        gpool=gp)[:4]
    assert int(packed[0, 1]) == 0 and int(packed[0, 0]) == 1
    tok = int(packed[0, 2])
    assert tok != bad and pr.token_allowed(g0, tok)
    assert int(state.gstate[0]) == pr.advance(g0, tok)




# ---------------------------------------------------------------------------
# the server


def _servers(models, **extra):
    """A JAX and a port server of one configuration (not started)."""
    (jmod, jparams), model = models
    cfg = dict(SERVE_KW, **extra)
    jsrv = JaxServer(jmod, jparams, JaxServeConfig(
        paged=True, attn_kernel="paged", prefill_kernel=True,
        sample_kernel=True, **cfg), install_signal_handler=False)
    return jsrv, InferenceServer(model, ServeConfig(**cfg), device="cpu")


def _serve(srv, asks):
    """Submit ``asks`` (submit keyword dicts) one wave at a time, wait
    for each wave; returns the handles."""
    srv.start()
    try:
        out = []
        for wave in asks:
            hs = [srv.submit(tc._prompt(5 + i, i), **kw)
                  for i, kw in wave]
            for h in hs:
                assert h.wait(120)
            out.extend(hs)
        return out
    finally:
        assert srv.close(60)


#: greedy asks: a regex and a schema lane with logprobs, a free lane with
#: logprobs, a free lane without; then stop lanes (a token the free lane
#: emits; a pair of its tokens, beside a sequence it never emits)
WAVES = [[(0, dict(grammar=tc.REGEX, eos_id=EOS, logprobs=3)),
          (1, dict(json_schema=tc.SCHEMA, eos_id=EOS, logprobs=2)),
          (2, dict(logprobs=1)), (3, dict())],
         [(2, dict(stop=[14])), (2, dict(stop=[[14, 14], [999, 998]]))]]


def test_server_streams_stops_logprobs_equal_jax(models):
    jsrv, srv = _servers(models, **STRUCTURED)
    want, got = _serve(jsrv, WAVES), _serve(srv, WAVES)
    for j, p in zip(want, got):
        assert p.tokens == j.tokens
        assert p.finish_reason == j.finish_reason
        assert len(p.logprobs) == len(j.logprobs)
        for a, b in zip(j.logprobs, p.logprobs):
            assert (a is None) == (b is None)
            if a is not None:
                assert b[0] == a[0]
                np.testing.assert_allclose(b[1], a[1], rtol=1e-5,
                                           atol=1e-5)
    assert got[0].logprobs[0] is None and len(got[0].logprobs[1][0]) == 3
    assert got[3].logprobs == []
    (_, pr), (_, ps) = tc._grammars()
    assert pr.walk(tc._trim(got[0].tokens)) is not None
    assert ps.walk(tc._trim(got[1].tokens)) is not None
    free = got[2].tokens
    assert got[4].finish_reason == got[5].finish_reason == "stop_sequence"
    assert got[4].tokens == free[:free.index(14) + 1]
    assert got[5].tokens == free[:2] == [14, 14]
    st = srv.stats()["constrained"]
    assert st["enabled"] and st["logprobs"] == N_LP and st["pinned"] == 0


def test_stop_pair_straddling_a_block_boundary(models):
    """A lane alone with decode blocks of 4 and max_new 10 takes token 0
    from the prefill, 1-4 and 5-8 from two blocks and 9 from a block of
    one: a stop pair ending at token 5 or 9 straddles a boundary and still
    matches, on the delivered stream, at its first occurrence."""
    _, model = models
    srv = InferenceServer(model, ServeConfig(**SERVE_KW, **STRUCTURED),
                          device="cpu").start()
    try:
        for seed in range(20):
            free = srv.submit(tc._prompt(5, 0), temperature=0.9, seed=seed)
            assert free.wait(60)
            toks = free.tokens
            ends = [i for i in (5, 9) if next(
                j for j in range(1, len(toks))
                if toks[j - 1:j + 1] == toks[i - 1:i + 1]) == i]
            if ends:
                break
        assert ends, "no seed gave a first-occurrence pair at a boundary"
        end = ends[0]
        h = srv.submit(tc._prompt(5, 0), temperature=0.9, seed=seed,
                       stop=[toks[end - 1:end + 1]])
        assert h.wait(60)
    finally:
        assert srv.close(30)
    assert h.finish_reason == "stop_sequence"
    assert h.tokens == toks[:end + 1]


ASKS = [dict(grammar="[unclosed", eos_id=EOS), dict(grammar=tc.REGEX),
        dict(grammar=tc.REGEX, json_schema={}, eos_id=EOS),
        dict(json_schema={"type": "martian"}, eos_id=EOS),
        dict(grammar="[a-z]{3}", eos_id=EOS),  # unspellable at vocab 64
        dict(logprobs=9), dict(logprobs=-1), dict(stop=[[]]),
        dict(stop=[["x"]]), dict(stop=7)]


@pytest.mark.parametrize("structured", [True, False], ids=["on", "off"])
def test_rejection_reasons_equal_jax(models, structured):
    jsrv, srv = _servers(models, **(STRUCTURED if structured else {}))
    asks = ASKS if structured else ASKS + [
        dict(grammar=tc.REGEX, eos_id=EOS), dict(logprobs=1)]
    for kw in asks:
        with pytest.raises(JaxAdmissionError) as want:
            jsrv.submit(tc._prompt(5, 0), **kw)
        with pytest.raises(AdmissionError) as got:
            srv.submit(tc._prompt(5, 0), **kw)
        assert got.value.reason == want.value.reason, kw
    assert srv.scheduler.rejected == len(asks)
    assert srv.close(30) and jsrv.close(30)


def test_finish_reasons_registered():
    for name in ("stop_sequence", "grammar_violation"):
        assert FINISH_REASONS[name] == JAX_FINISH_REASONS[name]


def test_diverged_tables_finish_grammar_violation(models):
    """Tables that never reach the device (the pool stays the identity)
    let the lane sample outside its grammar: the host shadow truncates the
    stream before the first forbidden token."""
    _, model = models
    srv = InferenceServer(model, ServeConfig(**SERVE_KW, **STRUCTURED),
                          device="cpu")
    srv.engine._write_grammar_block = lambda block, tg: None
    srv.start()
    try:
        h = srv.submit(tc._prompt(5, 0), grammar=tc.REGEX, eos_id=EOS)
        free = srv.submit(tc._prompt(5, 0))
        assert h.wait(60) and free.wait(60)
    finally:
        assert srv.close(30)
    (_, pr), _ = tc._grammars()
    assert h.finish_reason == "grammar_violation"
    cut = len(h.tokens)
    assert h.tokens == free.tokens[:cut]
    assert pr.walk(h.tokens) is not None
    assert pr.walk(free.tokens[:cut + 1]) is None


def test_free_sampled_lane_same_beside_constrained_lanes(models):
    _, model = models
    alone = InferenceServer(model, ServeConfig(**SERVE_KW),
                            device="cpu").start()
    try:
        h = alone.submit(tc._prompt(7, 9), temperature=0.9, seed=5)
        assert h.wait(60)
        want = h.tokens
    finally:
        assert alone.close(30)
    srv = InferenceServer(model, ServeConfig(**SERVE_KW, **STRUCTURED),
                          device="cpu").start()
    try:
        hs = [srv.submit(tc._prompt(5, 1), temperature=0.9, seed=1,
                         grammar=tc.REGEX, eos_id=EOS, logprobs=3),
              srv.submit(tc._prompt(7, 9), temperature=0.9, seed=5),
              srv.submit(tc._prompt(4, 2), temperature=0.9, seed=2,
                         json_schema=tc.SCHEMA, eos_id=EOS)]
        for x in hs:
            assert x.wait(60)
    finally:
        assert srv.close(30)
    assert hs[1].tokens == want
    (_, pr), (_, ps) = tc._grammars()
    assert pr.walk(tc._trim(hs[0].tokens)) is not None
    assert ps.walk(tc._trim(hs[2].tokens)) is not None
    assert all(r is None or all(
        pr.token_allowed(s, i) for i, v in zip(*r) if v > -1e30)
        for s, r in zip(_states(pr, hs[0].tokens), hs[0].logprobs))


def test_pool_full_defers_constrained_requests(models):
    """One grammar block and two grammars in one admission: the second
    constrained request waits at the head of the queue (the free one
    beside it is admitted) and is served once the first lane frees the
    block."""
    _, model = models
    srv = InferenceServer(model, ServeConfig(**dict(
        SERVE_KW, **STRUCTURED) | dict(constrain_blocks=1)), device="cpu")
    hs = [srv.submit(tc._prompt(5, 0), grammar=tc.REGEX, eos_id=EOS),
          srv.submit(tc._prompt(6, 1), json_schema=tc.SCHEMA, eos_id=EOS),
          srv.submit(tc._prompt(7, 2))]
    srv.start()
    try:
        for h in hs:
            assert h.wait(60)
    finally:
        assert srv.close(30)
    (_, pr), (_, ps) = tc._grammars()
    assert pr.walk(tc._trim(hs[0].tokens)) is not None
    assert ps.walk(tc._trim(hs[1].tokens)) is not None
    assert hs[1].t_first_token > hs[0].t_done
    assert hs[2].finish_reason == "length"
    st = srv.stats()["constrained"]
    assert st["evictions"] == 1 and st["pinned"] == 0


def _states(tg, toks):
    """The automaton state before each token of ``toks``."""
    out, s = [], 0
    for t in toks:
        out.append(s)
        s = tg.advance(s, t)
    return out
