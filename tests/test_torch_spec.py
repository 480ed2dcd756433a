"""Speculative decoding in the port (tpudist_torch/ops/fused_sample.py's
residual prep, tied_draft, the draft programs of make_slot_decode, the spec
paths of SlotEngine and InferenceServer) against the JAX package on the CPU.

- the residual prep's plain version against the interpreted Pallas kernel
  and its reference: ``pt``/``pd`` to ``rtol 2e-6, atol 1e-7`` (the two sum
  the softmax in different orders), the empty-residual rows bit for bit,
  the residual probabilities ``exp(lr)`` to ``atol 1e-6`` (a log of a
  cancellation is not comparable elementwise);
- Philox substream 0 is pinned to the values it had before substreams
  existed; substreams 1-3 differ from it and from each other;
- the tied draft's logits equal ``tpudist.models.tied_draft``'s to 1e-5,
  through the target's own parameter objects;
- greedy streams of the port's spec engine EQUAL the JAX spec
  ``SlotEngine``'s (paged, kernel knobs on) and the port's non-spec
  engine's, and the acceptance counters equal JAX's, for K in {2, 4, 8},
  on the full adapter stack, and with int8 KV plus the prefix cache;
- the zero-acceptance bound (a loaded draft of other random weights), the
  budget edges, the sampled acceptance by distribution (chi-square), a
  sampled spec lane alone and beside neighbours, a spec-off sampled lane
  against the non-spec engine, and the server's spec knobs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models import create_transformer as jax_create
from tpudist.models import tied_draft as jax_tied_draft
from tpudist.models.lora import make_adapter_factors as jax_factors
from tpudist.ops.fused_sample import fused_residual_prep as jax_residual
from tpudist.ops.fused_sample import \
    fused_residual_reference as jax_residual_reference
from tpudist.serve import SlotEngine as JaxSlotEngine
from torch_cases import settled_torch_cpu
from tpudist_torch.models import (SlotState, TransformerLM,
                                  adapter_factors_from_jax, params_from_flax,
                                  spec_accept, tied_draft)
from tpudist_torch.models.generate import philox_uniform
from tpudist_torch.ops import fused_residual_prep
from tpudist_torch.serve import (InferenceServer, ServeConfig, SlotEngine,
                                 hash_chain)

CFG = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=32)
KERNEL_KNOBS = dict(paged=True, attn_kernel="paged", prefill_kernel=True,
                    sample_kernel=True)
ENGINE_KW = dict(num_slots=2, prefill_pad=8, kv_block=4)
FULL = dict(fused_rope=True, adapters=True, lora_kernel=True)
NAMES = ["ad0", None, "ad1", "ad0"]


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _port_model(jparams, **extra):
    model = TransformerLM(**dict(CFG, **extra))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return model.requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    """(JAX module, JAX params) and the port's model with the same weights:
    test_serve_spec's target (PRNGKey 0, RoPE for the adapter stack)."""
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, rope=True,
                               **CFG)
    return (jmod, jparams), _port_model(jparams, rope=True)


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab"],
                                                size=plen).astype(np.int32)


def _reqs():
    """test_serve_spec's request mix: one spec=False lane, one prompt past
    the prefill chunk."""
    return [(_prompt(3, 0), 4, True), (_prompt(5, 1), 6, False),
            (_prompt(12, 2), 3, True), (_prompt(6, 3), 5, True)]


def _drive(eng, requests, *, temperature=0.0, seed=0, names=None,
           hashes=False):
    """Continuous-batching churn through ``decode_auto`` (the JAX suite's
    harness; works on both engines): FIFO admission, chunked prefill, evict
    on budget, and no block may deliver past a lane's budget."""
    pending = list(enumerate(requests))
    out = {rid: [] for rid, _ in pending}
    slot_rid, slot_budget = {}, {}

    def deliver(slot, toks):
        rid = slot_rid[slot]
        out[rid].extend(toks)
        assert len(out[rid]) <= slot_budget[slot], "block overdrew a budget"
        if len(out[rid]) >= slot_budget[slot]:
            eng.evict(slot)
            del slot_rid[slot], slot_budget[slot]

    while pending or eng.num_occupied:
        free, items = eng.free_slots(), []
        while free and pending:
            rid, (prompt, max_new, spec) = pending.pop(0)
            slot = free.pop(0)
            slot_rid[slot], slot_budget[slot] = rid, max_new
            chain = tuple(hash_chain(prompt, 4)) if hashes else ()
            items.append((slot, prompt, temperature, seed + rid, max_new,
                          chain, spec, None if names is None else
                          names[rid]))
        for slot, tok in eng.start_batch(items).items():
            if tok is not None:
                deliver(slot, [tok])
        for slot, tok in eng.advance_prefill().items():
            deliver(slot, [tok])
        if eng.num_active:
            _, blocks = eng.decode_auto()
            for slot, toks in list(blocks.items()):
                if slot in slot_rid:
                    deliver(slot, toks)
    return out


SPEC_KEYS = ("accepted", "drafted", "blocks", "tokens")


def _stats(eng):
    st = eng.spec_stats()
    return {k: st[k] for k in SPEC_KEYS}


# ---------------------------------------------------------------------------
# kernel 4: the residual prep


@pytest.mark.parametrize("V", [17, 256])
@pytest.mark.parametrize("same", [False, True], ids=["draft", "empty"])
def test_residual_prep_matches_jax(V, same):
    """tests/test_kernel_family.py's case ([3, 4, 17], temps 0 / 0.9 / 1.4)
    and V = 256, with the draft logits and with draft == target (every
    residual empty)."""
    r = np.random.default_rng(4)
    lt = r.normal(size=(3, 4, V)).astype(np.float32)
    ld = lt if same else r.normal(size=(3, 4, V)).astype(np.float32)
    temps = np.asarray([0.0, 0.9, 1.4], np.float32)
    pt, pd, lr = (t.numpy() for t in fused_residual_prep(
        *map(torch.from_numpy, (lt, ld, temps))))
    has_res = (np.maximum(pt - pd, 0) > 0).any(-1)
    args = [jnp.asarray(a) for a in (lt, ld, temps)]
    for jout in (jax_residual(*args, interpret=True),
                 jax_residual_reference(*args)):
        jpt, jpd, jlr = (np.asarray(a) for a in jout)
        np.testing.assert_allclose(pt, jpt, rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(pd, jpd, rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(
            has_res, (np.maximum(jpt - jpd, 0) > 0).any(-1))
        np.testing.assert_array_equal(lr[~has_res], jlr[~has_res])
        np.testing.assert_allclose(np.exp(lr[has_res]),
                                   np.exp(jlr[has_res]), atol=1e-6)
    assert has_res.any() != same
    temp = np.maximum(temps, 1e-6)[:, None, None]
    np.testing.assert_array_equal(
        lr[~has_res], np.broadcast_to(lt / temp, lt.shape)[~has_res])


# ---------------------------------------------------------------------------
# Philox substreams

#: philox_uniform(seeds, counts, 6) before the substream argument existed
PHILOX_GOLDEN = [
    [0.3990464508533478, 0.880520224571228, 0.7357127666473389,
     0.6054818630218506, 0.9722411632537842, 0.3620910942554474],
    [0.542467474937439, 0.00299111008644104, 0.9012755155563354,
     0.3032914102077484, 0.9754353761672974, 0.3574558198451996],
    [0.6052075624465942, 0.8280465602874756, 0.24382051825523376,
     0.6881625652313232, 0.2222742736339569, 0.5881133079528809],
    [0.4136255085468292, 0.3133554756641388, 0.576592206954956,
     0.07799646258354187, 0.21606764197349548, 0.6415328979492188]]


def test_philox_stream_zero_unchanged_and_substreams_differ():
    seeds = torch.tensor([0, 7, 123456789012, -5])
    counts = torch.tensor([0, 3, 1 << 33, 17])
    s0 = philox_uniform(seeds, counts, 6)
    np.testing.assert_array_equal(s0.numpy(),
                                  np.asarray(PHILOX_GOLDEN, np.float32))
    assert torch.equal(philox_uniform(seeds, counts, 6, stream=0), s0)
    subs = [s0] + [philox_uniform(seeds, counts, 6, stream=j)
                   for j in (1, 2, 3)]
    for i in range(4):
        for j in range(i):
            assert not bool((subs[i] == subs[j]).any()), (i, j)


# ---------------------------------------------------------------------------
# the tied draft


def test_tied_draft_matches_jax_and_shares_parameters(models):
    (jmod, jparams), model = models
    draft = tied_draft(model, 1)
    dmod, dparams = jax_tied_draft(jmod, jparams, 1)
    toks = np.random.default_rng(2).integers(0, 16, size=(2, 9))
    ref = np.asarray(dmod.apply(dparams, jnp.asarray(toks, jnp.int32)))
    np.testing.assert_allclose(draft(torch.from_numpy(toks)).numpy(), ref,
                               atol=1e-5, rtol=1e-5)
    target = {id(p) for p in model.parameters()}
    assert all(id(p) in target for p in draft.parameters())
    assert draft.blocks[0] is model.blocks[0] and len(draft.blocks) == 1
    storage = {p.untyped_storage().data_ptr() for p in model.parameters()}
    assert {p.untyped_storage().data_ptr()
            for p in draft.parameters()} <= storage
    with pytest.raises(ValueError):
        tied_draft(model, 3)


# ---------------------------------------------------------------------------
# greedy engines against JAX


def _jax_engine(models, k, **kw):
    (jmod, jparams), _ = models
    return JaxSlotEngine(jmod, jparams, spec_draft=1, spec_k=k,
                         **KERNEL_KNOBS, **ENGINE_KW, **kw)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_greedy_streams_and_acceptance_equal_jax(models, k):
    _, model = models
    jeng = _jax_engine(models, k)
    want = _drive(jeng, _reqs())
    eng = SlotEngine(model, spec_draft=1, spec_k=k, **ENGINE_KW,
                     device="cpu")
    out = _drive(eng, _reqs())
    assert out == want
    assert out == _drive(SlotEngine(model, **ENGINE_KW, device="cpu"),
                         _reqs())
    assert _stats(eng) == _stats(jeng)
    st = eng.spec_stats()
    assert st["blocks"] > 0 and st["tokens"] > st["blocks"]
    assert eng.alloc.free_blocks == eng.alloc.num_blocks
    assert st["draft_pool_bytes"] * 2 == eng.fns.paged.pool_bytes


def _factors(jmod, i):
    f = jax_factors(jax.random.PRNGKey(100 + i), jmod, 8)
    return {k: np.asarray(v) for k, v in f.items()}


def test_full_stack_streams_and_acceptance_equal_jax(models):
    """Spec on the adapter stack: the tied draft shares each lane's adapter
    (the pool's first layer slices), so acceptance — engine-wide and per
    adapter — equals JAX's, and every stream does."""
    (jmod, _), model = models
    jeng = _jax_engine(models, 4, **FULL)
    eng = SlotEngine(model, spec_draft=1, spec_k=4, **FULL, **ENGINE_KW,
                     device="cpu")
    for i, name in enumerate(sorted({n for n in NAMES if n})):
        jeng.load_adapter(name, _factors(jmod, i))
        eng.load_adapter(name, adapter_factors_from_jax(_factors(jmod, i)))
    want = _drive(jeng, _reqs(), names=NAMES)
    assert _drive(eng, _reqs(), names=NAMES) == want
    assert _stats(eng) == _stats(jeng)
    assert eng.spec_stats()["by_adapter"] == jeng.spec_stats()["by_adapter"]
    assert eng.adapter_stats()["slots_bound"] == 0


def _prefix_reqs():
    base = _prompt(13, 9)
    return [(base, 3, True),
            (np.concatenate([base[:12], _prompt(3, 10)]), 4, True),
            (np.concatenate([base[:8], _prompt(5, 11)]), 5, False),
            (np.concatenate([base[:12], _prompt(2, 12)]), 6, True)]


def test_int8_and_prefix_cache_streams_equal_jax(models):
    """int8 KV (rollback garbage inside quantized blocks) and the prefix
    cache (draft blocks under shared prefix blocks) under speculation."""
    _, model = models
    kw = dict(kv_int8=True, prefix_cache_blocks=8)
    jeng = _jax_engine(models, 4, **kw)
    want = _drive(jeng, _prefix_reqs(), hashes=True)
    eng = SlotEngine(model, spec_draft=1, spec_k=4, **kw, **ENGINE_KW,
                     device="cpu")
    assert _drive(eng, _prefix_reqs(), hashes=True) == want
    assert _stats(eng) == _stats(jeng)
    assert eng.alloc.prefix_hit_blocks == jeng.alloc.prefix_hit_blocks > 0


# ---------------------------------------------------------------------------
# bounds


def test_zero_acceptance_draft_is_bounded(models):
    """An adversarial loaded draft (other random weights) still emits >= 1
    token a pass, never overdraws a budget (the harness asserts it) and
    stays equal to the oracle, the non-speculative engine."""
    _, model = models
    _, wrong = jax_create(jax.random.PRNGKey(99), seq_len=16, rope=True,
                          **CFG)
    eng = SlotEngine(model, spec_draft=_port_model(wrong, rope=True),
                     spec_k=4, **ENGINE_KW, device="cpu")
    out = _drive(eng, _reqs())
    assert out == _drive(SlotEngine(model, **ENGINE_KW, device="cpu"),
                         _reqs())
    st = eng.spec_stats()
    assert st["blocks"] > 0 and st["tokens"] >= st["blocks"]
    assert st["acceptance_rate"] < 0.5
    assert sum(map(len, out.values())) == sum(m for _, m, _ in _reqs())


def test_budget_edges(models):
    """max_new 1 finishes at insert; max_new 2 exercises the in-graph
    clamp beside a long-budget neighbour."""
    _, model = models
    reqs = [(_prompt(3, 40), 1, True), (_prompt(4, 41), 2, True),
            (_prompt(5, 42), 12, True)]
    eng = SlotEngine(model, spec_draft=1, spec_k=8, **ENGINE_KW,
                     device="cpu")
    assert _drive(eng, reqs) == _drive(
        SlotEngine(model, **ENGINE_KW, device="cpu"), reqs)


def test_unported_spec_pieces_raise(models):
    """Both pieces once unported are ported: ``swap_draft`` (the
    distillation hot-swap) checks the candidate's geometry and swaps a
    same-geometry one, leaving the target's weights as they were;
    ``draft_arm`` (with the lane transfer) maps an imported lane's row and
    cold-starts its draft cursor at ``pos``."""
    _, model = models
    eng = SlotEngine(model, spec_draft=1, **ENGINE_KW, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        eng.swap_draft({})
    target = {k: v.clone() for k, v in model.state_dict().items()}
    cand = {k: v * 0.5 for k, v in eng.draft_model.state_dict().items()}
    info = eng.swap_draft(cand)
    assert info["swapped"] and info["draft_swaps"] == 1
    assert info["lanes_rearmed"] == 0  # no lane was occupied
    assert all(torch.equal(v, target[k])
               for k, v in model.state_dict().items())
    assert all(torch.equal(v, cand[k])
               for k, v in eng.draft_model.state_dict().items())
    M = eng.max_len // eng.paged_cfg.block_size
    row = torch.full((M,), eng.paged_cfg.num_blocks, dtype=torch.int32)
    row[:2] = torch.tensor([3, 5])
    dkv = eng.fns.draft_arm(eng.dcache, 1, row, 7)
    assert torch.equal(dkv.table[1], row) and int(dkv.cursor[1]) == 7
    assert int(dkv.cursor[0]) == 0
    with pytest.raises(ValueError, match="vocab"):
        SlotEngine(model, spec_draft=TransformerLM(**dict(CFG, vocab=8)),
                   **ENGINE_KW, device="cpu")


def test_verify_runs_with_grammar_and_logprobs(models):
    """The verify takes the grammar pool and returns logprobs (it raised
    before the port had structured output): a constrained greedy lane's
    emitted tokens walk its automaton, ``gstate`` ends where the host
    shadow does, and every emitted token has a top-n row."""
    from tpudist_torch.constrain import (ConstrainConfig, compile_grammar,
                                         default_vocab)

    _, model = models
    vocab = default_vocab(CFG["vocab"], 1)
    tg = compile_grammar(regex="[!-#]{2,6}", vocab=vocab, eos_id=1,
                         max_states=16)
    eng = SlotEngine(model, spec_draft=1, spec_k=4, **ENGINE_KW,
                     constrain=ConstrainConfig(vocab, 2, 16), logprobs=2,
                     device="cpu")
    first = eng.start_batch([(0, _prompt(5, 0), 0.0, 0, 9, (), True, None,
                              tg)])
    toks, rows = [first[0]], 0
    while eng.num_active and eng.counts[0] < eng.budget[0]:
        info, out = eng.spec_decode_block()
        toks.extend(out.get(0, []))
        rows += len(info["logprobs"].get(0, []))
        for ids, vals in info["logprobs"].get(0, []):
            assert len(ids) == 2 and vals[0] >= vals[1]
    assert rows == len(toks) - 1 and eng.n_spec_blocks > 0
    end = tg.walk(toks)
    assert end is not None and int(eng.state.gstate[0]) == end


# ---------------------------------------------------------------------------
# sampled lanes


def test_sampled_acceptance_matches_target_distribution():
    """One k = 1 acceptance step over 20000 lanes (one seed each) with
    drafts drawn from the draft distribution: the first emitted token —
    the accepted draft or the residual draw — follows softmax(lt / temp).
    Chi-square over the 8 tokens (7 degrees of freedom) must stay below
    24.32, the 0.999 quantile: a fixed-seed test that a sound step passes
    with probability 0.999; a draft accepted without the ``u`` test or a
    correction drawn from the target instead of the residual lands far
    above (both give ``pd``-weighted mass)."""
    from scipy.stats import chi2

    S, V, temp = 20000, 8, 0.9
    r = np.random.default_rng(17)
    lt = r.normal(size=V).astype(np.float32) * 1.5
    ld = r.normal(size=V).astype(np.float32) * 1.5

    def softmax(x):
        e = np.exp(x.astype(np.float64) / temp - (x / temp).max())
        return e / e.sum()

    pt, pd = softmax(lt), softmax(ld)
    drafts = r.choice(V, size=S, p=pd)
    z = torch.zeros(S, dtype=torch.int32)
    state = SlotState(last_tok=z.clone(),
                      active=torch.ones(S, dtype=torch.bool), pos=z.clone(),
                      counts=torch.from_numpy(r.integers(0, 50, size=S)
                                              .astype(np.int32)),
                      temps=torch.full((S,), temp),
                      seeds=torch.arange(S, dtype=torch.int64) * 7919,
                      adapter_id=z.clone(), gidx=z.clone(), gstate=z.clone())
    logits = torch.from_numpy(np.broadcast_to(lt, (S, 2, V)).copy())
    dlogits = torch.from_numpy(np.broadcast_to(ld, (1, S, V)).copy())
    x, a_raw, inc, out = spec_accept(
        state, logits, torch.from_numpy(drafts[None].astype(np.int32)),
        dlogits, torch.ones(S, dtype=torch.bool),
        torch.full((S,), 5, dtype=torch.int32), sampled=True)
    first = out[:, 0].numpy()
    hist = np.bincount(first, minlength=V)
    stat = float(((hist - S * pt) ** 2 / (S * pt)).sum())
    assert stat < chi2.ppf(0.999, V - 1) and abs(chi2.ppf(0.999, 7)
                                                 - 24.32) < 0.01, stat
    # both branches ran: some drafts accepted, some rejected
    assert 0 < int(a_raw.sum()) < S
    assert bool((inc == a_raw + 1).all())


def test_sampled_spec_lane_same_alone_and_beside_neighbours(models):
    """A sampled spec lane draws every token on per-request substreams at
    its own counts: alone and beside shorter-budget neighbours (so K, set
    by the largest remaining budget, is the same) its stream is the same."""
    _, model = models
    target = (_prompt(10, 21), 12, True)
    alone = SlotEngine(model, spec_draft=1, spec_k=4, num_slots=1,
                       prefill_pad=8, kv_block=4, device="cpu")
    a = _drive(alone, [target], temperature=0.9, seed=100)[0]
    crowd = SlotEngine(model, spec_draft=1, spec_k=4, num_slots=3,
                       prefill_pad=8, kv_block=4, device="cpu")
    reqs = [(_prompt(4, 22), 5, True), target, (_prompt(3, 23), 4, False)]
    b = _drive(crowd, reqs, temperature=0.9, seed=99)[1]
    assert a == b
    assert len(set(a)) > 1
    assert alone.spec_stats()["blocks"] > 0


def test_spec_off_sampled_lane_equals_nonspec_engine(models):
    """A spec=False lane rides the spec programs with acceptance forced to
    zero and draws on substream 0 at its count: byte for byte the
    non-speculative engine's stream, while its neighbours speculate."""
    _, model = models
    spec = _drive(SlotEngine(model, spec_draft=1, spec_k=4, **ENGINE_KW,
                             device="cpu"), _reqs(), temperature=1.3, seed=5)
    plain = _drive(SlotEngine(model, **ENGINE_KW, device="cpu"), _reqs(),
                   temperature=1.3, seed=5)
    assert spec[1] == plain[1]  # request 1 opts out (see _reqs)


# ---------------------------------------------------------------------------
# the server


def test_serve_config_spec_knobs(monkeypatch, models):
    _, model = models
    assert ServeConfig().resolve_spec_draft(model) is None
    assert ServeConfig(spec=True).resolve_spec_draft(model) == 1
    assert ServeConfig(spec=True, spec_draft_layers=2).resolve_spec_draft(
        model) == 2
    monkeypatch.setenv("TPUDIST_SERVE_SPEC", "1")
    monkeypatch.setenv("TPUDIST_SERVE_SPEC_K", "2")
    monkeypatch.setenv("TPUDIST_SERVE_SPEC_DRAFT_LAYERS", "1")
    cfg = ServeConfig.from_env()
    assert (cfg.spec, cfg.spec_k, cfg.spec_draft_layers) == (True, 2, 1)


def test_server_mixed_spec_traffic_on_cpu(models):
    """Spec on and off, greedy and sampled, through the server: every
    request finishes ``length``, greedy streams equal the non-spec
    engine's, and ``stats()["spec"]`` carries the counters."""
    _, model = models
    reqs = _reqs()
    plain = _drive(SlotEngine(model, **ENGINE_KW, device="cpu"), reqs)
    server = InferenceServer(
        model, ServeConfig(spec=True, spec_k=4, **ENGINE_KW),
        device="cpu").start()
    try:
        hs = [server.submit(p, max_new=n, spec=s) for p, n, s in reqs]
        hs += [server.submit(p, max_new=n, spec=s, temperature=0.8,
                             seed=3) for p, n, s in reqs]
        for h in hs:
            assert h.wait(60)
        st = server.stats()
    finally:
        assert server.close(30)
    assert [h.finish_reason for h in hs] == ["length"] * len(hs)
    assert [h.tokens for h in hs[:len(reqs)]] == [plain[i]
                                                  for i in range(len(reqs))]
    spec = st["spec"]
    assert spec["enabled"] and spec["blocks"] > 0 and spec["drafted"] > 0
    for key in ("lane_passes", "accepted", "rollbacks", "accepted_per_pass",
                "acceptance_rate", "draft_s", "verify_s", "sync_s",
                "spec_k", "draft_pool_bytes"):
        assert key in spec
    assert st["decode"]["draft_forwards"] > 0
