"""Structured output in the port (tpudist_torch/constrain, the grammar and
logprobs seams of tpudist_torch/models/generate.py and
tpudist_torch/serve/engine.py) against the JAX package on the CPU.

- the copy pinned equal: over the regexes and schemas of
  ``tests/test_constrain.py``, the port's ``compile_grammar`` gives the
  same allow / next / accept tables (``np.array_equal``), the same
  ``grammar_source_key`` and key, the same character DFA, and the same
  error class and message on every malformed ask; the registry walks the
  same bind / release / evict sequence;
- engines on a mixed constrained and free batch (regex, JSON schema and
  free lanes, greedy; a prompt past the prefill chunk): the port's
  ``SlotEngine(constrain=, logprobs=3)`` gives the JAX engine's streams,
  ``gidx`` / ``gstate`` after every block, and logprobs ids, with values
  within ``rtol 1e-5, atol 1e-5`` (f32), including an automaton state
  where only EOS is allowed; the registry's refcounts follow the slots
  (``tests/test_torch_logprobs.py`` holds the speculative verify and the
  server);
- sampled constrained lanes stay in their language, and a free sampled
  lane is the same alone and beside constrained neighbours.
"""

import jax
import numpy as np
import pytest
import torch

import test_constrain as jax_suite
from tpudist.constrain import ConstrainConfig as JaxConstrainConfig
from tpudist.constrain import GrammarRegistry as JaxRegistry
from tpudist.constrain import compile_grammar as jax_compile
from tpudist.constrain import compile_regex_dfa as jax_dfa
from tpudist.constrain import grammar_source_key as jax_source_key
from tpudist.models import create_transformer as jax_create
from tpudist.serve import SlotEngine as JaxSlotEngine
from torch_cases import settled_torch_cpu
from tpudist_torch.constrain import (ConstrainConfig, GrammarPoolFull,
                                     GrammarRegistry, compile_grammar,
                                     compile_regex_dfa, default_vocab,
                                     grammar_source_key)
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.serve import SlotEngine

#: vocab 64: ids 1..63 spell ALPHABET[1..63] — digits, ``-``, ``[``,
#: ``]``, ``,``, upper-case letters — so integer arrays and letter/digit
#: regexes are spellable; id 1 is EOS
CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=32,
           rope=True)
EOS = 1
VOCAB = default_vocab(CFG["vocab"], EOS)
KERNEL_KNOBS = dict(paged=True, attn_kernel="paged", prefill_kernel=True,
                    sample_kernel=True)
ENGINE_KW = dict(num_slots=4, prefill_pad=8, kv_block=4, decode_block=4)
N_LP = 3
#: at most 4 letters then EOS is the only allowed token: a greedy lane
#: reaches that state within its budget
REGEX = "[A-F]{2,4}"
SCHEMA = {"type": "array", "items": {"type": "integer"}}
#: the vocabulary the copy is pinned on: every ALPHABET character spellable
WIDE = default_vocab(128, EOS)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _models():
    """(JAX module, JAX params) and the port's model with the same
    weights."""
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, **CFG)
    model = TransformerLM(**CFG)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return (jmod, jparams), model.requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    return _models()


def _grammars(regex=REGEX, schema=SCHEMA):
    """(JAX, port) TokenGrammar pairs of the regex and the schema."""
    kw = dict(eos_id=EOS, max_states=32)
    return ((jax_compile(regex=regex, vocab=VOCAB, **kw),
             compile_grammar(regex=regex, vocab=VOCAB, **kw)),
            (jax_compile(json_schema=schema, vocab=VOCAB, **kw),
             compile_grammar(json_schema=schema, vocab=VOCAB, **kw)))


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(
        2, CFG["vocab"], size=plen).astype(np.int32)


def _trim(toks):
    return toks[:toks.index(EOS)] if EOS in toks else toks


# ---------------------------------------------------------------------------
# (a) the copy pinned equal

REGEXES = [c[0] for c in jax_suite.TestRegexOracle.CASES] + [
    jax_suite.PAT, REGEX, "[a-f]{3,8}-[0-9]{2}", "\\d+(\\.\\d+)?"]
SCHEMAS = [c[0] for c in jax_suite.TestSchemaLowering.CASES] + [
    SCHEMA, {"type": "object",
             "properties": {"n": {"type": "integer"},
                            "ok": {"type": "boolean"}},
             "required": ["n", "ok"]}]


def _assert_same_grammar(a, b):
    assert b.key == a.key and b.source == a.source
    assert b.n_states == a.n_states and b.eos_id == a.eos_id
    for name in ("allowed", "next_state", "accept"):
        x, y = getattr(a, name), getattr(b, name)
        assert y.dtype == x.dtype and np.array_equal(y, x), name


@pytest.mark.parametrize("regex", REGEXES, ids=REGEXES)
def test_regex_tables_equal_jax(regex):
    kw = dict(vocab=WIDE, eos_id=EOS, max_states=64)
    _assert_same_grammar(jax_compile(regex=regex, **kw),
                         compile_grammar(regex=regex, **kw))
    a, b = jax_dfa(regex), compile_regex_dfa(regex)
    assert (b.n_states, b.accepts) == (a.n_states, a.accepts)
    assert b.trans == a.trans
    assert grammar_source_key({"kind": "regex", "src": regex}) \
        == jax_source_key({"kind": "regex", "src": regex})


@pytest.mark.parametrize("schema", SCHEMAS,
                         ids=[str(i) for i in range(len(SCHEMAS))])
def test_schema_tables_equal_jax(schema):
    kw = dict(vocab=WIDE, eos_id=EOS, max_states=64)
    _assert_same_grammar(jax_compile(json_schema=schema, **kw),
                         compile_grammar(json_schema=schema, **kw))


def _outcome(fn, **kw):
    try:
        fn(**kw)
    except Exception as e:  # noqa: BLE001 - the class name is the check
        return type(e).__name__, str(e)
    return None


MALFORMED = [dict(regex=bad) for bad in ("[unclosed", "a{3,1}", "(",
                                         "a{99}")] + [
    dict(regex="\\q", vocab=default_vocab(16, EOS)),
    dict(regex="[abc]{40,50}", max_states=4),
    dict(json_schema={"type": "boolean"}, vocab=default_vocab(16, EOS)),
    dict(regex="a", json_schema={"const": 1}), dict(),
    dict(json_schema={"type": "martian"}), dict(json_schema={"allOf": []}),
    dict(regex="a", eos_id=999)]


@pytest.mark.parametrize("ask", MALFORMED,
                         ids=[str(i) for i in range(len(MALFORMED))])
def test_malformed_asks_fail_alike(ask):
    kw = dict(dict(vocab=WIDE, eos_id=EOS), **ask)
    want = _outcome(jax_compile, **kw)
    assert want is not None and want[0] == "GrammarError"
    assert _outcome(compile_grammar, **kw) == want


def test_registry_walks_like_jax():
    """The same bind / release sequence gives the same blocks, fresh
    flags, GrammarPoolFull and stats."""
    def run(reg_cls, compile_fn):
        reg, log = reg_cls(2), []
        gs = [compile_fn(regex="[A-C]{1,%d}" % (2 + i), vocab=VOCAB,
                         eos_id=EOS, max_states=16) for i in range(3)]
        for op, i in [("bind", 0), ("bind", 1), ("bind", 0), ("bind", 2),
                      ("release", 1), ("bind", 2), ("release", 0),
                      ("release", 0), ("bind", 1)]:
            try:
                log.append((op, reg.bind(gs[i]) if op == "bind"
                            else reg.release({0: 0, 1: 1, 2: 1}[i])))
            except Exception as e:  # noqa: BLE001
                log.append((op, type(e).__name__))
        return log, reg.stats()

    want = run(JaxRegistry, jax_compile)
    assert run(GrammarRegistry, compile_grammar) == want
    assert ("bind", "GrammarPoolFull") in want[0]


# ---------------------------------------------------------------------------
# (b) engines on a mixed constrained and free batch


def _ccfgs(blocks=2):
    return (JaxConstrainConfig(vocab=VOCAB, num_blocks=blocks,
                               max_states=32),
            ConstrainConfig(vocab=VOCAB, num_blocks=blocks, max_states=32))


def _engines(models, **kw):
    (jmod, jparams), model = models
    jc, pc = _ccfgs()
    jeng = JaxSlotEngine(jmod, jparams, **KERNEL_KNOBS, **ENGINE_KW,
                         constrain=jc, logprobs=N_LP, **kw)
    eng = SlotEngine(model, **ENGINE_KW, constrain=pc, logprobs=N_LP,
                     device="cpu", **kw)
    return jeng, eng


def _items(gr, gs, which):
    """Admission items for both engines: (slot, prompt, temp, seed,
    max_new, hashes, spec, adapter, grammar); ``gr`` / ``gs`` the regex and
    schema grammars of one package."""
    g = {"regex": gr, "schema": gs, None: None}
    plans = [("regex", 5, 12), (None, 12, 10), ("schema", 3, 14),
             ("regex", 9, 10)]
    return [(slot, _prompt(plen, slot), 0.0, slot, max_new, (), True, None,
             g[kind]) for slot, (kind, plen, max_new) in enumerate(plans)
            if slot in which]


def _state(eng, name):
    return np.asarray(getattr(eng.state, name))


def _lockstep(jeng, eng, jitems, items):
    """Admit the same batch on both engines and decode them block for block
    (``decode_auto``): firsts, every block's tokens, ``gidx`` / ``gstate``
    after every program and the logprobs rows must agree; lanes evict on
    budget.  Returns the port's streams and the EOS-only rows seen."""
    streams = {}
    assert eng.start_batch(items) == (first := jeng.start_batch(jitems))
    for s, t in first.items():
        streams[s] = [] if t is None else [t]
    while eng.prefilling_slots() or jeng.prefilling_slots():
        done = eng.advance_prefill()
        assert done == jeng.advance_prefill()
        for s, t in done.items():
            streams[s].append(t)
    eos_only = 0
    while eng.num_active:
        for name in ("gidx", "gstate"):
            np.testing.assert_array_equal(_state(eng, name),
                                          _state(jeng, name), name)
        pinfo, pout = eng.decode_auto()
        jinfo, jout = jeng.decode_auto()
        assert pout == jout
        assert set(pinfo["logprobs"]) == set(jinfo["logprobs"])
        for s, rows in jinfo["logprobs"].items():
            for (jid, jv), (pid, pv) in zip(rows, pinfo["logprobs"][s]):
                assert pid == jid
                np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-5)
                eos_only += jid[0] == EOS and jv[1] < -1e30
        for s, toks in pout.items():
            streams[s].extend(toks)
            if eng.counts[s] >= eng.budget[s]:
                eng.evict(s)
                jeng.evict(s)
    for name in ("gidx", "gstate"):
        np.testing.assert_array_equal(_state(eng, name), _state(jeng, name))
    return streams, eos_only


def test_engine_streams_states_logprobs_equal_jax(models):
    (jr, pr), (js, ps) = _grammars()
    jeng, eng = _engines(models)
    which = range(4)
    streams, eos_only = _lockstep(jeng, eng, _items(jr, js, which),
                                  _items(pr, ps, which))
    assert eos_only > 0  # a state where EOS alone is allowed was read
    assert pr.walk(_trim(streams[0])) is not None
    assert pr.walk(_trim(streams[3])) is not None
    assert ps.walk(_trim(streams[2])) is not None
    assert len(set(streams[1])) > 1
    st = eng.constrain_stats()
    assert st["pinned"] == 0 and st["binds"] == jeng.constrain_stats()[
        "binds"] == 3
    assert eng.state.gidx.tolist() == [2] * 4


def test_registry_refcounts_follow_slots(models):
    (_, pr), (_, ps) = _grammars()
    _, model = models
    eng = SlotEngine(model, **ENGINE_KW, constrain=_ccfgs()[1],
                     device="cpu")
    eng.start_batch(_items(pr, ps, [0, 3]))
    st = eng.constrain_stats()
    assert (st["pinned"], st["slots_bound"], st["resident"]) == (1, 2, 1)
    assert eng.state.gidx.tolist()[1:3] == [2, 2]  # free slots: sentinel
    eng.evict(0)
    assert eng.constrain_stats()["pinned"] == 1
    eng.start_batch(_items(pr, ps, [2]))
    assert eng.constrain_stats()["pinned"] == 2
    with pytest.raises(GrammarPoolFull):  # both blocks pinned
        eng._acquire_grammar(1, compile_grammar(
            regex="[G-K]{2}", vocab=VOCAB, eos_id=EOS, max_states=32))
    for s in (2, 3):
        eng.evict(s)
    st = eng.constrain_stats()
    assert (st["pinned"], st["slots_bound"]) == (0, 0)
    assert eng.state.gidx.tolist() == [2] * 4
    assert eng.state.gstate.tolist() == [0] * 4


def test_constrained_item_needs_constrain_engine(models):
    _, model = models
    eng = SlotEngine(model, **ENGINE_KW, device="cpu")
    (_, pr), _ = _grammars()
    with pytest.raises(ValueError, match="TPUDIST_SERVE_CONSTRAIN"):
        eng.start_batch([(0, _prompt(4, 0), 0.0, 0, 4, (), True, None,
                          pr)])
    with pytest.raises(ValueError, match="logprobs"):
        SlotEngine(model, **ENGINE_KW, logprobs=65, device="cpu")


def test_sampled_lanes_in_language_and_free_lane_unmoved(models):
    """Sampled constrained lanes (regex and schema, plain and spec engines)
    stay in their language; a free sampled lane's stream is the same alone
    on an engine without constrain and beside constrained neighbours."""
    _, model = models
    (_, pr), (_, ps) = _grammars()
    free_item = (1, _prompt(7, 9), 0.9, 11, 12, (), True, None, None)

    def run(eng, items):
        toks = {s: [t] for s, t in eng.start_batch(items).items()}
        while eng.num_active:
            _, out = eng.decode_auto()
            for s, ts in out.items():
                toks[s].extend(ts)
                if eng.counts[s] >= eng.budget[s]:
                    eng.evict(s)
        return toks

    alone = run(SlotEngine(model, **ENGINE_KW, device="cpu"),
                [free_item[:5]])[1]
    for spec in ({}, dict(spec_draft=1, spec_k=2)):
        eng = SlotEngine(model, **ENGINE_KW, constrain=_ccfgs()[1],
                         logprobs=N_LP, device="cpu", **spec)
        items = [(0, _prompt(5, 2), 0.9, 5, 12, (), True, None, pr),
                 free_item,
                 (2, _prompt(4, 3), 0.9, 6, 14, (), True, None, ps),
                 (3, _prompt(6, 4), 0.9, 7, 12, (), True, None, pr)]
        toks = run(eng, items)
        for s, g in ((0, pr), (2, ps), (3, pr)):
            assert g.walk(_trim(toks[s])) is not None, (spec, s, toks[s])
        if not spec:
            assert toks[1] == alone
