"""The seams on the port's dense and gather arms against the JAX package on
the CPU: speculative decoding (the dense twin of the draft programs and the
gather verify), per-tenant adapters (pre-gathered factors), and structured
output with logprobs.

- speculative engines (the tied 1-layer draft, ``spec_k`` 2): greedy
  streams and the accepted / drafted counters EQUAL the JAX spec
  ``SlotEngine``'s under churn with chunked prompts, on the dense cache
  and on the gather arm over an int8 pool, both sampling tails;
- adapter engines (factors made by the JAX package, carried across by
  ``adapter_factors_from_jax``, scaled 20-fold so that they move greedy
  tokens; base lanes beside adapter lanes): greedy streams EQUAL the JAX
  engine's on the dense and the gather arm;
- constrained engines (a regex, a JSON schema and a free lane, top-3
  logprobs): first tokens and every decode block's tokens equal, ``gidx``
  / ``gstate`` equal after every program, logprobs rows to ``rtol 1e-5,
  atol 1e-5`` (two f32 log-softmaxes of the same logits up to rounding),
  block for block against the JAX engine on both arms.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_constrain import (CFG as GCFG, ENGINE_KW as GKW,
                                  N_LP, _ccfgs, _grammars, _items,
                                  _lockstep, _trim)
from test_torch_dense import ARMS, ENGINE_KW, _models, _reqs, drive
from tpudist.models import create_transformer as jax_create
from tpudist.models.lora import make_adapter_factors as jax_factors
from tpudist.serve import SlotEngine as JaxSlotEngine
from torch_cases import settled_torch_cpu
from tpudist_torch.models import (TransformerLM, adapter_factors_from_jax,
                                  params_from_flax)
from tpudist_torch.serve import SlotEngine


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(scope="module")
def models():
    memo = {}

    def get(pos):
        if pos not in memo:
            memo[pos] = _models(rope=pos == "rope")
        return memo[pos]

    return get


SPEC = dict(spec_draft=1, spec_k=2)


@pytest.mark.parametrize("arm,pos", [("dense", "rope"),
                                     ("gather-int8", "learned")])
def test_spec_streams_and_counters_match_jax(models, arm, pos):
    (jmod, jparams), model = models(pos)
    jeng = JaxSlotEngine(jmod, jparams, **ENGINE_KW, **ARMS[arm], **SPEC)
    want = drive(jeng, _reqs())
    jspec = jeng.spec_stats()
    assert jspec["blocks"] > 0
    for sample_kernel in (False, True):
        eng = SlotEngine(model, **ENGINE_KW, **ARMS[arm], **SPEC,
                         sample_kernel=sample_kernel, device="cpu")
        assert drive(eng, _reqs()) == want, sample_kernel
        spec = eng.spec_stats()
        for key in ("blocks", "accepted", "drafted", "tokens"):
            assert spec[key] == jspec[key], key
        assert spec["draft_pool_bytes"] > 0


NAMES = ["ad0", None, "ad1", "ad0", None]


def _drive_named(eng, names):
    """:func:`drive` with each request's adapter name in its item."""
    reqs = _reqs()
    pending = list(enumerate(reqs))
    out = {rid: [] for rid, _ in pending}
    slot_rid, slot_budget = {}, {}

    def deliver(slot, toks):
        rid = slot_rid[slot]
        out[rid].extend(toks)
        if len(out[rid]) >= slot_budget[slot]:
            out[rid] = out[rid][:slot_budget[slot]]
            eng.evict(slot)
            del slot_rid[slot], slot_budget[slot]

    while pending or eng.num_occupied:
        free, items = eng.free_slots(), []
        while free and pending:
            rid, (prompt, max_new) = pending.pop(0)
            slot = free.pop(0)
            slot_rid[slot], slot_budget[slot] = rid, max_new
            items.append((slot, prompt, 0.0, 0, max_new, (), None,
                          names[rid]))
        for slot, tok in eng.start_batch(items).items():
            if tok is not None:
                deliver(slot, [tok])
        for slot, tok in eng.advance_prefill().items():
            deliver(slot, [tok])
        if eng.num_active:
            for slot, toks in list(eng.decode_auto()[1].items()):
                if slot in slot_rid:
                    deliver(slot, toks)
    return out


@pytest.mark.parametrize("arm,pos", [("dense", "learned"),
                                     ("gather", "rope")])
def test_adapter_streams_match_jax(models, arm, pos):
    (jmod, jparams), model = models(pos)
    kw = dict(ENGINE_KW, **ARMS[arm], adapters=True, adapter_blocks=3,
              adapter_rank=4)
    # scaled so that an adapter moves a greedy token of the toy model
    factors = {f"ad{i}": {k: 20 * np.asarray(v) for k, v in jax_factors(
        jax.random.PRNGKey(100 + i), jmod, 4).items()} for i in range(2)}
    jeng = JaxSlotEngine(jmod, jparams, **kw)
    eng = SlotEngine(model, **kw, device="cpu")
    for name, f in factors.items():
        jeng.load_adapter(name, f)
        eng.load_adapter(name, adapter_factors_from_jax(f))
    want = _drive_named(jeng, NAMES)
    assert _drive_named(eng, NAMES) == want
    # the adapters act: the same traffic base-only differs on a named lane
    base = _drive_named(eng, [None] * len(NAMES))
    assert any(base[i] != want[i] for i, n in enumerate(NAMES) if n)


@pytest.fixture(scope="module")
def gmodels():
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, **GCFG)
    model = TransformerLM(**GCFG)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return (jmod, jparams), model.requires_grad_(False)


@pytest.mark.parametrize("arm", ["dense", "gather"])
def test_constrained_engine_lockstep_with_jax(gmodels, arm):
    (jmod, jparams), model = gmodels
    jc, pc = _ccfgs()
    kw = dict(GKW, **ARMS[arm], logprobs=N_LP)
    jeng = JaxSlotEngine(jmod, jparams, constrain=jc, **kw)
    eng = SlotEngine(model, constrain=pc, sample_kernel=False,
                     device="cpu", **kw)
    (jr, pr), (js, ps) = _grammars()
    streams, eos_only = _lockstep(jeng, eng, _items(jr, js, range(4)),
                                  _items(pr, ps, range(4)))
    assert eos_only > 0
    assert pr.walk(_trim(streams[0])) is not None
    assert ps.walk(_trim(streams[2])) is not None
    assert eng.constrain_stats()["pinned"] == 0

