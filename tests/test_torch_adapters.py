"""Per-tenant LoRA serving in the port (tpudist_torch/models/lora.py,
tpudist_torch/serve/adapters.py, the adapter seam of the slot programs,
engine and server) against the JAX package on the CPU.

- the host registry is a copy: the same load / acquire / release / unload
  sequence gives the same answers and counters in both packages;
- the port's full-stack engine (paged decode and prefill kernels, fused
  sampling, fused RoPE+QKV, the LoRA gather-matmul) gives greedy streams
  EQUAL to the JAX ``SlotEngine`` with the same knobs, over the requests and
  adapter names of ``tests/test_kernel_family.py::
  test_full_stack_greedy_byte_identity`` (factors made by the JAX package
  and carried across by ``adapter_factors_from_jax``), for learned and RoPE
  positions;
- an off (base-only) lane is bit for bit the base model, and an adapter
  changes its lane;
- ``adapter_missing`` at submit and at placement; a deferred unload frees
  and zeroes its block on the last evict; the JAX engine's knob errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models import create_transformer as jax_create
from tpudist.models.lora import make_adapter_factors as jax_factors
from tpudist.serve import SlotEngine as JaxSlotEngine
from tpudist.serve.adapters import AdapterPoolFull as JaxPoolFull
from tpudist.serve.adapters import AdapterRegistry as JaxRegistry
from torch_cases import settled_torch_cpu
from tpudist_torch.models import (PagedKVConfig, TransformerLM,
                                  adapter_factors_from_jax, make_slot_decode,
                                  params_from_flax)
from tpudist_torch.models import lora
from tpudist_torch.serve import (AdmissionError, DisaggServer,
                                 InferenceServer, ServeConfig, SlotEngine,
                                 serve_forever)
from tpudist_torch.serve.adapters import (AdapterMissingError,
                                          AdapterPoolFull, AdapterRegistry)

CFG = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=32)
FULL = dict(paged=True, attn_kernel="paged", prefill_kernel=True,
            sample_kernel=True, fused_rope=True, adapters=True,
            lora_kernel=True)
ENGINE_KW = dict(num_slots=2, prefill_pad=8, kv_block=4, decode_block=2)
NAMES = ["ad0", None, "ad1", "ad0"]


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _models(**extra):
    cfg = dict(CFG, **extra)
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, **cfg)
    model = TransformerLM(**cfg)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return (jmod, jparams), model.requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    memo = {}

    def get(pos):
        if pos not in memo:
            memo[pos] = _models(rope=pos == "rope")
        return memo[pos]

    return get


def _factors(jmod, i, rank=8):
    """The JAX test's factor set ``i`` (PRNGKey(100 + i)), as numpy."""
    f = jax_factors(jax.random.PRNGKey(100 + i), jmod, rank)
    return {k: np.asarray(v) for k, v in f.items()}


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 16, size=plen).astype(
        np.int32)


def _reqs():
    return [(_prompt(3, 0), 4), (_prompt(5, 1), 6),
            (_prompt(12, 2), 3),  # > prefill_pad 8: chunked prefill
            (_prompt(6, 3), 5)]


def _drive(eng, requests, names=None):
    """Continuous-batching churn with 8-tuple items (adapter names), evict
    on budget — works on the JAX and the port engine alike."""
    pending = list(enumerate(requests))
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
            name = None if names is None else names[rid]
            items.append((slot, prompt, 0.0, 0, max_new, (), None, name))
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


def _port_engine(model, jmod, **kw):
    eng = SlotEngine(model, **dict(FULL, **kw), **ENGINE_KW, device="cpu")
    for i, name in enumerate(sorted({n for n in NAMES if n})):
        eng.load_adapter(name, adapter_factors_from_jax(_factors(jmod, i)))
    return eng


# ---------------------------------------------------------------------------
# the host registry


def _registry_script(reg, full_error):
    """One fixed operation sequence over a 2-block registry; returns every
    answer and the stats after each step."""
    out = []

    def note(x):
        out.append((x, reg.stats(), reg.has("a"), reg.has("b")))

    note(reg.load("a"))
    note(reg.acquire("a"))             # pending load: not bindable
    reg.activate("a")
    note(reg.acquire("a"))
    note(reg.load("b"))
    reg.activate("b")
    note(reg.acquire("b"))
    try:
        reg.load("c")                  # both blocks hot
    except full_error:
        note("full")
    note(reg.release("b", reg.block_of("b")))
    note(reg.load("c"))                # LRU-evicts cold "b"
    reg.activate("c")
    note(reg.unload("a"))              # a lane holds "a": deferred
    note(reg.acquire("a"))             # marked for unload: refused
    note(reg.load("a"))                # reload retires the old generation
    reg.activate("a")
    note(reg.release("a", 0))          # the old generation frees block 0
    note(reg.unload("c"))
    note(reg.unload("nope"))
    with pytest.raises(ValueError):
        reg.load("a")                  # live resident name
    note(sorted(reg.resident_names()))
    return out


def test_registry_sequences_equal_jax():
    assert _registry_script(AdapterRegistry(2), AdapterPoolFull) == \
        _registry_script(JaxRegistry(2), JaxPoolFull)


# ---------------------------------------------------------------------------
# the full-stack engine against JAX


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_full_stack_greedy_streams_equal_jax(models, pos):
    """All the kernel knobs at once with mixed adapter/base lanes: the
    port's greedy streams equal the JAX engine's; every lane releases its
    adapter and the pools drain."""
    (jmod, jparams), model = models(pos)
    jeng = JaxSlotEngine(jmod, jparams, **FULL, **ENGINE_KW)
    for i, name in enumerate(sorted({n for n in NAMES if n})):
        jeng.load_adapter(name, _factors(jmod, i))
    want = _drive(jeng, _reqs(), NAMES)
    eng = _port_engine(model, jmod)
    assert _drive(eng, _reqs(), NAMES) == want
    assert eng.alloc.free_blocks == eng.alloc.num_blocks
    st = eng.adapter_stats()
    assert st["slots_bound"] == 0 and st["in_use"] == 0
    assert st["resident"] == 2 and st["rank"] == 8
    assert eng.kv_stats()["fused_rope"] is True
    assert eng.kv_stats()["lora_kernel"] is True
    assert int((eng.state.adapter_id == 8).sum()) == ENGINE_KW["num_slots"]


def test_lora_kernel_off_runs_the_same_path(models):
    """``lora_kernel=False`` takes the same pool-form kernel path: the
    streams equal the ``lora_kernel=True`` engine's (the JAX suite pins its
    two forms identical)."""
    (jmod, _), model = models("learned")
    a = _drive(_port_engine(model, jmod), _reqs(), NAMES)
    b = _drive(_port_engine(model, jmod, lora_kernel=False), _reqs(), NAMES)
    assert a == b


def test_base_lanes_are_the_base_model(models):
    """A sentinel (base-only) lane's logits are bit for bit those of the
    model without adapters, on the unfused and the fused arm; an adapter
    lane's differ, and so do its greedy streams."""
    (jmod, _), model = models("rope")
    fns = {}
    for fused in (False, True):
        fns[fused] = make_slot_decode(
            model, 2, 8, PagedKVConfig(16, 4, False), fused_rope=fused,
            adapters=lora.AdapterPoolConfig(3, 8))
    pool = lora.init_adapter_pool(model, lora.AdapterPoolConfig(3, 8))
    f = adapter_factors_from_jax(_factors(jmod, 0))
    lora.load_factors(pool, 1, {k: v * 20 for k, v in f.items()})
    rows = torch.full((2, 8), 16, dtype=torch.int32)
    rows[0, :2], rows[1, :2] = torch.tensor([0, 1]), torch.tensor([2, 3])
    toks = torch.from_numpy(np.stack([_prompt(8, 5), _prompt(8, 5)]))
    args = (rows, torch.zeros(2, dtype=torch.int32),
            torch.full((2,), 8, dtype=torch.int32), toks,
            torch.ones(2, dtype=torch.bool))
    for fused, fn in fns.items():
        _, base = fn.prefill_chunk(fn.init_slots(), *args)
        ads = lora.pool_collection(pool, torch.tensor([3, 1]))
        _, mixed = fn.prefill_chunk(fn.init_slots(), *args, ads)
        assert torch.equal(mixed[0], base[0]), fused
        assert not torch.allclose(mixed[1], base[1]), fused
    # streams: every adapter lane differs from the same request as a base
    # lane on an otherwise identical engine (large factors, so the delta
    # moves the arg-max of this tiny model)
    eng = SlotEngine(model, **FULL, **ENGINE_KW, device="cpu")
    eng.load_adapter("big", {k: v * 20 for k, v in f.items()})
    plain = SlotEngine(model, **dict(FULL, adapters=False, lora_kernel=False),
                       **ENGINE_KW, device="cpu")
    reqs = [(_prompt(6, 30 + i), 8) for i in range(4)]
    names = ["big", None, "big", None]
    with_ad = _drive(eng, reqs, names)
    base = _drive(plain, reqs)
    for rid, name in enumerate(names):
        if name is None:
            assert with_ad[rid] == base[rid]
        else:
            assert with_ad[rid] != base[rid]


def test_five_tuple_items_are_base_lanes(models):
    """The 5-tuple item keeps working on an adapter engine (a base lane)."""
    (jmod, _), model = models("learned")
    eng = _port_engine(model, jmod)
    out = eng.start_batch([(0, _prompt(5, 1), 0.0, 0, 3)])
    assert out[0] is not None and eng.slot_adapter[0] is None
    assert int(eng.state.adapter_id[0]) == 8
    eng.evict(0)


# ---------------------------------------------------------------------------
# registry semantics through the engine and the server


def test_deferred_unload_frees_on_last_evict(models):
    (jmod, _), model = models("learned")
    eng = _port_engine(model, jmod)
    bid = eng.adapters.block_of("ad0")
    eng.start_batch([(0, _prompt(4, 0), 0.0, 0, 4, (), None, "ad0"),
                     (1, _prompt(4, 1), 0.0, 0, 4, (), None, "ad0")])
    assert eng.slot_adapter[0] == ("ad0", bid)
    assert eng.unload_adapter("ad0") == {"freed": False, "resident": 2,
                                         "known": True}
    assert not eng.has_adapter("ad0")
    with pytest.raises(AdapterMissingError):
        eng.start_batch([(0, _prompt(4, 2), 0.0, 0, 4, (), None, "ad0")])
    eng.evict(0)
    assert eng.adapters.block_of("ad0") == bid
    assert float(eng.apool.a_qkv[:, bid].abs().sum()) > 0
    eng.evict(1)
    assert eng.adapters.block_of("ad0") is None
    assert eng.adapter_stats()["free_blocks"] == 7
    for key in lora.FACTOR_KEYS:
        assert float(getattr(eng.apool, key)[:, bid].abs().sum()) == 0.0


def test_adapter_missing_at_submit_and_at_placement(models):
    (jmod, _), model = models("learned")
    cfg = ServeConfig(max_new=4, adapters=True, fused_rope=True,
                      lora_kernel=True, **ENGINE_KW)
    server = InferenceServer(model, cfg, device="cpu")
    server.load_adapter("ad0", adapter_factors_from_jax(_factors(jmod, 0)))
    with pytest.raises(AdmissionError, match="adapter_missing"):
        server.submit(_prompt(4, 0), adapter="nope")
    # queued before the loop starts, then unloaded: placement finishes it
    doomed = server.submit(_prompt(4, 0), adapter="ad0")
    ok = server.submit(_prompt(4, 1), adapter=None)
    server.unload_adapter("ad0")
    server.start()
    try:
        assert doomed.wait(60) and ok.wait(60)
        assert doomed.finish_reason == "adapter_missing"
        assert doomed.tokens == []
        assert ok.finish_reason == "length" and len(ok.tokens) == 4
        assert server.stats()["adapters"]["resident"] == 0
    finally:
        assert server.close(30)
    plain = InferenceServer(model, ServeConfig(**ENGINE_KW), device="cpu")
    with pytest.raises(RuntimeError, match="without adapters"):
        plain.load_adapter("x", {})
    with pytest.raises(AdmissionError, match="adapter_missing"):
        plain.submit(_prompt(4, 0), max_new=4, adapter="x")


def test_server_serves_adapter_streams_equal_to_engine(models):
    (jmod, _), model = models("rope")
    cfg = ServeConfig(max_new=4, adapters=True, fused_rope=True,
                      lora_kernel=True, **ENGINE_KW)
    server = InferenceServer(model, cfg, device="cpu").start()
    try:
        for i, name in enumerate(["ad0", "ad1"]):
            server.load_adapter(name, adapter_factors_from_jax(
                _factors(jmod, i)))
        handles = [server.submit(p, max_new=n, adapter=a)
                   for (p, n), a in zip(_reqs(), NAMES)]
        for h in handles:
            assert h.wait(60) and h.finish_reason == "length"
    finally:
        assert server.close(30)
    want = _drive(_port_engine(model, jmod), _reqs(), NAMES)
    assert [h.tokens for h in handles] == [want[i] for i in range(4)]


# ---------------------------------------------------------------------------
# knobs


def test_knob_validation_matches_jax(models):
    """The JAX engine's knob errors (test_kernel_family.py), each naming its
    env var, raised by the port with the same arguments."""
    (jmod, jparams), model = models("learned")
    cases = [dict(attn_kernel="gather", prefill_kernel=False,
                  fused_rope=True),
             dict(attn_kernel="paged", lora_kernel=True),
             dict(attn_kernel="gather", prefill_kernel=False, adapters=True,
                  lora_kernel=True)]
    for kw in cases:
        name = "FUSED_ROPE" if "fused_rope" in kw else "LORA_KERNEL"
        with pytest.raises(ValueError, match=name):
            JaxSlotEngine(jmod, jparams, num_slots=2, paged=True,
                          kv_block=4, **kw)
        with pytest.raises(ValueError, match=name):
            SlotEngine(model, num_slots=2, kv_block=4, device="cpu", **kw)
    with pytest.raises(ValueError, match="adapters=..."):
        make_slot_decode(model, 2, 8, PagedKVConfig(16, 4, False),
                         lora_kernel=True)
    with pytest.raises(RuntimeError, match="without adapters"):
        SlotEngine(model, num_slots=2, kv_block=4,
                   device="cpu").load_adapter("x", {})
    eng = SlotEngine(model, num_slots=2, kv_block=4, device="cpu",
                     adapters=True, adapter_blocks=3, adapter_rank=4)
    with pytest.raises(ValueError, match="shape"):
        eng.load_adapter("bad", _factors(jmod, 0, rank=8))
    with pytest.raises(ValueError, match="constrain"):
        eng.start_batch([(0, _prompt(3, 0), 0.0, 0, 2, (), None, None,
                          object())])


def test_training_arm_refuses_fused_rope(models):
    """The training forward keeps the unfused projection, as JAX's Block
    raises for fused_rope there."""
    from tpudist_torch.models.transformer import _Causal

    _, model = models("rope")
    ctx = _Causal(True, None)
    ctx.fused_rope = True
    with pytest.raises(ValueError, match="paged decode/prefill"):
        model(torch.zeros(1, 4, dtype=torch.int64), ctx)


def test_serve_config_adapter_knobs_from_env(monkeypatch):
    for var, val in (("FUSED_ROPE", "1"), ("LORA_KERNEL", "1"),
                     ("ADAPTERS", "1"), ("ADAPTER_BLOCKS", "3"),
                     ("ADAPTER_RANK", "16")):
        monkeypatch.setenv(f"TPUDIST_SERVE_{var}", val)
    cfg = ServeConfig.from_env()
    assert (cfg.fused_rope, cfg.lora_kernel, cfg.adapters,
            cfg.adapter_blocks, cfg.adapter_rank) == (True, True, True, 3,
                                                      16)
    # the disaggregated server carries the adapter knobs on both pools:
    # fused RoPE and the LoRA kernel ride the prefill pool with its kernel
    monkeypatch.setenv("TPUDIST_SERVE_DISAGG", "1")
    monkeypatch.setenv("TPUDIST_SERVE_KV_BLOCK", "4")
    monkeypatch.setenv("TPUDIST_SERVE_PREFILL_PAD", "8")
    server = serve_forever(TransformerLM(**CFG), device="cpu")
    try:
        assert isinstance(server, DisaggServer)
        engines = server.prefill_pool + server.decode_pool
        assert len(engines) == 2
        for eng in engines:
            assert eng.fused_rope and eng.lora_kernel
            assert eng.adapter_cfg == lora.AdapterPoolConfig(3, 16)
        server.load_adapter("a0", lora.make_adapter_factors(
            torch.Generator().manual_seed(0), server.decode_pool[0].model,
            16))
        assert all(eng.has_adapter("a0") for eng in engines)
    finally:
        assert server.close(30)


def test_pool_helpers():
    model = TransformerLM(**dict(CFG, n_kv_heads=1))
    assert lora.adapter_dims(model) == {"qkv": (32, 64), "wi": (32, 64),
                                        "wo": (64, 32)}
    cfg = lora.AdapterPoolConfig(2, 4)
    pool = lora.init_adapter_pool(model, cfg)
    assert pool.a_qkv.shape == (2, 2, 32, 4)
    assert pool.b_wo.shape == (2, 2, 4, 32)
    assert lora.pool_bytes(pool) == 2 * lora.adapter_block_bytes(model, cfg)
    f = lora.make_adapter_factors(torch.Generator().manual_seed(0), model, 4)
    lora.check_factors(model, cfg, f)
    lora.load_factors(pool, 1, f)
    assert torch.equal(pool.b_wi[:, 1], f["b_wi"])
    lora.zero_block(pool, 1)
    assert float(pool.b_wi.abs().sum()) == 0.0
    col = lora.pool_collection(pool, torch.tensor([0, 2, 1]))
    assert col["on"].tolist() == [True, False, True]
    assert col["ids"].dtype == torch.int32
    with pytest.raises(ValueError, match="missing"):
        lora.check_factors(model, cfg, {})
    with pytest.raises(ValueError):
        lora.init_adapter_pool(model, lora.AdapterPoolConfig(0, 4))
