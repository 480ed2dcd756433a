"""The port's serving mesh (``tpudist_torch/serve/spmd.py`` and the slot
engine over ``data × model`` places) against the JAX package's on the CPU.

The JAX suite's contract (``tests/test_serve_spmd.py``), on its request
mix: greedy output equal to the single-device ``generate()`` oracle at
1x2 and 2x2, dense and paged, with the overlapped MLP off, ``ring`` and
``bidir``, at decode blocks 1, 4 and 8, on an int8 pool, the gather and
fused RoPE arms and a tied speculative draft; and beyond it, every
``peek_logits`` the mesh engine reads equal to the unsharded port engine's
bit for bit (the tolerance is none).  Adapters (the LoRA kernel path and
the gather arm) and sampled streams hold to the unsharded engine.  The
places' kernel calls, counted through wrappers on the CPU, are the
unsharded engine's times the places for the kernels a place runs on its
slice, and the unsharded engine's for the sampling preps, over churn and
a late join.  A lane moves between a 1x2 engine and an unsharded one bit
for bit.  ``ServeMeshConfig``, ``resolve_serve_overlap`` and
``spmd_stats`` are pinned equal to JAX's; at 1x4 over 2 kv heads the port
keeps attention whole where JAX splits the qkv columns, and its stats
say so."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models import create_transformer as jax_create
from tpudist.models import generate as jax_generate
from tpudist.serve import ServeMeshConfig as JaxMeshConfig
from tpudist.serve import SlotEngine as JaxSlotEngine
from tpudist.serve import spmd as jax_spmd
from torch_cases import settled_torch_cpu
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.models.lora import make_adapter_factors
from tpudist_torch.serve import ServeMeshConfig, SlotEngine, spmd

CFG = dict(vocab=16, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=32)
#: the two geometries: 4 heads with RoPE, and GQA 4/2 with learned
#: positions
MODELS = {"mha": dict(rope=True), "gqa": dict(n_kv_heads=2)}


def _prompt(plen, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["vocab"], size=plen).astype(np.int32)


#: ``tests/test_serve_spmd.py``'s request mix: more requests than slots
#: (churn), a prompt longer than the pad (chunked prefill)
REQUESTS = [(_prompt(3, 0), 4), (_prompt(5, 1), 6), (_prompt(12, 2), 3),
            (_prompt(6, 3), 5)]


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(scope="module")
def models():
    memo = {}

    def get(name):
        if name not in memo:
            cfg = dict(CFG, **MODELS[name])
            jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16,
                                       **cfg)
            model = TransformerLM(**cfg)
            model.load_state_dict(params_from_flax(
                jax.tree.map(np.asarray, jparams)))
            want = [np.asarray(jax_generate(
                jmod, jparams, jnp.asarray(p)[None], n))[0, len(p):].tolist()
                for p, n in REQUESTS]
            memo[name] = (jmod, jparams), model.requires_grad_(False), want
        return memo[name]

    return get


def drive(eng, requests, *, temperature=0.0, seed=0, names=None):
    """The JAX suite's FIFO churn (admit into free slots, chunked
    prefill, decode blocks, evict on budget) → ``(streams, the
    peek_logits read before each decode block)``."""
    pending = list(enumerate(requests))
    out = {rid: [] for rid, _ in pending}
    slot_rid, slot_budget, peeks = {}, {}, []

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
            items.append((slot, prompt, temperature, seed + rid, max_new,
                          (), None, name))
        for slot, tok in eng.start_batch(items).items():
            if tok is not None:
                deliver(slot, [tok])
        for slot, tok in eng.advance_prefill().items():
            deliver(slot, [tok])
        if eng.num_active:
            peeks.append(eng.fns.peek_logits(eng.state, eng.cache,
                                             apool=eng.apool).clone())
            _, blocks = eng.decode_auto()
            for slot, toks in list(blocks.items()):
                if slot in slot_rid:
                    deliver(slot, toks)
    return [out[r] for r in range(len(requests))], peeks


#: engine arms: knobs beside ``num_slots=2, prefill_pad=8``
ARMS = {
    "paged": dict(kv_block=4),
    "dense": dict(paged=False),
    "int8": dict(kv_block=4, kv_int8=True, prefix_cache_blocks=4),
    "gather": dict(kv_block=4, attn_kernel="gather", prefill_kernel=False),
    "fused_rope": dict(kv_block=4, fused_rope=True),
    "spec": dict(kv_block=4, spec_draft=1, spec_k=2),
    "spec-dense": dict(paged=False, spec_draft=1, spec_k=3),
}

#: (arm, mesh, overlap, decode block)
RUNS = [
    ("paged", "1x2", "off", 8), ("paged", "1x2", "ring", 8),
    ("paged", "1x2", "bidir", 8), ("paged", "2x2", "off", 8),
    ("paged", "2x2", "ring", 8), ("paged", "2x2", "bidir", 8),
    ("paged", "1x2", "off", 1), ("paged", "2x2", "ring", 4),
    ("dense", "1x2", "off", 8), ("dense", "1x2", "ring", 8),
    ("dense", "2x2", "off", 8), ("dense", "2x2", "bidir", 8),
    ("dense", "2x2", "ring", 1), ("dense", "1x2", "bidir", 4),
    ("int8", "1x2", "off", 8), ("int8", "2x2", "ring", 4),
    ("gather", "1x2", "ring", 8), ("gather", "2x2", "off", 4),
    ("fused_rope", "1x2", "off", 8), ("fused_rope", "2x2", "bidir", 1),
    ("spec", "1x2", "off", 8), ("spec", "2x2", "ring", 8),
    ("spec-dense", "2x2", "off", 8), ("spec-dense", "1x2", "ring", 8),
]

_UNSHARDED: dict = {}


def _engine(model, arm, block=8, **kw):
    return SlotEngine(model, num_slots=2, prefill_pad=8, decode_block=block,
                      device="cpu", **ARMS[arm], **kw)


def _unsharded(name, model, arm, block):
    key = (name, arm, block)
    if key not in _UNSHARDED:
        _UNSHARDED[key] = drive(_engine(model, arm, block), REQUESTS)
    return _UNSHARDED[key]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("arm,mesh,overlap,block", RUNS)
def test_mesh_greedy_matches_oracle_and_unsharded_logits(
        models, name, arm, mesh, overlap, block):
    _, model, want = models(name)
    eng = _engine(model, arm, block,
                  mesh=ServeMeshConfig(mesh, tp_overlap=overlap))
    got, peeks = drive(eng, REQUESTS)
    assert got == want
    base, base_peeks = _unsharded(name, model, arm, block)
    assert got == base
    assert len(peeks) == len(base_peeks)
    for i, (a, b) in enumerate(zip(peeks, base_peeks)):
        assert torch.equal(a, b), f"peek_logits before decode block {i}"
    st = eng.spmd_stats()
    d, m = (int(x) for x in mesh.split("x"))
    assert st["mesh"] == {"data": d, "model": m}
    assert st["tp_overlap"] == overlap and st["replicated"] == []
    assert st["param_bytes_per_device"] < st["param_bytes_total"]
    assert eng.num_occupied == 0
    if eng.alloc is not None:
        assert eng.alloc.free_blocks == eng.alloc.num_blocks


def _factors(model, i):
    return make_adapter_factors(torch.Generator().manual_seed(10 + i),
                                model, 4)


ADAPTER_ARMS = {
    "lora-kernel": dict(kv_block=4, fused_rope=True, lora_kernel=True),
    "gather": dict(kv_block=4, attn_kernel="gather", prefill_kernel=False),
}


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arm", sorted(ADAPTER_ARMS))
def test_mesh_adapters_equal_unsharded(models, name, mesh, arm):
    """Two adapters and base lanes through the placed pool: streams and
    logits the unsharded engine's; adapters keep the overlap off, as in
    JAX."""
    _, model, _ = models(name)
    names = ["a0", None, "a1", "a0"]
    runs = []
    for kw in ({}, dict(mesh=ServeMeshConfig(mesh, tp_overlap="ring"))):
        eng = SlotEngine(model, num_slots=2, prefill_pad=8, decode_block=4,
                         adapters=True, adapter_blocks=2, adapter_rank=4,
                         device="cpu", **ADAPTER_ARMS[arm], **kw)
        for i in range(2):
            eng.load_adapter(f"a{i}", _factors(model, i))
        runs.append((drive(eng, REQUESTS, names=names), eng))
    (base, base_peeks), _ = runs[0]
    (got, peeks), eng = runs[1]
    assert got == base
    assert all(torch.equal(a, b) for a, b in zip(peeks, base_peeks))
    assert len(peeks) == len(base_peeks)
    assert eng.spmd_stats()["tp_overlap"] == "off"
    assert eng.adapter_stats()["pool_bytes"] == \
        runs[0][1].adapter_stats()["pool_bytes"]


@pytest.mark.parametrize("mesh,arm", [("1x2", "paged"), ("2x2", "dense"),
                                      ("2x2", "spec")])
def test_mesh_sampled_streams_equal_unsharded(models, mesh, arm):
    _, model, _ = models("mha")
    base, _ = drive(_engine(model, arm), REQUESTS, temperature=0.9, seed=5)
    got, _ = drive(_engine(model, arm, mesh=mesh), REQUESTS,
                   temperature=0.9, seed=5)
    assert got == base


#: the kernels a place runs on its own slice, and those run once on
#: gathered rows
SHARDED = ("fused_rope_qkv", "paged_attention", "paged_prefill_attention",
           "lora_delta")
ONCE = ("fused_sample_prep", "fused_residual_prep")


def _count_calls(monkeypatch):
    """Count the CPU calls into each kernel wrapper (``ops.launch_counts``
    counts CUDA launches only) where the serving path calls them."""
    import importlib

    gen = importlib.import_module("tpudist_torch.models.generate")
    tr = importlib.import_module("tpudist_torch.models.transformer")

    calls = dict.fromkeys(SHARDED + ONCE, 0)

    def wrap(mod, fname):
        fn = getattr(mod, fname)

        def counted(*a, **kw):
            calls[fname] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, fname, counted)

    for fname in SHARDED:
        wrap(tr, fname)
    for fname in ONCE:
        wrap(gen, fname)
    return calls


@pytest.mark.parametrize("arm", ["adapters", "spec"])
def test_kernel_calls_scale_by_places(models, monkeypatch, arm):
    """Over churn, then a late join: each phase's calls on a 1x2 engine
    are the unsharded engine's times 2 for the per-place kernels
    (``lora_delta``: the qkv and wi deltas a place, the wo delta once),
    and the unsharded engine's for the sampling preps."""
    _, model, _ = models("mha")
    calls = _count_calls(monkeypatch)
    kw = (dict(kv_block=4, fused_rope=True, adapters=True, adapter_blocks=2,
               adapter_rank=4, lora_kernel=True) if arm == "adapters"
          else dict(kv_block=4, spec_draft=1, spec_k=2, fused_rope=True))
    late = [(_prompt(7, 9), 5)]
    phases = {}
    for mesh in (None, "1x2"):
        eng = SlotEngine(model, num_slots=2, prefill_pad=8, decode_block=4,
                         device="cpu", mesh=mesh, **kw)
        names = None
        if arm == "adapters":
            eng.load_adapter("a0", _factors(model, 0))
            names = ["a0", None, "a0", None]
        counts = []
        for reqs, nm in ((REQUESTS, names), (late, None if names is None
                                             else ["a0"])):
            for k in calls:
                calls[k] = 0
            drive(eng, reqs, names=nm)
            counts.append(dict(calls))
        phases[mesh] = counts
    for base, got in zip(phases[None], phases["1x2"]):
        assert base["paged_attention"] > 0 and base["fused_rope_qkv"] > 0
        for k in ("fused_rope_qkv", "paged_attention",
                  "paged_prefill_attention"):
            assert got[k] == 2 * base[k], (k, base, got)
        assert got["lora_delta"] * 3 == base["lora_delta"] * 5
        for k in ONCE:
            assert got[k] == base[k], (k, base, got)
    if arm == "spec":
        assert phases[None][0]["fused_residual_prep"] > 0


def _adopt(src, slot, dst, dslot):
    lane, row = src.fns.export_lane(src.state, src.cache, slot)
    if dst.alloc is not None:
        got, _ = dst.alloc.admit(dslot, int(src.pos[slot]),
                                 int(src.budget[slot]), ())
        table = np.full(dst.max_len // dst.paged_cfg.block_size,
                        dst.paged_cfg.num_blocks, np.int32)
        table[:len(got)] = got
        dst.state, dst.cache = dst.fns.import_lane(
            dst.state, dst.cache, dslot, torch.from_numpy(table), lane, row)
    else:
        dst.state, dst.cache = dst.fns.import_lane(dst.state, dst.cache,
                                                   dslot, lane, row)
    dst.occupied[dslot] = dst.decoding[dslot] = True
    for name in ("pos", "counts", "budget", "temps"):
        getattr(dst, name)[dslot] = getattr(src, name)[slot]
    return lane


def _finish(eng):
    out = {}
    while eng.num_active:
        for s, toks in eng.decode_block()[1].items():
            out.setdefault(s, []).extend(toks)
            if eng.counts[s] >= eng.budget[s]:
                eng.evict(s)
    return out


@pytest.mark.parametrize("arm", ["paged", "dense", "int8"])
def test_lanes_move_between_mesh_and_unsharded_engines(models, arm):
    """Two lanes warmed on a 1x2 and on an unsharded engine export the same
    tensors; handed from the mesh engine to an unsharded one and back,
    each continues as the engine it left would have."""
    _, model, _ = models("gqa")
    items = [(0, _prompt(5, 1), 0.9, 3, 9), (1, _prompt(10, 2), 0.0, 4, 8)]

    def warm(mesh):
        eng = _engine(model, arm, 2, mesh=mesh)
        eng.start_batch(items)
        while eng.prefilling_slots():
            eng.advance_prefill()
        eng.decode_block()
        return eng

    src, ref = warm("1x2"), warm(None)
    for slot in (0, 1):
        (k, v, c), row = src.fns.export_lane(src.state, src.cache, slot)
        (rk, rv, rc), rrow = ref.fns.export_lane(ref.state, ref.cache, slot)
        assert torch.equal(k, rk) and torch.equal(v, rv) and int(c) == int(rc)
        assert all(torch.equal(a, b) for a, b in zip(row, rrow))
    want = _finish(warm(None))
    for dst_mesh in (None, "1x2"):
        src = warm("1x2" if dst_mesh is None else None)
        dst = _engine(model, arm, 2, mesh=dst_mesh)
        for slot in (0, 1):
            _adopt(src, slot, dst, slot)
        assert _finish(dst) == want, dst_mesh


SHAPES = ["2x2", "4", "1", "1x1", "2x4", " 1X2 ", "2×2", "", None, "x",
          "2x2x2", "0x2", "two", "2x-1"]


def _parse(cls, shape):
    try:
        c = cls(shape)
        return (c.dims, c.n_devices, c.enabled), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("shape", SHAPES)
def test_serve_mesh_config_parses_like_jax(shape):
    assert _parse(ServeMeshConfig, shape) == _parse(JaxMeshConfig, shape)


def test_mesh_config_from_env_and_folding(monkeypatch):
    """``from_env`` as JAX's; a mesh larger than the host folds onto its
    device (JAX refuses: "needs 16 devices")."""
    monkeypatch.setenv("TPUDIST_SERVE_MESH", "2x4")
    monkeypatch.setenv("TPUDIST_SERVE_TP_OVERLAP", "bidir")
    assert ServeMeshConfig.from_env() == ServeMeshConfig("2x4", "bidir")
    j = JaxMeshConfig.from_env()
    assert (j.shape, j.tp_overlap) == ("2x4", "bidir")
    with pytest.raises(ValueError, match="needs"):
        jax_spmd.build_serve_mesh(JaxMeshConfig("4x4"))
    mesh = spmd.build_serve_mesh(ServeMeshConfig("4x4"), "cpu")
    assert mesh.shape == {"data": 4, "model": 4}
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert spmd.build_serve_mesh(ServeMeshConfig("1x1"), "cpu") is None


@pytest.mark.parametrize("explicit,serve_knob,knob", [
    (None, None, None), (None, None, "ring"), (None, None, "bidir"),
    (None, None, "bogus"), (None, "ring", None), (None, "BIDIR ", "ring"),
    (None, "off", "ring"), (None, "junk", "ring"), ("ring", "bidir", None),
    ("bidir", None, "ring"), ("off", "ring", "ring"), (" Ring", None, None),
    ("nope", None, "ring")])
def test_resolve_serve_overlap_equals_jax(monkeypatch, explicit, serve_knob,
                                          knob):
    for var, val in (("TPUDIST_SERVE_TP_OVERLAP", serve_knob),
                     ("TPUDIST_OVERLAP", knob)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    assert spmd.resolve_serve_overlap(ServeMeshConfig(
        "1x2", explicit)) == jax_spmd.resolve_serve_overlap(
        JaxMeshConfig("1x2", explicit))


JAX_KEYS = ("mesh", "n_devices", "tp_overlap", "param_bytes_total",
            "param_bytes_sharded", "param_bytes_per_device")


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("mesh,overlap", [("1x2", "off"), ("1x2", "ring"),
                                          ("2x2", "off"), ("2x2", "bidir")])
def test_spmd_stats_equal_jax(models, name, mesh, overlap):
    (jmod, jparams), model, _ = models(name)
    cfg = dict(num_slots=2, prefill_pad=8)
    jeng = JaxSlotEngine(jmod, jparams, mesh=JaxMeshConfig(mesh, overlap),
                         **cfg)
    eng = SlotEngine(model, device="cpu", kv_block=4,
                     mesh=ServeMeshConfig(mesh, overlap), **cfg)
    want, got = jeng.spmd_stats(), eng.spmd_stats()
    assert {k: got[k] for k in JAX_KEYS} == {k: want[k] for k in JAX_KEYS}
    assert SlotEngine(model, device="cpu", **cfg).spmd_stats() == \
        JaxSlotEngine(jmod, jparams, **cfg).spmd_stats()


def test_gqa_attention_stays_whole_where_model_exceeds_kv_heads(models):
    """At 1x4 over GQA 4/2 the kv heads do not split four ways: the port
    keeps qkv (and the KV) whole, where JAX splits qkv's 64 columns
    evenly; every other byte is accounted as JAX's, and the stream is the
    oracle's."""
    (jmod, jparams), model, want = models("gqa")
    jeng = JaxSlotEngine(jmod, jparams, num_slots=2, prefill_pad=8,
                         mesh=JaxMeshConfig("1x4", "off"))
    eng = _engine(model, "paged", mesh="1x4")
    j, p = jeng.spmd_stats(), eng.spmd_stats()
    assert p["replicated"] == ["attention"]
    qkv = sum(b.qkv.numel() * b.qkv.element_size() for b in model.blocks)
    assert p["param_bytes_total"] == j["param_bytes_total"]
    assert p["param_bytes_sharded"] == j["param_bytes_sharded"] - qkv
    assert p["param_bytes_per_device"] == \
        j["param_bytes_per_device"] + qkv - qkv // 4
    assert drive(eng, REQUESTS)[0] == want
    assert spmd.serve_paged_sharding(eng.mesh, eng.fns.paged.whole.init()) \
        == {"pool_k": (), "pool_v": (), "scale_k": (), "scale_v": (),
            "table": (), "cursor": ()}


def test_layout_records(models):
    """The layout functions' records at 2x2 over the GQA model: qkv and
    b_qkv by kv heads, wi / head by rows, wo only under the overlap, the
    dense arena's slots over data and its kv heads over model, the pool's
    kv heads over model, the state whole."""
    _, model, _ = models("gqa")
    mesh = spmd.build_serve_mesh(ServeMeshConfig("2x2"), "cpu")
    heads = (spmd.Split("model", 0, 2, "heads"),)
    rows = (spmd.Split("model", 0, 2),)
    plain = spmd.serve_param_sharding(mesh, model)
    over = spmd.serve_param_sharding(mesh, model, overlap=True)
    assert plain["blocks.0.qkv"] == heads and plain["head"] == rows
    assert plain["blocks.1.wi"] == rows and plain["blocks.1.wo"] == ()
    assert over["blocks.1.wo"] == rows
    assert plain["blocks.0.proj"] == plain["tok_embed"] == \
        plain["blocks.0.ln1"] == ()
    eng = _engine(model, "dense", mesh="2x2", adapters=True,
                  adapter_blocks=2, adapter_rank=4)
    whole = eng.fns.init_slots
    assert spmd.serve_cache_sharding(mesh, type("KV", (), dict(
        k=torch.empty(2, 2, 2, 32, 8)))) == {
        "k": (spmd.Split("data", 1, 2), spmd.Split("model", 2, 2)),
        "v": (spmd.Split("data", 1, 2), spmd.Split("model", 2, 2)),
        "cursor": ()}
    assert [t.shape for t in whole().k] == [(2, 2, 1, 32, 8)] * 2
    from tpudist_torch.models.lora import (AdapterPoolConfig,
                                           init_adapter_pool)

    ad = spmd.serve_adapter_sharding(mesh, init_adapter_pool(
        model, AdapterPoolConfig(2, 4)), model)
    assert ad["b_qkv"] == (spmd.Split("model", 3, 2, "heads"),)
    assert ad["b_wi"] == (spmd.Split("model", 3, 2),)
    assert ad["a_qkv"] == ad["b_wo"] == ()
    assert [t.shape[-1] for t in eng.apool.b_qkv] == [32, 32]
    assert set(spmd.serve_state_sharding(mesh, eng.state).values()) == {()}
