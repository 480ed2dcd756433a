"""The port's serving slice (tpudist_torch/models, tpudist_torch/serve)
against the JAX package on the CPU.

- ``TransformerLM`` training-mode logits from converted flax params agree
  with the JAX model within ``atol 2e-5`` (f32; the two sum in different
  orders through a 2-layer stack of ~1-magnitude activations);
- the paged storage programs (window commit, write tables, storage-form
  commit, release) equal the JAX ``_Paged`` methods — exactly for int8
  blocks and tables, ``atol 1e-6`` for float blocks;
- the port's ``SlotEngine`` greedy streams EQUAL the JAX ``SlotEngine``'s
  (paged pool, paged-attention, prefill and sampling kernels on) and
  ``generate()``'s for every request of a churn harness with chunked
  prefill, for RoPE and learned positions and for native and int8 KV; the
  pool drains back to all-free;
- ``InferenceServer`` serves end to end on ``device="cpu"``, and refuses to
  start on a box without CUDA when no device is given;
- a sampled stream is the same alone and beside neighbours.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models import create_transformer as jax_create
from tpudist.models import generate as jax_generate
from tpudist.models.paged import PagedKVConfig as JaxPagedCfg
from tpudist.models.paged import _Paged as JaxPaged
from tpudist.serve import SlotEngine as JaxSlotEngine
from tpudist.serve.paged_alloc import BlockAllocator as JaxAllocator
from tpudist.serve.paged_alloc import hash_chain as jax_hash_chain
from torch_cases import settled_torch_cpu
from tpudist_torch.models import (PagedKVConfig, TransformerLM,
                                  create_transformer, params_from_flax)
from tpudist_torch.models.generate import philox_uniform
from tpudist_torch.models.paged import _Paged
from tpudist_torch.serve import (AdmissionError, BlockAllocator,
                                 InferenceServer, ServeConfig, SlotEngine,
                                 hash_chain)

BASE = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_len=32)
KERNEL_KNOBS = dict(paged=True, attn_kernel="paged", prefill_kernel=True,
                    sample_kernel=True)
ENGINE_KW = dict(num_slots=2, prefill_pad=8, kv_block=4, decode_block=2)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _models(**extra):
    cfg = dict(BASE, **extra)
    jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16, **cfg)
    model = TransformerLM(**cfg)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return (jmod, jparams), model.requires_grad_(False)


@pytest.fixture(scope="module")
def rope_models():
    return _models(rope=True)


@pytest.fixture(scope="module")
def learned_models():
    return _models()


@pytest.fixture(scope="module")
def jax_streams(rope_models, learned_models):
    """The JAX SlotEngine's greedy streams over ``_reqs()``, per (positions,
    int8), computed once per module (the JAX engine compiles its programs
    on first use, which dominates these tests' time)."""
    memo = {}

    def get(pos, int8):
        if (pos, int8) not in memo:
            jmod, jparams = (rope_models if pos == "rope"
                             else learned_models)[0]
            jeng = JaxSlotEngine(jmod, jparams, **KERNEL_KNOBS,
                                 **ENGINE_KW, kv_int8=int8)
            memo[pos, int8] = _drive(jeng, _reqs())
        return memo[pos, int8]

    return get


# ---------------------------------------------------------------------------
# (b) the model


@pytest.mark.parametrize("extra", [dict(), dict(rope=True),
                                   dict(rope=True, n_kv_heads=1),
                                   dict(sliding_window=5)],
                         ids=["learned", "rope", "rope-gqa", "window"])
def test_training_logits_match_jax(extra):
    (jmod, jparams), model = _models(**extra)
    toks = np.random.default_rng(0).integers(0, 16, size=(3, 12))
    ref = np.asarray(jmod.apply(jparams, jnp.asarray(toks, jnp.int32)))
    out = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


def test_rope_matches_jax_with_vector_offsets():
    from tpudist.models.transformer import rope_rotate as jax_rope

    from tpudist_torch.models import rope_rotate

    x = np.random.default_rng(1).normal(size=(3, 2, 4, 8)).astype(
        np.float32)
    offs = np.asarray([0, 5, 29], np.int32)
    ref = np.asarray(jax_rope(jnp.asarray(x), offset=jnp.asarray(offs)))
    out = rope_rotate(torch.from_numpy(x), offset=torch.from_numpy(offs))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_bf16_weights_are_rounded_masters(rope_models):
    """A bf16 model holds exactly the bf16 rounding of the f32 masters
    (flax's cast at apply); LayerNorm scales stay f32."""
    (_, jparams), _ = rope_models
    model = TransformerLM(**dict(BASE, rope=True), dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    w = np.asarray(jparams["params"]["block_0"]["qkv"]["kernel"]).T
    ref = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(model.blocks[0].qkv.detach().float().numpy(),
                                  ref)
    assert model.blocks[0].ln1.dtype == torch.float32


# ---------------------------------------------------------------------------
# paged storage programs against the JAX _Paged


def _paged_pair(models, quant):
    (jmod, jparams), model = models
    from tpudist.models.generate import make_decode_step

    init_cache, _ = make_decode_step(jmod, jparams)
    jpg = JaxPaged(init_cache(1), 3, JaxPagedCfg(num_blocks=12,
                                                 block_size=4,
                                                 quantized=quant))
    pg = _Paged(model, 3, PagedKVConfig(12, 4, quant), "cpu")
    return jpg, pg


def _fill_pools(jpg, pg, quant, seed):
    r = np.random.default_rng(seed)
    shape = (2, 12, 2, 4, 16)
    if quant:
        pk = r.integers(-127, 128, size=shape).astype(np.int8)
        pv = r.integers(-127, 128, size=shape).astype(np.int8)
        sk = r.uniform(0.01, 0.2, size=shape[:3]).astype(np.float32)
        sv = r.uniform(0.01, 0.2, size=shape[:3]).astype(np.float32)
    else:
        pk = r.normal(size=shape).astype(np.float32)
        pv = r.normal(size=shape).astype(np.float32)
        sk = sv = np.ones(shape[:3], np.float32)
    table = np.full((3, 8), 12, np.int32)
    table[0, :3] = [4, 7, 1]
    table[1, :5] = [0, 2, 3, 5, 6]
    table[2, :2] = [9, 10]
    jkv = jpg.init()._replace(
        pool_k=jnp.asarray(pk), pool_v=jnp.asarray(pv),
        scale_k=jnp.asarray(sk), scale_v=jnp.asarray(sv),
        table=jnp.asarray(table))
    tkv = pg.init()
    for dst, src in zip(tkv[:5], (pk, pv, sk, sv, table)):
        dst.copy_(torch.from_numpy(src))
    return jkv, tkv


def _assert_pool_equal(jkv, tkv, quant):
    for a, b in zip(jkv[:5], tkv[:5]):
        a = np.asarray(a)
        if quant or a.dtype != np.float32:
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_commit_window_and_release_match_jax(rope_models, quant):
    jpg, pg = _paged_pair(rope_models, quant)
    jkv, tkv = _fill_pools(jpg, pg, quant, seed=4)
    span = 4
    r = np.random.default_rng(5)
    w = r.normal(size=(2, 3, 2, span, 16)).astype(np.float32)
    wv = r.normal(size=(2, 3, 2, span, 16)).astype(np.float32)
    pos0 = np.asarray([9, 6, 30], np.int32)   # lane 2: past its span
    mask = np.asarray([True, True, False])
    view = dict(jpg.window_view(jkv, span))
    for i, name in enumerate(jpg.layers):
        view[name] = dict(view[name], k=jnp.asarray(w[i]),
                          v=jnp.asarray(wv[i]))
    jkv = jpg.commit_window(jkv, view, jnp.asarray(pos0), span,
                            jnp.asarray(mask))
    pg.commit_window(tkv, torch.from_numpy(w), torch.from_numpy(wv),
                     torch.from_numpy(pos0), span, torch.from_numpy(mask))
    _assert_pool_equal(jkv, tkv, quant)
    free = np.asarray([7, 1, 12, 12, 12, 12, 12, 12], np.int32)
    jkv = jpg.release(jkv, jnp.asarray(0), jnp.asarray(free))
    pg.release(tkv, 0, torch.from_numpy(free))
    _assert_pool_equal(jkv, tkv, quant)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_write_tables_and_commit_quantized_match_jax(rope_models, quant):
    jpg, pg = _paged_pair(rope_models, quant)
    jkv, tkv = _fill_pools(jpg, pg, quant, seed=6)
    rows = np.array(jkv.table)
    pos0 = np.asarray([5, 0, 4], np.int32)
    clen = np.asarray([6, 0, 3], np.int32)
    mask = np.asarray([True, True, True])
    jw = np.asarray(jpg.write_tables(jnp.asarray(rows), jnp.asarray(pos0),
                                     jnp.asarray(clen), 8,
                                     jnp.asarray(mask)))
    tw = pg.write_tables(torch.from_numpy(rows), torch.from_numpy(pos0),
                         torch.from_numpy(clen), 8, torch.from_numpy(mask))
    np.testing.assert_array_equal(tw.numpy(), jw)
    n = jw.size
    r = np.random.default_rng(7)
    dt = np.int8 if quant else np.float32
    qk = r.integers(-127, 128, size=(2, n, 2, 4, 16)).astype(dt)
    qv = r.integers(-127, 128, size=(2, n, 2, 4, 16)).astype(dt)
    sk = r.uniform(0.01, 0.2, size=(2, n, 2)).astype(np.float32)
    sv = r.uniform(0.01, 0.2, size=(2, n, 2)).astype(np.float32)
    jkv = jpg.commit_quantized(jkv, jnp.asarray(jw.reshape(n)),
                               *map(jnp.asarray, (qk, qv, sk, sv)))
    pg.commit_quantized(tkv, tw.reshape(n),
                        *map(torch.from_numpy, (qk, qv, sk, sv)))
    _assert_pool_equal(jkv, tkv, quant)


def test_allocator_copy_matches_jax():
    """The host allocator and hash chain are copies: same rows, reuse and
    frees under the same admission/progress/release sequence."""
    prompt = np.arange(23, dtype=np.int32) % 7
    assert hash_chain(prompt, 4) == jax_hash_chain(prompt, 4)
    a, b = BlockAllocator(16, 4, 32, 4), JaxAllocator(16, 4, 32, 4)
    hs = hash_chain(prompt, 4)
    for alloc in (a, b):
        alloc.admit(0, 23, 5, hs)
        alloc.note_progress(0, 23)
        alloc.admit(1, 23, 2, hs)
    assert a.slot_row(1) == b.slot_row(1)
    assert a.release(0) == b.release(0)
    assert (a.free_blocks, a.cached_blocks, a.prefix_hit_blocks) == \
        (b.free_blocks, b.cached_blocks, b.prefix_hit_blocks)


# ---------------------------------------------------------------------------
# (c) engine streams under churn


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 16, size=plen).astype(
        np.int32)


def _reqs():
    return [(_prompt(3, 0), 4), (_prompt(5, 1), 6),
            (_prompt(12, 2), 3),  # > prefill_pad 8: chunked prefill
            (_prompt(6, 3), 5), (_prompt(17, 4), 7)]


def _drive(eng, requests, *, temperature=0.0, seed=0):
    """Continuous-batching churn: FIFO admission, chunked prefill, decode
    through decode_auto, evict on budget (the JAX suite's harness)."""
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
            items.append((slot, prompt, temperature, seed + rid, max_new))
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


@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("pos", ["rope", "learned"])
def test_engine_greedy_streams_match_jax(rope_models, learned_models,
                                         jax_streams, pos, int8):
    (jmod, jparams), model = rope_models if pos == "rope" \
        else learned_models
    eng = SlotEngine(model, **KERNEL_KNOBS, device="cpu", **ENGINE_KW,
                     kv_int8=int8)
    out = _drive(eng, _reqs())
    assert out == jax_streams(pos, int8)
    if not int8:
        for rid, (prompt, max_new) in enumerate(_reqs()):
            g = jax_generate(jmod, jparams, jnp.asarray(prompt)[None],
                             max_new)
            assert out[rid] == np.asarray(g)[0, len(prompt):].tolist(), rid
    assert eng.alloc.free_blocks == eng.alloc.num_blocks
    assert eng.num_occupied == 0


def test_engine_prefix_cache_reuses_blocks(rope_models):
    """Requests sharing a prompt prefix map the cached blocks instead of
    re-prefilling them; streams still equal generate()."""
    (jmod, jparams), model = rope_models
    eng = SlotEngine(model, num_slots=2, prefill_pad=8, kv_block=4,
                     prefix_cache_blocks=8, device="cpu")
    base = _prompt(13, 9)
    reqs = [(base, 3), (np.concatenate([base[:12], _prompt(3, 10)]), 4)]
    pending = [(s, p, 0.0, 0, n, hash_chain(p, 4))
               for s, (p, n) in enumerate(reqs[:1])]
    out = _drive_items(eng, pending)
    pending = [(0, reqs[1][0], 0.0, 0, reqs[1][1],
                hash_chain(reqs[1][0], 4))]
    out.update({1: _drive_items(eng, pending)[0]})
    assert eng.alloc.prefix_hit_blocks >= 3
    for rid, (prompt, max_new) in enumerate(reqs):
        g = jax_generate(jmod, jparams, jnp.asarray(prompt)[None], max_new)
        assert out[rid] == np.asarray(g)[0, len(prompt):].tolist()


def test_learned_positions_chunk_past_max_len(learned_models):
    """A prefix-cache hit shifts chunked prefill off chunk alignment, so the
    last chunk's padding rows sit past max_len.  The port clamps those
    rows' position ids (their outputs are never read) and matches
    generate(); the JAX kernel path gathers NaN embeddings there
    (jnp.take fills out-of-range rows) and its 0 x NaN in the chunk's
    P.V product turns the lane's logits to NaN (ROADMAP.md queue C)."""
    (jmod, jparams), model = learned_models
    rng = np.random.default_rng(0)
    a = rng.integers(0, 16, size=13).astype(np.int32)
    b = np.concatenate([a[:12], rng.integers(0, 16, size=18).astype(
        np.int32)])                            # 30 tokens: 12 reused
    eng = SlotEngine(model, num_slots=1, prefill_pad=8, kv_block=4,
                     prefix_cache_blocks=8, device="cpu")
    out = [_drive_items(eng, [(0, x, 0.0, 0, 2, hash_chain(x, 4))])[0]
           for x in (a, b)]
    assert eng.alloc.prefix_hit_blocks == 3
    ref = [np.asarray(jax_generate(jmod, jparams, jnp.asarray(x)[None],
                                   2))[0, len(x):].tolist() for x in (a, b)]
    assert out == ref


def _drive_items(eng, items):
    out = {it[0]: [] for it in items}
    budget = {it[0]: it[4] for it in items}
    for slot, tok in eng.start_batch(items).items():
        if tok is not None:
            out[slot].append(tok)
    while eng.num_occupied:
        for slot, tok in eng.advance_prefill().items():
            out[slot].append(tok)
        if eng.num_active:
            for slot, toks in eng.decode_auto()[1].items():
                out[slot].extend(toks)
        for slot in list(out):
            if eng.occupied[slot] and len(out[slot]) >= budget[slot]:
                out[slot] = out[slot][:budget[slot]]
                eng.evict(slot)
    return out


def test_engine_knob_validation(rope_models):
    """The JAX engine's arms outside the kernel configuration build and
    serve a request (the dense cache, the gather decode, the teacher-forced
    prefill, the unfused sampling tail) with the stream ``generate()``
    gives; the serving mesh (1x2, folded onto the CPU) serves it too; the
    kernel arms raise without a pool, as the JAX
    engine's do; the fused RoPE+QKV arm and the tied-draft speculative
    engine build."""
    (jmod, jparams), model = rope_models
    prompt, max_new = _prompt(11, 5), 5
    want = np.asarray(jax_generate(jmod, jparams, jnp.asarray(prompt)[None],
                                   max_new))[0, len(prompt):].tolist()
    for kw in (dict(paged=False), dict(attn_kernel="gather"),
               dict(prefill_kernel=False), dict(sample_kernel=False)):
        eng = SlotEngine(model, num_slots=2, prefill_pad=8, kv_block=4,
                         device="cpu", **kw)
        assert _drive_items(eng, [(1, prompt, 0.0, 0, max_new)]) == {
            1: want}, kw
        assert eng.kv_stats()["paged"] is kw.get("paged", True)
    eng = SlotEngine(model, num_slots=2, kv_block=4, device="cpu",
                     prefill_pad=8, mesh="1x2")
    assert _drive_items(eng, [(1, prompt, 0.0, 0, max_new)]) == {1: want}
    assert eng.spmd_stats()["mesh"] == {"data": 1, "model": 2}
    for kw in (dict(attn_kernel="paged"), dict(prefill_kernel=True)):
        with pytest.raises(ValueError, match="requires paged=True"):
            SlotEngine(model, num_slots=2, device="cpu", paged=False, **kw)
    eng = SlotEngine(model, num_slots=2, kv_block=4, device="cpu",
                     fused_rope=True)
    assert eng.kv_stats()["fused_rope"] is True
    eng = SlotEngine(model, num_slots=2, kv_block=4, device="cpu",
                     spec_draft=1)
    assert eng.spec_stats()["enabled"] is True


# ---------------------------------------------------------------------------
# (f) sampling streams


def test_sampled_stream_same_alone_and_beside_neighbours(rope_models):
    """A sampled request's stream is keyed by (seed, count) only: the same
    alone in a 1-slot engine and in a 3-slot engine beside other sampled
    and greedy requests (different slots, block sizes and batch-mates)."""
    _, model = rope_models
    target = (_prompt(10, 21), 9)
    alone = SlotEngine(model, num_slots=1, prefill_pad=8, kv_block=4,
                       decode_block=2, device="cpu")
    a = _drive(alone, [target], temperature=0.9, seed=100)[0]
    crowd = SlotEngine(model, num_slots=3, prefill_pad=8, kv_block=4,
                       decode_block=8, device="cpu")
    reqs = [(_prompt(4, 22), 8), target, (_prompt(7, 23), 5)]
    b = _drive(crowd, reqs, temperature=0.9, seed=99)[1]
    assert a == b
    assert len(set(a)) > 1


def test_philox_stream_is_per_request():
    u = philox_uniform(torch.tensor([1, 1, 2]), torch.tensor([0, 1, 0]), 10)
    assert u.shape == (3, 10) and bool(((u > 0) & (u < 1)).all())
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    again = philox_uniform(torch.tensor([2]), torch.tensor([0]), 10)
    assert torch.equal(again[0], u[2])


# ---------------------------------------------------------------------------
# (d) the server


def test_server_end_to_end_on_cpu(rope_models, jax_streams):
    _, model = rope_models
    cfg = ServeConfig(max_new=4, kv_int8=True, **ENGINE_KW)
    server = InferenceServer(model, cfg, device="cpu").start()
    try:
        reqs = _reqs()
        handles = [server.submit(p, max_new=n) for p, n in reqs]
        with pytest.raises(AdmissionError, match="budget_exceeded"):
            server.submit(_prompt(30, 0), max_new=8)
        for h in handles:
            assert h.wait(60)
        ref = jax_streams("rope", True)
        for rid, h in enumerate(handles):
            assert h.finish_reason == "length"
            assert h.tokens == ref[rid]
            assert h.ttft_s is not None
        st = server.stats()
        assert st["completed"] == len(reqs)
        assert st["kv"]["blocks_in_use"] == 0
        assert st["launch_counts"] == {
            "paged_attention": 0, "paged_prefill": 0, "fused_sample": 0,
            "flash_forward": 0, "flash_backward_dq": 0,
            "flash_backward_dkv": 0, "fused_rope_qkv": 0, "lora_delta": 0,
            "fused_residual_prep": 0, "fused_mlp": 0}
    finally:
        assert server.close(30)


def test_server_without_device_needs_cuda(rope_models, monkeypatch):
    """No CUDA and no ``device="cpu"``: construction raises, nothing falls
    back to the CPU."""
    _, model = rope_models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(model, ServeConfig(num_slots=2, kv_block=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_transformer(0, **BASE)


def test_serve_config_from_env(monkeypatch):
    monkeypatch.setenv("TPUDIST_SERVE_KV_INT8", "1")
    monkeypatch.setenv("TPUDIST_SERVE_SLOTS", "8")
    monkeypatch.setenv("TPUDIST_SERVE_ATTN_KERNEL", "gather")
    cfg = ServeConfig.from_env()
    assert cfg.kv_int8 and cfg.num_slots == 8 and cfg.paged
    assert cfg.attn_kernel == "gather"  # the gather decode on the pool


# the JAX ServeConfig.from_env variables with no port yet, and the
# ROADMAP.md queue A item each raises with
UNPORTED_ENV = {"AUTO": "8"}
# knobs that raised until their subsystem was ported: each case now holds
# the knob read — the server attribute it sets, or the ServeConfig field
# it sets, compared with the JAX ServeConfig.from_env's reading of the
# same value
PORTED_ENV = {"HEALTH_STALE_S": "health_stale_s"}
PORTED_CONFIG_ENV = {
    "HOST_TIER": ("host_tier", "1"), "PREEMPT": ("preempt", "0"),
    "SHED": ("shed", "1"), "SHED_ATTAINMENT": ("shed_attainment", "0.75"),
    "SHED_PRIORITY": ("shed_priority", "0"),
    "FAIR_SHARE": ("fair_share", "1.5"),
    "HANDOFF": ("handoff", "serial"), "HANDOFF_QUEUE": ("handoff_queue", "3"),
    "DECODE_WORKERS": ("decode_workers", "2"),
    "PREFILL_WORKERS": ("prefill_workers", "3"),
    "PREFILL_SLOTS": ("prefill_slots", "2"), "RECOVER": ("recover", "0"),
    "POOL_RESIZE": ("pool_resize", "4")}


@pytest.mark.parametrize("suffix", sorted(
    list(UNPORTED_ENV) + list(PORTED_CONFIG_ENV)) + sorted(PORTED_ENV))
def test_serve_config_from_env_refuses_unported_knobs(monkeypatch, request,
                                                      suffix):
    """Each knob the port cannot honour raises, naming itself and its
    ROADMAP item, instead of building a server that ignores it; a knob
    ported since is read instead (the graceful-degradation and the
    disaggregation knobs as the JAX ``ServeConfig.from_env`` reads
    them)."""
    name = f"TPUDIST_SERVE_{suffix}"
    if suffix in PORTED_ENV:
        monkeypatch.setenv(name, "7.5")
        _, model = request.getfixturevalue("rope_models")
        server = InferenceServer(model, ServeConfig.from_env(),
                                 device="cpu")
        assert getattr(server, PORTED_ENV[suffix]) == 7.5
        return
    if suffix in PORTED_CONFIG_ENV:
        from tpudist.serve import ServeConfig as JaxServeConfig

        field, value = PORTED_CONFIG_ENV[suffix]
        default = getattr(ServeConfig(), field)
        monkeypatch.setenv(name, value)
        got = getattr(ServeConfig.from_env(), field)
        assert got == getattr(JaxServeConfig.from_env(), field)
        assert got != default
        return
    monkeypatch.setenv(name, "1")
    with pytest.raises(NotImplementedError,
                       match=rf"{name} .*queue A item "
                             rf"{UNPORTED_ENV[suffix]}\b"):
        ServeConfig.from_env()


@pytest.mark.parametrize("name,value,field", [
    ("TPUDIST_HOST_TIER_BYTES", "4096", "host_tier_bytes"),
    ("TPUDIST_HOST_TIER_TTL_S", "2.5", "host_tier_ttl_s")])
def test_serve_config_from_env_reads_host_tier_budget(monkeypatch, name,
                                                      value, field):
    """The host tier's byte budget and idle TTL are read as the JAX server
    reads them (unset: 1 GiB and no expiry)."""
    from tpudist.serve import ServeConfig as JaxServeConfig

    monkeypatch.delenv(name, raising=False)
    assert getattr(ServeConfig.from_env(), field) == getattr(
        JaxServeConfig.from_env(), field)
    monkeypatch.setenv(name, value)
    got = getattr(ServeConfig.from_env(), field)
    assert got == getattr(JaxServeConfig.from_env(), field) == type(got)(
        value)


@pytest.mark.parametrize("name,value", [
    ("TPUDIST_SERVE_MESH", "2x1"), ("TPUDIST_SERVE_TP_OVERLAP", "ring")])
def test_serve_config_from_env_reads_mesh_knobs(monkeypatch, name, value):
    """The serving-mesh knobs (they raised before the port had the serving
    mesh) are read as the JAX server reads them: the same ``mesh`` /
    ``tp_overlap`` fields and the same ``mesh_config()``."""
    from tpudist.serve import ServeConfig as JaxServeConfig

    for var in [n for n in os.environ if n.startswith("TPUDIST_SERVE_")]:
        monkeypatch.delenv(var)
    monkeypatch.setenv(name, value)
    got, want = ServeConfig.from_env(), JaxServeConfig.from_env()
    assert (got.mesh, got.tp_overlap) == (want.mesh, want.tp_overlap)
    mine, theirs = got.mesh_config(), want.mesh_config()
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert (mine.shape, mine.tp_overlap, mine.dims) == (
            theirs.shape, theirs.tp_overlap, theirs.dims)


@pytest.mark.parametrize("name,value,field,want", [
    ("TPUDIST_SERVE_CONSTRAIN", "1", "constrain", True),
    ("TPUDIST_SERVE_LOGPROBS", "5", "logprobs", 5),
    ("TPUDIST_CONSTRAIN_BLOCKS", "6", "constrain_blocks", 6),
    ("TPUDIST_CONSTRAIN_STATES", "128", "constrain_states", 128)])
def test_serve_config_from_env_reads_structured_output_knobs(
        monkeypatch, name, value, field, want):
    """The structured-output knobs are read as the JAX server reads them
    (they raised before the port had the subsystem)."""
    monkeypatch.setenv(name, value)
    assert getattr(ServeConfig.from_env(), field) == want


def test_serve_config_from_env_without_unported_knobs(monkeypatch):
    """Unset or empty, the unported knobs change nothing: the config is
    the defaults'.  The port reads or refuses every ``TPUDIST_SERVE_*``
    variable of the JAX server module."""
    import inspect
    import os
    import re

    from tpudist.serve import server as jax_server

    for name in [n for n in os.environ if n.startswith("TPUDIST_SERVE_")]:
        monkeypatch.delenv(name)
    assert ServeConfig.from_env() == ServeConfig()
    for suffix in UNPORTED_ENV:
        monkeypatch.setenv(f"TPUDIST_SERVE_{suffix}", "")
    assert ServeConfig.from_env() == ServeConfig()
    names = lambda obj: set(re.findall(  # noqa: E731
        r"TPUDIST_SERVE_(\w+)", inspect.getsource(obj)))
    # HEALTH_STALE_S is read at construction, as in JAX
    read = (names(ServeConfig.from_env)
            | names(InferenceServer._init_observability))
    assert names(jax_server) - read == set(UNPORTED_ENV)


@pytest.mark.parametrize("env,want", [
    ({"TPUDIST_SERVE_PAGED": "0"},
     dict(paged=False, attn_kernel="gather", prefill_kernel=False)),
    ({"TPUDIST_SERVE_ATTN_KERNEL": "gather"},
     dict(paged=True, attn_kernel="gather", prefill_kernel=True)),
    ({"TPUDIST_SERVE_PREFILL_KERNEL": "0"},
     dict(paged=True, attn_kernel="paged", prefill_kernel=False)),
    ({"TPUDIST_SERVE_SAMPLE_KERNEL": "0"},
     dict(paged=True, attn_kernel="paged", sample_kernel=False))],
    ids=["paged", "attn_kernel", "prefill_kernel", "sample_kernel"])
def test_server_from_env_on_the_jax_default_knobs(rope_models, monkeypatch,
                                                  env, want):
    """Each knob the JAX server defaults off starts the port's server from
    ``ServeConfig.from_env()`` and serves; ``PAGED=0`` alone takes the
    dense arms, as the JAX server's defaults are."""
    (jmod, jparams), model = rope_models
    for name in [n for n in os.environ if n.startswith("TPUDIST_SERVE_")]:
        monkeypatch.delenv(name)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = ServeConfig.from_env()
    assert {k: getattr(cfg, k) for k in want} == want
    cfg = dataclasses.replace(cfg, max_new=4, **ENGINE_KW)
    server = InferenceServer(model, cfg, device="cpu").start()
    try:
        h = server.submit(_prompt(10, 3), max_new=4)
        assert h.wait(60) and h.finish_reason == "length"
    finally:
        server.close()
    ref = jax_generate(jmod, jparams, jnp.asarray(_prompt(10, 3))[None], 4)
    assert h.tokens == np.asarray(ref)[0, 10:].tolist()
    kv = server.stats()["kv"]
    assert {k: kv[k] for k in want} == want


@pytest.mark.parametrize("key,value,item", [
    ("tenant", "acme", "8"), ("session", "s1", "8")])
def test_submit_refuses_unported_keywords(rope_models, key, value, item):
    """The JAX ``submit`` keywords are taken (both raised before their
    subsystems were ported).  ``tenant``'s label rides on the request and
    into the ``/statusz`` in-flight count; ``session`` rides on the request
    as the host tier's key, and the default admits as before."""
    _, model = rope_models
    server = InferenceServer(model, ServeConfig(max_new=4, **ENGINE_KW),
                             device="cpu")
    if key == "tenant":
        h = server.submit(_prompt(5, 0), tenant=value)
        assert h.request.tenant == value and not h.done
        assert server._statusz_doc()["tenants_in_flight"] == {value: 1}
        assert server.close(30)
        return
    h = server.submit(_prompt(5, 0), **{key: value})
    assert h.request.session == value and not h.done
    h0 = server.submit(_prompt(5, 0), **{key: None})
    assert h0.request.session is None
    assert server.scheduler.pending() == 2 and not h0.done
    assert server.close(30)


@pytest.mark.parametrize("key,value", [
    ("grammar", "[!-#]{2}"), ("json_schema", {"enum": ["!!", "##"]}),
    ("stop", [[3, 4], 5]), ("logprobs", 2)])
def test_submit_takes_structured_output_keywords(rope_models, key, value):
    """``grammar=``, ``json_schema=``, ``stop=`` and ``logprobs=`` are
    taken (they raised before the port had structured output): the request
    queues with its compiled grammar, stop sequences or logprobs width."""
    _, model = rope_models
    server = InferenceServer(model, ServeConfig(
        max_new=4, constrain=True, constrain_states=32, logprobs=3,
        **ENGINE_KW), device="cpu")
    h = server.submit(_prompt(5, 0), eos_id=1, **{key: value})
    assert server.scheduler.pending() == 1 and not h.done
    req = h.request
    if key in ("grammar", "json_schema"):
        assert req.grammar.source["kind"] == ("regex" if key == "grammar"
                                              else "json_schema")
    else:
        assert (req.stop, req.logprobs) == (
            ((3, 4), (5,)), 0) if key == "stop" else ((), 2)
    assert server.close(30)


def test_demo_entry_point_runs_on_cpu(capsys):
    import json

    from tpudist_torch.serve.__main__ import main

    assert main(["--device", "cpu", "--requests", "3", "--max-new", "4",
                 "--max-len", "32", "--d-model", "32"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device"] == "cpu"
    assert [r["reason"] for r in report["requests"]] == ["length"] * 3
