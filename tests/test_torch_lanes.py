"""``peek_logits``, ``export_lane`` / ``import_lane`` and ``sample`` of the
port's slot programs (``tpudist_torch/models/generate.py``), on the dense
cache, the gather arm over an int8 pool and the paged kernel arm.

- on the same engine state (an admission batch with a chunked prompt, then
  a decode block), the port's ``peek_logits`` equals the JAX program's to
  ``atol 1e-5, rtol 1e-5`` (f32 logits of ~1 magnitude, summed in other
  orders), and advances nothing; the exported lane's K/V below the cursor
  equal JAX's to ``atol 1e-5`` (int8: within one quantization step, the
  block's scale, since a K/V value at a rounding boundary may round the
  other way), its cursor and state row exactly;
- a lane exported mid-stream and imported into another engine and another
  slot continues the greedy and the sampled stream of the unbroken run bit
  for bit, on each arm and from the dense cache into the kernel arm; an
  int8 lane re-imports to the same bytes and scales (f32 compute);
- ``sample`` is the unfused tail: the greedy arg-max and the kernel tail's
  draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense import ARMS, ENGINE_KW, _models, _prompt
from tpudist.serve import SlotEngine as JaxSlotEngine
from torch_cases import settled_torch_cpu
from tpudist_torch.models.generate import sample_tail
from tpudist_torch.serve import SlotEngine

KERNEL = dict(paged=True, attn_kernel="paged", prefill_kernel=True)
LANE_ARMS = {"dense": ARMS["dense"], "gather-int8": ARMS["gather-int8"],
             "kernel": KERNEL}


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(scope="module")
def models():
    return _models(rope=True)


def _warm(eng, temperature=0.0):
    """Two lanes admitted (slot 1's prompt chunked past the pad), prefilled
    and decoded one block."""
    eng.start_batch([(0, _prompt(5, 0), temperature, 11, 12),
                     (1, _prompt(13, 1), temperature, 12, 12)])
    while eng.prefilling_slots():
        eng.advance_prefill()
    eng.decode_block()


def _jax_lane_kv(lane):
    """``(k, v, cursor)`` of a JAX lane: ``(ks, vs, meta)`` from a pool, the
    flax cache slice ``{block_i: {k, v, idx}, pos}`` from the dense cache."""
    if isinstance(lane, tuple):
        ks, vs, meta = lane
        return np.asarray(ks), np.asarray(vs), int(meta["block_0"]["idx"])
    names = sorted((n for n in lane if n.startswith("block_")),
                   key=lambda n: int(n.rsplit("_", 1)[1]))
    return (np.stack([np.asarray(lane[n]["k"][0]) for n in names]),
            np.stack([np.asarray(lane[n]["v"][0]) for n in names]),
            int(lane[names[0]]["idx"]))


@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_peek_and_export_match_jax(models, arm):
    (jmod, jparams), model = models
    knobs = LANE_ARMS[arm]
    jeng = JaxSlotEngine(jmod, jparams, **ENGINE_KW, **knobs,
                         sample_kernel=arm == "kernel")
    eng = SlotEngine(model, **ENGINE_KW, **knobs, device="cpu")
    _warm(jeng)
    _warm(eng)
    want = np.asarray(jeng.fns.peek_logits(jeng.state, jeng.cache))
    before = [t.clone() for t in eng.state] + [eng.cache.cursor.clone()]
    got = eng.fns.peek_logits(eng.state, eng.cache)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    after = list(eng.state) + [eng.cache.cursor]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    for slot in (0, 1):
        jlane, jrow = jeng.fns.export_lane(jeng.state, jeng.cache,
                                           jnp.asarray(slot, jnp.int32))
        (k, v, cur), row = eng.fns.export_lane(eng.state, eng.cache, slot)
        jk, jv, jcur = _jax_lane_kv(jlane)
        assert int(cur) == jcur == int(eng.pos[slot])
        atol = 1e-5
        if eng.paged_cfg is not None and eng.paged_cfg.quantized:
            atol = float(max(eng.cache.scale_k.max(),
                             eng.cache.scale_v.max()))
        for a, b in ((k, jk), (v, jv)):
            np.testing.assert_allclose(a[:, :, :jcur].numpy(),
                                       b[:, :, :jcur], atol=atol, rtol=0)
        for name in ("last_tok", "active", "pos", "counts", "temps",
                     "adapter_id", "gidx", "gstate"):
            assert np.array_equal(getattr(row, name).numpy(),
                                  np.asarray(getattr(jrow, name))), name


def _adopt(src, slot, dst, dslot):
    """Export ``slot`` of engine ``src`` and install it in ``dslot`` of
    engine ``dst`` (a paged ``dst`` reserves the lane's footprint first),
    with the host shadows the continuation needs."""
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


def _finish(eng):
    """Decode every lane to its budget → ``slot → tokens``."""
    out = {}
    while eng.num_active:
        for s, toks in eng.decode_block()[1].items():
            out.setdefault(s, []).extend(toks)
            if eng.counts[s] >= eng.budget[s]:
                eng.evict(s)
    return out


@pytest.mark.parametrize("src_arm,dst_arm", [
    ("dense", "dense"), ("gather-int8", "gather-int8"),
    ("kernel", "kernel"), ("dense", "kernel")])
def test_export_import_continues_the_stream(models, src_arm, dst_arm):
    _, model = models
    for temperature in (0.0, 0.9):
        src = SlotEngine(model, **ENGINE_KW, **LANE_ARMS[src_arm],
                         device="cpu")
        _warm(src, temperature)
        dst = SlotEngine(model, **dict(ENGINE_KW, num_slots=3),
                         **LANE_ARMS[dst_arm], device="cpu")
        for slot, dslot in ((0, 2), (1, 0)):
            _adopt(src, slot, dst, dslot)
        unbroken, moved = _finish(src), _finish(dst)
        assert moved == {2: unbroken[0], 0: unbroken[1]}, temperature
        if dst.alloc is not None:
            assert dst.alloc.free_blocks == dst.alloc.num_blocks


def test_int8_lane_reimports_to_the_same_bytes(models):
    _, model = models
    eng = SlotEngine(model, **dict(ENGINE_KW, num_slots=3),
                     **ARMS["gather-int8"], device="cpu")
    _warm(eng)
    _adopt(eng, 1, eng, 2)
    kv, bs = eng.cache, eng.paged_cfg.block_size
    n = -(-int(eng.pos[1]) // bs)
    src, dst = kv.table[1, :n].long(), kv.table[2, :n].long()
    assert not set(src.tolist()) & set(dst.tolist())
    for pool in (kv.pool_k, kv.pool_v, kv.scale_k, kv.scale_v):
        assert torch.equal(pool[:, src], pool[:, dst])


def test_sample_program_is_the_unfused_tail(models):
    _, model = models
    eng = SlotEngine(model, **dict(ENGINE_KW, num_slots=4),
                     **ARMS["dense"], device="cpu")
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(4, model.vocab, generator=gen) * 3
    seeds = torch.tensor([5, 6, 7, 8])
    temps = torch.tensor([0.0, 0.7, 0.0, 1.3])
    counts = torch.tensor([0, 3, 9, 1], dtype=torch.int32)
    got = eng.fns.sample(logits, seeds, temps, counts)
    assert got.dtype == torch.int32
    assert torch.equal(got, sample_tail(logits, seeds, temps, counts)[0])
    assert got[[0, 2]].tolist() == logits[[0, 2]].argmax(-1).tolist()
