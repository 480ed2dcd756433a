"""The slot engine's dense, gather and unfused arms in the port
(``tpudist_torch/models/generate.py``, ``models/paged.py``,
``serve/engine.py``) against the JAX package on the CPU.

For every arm — the dense slot cache (``paged=False``), the gather decode
over a native and an int8 pool (``attn_kernel="gather"``), the gather
decode beside the paged prefill kernel, the paged decode kernel beside the
teacher-forced prefill — the port's ``SlotEngine`` greedy streams EQUAL the
JAX ``SlotEngine``'s at the same knobs over a churn harness (evict and
re-admit, prompts chunked past ``prefill_pad``), for RoPE and learned
positions: bit for bit, the tolerance is none.  Both of the port's sampling
tails (``sample_kernel`` True and False) give those streams, and byte-
identical sampled streams too.  The JAX engine computes in f32 on the CPU
like the port, so no near tie has parted the two; a test that met one
would show it as an inequality here.
"""

import jax
import numpy as np
import pytest
import torch

from tpudist.models import create_transformer as jax_create
from tpudist.serve import SlotEngine as JaxSlotEngine
from torch_cases import settled_torch_cpu
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.serve import SlotEngine

BASE = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_len=32)
ENGINE_KW = dict(num_slots=2, prefill_pad=8, kv_block=4, decode_block=2)

#: the arms: knobs both engines take (the JAX engine's kernel knobs off
#: unless named: its defaults are the dense arms)
ARMS = {
    "dense": dict(paged=False),
    "gather": dict(paged=True, attn_kernel="gather", prefill_kernel=False),
    "gather-int8": dict(paged=True, attn_kernel="gather",
                        prefill_kernel=False, kv_int8=True),
    "gather-prefill-kernel": dict(paged=True, attn_kernel="gather",
                                  prefill_kernel=True),
    "paged-teacher-forced": dict(paged=True, attn_kernel="paged",
                                 prefill_kernel=False),
}


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
def models():
    memo = {}

    def get(pos):
        if pos not in memo:
            memo[pos] = _models(rope=pos == "rope")
        return memo[pos]

    return get


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(0, 16, size=plen).astype(
        np.int32)


def _reqs():
    return [(_prompt(3, 0), 4), (_prompt(5, 1), 6),
            (_prompt(12, 2), 3),  # > prefill_pad 8: chunked prefill
            (_prompt(6, 3), 5), (_prompt(17, 4), 7)]


def drive(eng, requests, *, temperature=0.0, seed=0):
    """Continuous-batching churn (the JAX suite's harness): FIFO admission
    into free slots, chunked prefill, ``decode_auto``, evict on budget —
    for the JAX and the port engine alike."""
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


@pytest.mark.parametrize("arm,pos", [
    ("dense", "rope"), ("dense", "learned"), ("gather", "rope"),
    ("gather", "learned"), ("gather-int8", "rope"),
    ("gather-int8", "learned"), ("gather-prefill-kernel", "rope"),
    ("paged-teacher-forced", "learned")])
def test_engine_greedy_streams_match_jax(models, arm, pos):
    (jmod, jparams), model = models(pos)
    knobs = ARMS[arm]
    want = drive(JaxSlotEngine(jmod, jparams, **ENGINE_KW, **knobs),
                 _reqs())
    for sample_kernel in (False, True):
        eng = SlotEngine(model, **ENGINE_KW, **knobs,
                         sample_kernel=sample_kernel, device="cpu")
        assert drive(eng, _reqs()) == want, sample_kernel
        assert eng.num_occupied == 0
        if eng.alloc is not None:
            assert eng.alloc.free_blocks == eng.alloc.num_blocks
        else:  # evict zeroes the freed lanes of the dense cache
            assert not eng.cache.k.any() and not eng.cache.cursor.any()


@pytest.mark.parametrize("arm", ["dense", "gather-int8",
                                 "paged-teacher-forced"])
def test_sampled_streams_same_on_both_tails(models, arm):
    """The unfused tail draws what the fused kernel's does: sampled and
    greedy lanes side by side, the same streams byte for byte; at
    temperature 0.9 they are not the greedy ones."""
    _, model = models("rope")
    reqs = _reqs()
    streams = []
    for sample_kernel in (False, True):
        eng = SlotEngine(model, **ENGINE_KW, **ARMS[arm],
                         sample_kernel=sample_kernel, device="cpu")
        streams.append(drive(eng, reqs, temperature=0.9, seed=7))
    assert streams[0] == streams[1]
    greedy = drive(SlotEngine(model, **ENGINE_KW, **ARMS[arm],
                              device="cpu"), reqs)
    assert streams[0] != greedy


def test_gather_streams_equal_dense_streams(models):
    """An unquantized pool seen through its tables is the dense cache:
    greedy and sampled streams of the gather arm equal the dense arm's bit
    for bit (the JAX suite pins the same), in f32 and in bf16."""
    _, model = models("learned")
    bf16 = TransformerLM(**BASE, dtype=torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    for mdl in (model, bf16.requires_grad_(False)):
        for temperature in (0.0, 0.8):
            got = [drive(SlotEngine(mdl, **ENGINE_KW, **ARMS[arm],
                                    device="cpu"), _reqs(),
                         temperature=temperature, seed=3)
                   for arm in ("dense", "gather")]
            assert got[0] == got[1], (mdl.dtype, temperature)
