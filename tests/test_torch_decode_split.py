"""The paged decode's split walk and the two new arms' launch plans.

``_decode_split_reference`` (``tpudist_torch.ops.paged_attention``) is the
plain model of the split walk's schedule in ``csrc/paged_attention.cu``:
each lane's table cut into spans, each span's (m, l, acc) under the hard
-1e30 mask, the window columns in the split of the prefix's end, the
partials merged by logsumexp.  It is held, on seeded numpy inputs, against
``paged_attention_reference`` and the JAX ``tpudist.ops.paged_attention``
(the Pallas kernel in interpret mode and its reference): S 4, n_kv 2, group
1 and 4, s 1 and 5, dh 32, KV block 4, table width 16 and spans of 2
blocks, with an empty lane (pos0 0), partial blocks, sentinel table tails,
a sliding window that masks whole early spans, and an int8 pool.

Tolerances: f32 within ``atol 1e-5, rtol 1e-5`` (the same f32 math, summed
in another order), over int8 pools ``atol 5e-5`` as in
tests/test_torch_ops.py (dequantized magnitudes reach ~25, and the sums'
rounding scales with them, not with the output); bf16 within
``chip_smoke.close_bf16``'s bound (the split walk rounds each span's
unnormalized probabilities to bf16, the plain version the normalized
weights).

The plans (pure Python; the kernels run on the card in
tests/test_torch_cuda.py): which arm ``_fwd_arm`` and ``_decode_arm`` give
each dtype and head dim, and shared memory within the 227 KB one H100 CTA
may use.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import close_bf16, v_max
from torch_cases import decode_case, settled_torch_cpu
from tpudist.ops.paged_attention import (paged_attention as jax_paged,
                                         paged_attention_reference as
                                         jax_paged_reference)
from tpudist_torch.ops import _build
from tpudist_torch.ops.flash_attention import (FWD_WGMMA_KEYS,
                                               FWD_WGMMA_ROWS,
                                               FWD_WGMMA_STAGES, _bwd_arm,
                                               _fwd_arm, fwd_wgmma_smem)

pa = importlib.import_module("tpudist_torch.ops.paged_attention")

BF16, F32 = torch.bfloat16, torch.float32
# spans of 2 blocks of 4 keys over a 16-block table: 8 splits a lane
SIZE = dict(S=4, n_kv=2, dh=32, L=2, nb=80, bs=4, M=16)
SPAN = 2 * SIZE["bs"]
TOL = dict(atol=1e-5, rtol=1e-5)
TOL_INT8 = dict(atol=5e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _case(group, s, quant, seed, fill_max=2):
    return decode_case(nh=SIZE["n_kv"] * group, s=s, quant=quant, seed=seed,
                       fill_max=fill_max, **SIZE)


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("group", [1, 4])
def test_split_model_matches_plain_and_jax(group, s, quant, window):
    args = _case(group, s, quant, seed=10 * group + s + 100 * quant)
    assert args[6][0] == 0  # an empty lane
    assert any(p % SIZE["bs"] for p in args[6])  # a partial block
    assert (args[5] == SIZE["nb"]).any()  # sentinel table tails
    kw = dict(layer=1, window=window)
    tol = TOL_INT8 if quant else TOL
    out = pa._decode_split_reference(*_torch(args), split_keys=SPAN,
                                     **kw).numpy()
    np.testing.assert_allclose(
        out, pa.paged_attention_reference(*_torch(args), **kw).numpy(),
        **tol)
    np.testing.assert_allclose(
        out, np.asarray(jax_paged_reference(*_jax(args), **kw)), **tol)
    if window is None:  # the slow leg: the Pallas kernel interpreted
        np.testing.assert_allclose(
            out, np.asarray(jax_paged(*_jax(args), interpret=True, **kw)),
            **tol)


def test_the_lanes_span_several_splits():
    """The inputs exercise the merge: lanes whose prefix spans several
    splits, one whose prefix ends on a span boundary (the window then has a
    split of its own) and the empty lane (one split: the window's)."""
    args = _case(1, 1, False, seed=7)
    args[6][:] = [0, SPAN, 3 * SPAN + 1, SIZE["M"] * SIZE["bs"] - 1]
    parts = pa._decode_split_partials(*_torch(args), layer=0,
                                      split_keys=SPAN)
    assert [len(p) for p in parts] == [1, 2, 4, 8]
    np.testing.assert_allclose(
        pa._decode_split_reference(*_torch(args), layer=0,
                                   split_keys=SPAN).numpy(),
        pa.paged_attention_reference(*_torch(args), layer=0).numpy(), **TOL)


@pytest.mark.parametrize("s", [1, 5])
def test_dead_spans_weigh_zero_in_the_merge(s):
    """A sliding window that passes over early spans leaves them without a
    live key: m = -1e30 there and p = 1 on every masked key, so their l and
    acc are large.  The merge gives them weight exp(m - max m) = 0; weight 1
    instead (the planted fault chip_smoke phase 3 must catch) moves the
    output far past the tolerance."""
    args = _case(2, s, False, seed=20 + s)
    args[6][:] = [0, 3 * SPAN + 3, 5 * SPAN, 7 * SPAN + 2]
    kw = dict(layer=1, window=3)
    want = pa.paged_attention_reference(*_torch(args), **kw)
    lanes = pa._decode_split_partials(*_torch(args), split_keys=SPAN, **kw)
    dead = 0
    faulty = []
    for parts in lanes:
        dead += sum(int((p[0] <= -5e29).sum()) for p in parts)
        for p in parts:
            assert bool((p[1] > 0).all())  # every live split sums some p
        m = torch.stack([p[0] for p in parts])
        w = torch.where(m <= -5e29, torch.ones_like(m),
                        torch.exp(m - m.amax(dim=0)))
        lsum = (w * torch.stack([p[1] for p in parts])).sum(dim=0)
        acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(dim=0)
        faulty.append(acc / lsum[..., None])
    assert dead > 0  # whole early spans are dead
    got = torch.stack([pa._merge_split_partials(p) for p in lanes])
    np.testing.assert_allclose(got.reshape(want.shape).numpy(),
                               want.numpy(), **TOL)
    bad = torch.stack(faulty).reshape(want.shape)
    assert float((bad - want).abs().max()) > 0.1


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("group,s", [(1, 1), (4, 5)])
def test_split_model_bf16_within_close_bf16(group, s, quant):
    args = _torch(_case(group, s, quant, seed=30 + s, fill_max=3))
    for i in (0, 8, 9):  # q and the window in bf16
        args[i] = args[i].to(BF16)
    if not quant:
        args[1], args[2] = args[1].to(BF16), args[2].to(BF16)
    for window in (None, 5):
        kw = dict(layer=0, window=window)
        out = pa._decode_split_reference(*args, split_keys=SPAN, **kw)
        ref = pa.paged_attention_reference(*args, **kw)
        assert out.dtype == BF16
        close_bf16(torch, out, ref, v_max(args[2], args[4], args[9]))


# ------------------------------------------------------------------ the plans


class _T:  # a tensor's dtype and last dim, all the arm choices read
    def __init__(self, dtype, dh=None):
        self.dtype, self.shape = dtype, (1, 1, 1, dh)


@pytest.mark.parametrize("dtype,dh,arm", [
    (BF16, 128, "wgmma"), (BF16, 64, "wgmma"), (BF16, 32, "mma"),
    (BF16, 16, "mma"), (F32, 128, "f32"), (F32, 64, "f32"), (F32, 16, "f32")])
def test_fwd_arm_by_dtype_and_head_dim(dtype, dh, arm):
    assert _fwd_arm(_T(dtype, dh)) == arm
    assert _bwd_arm(_T(dtype, dh)) == arm  # the backward's arms alike


@pytest.mark.parametrize("dh", [64, 128])
def test_fwd_wgmma_shared_memory_fits(dh):
    """Two [64, dh] Q tiles, the ring's [128, dh] K and V tiles and 2 KB
    for the barriers and alignment, within one CTA's shared memory."""
    smem = fwd_wgmma_smem(dh)
    assert smem == (2 * 64 + 2 * FWD_WGMMA_STAGES[dh] * 128) * dh * 2 + 2048
    assert 0 < smem <= pa.SMEM_LIMIT == 227 * 1024
    assert FWD_WGMMA_STAGES[dh] >= 2  # a stage loads under each product


def test_fwd_plan_constants_match_the_kernel_source():
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert re.search(rf"constexpr int kWgKeys = {FWD_WGMMA_KEYS};", src)
    assert re.search(r"constexpr int kConsumers = 2;", src)
    assert f"return D == 128 ? {FWD_WGMMA_STAGES[128]} : " \
        f"{FWD_WGMMA_STAGES[64]};" in src
    assert FWD_WGMMA_ROWS == 2 * 64
    assert "constexpr int kWgThreads = (kConsumers + 1) * 128;" in src
    assert "((size_t)kConsumers * kWgRows + 2 * stages * kWgKeys) * D *" \
        in src


@pytest.mark.parametrize("q,pool,dh,arm", [
    (BF16, BF16, 128, "tc"), (BF16, torch.int8, 128, "tc"),
    (BF16, BF16, 64, "tc"), (BF16, torch.int8, 32, "tc"),
    (BF16, BF16, 16, "tc"), (BF16, F32, 128, "cc"), (F32, F32, 128, "cc"),
    (F32, torch.int8, 128, "cc"), (BF16, F32, 48, "cc"),
    (BF16, BF16, 8, "cc"), (BF16, BF16, 48, "tc"),
    (BF16, torch.int8, 80, "tc"), (BF16, BF16, 96, "tc"),
    (BF16, torch.int8, 112, "tc"), (BF16, BF16, 40, "cc"),
    (BF16, BF16, 256, "cc")])
def test_decode_arm_by_dtype_and_head_dim(q, pool, dh, arm):
    assert pa._decode_arm(_T(q), _T(pool), dh) == arm


# (arm, R = group * s, head dim, KV block, table width): the serving shapes
# (s 1, 5 and 9, MHA and GQA 8/2), the card tests' and the CPU tests' tiny
# ones
USED = [("tc", 1, 128, 16, 128), ("tc", 5, 128, 16, 128),
        ("tc", 36, 128, 16, 128), ("tc", 8, 32, 16, 8),
        ("tc", 2, 16, 16, 8), ("tc", 20, 64, 16, 8),
        ("cc", 1, 128, 16, 128), ("cc", 36, 128, 16, 128),
        ("cc", 4, 32, 4, 16), ("cc", 8, 8, 4, 8), ("tc", 1, 80, 16, 128),
        ("tc", 5, 112, 16, 128), ("cc", 8, 256, 16, 128)]


@pytest.mark.parametrize("arm,R,dh,bs,M", USED)
def test_decode_shared_memory_fits_every_case_in_use(arm, R, dh, bs, M):
    plan = pa._decode_plan(arm, R, dh, bs, M)
    assert plan.arm == arm
    assert 0 < plan.smem <= pa.SMEM_LIMIT == 227 * 1024
    pa._check_smem(plan, dh, bs)
    if arm == "tc":
        assert plan.rows == pa.TC_ROWS
        assert plan.splits == -(-M * bs // pa.SPLIT_KEYS)
        assert plan.smem == max(4 * 2 * 2 * 16 * (dh + 8) * 2,
                                4 * (dh // 2 + 4) * 32 * 4)
    else:
        assert plan.rows == min(R, pa.CC_ROWS) and plan.splits == 1


def test_decode_check_smem_raises_where_the_plan_does_not_fit():
    plan = pa._decode_plan("cc", 16, 512, 512, 4)
    assert plan.smem > pa.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        pa._check_smem(plan, 512, 512)
    with pytest.raises(ValueError, match="shared memory"):
        pa._check_smem(pa.DecodePlan("tc", 16, 1, pa.SMEM_LIMIT + 1), 128,
                       16)


def test_decode_plan_constants_match_the_kernel_source():
    src = (_build.CSRC / "paged_attention.cu").read_text()
    for name, value in (("kKeys", pa.TC_KEYS), ("kSplitKeys", pa.SPLIT_KEYS),
                        ("kWarps", pa.TC_WARPS), ("kBufs", pa.TC_BUFS),
                        ("kRows", pa.TC_ROWS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    common = (_build.CSRC / "paged_common.cuh").read_text()
    assert re.search(rf"constexpr int kRowsPerCta = {pa.CC_ROWS};", common)
