"""The port's sampling and residual preps (tpudist_torch/ops/fused_sample.py)
at long vocabularies, against the JAX package, and a numpy model of the
CUDA kernel's filters against the plain version.

- The port's CPU path (what the wrappers run for CPU tensors) against the
  JAX Pallas kernel in interpret mode and the JAX reference, at vocab 4097
  and 50257 with the filters of the serving knobs (top-k, top-p, both),
  grammar rows on and off, tied rows, ``-inf`` entries and a NaN row: all
  outputs exact (NaN where NaN).  The residual prep at ``[2, 3, 4097]``
  within the JAX suite's tolerances.
- ``radix_select``, a numpy model of what ``csrc/fused_sample.cu`` computes
  in place of a sort: order-preserving 32-bit keys, four rounds of 8-bit
  digit histograms (counts for top-k, fixed-point softmax masses for top-p)
  over a row split into C slices whose histograms are summed, each round
  walking the bins from the top.  On rows drawn by ``hypothesis`` (ties,
  flat rows, ``-inf``, ``finfo(f32).min``, NaN) the model's kth equals the
  plain version's exactly and its top-p kept set differs only where the
  softmax mass before a value lies within ``V * 2**-23`` of ``top_p``.
- The arm plans (``_sample_arm``, ``_residual_arm``) and the constants they
  share with the kernel source, without a card.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpudist.ops.fused_sample import fused_residual_prep as jax_residual
from tpudist.ops.fused_sample import \
    fused_residual_reference as jax_residual_reference
from tpudist.ops.fused_sample import fused_sample_prep as jax_sample
from tpudist.ops.fused_sample import \
    fused_sample_reference as jax_sample_reference
from torch_cases import settled_torch_cpu, top_p_boundary_gap
from tpudist_torch.ops import (_build, fused_residual_prep, fused_sample_prep,
                               fused_sample_reference, launch_counts,
                               reset_launch_counts)
from tpudist_torch.ops.fused_sample import (CLUSTER_SIZES, MAX_CLUSTER,
                                            RESIDUAL_ROW_MAX_NV,
                                            RESIDUAL_ROW_MAX_V, SAMPLE_ARMS,
                                            SAMPLE_ROW_MAX_NV,
                                            SAMPLE_ROW_MAX_V, SAMPLE_THREADS,
                                            SLICE_CAP, WAVE_CTAS,
                                            _check_width,
                                            _residual_arm, _sample_arm)

NEG = np.finfo(np.float32).min
FILTERS = [(0, 0.0), (50, 0.0), (0, 0.9), (40, 0.95), (0, 0.3)]


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _long_case(V, seed, S=4):
    """Logits ``[S, V]`` (row 1 tied at the top-k threshold, row 2 with
    ``-inf`` entries, row 3 with a NaN), temperatures and grammar rows."""
    r = np.random.default_rng(seed)
    logits = (r.normal(size=(S, V)) * 2).astype(np.float32)
    logits[1, :60] = 4.0  # ties straddling kth at top-k 40 and 50
    logits[2, ::7] = -np.inf
    logits[3, V // 3] = np.nan
    temps = np.asarray([1.0, 0.7, 1.3, 0.0][:S], np.float32)
    gallow = r.random((2, 3, V)) > 0.4
    gallow[1] = True
    gidx = np.asarray([0, 1, 0, 1][:S], np.int32)
    gstate = np.asarray([1, 0, 2, 1][:S], np.int32)
    return [logits, temps, gallow, gidx, gstate]


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("grammar", [False, True], ids=["free", "grammar"])
@pytest.mark.parametrize("tk,tp", FILTERS)
@pytest.mark.parametrize("V", [4097, 50257])
def test_long_vocab_matches_jax(V, tk, tp, grammar):
    """Masked, scaled-and-filtered and greedy outputs EXACT against the
    interpreted Pallas kernel and the JAX reference, NaN where NaN."""
    args = _long_case(V, seed=V + tk + int(tp * 100))
    if not grammar:
        args = args[:2]
    out = fused_sample_prep(*[torch.from_numpy(np.ascontiguousarray(a))
                              for a in args], top_k=tk, top_p=tp)
    jargs = [jnp.asarray(a) for a in args]
    for ref in (jax_sample(*jargs, top_k=tk, top_p=tp, interpret=True),
                jax_sample_reference(*jargs, top_k=tk, top_p=tp)):
        for a, b in zip(out, ref):
            _assert_same(a.numpy(), b)


def test_residual_prep_long_vocab_matches_jax():
    """``[2, 3, 4097]``: ``pt``/``pd`` within the JAX suite's ``rtol 2e-6,
    atol 1e-7`` (softmax sums in another order), an empty residual row's
    logits ``lt / temp`` exact, the residual's ``exp`` within ``1e-6``."""
    r = np.random.default_rng(7)
    lt = (r.normal(size=(2, 3, 4097)) * 3).astype(np.float32)
    ld = (r.normal(size=(2, 3, 4097)) * 3).astype(np.float32)
    ld[1, 2] = lt[1, 2]  # an empty residual
    temps = np.asarray([0.7, 1.3], np.float32)
    out = [t.numpy() for t in fused_residual_prep(
        *[torch.from_numpy(a) for a in (lt, ld, temps)])]
    jargs = [jnp.asarray(a) for a in (lt, ld, temps)]
    for ref in (jax_residual(*jargs, interpret=True),
                jax_residual_reference(*jargs)):
        ref = [np.asarray(x) for x in ref]
        for a, b in zip(out[:2], ref[:2]):
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(out[2][1, 2], ref[2][1, 2])
        np.testing.assert_allclose(np.exp(out[2]), np.exp(ref[2]), rtol=0,
                                   atol=1e-6)


def test_long_vocab_filters_run_without_a_limit_on_cpu():
    """A CPU tensor at vocab 50257 with both filters runs the plain
    version (no vocab limit anywhere on the path) and counts no launch."""
    reset_launch_counts()
    lg = torch.randn(2, 50257, generator=torch.Generator().manual_seed(0))
    masked, scaled, greedy = fused_sample_prep(lg, torch.ones(2), top_k=50,
                                               top_p=0.9)
    assert launch_counts()["fused_sample"] == 0
    assert int((scaled > NEG).sum(dim=-1).max()) <= 50
    assert torch.equal(greedy.long(), lg.argmax(dim=-1))


# ---------------------------------------------------------------------------
# the kernel's selection, modelled in numpy

MASS_SCALE = 2.0 ** 26  # csrc/fused_sample.cu kMassScale


def order_keys(x):
    """The kernel's order-preserving keys of float32 ``x``: the sign bit
    flipped for a positive value, every bit for a negative one, every NaN
    the largest key."""
    u = np.asarray(x, np.float32).view(np.uint32)
    keys = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF),
                    keys).astype(np.uint32)


def key_value(key):
    key = np.uint32(key)
    u = key & np.uint32(0x7FFFFFFF) if key & np.uint32(0x80000000) else ~key
    return np.array([u], np.uint32).view(np.float32)[0]


def _slices(n, C):
    """The cluster arm's split of n values over C CTAs (``slice_of``: a
    multiple of 4 values a CTA)."""
    per = ((n + C - 1) // C + 3) & ~3
    return [slice(r * per, min(n, (r + 1) * per)) for r in range(C)]


def radix_select(keys, C, k=None, mass=None, top_p=None):
    """Four rounds of 8-bit digits over ``keys`` split into C slices whose
    histograms are summed.  With ``k``: the key of the k-th largest (count
    above < k_rem <= count through the bin).  With ``mass`` (uint64 fixed
    point) and ``top_p``: the smallest key whose mass above stays below
    ``top_p * Z`` (the lowest non-empty bin with mass above < T)."""
    prefix, k_rem, above, T = 0, k, 0, None
    for rnd in range(4):
        shift = 24 - 8 * rnd
        cnt = np.zeros(256, np.int64)
        msum = np.zeros(256, np.uint64)
        for sl in _slices(len(keys), C):
            ks = keys[sl]
            hi = 0 if rnd == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
            sel = (ks & np.uint32(hi)) == np.uint32(prefix & hi)
            digits = ((ks[sel] >> np.uint32(shift)) & np.uint32(255)).astype(
                np.int64)
            cnt += np.bincount(digits, minlength=256)
            if mass is not None:
                np.add.at(msum, digits, mass[sl][sel])
        order = np.arange(255, -1, -1)  # walk the bins from the top
        incl_c = np.cumsum(cnt[order])
        excl_c = incl_c - cnt[order]
        if mass is None:
            i = int(np.flatnonzero((excl_c < k_rem) & (k_rem <= incl_c))[0])
            k_rem -= int(excl_c[i])
        else:
            incl_m = np.cumsum(msum[order].astype(np.float64))
            excl_m = incl_m - msum[order].astype(np.float64)
            if rnd == 0:
                T = top_p * float(msum.sum())
            ok = (cnt[order] > 0) & (above + excl_m < T) & (
                (above + incl_m >= T) | (incl_c == incl_c[-1]))
            i = int(np.flatnonzero(ok)[0])
            above += excl_m[i]
        prefix |= int(order[i]) << shift
    return prefix


def model_filters(sc, top_k, top_p, C):
    """The kernel's filtered row: kth by the count select, the top-p cutoff
    by the mass select over the top-k-filtered row (the top value alone
    where the row's maximum is NaN or infinite)."""
    sc = np.asarray(sc, np.float32)
    V = sc.shape[0]
    kth = np.float32(-np.inf)
    if 0 < top_k < V:
        kth = key_value(radix_select(order_keys(sc), C, k=top_k))
    cutoff = np.float32(-np.inf)
    if 0.0 < top_p < 1.0:
        with np.errstate(invalid="ignore"):
            y = np.where(sc < kth, NEG, sc).astype(np.float32)
        m = key_value(order_keys(sc).max())
        if not np.isfinite(m):
            cutoff = m
        else:
            with np.errstate(over="ignore"):
                w = np.exp((y - m).astype(np.float32)).astype(np.float32)
            mass = np.rint(w.astype(np.float64) * MASS_SCALE).astype(
                np.uint64)
            cutoff = key_value(radix_select(order_keys(y), C, mass=mass,
                                            top_p=top_p))
    with np.errstate(invalid="ignore"):
        out = np.where(sc < kth, NEG, sc)
        out = np.where(out < cutoff, NEG, out)
    return kth, out.astype(np.float32)


_values = st.one_of(
    st.integers(-3, 3).map(float),  # ties
    st.floats(-30, 30, width=32),
    st.sampled_from([float("-inf"), float(NEG), 0.0, -0.0, 1e-30]))


@st.composite
def _rows(draw):
    V = draw(st.integers(1, 300))
    kind = draw(st.sampled_from(["mixed", "flat", "normal"]))
    if kind == "flat":
        row = np.full(V, draw(_values), np.float32)
    elif kind == "normal":
        seed = draw(st.integers(0, 2 ** 16))
        row = (np.random.default_rng(seed).normal(size=V) * 3).astype(
            np.float32)
    else:
        row = np.asarray(draw(st.lists(_values, min_size=V, max_size=V)),
                         np.float32)
    if draw(st.booleans()) and V > 1:
        row[draw(st.integers(0, V - 1))] = np.nan
    top_k = draw(st.integers(0, V + 1))
    top_p = draw(st.sampled_from([0.0, 0.3, 0.9, 0.95, 0.999, 1.0]))
    C = draw(st.sampled_from([1, 2, 4, 8, 16]))
    return row, top_k, top_p, C


@settings(max_examples=150, deadline=None, derandomize=True)
@given(_rows())
def test_radix_select_model_matches_plain(case):
    """The model's kth equals ``torch.topk``'s (NaN the largest); its kept
    set equals the plain version's but where the mass before a value lies
    within ``V * 2**-23`` of ``top_p``; kept values are exact."""
    row, top_k, top_p, C = case
    V = row.shape[0]
    sc = torch.from_numpy(row)[None]
    kth, out = model_filters(row, top_k, top_p, C)
    if 0 < top_k < V:
        want = torch.topk(sc, top_k, dim=-1).values[0, -1].item()
        assert (np.isnan(kth) and np.isnan(want)) or kth == want
    ref = fused_sample_reference(sc, torch.ones(1), top_k=top_k,
                                 top_p=top_p)[1][0].numpy()
    if 0.0 < top_p < 1.0:
        topk_row = fused_sample_reference(sc, torch.ones(1),
                                          top_k=top_k)[1].numpy()
        if not np.isfinite(key_value(order_keys(topk_row[0]).max())):
            np.testing.assert_array_equal(out, ref)  # the top value alone
            return
        masses = top_p_boundary_gap(out[None], ref[None], topk_row)
        assert np.all(np.abs(masses - top_p) <= V * 2.0 ** -23), masses
        kept = (out > NEG) & (ref > NEG)
        np.testing.assert_array_equal(out[kept], ref[kept])
    else:
        np.testing.assert_array_equal(out, ref)


def test_order_keys_sort_like_the_plain_version():
    """Sorting by key is the plain version's descending sort read
    backwards, NaN the largest, -0 just below +0."""
    x = np.asarray([3.5, -np.inf, np.nan, NEG, -0.0, 0.0, 1e-38, -2.0,
                    np.inf, -1e-45], np.float32)
    by_key = x[np.argsort(order_keys(x), kind="stable")]
    want = torch.sort(torch.from_numpy(x)).values.numpy()
    np.testing.assert_array_equal(by_key, want)
    for v in x:
        got = key_value(order_keys(np.asarray([v], np.float32))[0])
        assert (np.isnan(v) and np.isnan(got)) or (
            got == v and np.signbit(got) == np.signbit(v))


# ---------------------------------------------------------------------------
# the arm plans


@pytest.mark.parametrize("S", [1, 8, 40])
@pytest.mark.parametrize("V", [1, 17, 256, 1000, 4096, 4097, 32000, 50257,
                               128256])
def test_sample_arm_by_vocab(S, V):
    """Up to ``SAMPLE_ROW_MAX_V`` the row arm with the fewest values a
    thread that hold the row (a power of two); past it a cluster whose grid
    fits ``WAVE_CTAS`` CTAs."""
    arm, width = _sample_arm(S, V)
    if V <= SAMPLE_ROW_MAX_V:
        assert arm == "row"
        assert width * SAMPLE_THREADS >= V
        assert width == 1 or (width // 2) * SAMPLE_THREADS < V
        assert width & (width - 1) == 0
    else:
        assert arm == "cluster" and width in CLUSTER_SIZES
        assert width <= MAX_CLUSTER
        assert S * width <= WAVE_CTAS or width == CLUSTER_SIZES[0]


def test_sample_arm_at_the_main_path_and_the_long_shapes():
    """Serving's 8 slots and the verify's 40 rows at vocab 256 take the row
    arm at one value a thread; 8 rows at 32000 and 50257 take clusters of
    16 CTAs (128 CTAs on the card)."""
    assert _sample_arm(8, 256) == ("row", 1)
    assert _sample_arm(40, 256) == ("row", 1)
    assert _sample_arm(8, 32000) == ("cluster", 16)
    assert _sample_arm(8, 50257) == ("cluster", 16)
    assert _sample_arm(40, 32000) == ("cluster", 4)


@pytest.mark.parametrize("rows,V,want", [
    (32, 256, ("row", 1)), (32, 17, ("row", 1)), (6, 4097, ("cluster", 16)),
    (32, 2048, ("row", 8)), (32, 2049, ("cluster", 8)),
    (32, 32000, ("cluster", 8)), (200, 32000, ("cluster", 2))])
def test_residual_arm_by_vocab(rows, V, want):
    """The verify's ``[8, 4, V]``: a CTA a row up to
    ``RESIDUAL_ROW_MAX_V``, past it clusters sized to the grid."""
    assert _residual_arm(rows, V) == want


def test_forced_arm_widths_are_checked():
    """A forced arm must hold the row: the row arm's values a thread times
    the CTA's threads, the cluster arm one of the instantiated sizes."""
    _check_width("row", 1, 256, SAMPLE_ROW_MAX_NV, "x")
    _check_width("cluster", 8, 7, SAMPLE_ROW_MAX_NV, "x")
    for arm, width, V in (("row", 1, 257), ("row", 3, 700), ("row", 32, 10),
                          ("cluster", 32, 10), ("cluster", 3, 10),
                          ("split", 1, 10)):
        with pytest.raises(ValueError):
            _check_width(arm, width, V, SAMPLE_ROW_MAX_NV, "x")


def test_sample_constants_match_the_kernel_source():
    """The CTA's threads, the row arms' values a thread, the mass scale,
    the arm codes and the instantiated cluster sizes are the kernel's."""
    src = (_build.CSRC / "fused_sample.cu").read_text()
    for name, value in (("kThreads", SAMPLE_THREADS),
                        ("kSliceCap", SLICE_CAP),
                        ("kRowMaxNV", SAMPLE_ROW_MAX_NV),
                        ("kResRowMaxNV", RESIDUAL_ROW_MAX_NV)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(r"constexpr float kMassScale = 67108864\.f;", src)
    assert MASS_SCALE == 67108864.0
    codes = dict(re.findall(r"kArm(\w+) = (\d+)",
                            re.search(r"enum Arm[^}]*}", src).group()))
    assert {k.lower(): int(v) for k, v in codes.items()} == {
        arm: i for i, arm in enumerate(SAMPLE_ARMS)}
    for macro in ("TPD_SAMPLE", "TPD_RESIDUAL"):
        sizes = tuple(int(c) for c in re.findall(rf"{macro}\((\d+)\)\n",
                                                 src))
        assert sizes == CLUSTER_SIZES, macro
    assert RESIDUAL_ROW_MAX_V <= RESIDUAL_ROW_MAX_NV * SAMPLE_THREADS
    assert SAMPLE_ROW_MAX_V <= SAMPLE_ROW_MAX_NV * SAMPLE_THREADS
