"""The port's fused toy-MLP forward (tpudist_torch/ops/fused_mlp.py) against
the JAX package.

On a CPU tensor the port's ``fused_mlp`` runs its plain version
(``mlp_reference``: ``x @ w + b`` and ``where``, over the true-width views
of the padded packing), held here against the JAX Pallas kernel in
interpret mode (``block_batch`` 256) and against the JAX ``mlp_reference``
on the same numpy inputs.  Both sides are f32 products summed in f32 (the
Pallas kernel at ``Precision.HIGHEST``), differing only in summation
order: ``rtol 1e-5, atol 1e-6`` on outputs of magnitude ~1 (the toy model)
and ~10 (the 128-wide case, whose 128-term sums round about 2**-24 ·
sqrt(128) relative each).  The CUDA kernel against the plain version on
the card is in tests/test_torch_cuda.py.

The CUDA kernel's launch plan (``_mlp_plan``: arm, rows a thread, rows a
CTA, grid, shared memory) and the struct that carries it are pure Python
and held here too, with the constants they share with
``csrc/fused_mlp.cu``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models.toy_mlp import create_toy_model as jax_toy_model
from tpudist.ops.fused_mlp import fused_mlp as jax_fused_mlp
from tpudist.ops.fused_mlp import mlp_reference as jax_mlp_reference
from tpudist.ops.fused_mlp import pad_params
from torch_cases import settled_torch_cpu
from tpudist_torch.bench import bench_fused_mlp
from tpudist_torch.models import create_toy_model
from tpudist_torch.ops import (fused_mlp, launch_counts, mlp_reference,
                               pack_params, reset_launch_counts,
                               unpack_params)
from tpudist_torch.ops import _build
from tpudist_torch.ops.fused_mlp import (ACT_LD, ALL_FLOATS, DIMS_CAP,
                                         H100_SMS, LANE, MAX_THREADS,
                                         SMALL_MAX, SMALL_ROWS, W_LAYER,
                                         MlpLaunch, MlpPlan, _launch_struct,
                                         _mlp_plan, pad2)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _toy_weights():
    p = jax_toy_model(jax.random.PRNGKey(0))[1]["params"]
    return [(np.array(p[f"dense_{i}"]["kernel"]),
             np.array(p[f"dense_{i}"]["bias"])) for i in range(len(p))]


def _wide_weights(seed=3, width=128, depth=5):
    r = np.random.default_rng(seed)
    return [(r.normal(scale=width ** -0.5, size=(width, width))
             .astype(np.float32), r.normal(scale=0.1, size=width)
             .astype(np.float32)) for _ in range(depth)]


def _x(batch, d_in, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, d_in)).astype(np.float32)


def _port(x, weights):
    packed = pack_params([(torch.from_numpy(w), torch.from_numpy(b))
                          for w, b in weights])
    return fused_mlp(torch.from_numpy(x), packed).numpy()


def _jax(x, weights, interpret):
    jw = [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights]
    if interpret:
        padded, _, d_out = pad_params(jw)
        return np.asarray(jax_fused_mlp(jnp.asarray(x), padded, d_out,
                                        block_batch=256, interpret=True))
    return np.asarray(jax_mlp_reference(jnp.asarray(x), jw))


@pytest.mark.parametrize("case,batch", [("toy", 256), ("toy", 512),
                                        ("toy", 1024), ("wide", 256)])
def test_fused_mlp_matches_interpreted_kernel(case, batch):
    """The toy weights (JAX ``create_toy_model`` at key 0) at the bench's
    block of 256 and multiples; five 128-wide layers from a numpy seed."""
    weights = _toy_weights() if case == "toy" else _wide_weights()
    x = _x(batch, weights[0][0].shape[0])
    got = _port(x, weights)
    assert got.shape == (batch, weights[-1][0].shape[1])
    np.testing.assert_allclose(got, _jax(x, weights, interpret=True), **TOL)
    np.testing.assert_allclose(got, _jax(x, weights, interpret=False), **TOL)


def test_ragged_batch_matches_reference():
    """A batch of 1000 (the JAX kernel's grid needs block_batch to divide
    the batch and raises; the port takes any batch): against the JAX
    ``mlp_reference`` alone."""
    weights = _toy_weights()
    x = _x(1000, 2, seed=1)
    np.testing.assert_allclose(_port(x, weights),
                               _jax(x, weights, interpret=False), **TOL)
    with pytest.raises(ValueError):
        _jax(x, weights, interpret=True)


def test_pack_params_round_trips():
    """Packing keeps every weight bit for bit at its true width, each width
    zero-padded to an even number (the buffer holds sum(pad2(d_in) ·
    pad2(d_out) + pad2(d_out)) floats, rounded up to a multiple of 4, and
    every padded entry is 0), the table the true widths, and unpacking
    gives the true-width layers back as views of the buffer."""
    for weights in (_toy_weights(), _wide_weights(depth=2),
                    _width_weights((3, 17, 5, 1))):
        tw = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in weights]
        packed = pack_params(tw)
        widths = (weights[0][0].shape[0],) + tuple(w.shape[1]
                                                   for w, _ in weights)
        assert packed.widths == widths
        assert packed.table.tolist() == list(widths)
        assert packed.table.dtype == torch.int32
        sizes = [pad2(a) * pad2(b) + pad2(b)
                 for a, b in zip(widths[:-1], widths[1:])]
        assert packed.max_layer_floats == max(sizes)
        assert packed.params.numel() == sum(sizes) + (-sum(sizes)) % 4
        unpacked = unpack_params(packed)
        for (w, b), (pw, pb) in zip(tw, unpacked):
            assert torch.equal(w, pw) and torch.equal(b, pb)
            assert pw.data_ptr() >= packed.params.data_ptr()
        # the padding is exact zeros: clearing the true-width views clears
        # the whole buffer
        with torch.no_grad():
            for pw, pb in unpacked:
                pw.zero_()
                pb.zero_()
        assert not packed.params.any()


def test_pad2():
    assert [pad2(w) for w in (1, 2, 9, 10, 17, 33, 127, 128)] == \
        [2, 2, 10, 10, 18, 34, 128, 128]


TOY = (2, 10, 10, 10, 10, 1)


@pytest.mark.parametrize("batch,r,threads,rows,blocks", [
    (1, 1, 32, 1, 1), (256, 1, 32, 2, 128), (1000, 1, 32, 8, 125),
    (4096, 1, 32, 32, 128), (16384, 1, 128, 125, 132),
    (70001, 4, 128, 512, 137), (1 << 20, 4, 128, 512, 2048)])
def test_plan_toy_spreads_rows_over_the_card(batch, r, threads, rows,
                                             blocks):
    """The toy model on the register-blocked arm: up to the rows that fill
    the card four warps deep, one row a thread and ``batch / 132`` rows a
    CTA, rounded up (32 at the bench's 4096, one warp), so the grid spreads
    over the SMs from 132 rows up; past that, 4 rows a thread in CTAs of
    128 threads."""
    plan = _mlp_plan(TOY, batch)
    x_tiles = 2 * rows * 2 if r > 1 else 0  # two tiles' x at R > 1
    assert plan == MlpPlan("small", 16, r, threads, rows, blocks,
                           4 * (384 + x_tiles))
    assert plan.blocks == -(-batch // plan.rows_per_cta)
    assert plan.rows_per_cta <= plan.threads * plan.rows
    if r == 1:
        assert plan.rows_per_cta == min(MAX_THREADS, -(-batch // H100_SMS))


@pytest.mark.parametrize("widths,arm,cn", [
    ((2, 16, 1), "small", 16), ((2, 15, 1), "small", 16),
    ((2, 17, 1), "small", 32), ((2, 32, 5), "small", 32),
    ((2, 33, 1), "wide", LANE), ((128,) * 6, "wide", LANE),
    ((1, 1), "small", 16), ((100, 3), "wide", LANE)])
def test_plan_arm_by_padded_width(widths, arm, cn):
    """Padded widths up to 16 and 32 take the register-blocked arm at those
    bounds, anything wider the tiled arm; 17 and 33 cross the arms."""
    plan = _mlp_plan(widths, 5000)
    assert (plan.arm, plan.cn) == (arm, cn)
    assert plan.rows in (SMALL_ROWS[cn] if arm == "small" else (4, 8))


@pytest.mark.parametrize("batch,tm", [(1, 4), (4096, 4), (8384, 4),
                                      (8385, 8), (1 << 16, 8)])
def test_plan_wide_tiles(batch, tm):
    """The tiled arm takes 64-row tiles where they give every SM a CTA
    (past 131 · 64 = 8384 rows), else 32, and sizes its shared memory for two
    activation tiles and two staged layers (at most 227 KB)."""
    plan = _mlp_plan((128,) * 6, batch)
    rows = 8 * tm
    assert plan == MlpPlan("wide", LANE, tm, MAX_THREADS, rows,
                           -(-batch // rows),
                           4 * (2 * rows * ACT_LD + 2 * W_LAYER))
    assert plan.smem <= 227 * 1024


def test_plan_small_shared_memory_past_48k():
    """Past ``ALL_FLOATS`` packed floats the register-blocked arm stages
    one layer at a time: 40 layers of width 32 (the CUDA tests' deep
    case) need one layer's share, not the whole buffer."""
    widths = (4,) + (32,) * 40 + (3,)
    sizes = [pad2(a) * pad2(b) + pad2(b) for a, b in zip(widths[:-1],
                                                         widths[1:])]
    assert sum(sizes) > ALL_FLOATS
    assert _mlp_plan(widths, 3000).smem == 4 * max(sizes)
    assert _mlp_plan((2, 33, 1), 3000).arm == "wide"


@pytest.mark.parametrize("widths,batch", [
    (TOY, 4096), ((128,) * 6, 1 << 16), ((4,) + (32,) * 40 + (3,), 3000)])
def test_launch_struct_carries_the_plan(widths, batch):
    """The struct the kernel reads holds the plan, the packed buffer's
    sizes and the first ``DIMS_CAP + 1`` true widths (zero past a shorter
    net); it is laid out as the kernel's ``MlpLaunch``: two 64-bit fields,
    nine ints, ``DIMS_CAP + 1`` widths."""
    weights = [(torch.zeros(a, b), torch.zeros(b))
               for a, b in zip(widths[:-1], widths[1:])]
    packed = pack_params(weights)
    plan = _mlp_plan(widths, batch)
    got = _launch_struct(packed, batch, H100_SMS)
    assert (got.batch, got.blocks, got.n_layers, got.arm, got.cn, got.r,
            got.threads, got.rows_per_cta, got.total_floats, got.w_floats,
            got.smem) == (batch, plan.blocks, len(widths) - 1,
                          int(plan.arm == "wide"), plan.cn, plan.rows,
                          plan.threads, plan.rows_per_cta,
                          packed.params.numel(), packed.max_layer_floats,
                          plan.smem)
    cap = list(widths[:DIMS_CAP + 1])
    assert list(got.widths) == cap + [0] * (DIMS_CAP + 1 - len(cap))
    assert ctypes.sizeof(MlpLaunch) == 16 + 9 * 4 + (DIMS_CAP + 1) * 4
    assert packed.launch_cache == {}  # filled by the CUDA path only


def test_plan_constants_match_the_kernel_source():
    """The arm bound, the staging limit, the CTA size, the tile stride and
    layer, the by-value width capacity and the instantiated (bound, rows)
    pairs are the kernel's."""
    import re

    src = (_build.CSRC / "fused_mlp.cu").read_text()
    assert re.search(rf"constexpr int kSmallMax = {SMALL_MAX};", src)
    assert re.search(rf"constexpr int kAllFloats = {ALL_FLOATS};", src)
    assert re.search(rf"constexpr int kMaxThreads = {MAX_THREADS};", src)
    assert re.search(rf"constexpr int kLane = {LANE};", src)
    assert re.search(rf"constexpr int kDimsCap = {DIMS_CAP};", src)
    fields = re.search(r"struct MlpLaunch \{(.*?)\};", src, re.S).group(1)
    assert " ".join(fields.split()) == (
        "long long batch, blocks; int n_layers, arm, cn, r, threads, "
        "rows_per_cta, total_floats, w_floats, smem; "
        "int widths[kDimsCap + 1];")
    assert [f[0] for f in MlpLaunch._fields_] == [
        "batch", "blocks", "n_layers", "arm", "cn", "r", "threads",
        "rows_per_cta", "total_floats", "w_floats", "smem", "widths"]
    assert "constexpr int kActLd = kLane + 4;" in src and ACT_LD == LANE + 4
    assert "constexpr int kWLayer = kLane * kLane + kLane;" in src
    pairs = set(re.findall(r"TPD_SMALL\((\d+), (\d+)\)\n", src))
    assert pairs == {(str(cn), str(r)) for cn, rs in SMALL_ROWS.items()
                     for r in rs}
    assert set(re.findall(r"launch_wide<(\d+)>\(", src)) == {"4", "8"}


def _width_weights(widths, seed=5):
    r = np.random.default_rng(seed)
    return [(r.normal(scale=a ** -0.5, size=(a, b)).astype(np.float32),
             r.normal(scale=0.1, size=b).astype(np.float32))
            for a, b in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("widths,batch", [
    ((2, 10, 10, 10, 10, 1), 1), ((5, 7), 256), ((2, 17, 1), 256),
    ((2, 33, 1), 256), ((3,) + (9,) * 8 + (2,), 512)],
    ids=["toy batch 1", "one layer", "width 17", "width 33", "9 layers"])
def test_edge_shapes_match_interpreted_kernel(widths, batch):
    """The CUDA tests' edge shapes (batch 1, a one-layer MLP, widths 17 and
    33 either side of the arms' bound, 9 layers) through the port's plain
    path against the interpreted Pallas kernel and the JAX reference."""
    weights = _width_weights(widths)
    x = _x(batch, widths[0], seed=len(widths))
    got = _port(x, weights)
    assert got.shape == (batch, widths[-1])
    np.testing.assert_allclose(got, _jax(x, weights, interpret=True), **TOL)
    np.testing.assert_allclose(got, _jax(x, weights, interpret=False), **TOL)


def test_deep_narrow_matches_reference():
    """40 layers of width 32 (past the kernel's by-value widths and its
    48 KB staging): against the JAX reference."""
    widths = (4,) + (32,) * 40 + (3,)
    weights = _width_weights(widths)
    x = _x(300, 4, seed=9)
    np.testing.assert_allclose(_port(x, weights),
                               _jax(x, weights, interpret=False), **TOL)


def test_toy_model_packs_its_own_parameters():
    """``ToyMLP.layers()`` feeds ``pack_params``: the fused forward of the
    module's own weights equals the module's forward."""
    model = create_toy_model(0, device="cpu")
    x = torch.from_numpy(_x(300, 2, seed=2))
    with torch.no_grad():
        assert torch.equal(fused_mlp(x, pack_params(model.layers())),
                           model(x))


def test_wrong_inputs_raise():
    """Widths over 128, broken chains, empty weight sets, a bias of the
    wrong length and a wrong x width raise; an empty batch returns an empty
    output; the CPU path counts no launch."""
    r = np.random.default_rng(0)

    def layer(din, dout):
        return (torch.from_numpy(r.normal(size=(din, dout)).astype(
            np.float32)), torch.zeros(dout))

    with pytest.raises(ValueError, match="128"):
        pack_params([layer(2, 129), layer(129, 1)])
    with pytest.raises(ValueError, match="128"):
        pack_params([layer(200, 10)])
    with pytest.raises(ValueError, match="previous layer"):
        pack_params([layer(2, 10), layer(9, 1)])
    with pytest.raises(ValueError, match="at least one"):
        pack_params([])
    w, b = layer(2, 3)
    with pytest.raises(ValueError):
        pack_params([(w, b[:2])])
    packed = pack_params([layer(2, 10), layer(10, 1)])
    with pytest.raises(ValueError, match=r"\[batch, 2\]"):
        fused_mlp(torch.zeros(4, 3), packed)
    reset_launch_counts()
    assert fused_mlp(torch.zeros(0, 2), packed).shape == (0, 1)
    assert mlp_reference(torch.zeros(5, 2), unpack_params(packed)).shape == \
        (5, 1)
    assert launch_counts()["fused_mlp"] == 0


def test_bench_fused_mlp_on_cpu():
    """The bench's fields, its f64 checks passed, on the CPU."""
    out = bench_fused_mlp(4096, device="cpu")
    assert out["metric"] == "toy_mlp_fused_forward_samples_per_sec"
    assert out["config"] == {"batch": 4096} and out["device"] == "cpu"
    assert out["max_rel_err_vs_f64"] <= 1e-4
    assert out["plain_rel_err_vs_f64"] <= 1e-5
    for k in ("kernel_fused", "plain_chain", "kernel_over_plain"):
        assert out[k] > 0
    assert out["kernel_calls"] >= 60
