"""The port's ring attention (``tpudist_torch.parallel``) against the JAX
package's ``tpudist.parallel.ring_attention``, on the CPU at a small size
(b 2, h 4 and GQA h_kv 2, seq 32–64, dh 16, f32; inputs from numpy under a
seed).

- The plain carry body against JAX ``make_ring_attention(kernel="xla")``
  and the kernel body (the flash kernels' plain versions here) against
  ``kernel="flash", interpret=True``, both on a 4-device ``seq`` mesh of the
  suite's virtual CPU devices, the port on a :class:`LocalRing` of 4:
  causal, non-causal, windows 6 and 20, GQA and ``inner_block`` 4.  Outputs
  and q/k/v gradients at ``atol 2e-5``, the JAX tests' own bound.
- ``zigzag_indices`` equal to JAX's; the zigzag ring (both bodies) and the
  zigzag loss against JAX's.
- :class:`SeqLayout`: tokens and temporal targets of every shard, the loss
  scale that makes the mean over the ranks the global mean.
- :class:`ProcessGroupRing` at world 4 over gloo (``tests/torch_launch.py``),
  as data 1 × seq 4 and data 2 × seq 2: every rank's shard of the outputs
  and gradients equal to the :class:`LocalRing`'s at ``rtol 1e-6`` (the
  same launches; the gradients of K/V summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpudist.models.transformer import lm_loss as jax_lm_loss
from tpudist.parallel import make_ring_attention as jax_ring
from tpudist.parallel import make_zigzag_lm_loss as jax_zigzag_loss
from tpudist.parallel import make_zigzag_ring_attention as jax_zigzag_ring
from tpudist.parallel import zigzag_indices as jax_zigzag_indices
from tpudist.runtime.mesh import AXIS_SEQ
from torch_cases import settled_torch_cpu
from torch_launch import REPO, launch_ranks, torchrun_envs
from torch_ring_worker import CASES, SEQ, run_case
from tpudist_torch.models.transformer import lm_loss
from tpudist_torch.parallel import (LocalRing, SeqLayout,
                                    attention_reference,
                                    make_ring_attention, make_zigzag_lm_loss,
                                    make_zigzag_ring_attention,
                                    zigzag_indices)

N = 4
ATOL = 2e-5  # tests/test_parallel.py's bound on the ring against dense


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(scope="module")
def seq_mesh():
    return Mesh(np.asarray(jax.devices()[:N]), axis_names=(AXIS_SEQ,))


def _qkv(seq, kv=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 4, seq, 16)).astype(np.float32)
    k = rng.normal(size=(2, kv, seq, 16)).astype(np.float32)
    v = rng.normal(size=(2, kv, seq, 16)).astype(np.float32)
    g = rng.normal(size=(2, 4, seq, 16)).astype(np.float32)
    return q, k, v, g


def _jax_run(fn, q, k, v, g):
    """Output and ``(dq, dk, dv)`` of ``sum(fn(q, k, v) · g)``."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_run(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _hold(got, want, atol=ATOL):
    np.testing.assert_allclose(got[0], want[0], atol=atol, rtol=atol,
                               err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=atol, rtol=atol, err_msg=name)


# (causal, window, inner_block, kv heads, seq)
RING_CASES = {
    "causal": (True, None, None, 4, 64),
    "full": (False, None, None, 4, 64),
    "window 6": (True, 6, None, 4, 32),
    "window 20, gqa": (True, 20, None, 2, 64),
    "gqa": (True, None, None, 2, 64),
    "inner_block 4": (True, None, 4, 4, 64),
}


@pytest.mark.parametrize("kernel", ["xla", "flash"])
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_equals_jax_ring(seq_mesh, kernel, case):
    """Each body against its JAX twin on the same inputs, forward and
    backward (the flash body's gradients run through the lse cotangent of
    every merge)."""
    causal, window, inner, kv, seq = RING_CASES[case]
    q, k, v, g = _qkv(seq, kv, seed=len(case))
    jfn = jax_ring(seq_mesh, causal=causal, kernel=kernel,
                   interpret=kernel == "flash", window=window,
                   inner_block=inner)
    pfn = make_ring_attention(LocalRing(N), causal=causal, kernel=kernel,
                              window=window, inner_block=inner)
    assert pfn.supports_gqa and pfn.window == window
    _hold(_port_run(pfn, q, k, v, g), _jax_run(jfn, q, k, v, g))


def test_ring_against_dense_and_its_checks():
    """The kernel body equals the dense reference (the window's early stop
    included: 6 inside a shard of 16 stops the ring after one hop); the
    checks of the JAX body raise alike."""
    q, k, v, g = _qkv(64, seed=3)
    ring = LocalRing(N)
    for window in (None, 6, 40):
        got = make_ring_attention(ring, causal=True, kernel="flash",
                                  window=window)(*map(torch.from_numpy,
                                                      (q, k, v)))
        want = attention_reference(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="inner_block 5 must divide"):
        make_ring_attention(ring, causal=True, inner_block=5)(*t)
    with pytest.raises(ValueError, match="inner_block 5 must divide"):
        make_ring_attention(ring, causal=True, inner_block=5,
                            kernel="flash")(*t)
    with pytest.raises(ValueError, match="window requires causal"):
        make_ring_attention(ring, window=4)
    with pytest.raises(ValueError, match="auto|xla|flash"):
        make_ring_attention(ring, kernel="pallas")
    with pytest.raises(ValueError, match="equal seq shards"):
        make_ring_attention(ring, causal=True)(*(x[:, :, :62] for x in t))


@pytest.mark.parametrize("seq,n", [(8, 1), (16, 2), (64, 4), (96, 8),
                                   (48, 3)])
def test_zigzag_indices_equal_jax(seq, n):
    np.testing.assert_array_equal(zigzag_indices(seq, n),
                                  np.asarray(jax_zigzag_indices(seq, n)))
    with pytest.raises(ValueError, match="half-chunks"):
        zigzag_indices(seq + 1, n)


@pytest.mark.parametrize("kernel,kv", [("xla", 4), ("flash", 4),
                                       ("xla", 2), ("flash", 2)])
def test_zigzag_ring_equals_jax(seq_mesh, kernel, kv):
    """Both zigzag bodies against the JAX zigzag ring (plain XLA, the only
    one it has) on zigzag-ordered inputs."""
    q, k, v, g = _qkv(64, kv, seed=7)
    pi = np.asarray(jax_zigzag_indices(64, N))
    q, k, v, g = (a[:, :, pi] for a in (q, k, v, g))
    want = _jax_run(jax_zigzag_ring(seq_mesh), q, k, v, g)
    pfn = make_zigzag_ring_attention(LocalRing(N), kernel=kernel)
    assert pfn.supports_gqa and pfn.window is None
    _hold(_port_run(pfn, q, k, v, g), want)


def test_zigzag_loss_and_layout_equal_jax():
    """``make_zigzag_lm_loss`` equals JAX's on permuted logits and tokens
    and the natural-order ``lm_loss``; a :class:`SeqLayout`'s loss on the
    ring's tokens and targets equals it too, zigzag or not."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 32, (3, SEQ)).astype(np.int32)
    logits = rng.normal(size=(3, SEQ, 32)).astype(np.float32)
    pi = zigzag_indices(SEQ, N)
    want = float(jax_zigzag_loss(SEQ, N)(jnp.asarray(logits[:, pi]),
                                         jnp.asarray(tokens[:, pi])))
    natural = float(jax_lm_loss(jnp.asarray(logits), jnp.asarray(tokens)))
    got = float(make_zigzag_lm_loss(SEQ, N)(torch.from_numpy(logits[:, pi]),
                                            torch.from_numpy(tokens[:, pi])))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, natural, rtol=1e-6)
    for zigzag in (False, True):
        layout = SeqLayout(LocalRing(N), SEQ, zigzag=zigzag)
        toks, targets = layout.place(tokens)
        np.testing.assert_array_equal(toks, tokens[:, layout.positions])
        assert layout.loss_scale == 1.0
        order = pi if zigzag else np.arange(SEQ)
        loss = layout.loss(torch.from_numpy(logits[:, order]),
                           torch.from_numpy(targets))
        np.testing.assert_allclose(float(loss), natural, rtol=1e-6)
    assert float(lm_loss(torch.from_numpy(logits),
                         torch.from_numpy(tokens))) == pytest.approx(
                             natural, rel=1e-6)


class _Place:
    """A ring place of a ring spanning ranks (the layout reads these)."""

    def __init__(self, index, size):
        self.size, self.indices, self.processes = size, (index,), size


@pytest.mark.parametrize("zigzag", [False, True])
def test_layout_shards_and_scales_sum_to_the_global_mean(zigzag):
    """Each rank of a 4-rank ring holds its shard of the tokens with their
    temporal successors (the next shard's first token on a shard's last,
    −1 at the final position); the rank losses, scaled by the global
    target count and averaged over the 4 ranks, give the global mean."""
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 32, (2, SEQ)).astype(np.int32)
    logits = rng.normal(size=(2, SEQ, 32)).astype(np.float32)
    order = zigzag_indices(SEQ, N) if zigzag else np.arange(SEQ)
    losses, seen = [], []
    for s in range(N):
        layout = SeqLayout(_Place(s, N), SEQ, zigzag=zigzag)
        pos = layout.positions
        np.testing.assert_array_equal(pos, order[s * 8:(s + 1) * 8])
        toks, targets = layout.place(tokens)
        np.testing.assert_array_equal(toks, tokens[:, pos])
        want = np.where(pos + 1 < SEQ, tokens[:, np.minimum(pos + 1,
                                                            SEQ - 1)], -1)
        np.testing.assert_array_equal(targets, want)
        seen += list(pos)
        losses.append(float(layout.loss(torch.from_numpy(logits[:, pos]),
                                        torch.from_numpy(targets))))
    assert sorted(seen) == list(range(SEQ))
    natural = float(lm_loss(torch.from_numpy(logits),
                            torch.from_numpy(tokens)))
    np.testing.assert_allclose(np.mean(losses), natural, rtol=1e-6)
    with pytest.raises(ValueError, match="divide over the 4 seq shards"):
        SeqLayout(LocalRing(N), 30)
    with pytest.raises(ValueError, match="row batch"):
        SeqLayout(LocalRing(N), SEQ).place(tokens[:, :16])


@pytest.mark.parametrize("seq", [4, 2])
def test_process_group_ring_equals_local_ring(tmp_path, seq):
    """World 4 over gloo, data ``4 / seq`` × seq ``seq``: every rank's shard
    of every case's output and q/k/v gradients equals the LocalRing's over
    its data row's whole sequence (``rtol 1e-6``)."""
    launch_ranks("torch_ring_worker", ["--out", str(tmp_path), "--seq",
                                       str(seq)], REPO / "tests",
                 torchrun_envs(4))
    for rank in range(4):
        got = np.load(tmp_path / f"rank{rank}.npz")
        d, s = int(got["data"]), int(got["seq"])
        assert (d, s) == divmod(rank, seq)
        cols = slice(s * SEQ // seq, (s + 1) * SEQ // seq)
        for name in CASES:
            want = run_case(name, LocalRing(seq), d)
            for what, arr in want.items():
                np.testing.assert_allclose(
                    got[f"{name}|{what}"], arr[:, :, cols], rtol=1e-6,
                    atol=1e-7, err_msg=f"rank {rank} {name} {what}")


def test_merge_equals_jax_merge_and_masked_rows_stay_empty():
    """``_merge_partials`` (``logaddexp`` weights) against the JAX merge
    (max, exp, sum, log, divide) on rows where either partial, both or
    neither is fully masked (lse −1e30, out 0): outputs and lse at ``atol
    2e-6``; a row masked in both stays out 0, lse −1e30, and a row masked
    in one takes the other's partial unchanged."""
    from tpudist.parallel.ring_attention import (
        _merge_partials as jax_merge)
    from tpudist_torch.parallel.ring_attention import (_MASK_VALUE,
                                                       _merge_partials)

    rng = np.random.default_rng(11)
    out_c, out_h = (rng.standard_normal((2, 3, 6, 8)).astype(np.float32)
                    for _ in range(2))
    lse_c, lse_h = (rng.normal(0, 4, (2, 3, 6)).astype(np.float32)
                    for _ in range(2))
    for out, lse, rows in ((out_c, lse_c, [0, 1]), (out_h, lse_h, [1, 2])):
        lse[:, :, rows] = _MASK_VALUE
        out[:, :, rows] = 0
    ins = (out_c, lse_c, out_h, lse_h)
    got = _merge_partials(*map(torch.from_numpy, ins))
    want = jax_merge(*map(jnp.asarray, ins))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)
    assert bool((got[0][:, :, 1] == 0).all())
    assert bool((got[1][:, :, 1] == np.float32(_MASK_VALUE)).all())
    np.testing.assert_array_equal(got[0][:, :, 0].numpy(), out_h[:, :, 0])
    np.testing.assert_array_equal(got[0][:, :, 2].numpy(), out_c[:, :, 2])


@pytest.mark.parametrize("band", [(None, -40), (None, None), (0, None),
                                  (10, 40), (-20, 24), (0, 8)])
def test_band_live_extent_counts_the_live_rows_and_keys(band):
    """``chip_smoke.band_live_extent`` (what a banded hop's bound counts as
    read) equals the rows and keys with a live pair in the band's mask."""
    from chip_smoke import band_live_extent
    from tpudist_torch.ops.flash_attention import _band_mask

    keep = _band_mask(0, 64, 64, band, "cpu")
    assert band_live_extent(64, 64, band) == (int(keep.any(1).sum()),
                                               int(keep.any(0).sum()))
