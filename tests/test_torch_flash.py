"""The port's flash attention (tpudist_torch/ops/flash_attention.py) against
the JAX package's Pallas kernels in interpret mode.

The same numpy inputs (seeded) go through ``tpudist.ops.flash_attention_with
_lse(..., interpret=True)`` — as tests/test_ops.py runs it — and through the
port's CPU path (the plain versions the wrappers run for CPU tensors).
Shapes: b 2, s 128, dh 64, blocks 64, f32.  Tolerances are the JAX suite's
own (tests/test_ops.py): forward out and lse within atol/rtol 2e-5 (the two
sides share the -1e30 mask and the f32 softmax and differ only in summation
order); gradients within atol/rtol 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_lse)
from tpudist.parallel.ring_attention import (
    attention_reference as jax_attention_reference)
from torch_cases import settled_torch_cpu
from tpudist_torch.ops import (FlashAttention, flash_attention,
                               flash_attention_with_lse, flash_backward_dkv,
                               flash_backward_dq, flash_forward,
                               launch_counts, reset_launch_counts)
from tpudist_torch.ops.flash_attention import (_normalize_band,
                                               band_live_pairs)

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)

# (causal, window, heads, kv_heads, out_f32, sq, sk)
CASES = {
    "full": (False, None, 2, 2, False, 128, 128),
    "causal": (True, None, 2, 2, False, 128, 128),
    "window32": (True, 32, 2, 2, False, 128, 128),
    "band": (False, (-16, 48), 2, 2, False, 128, 128),
    "gqa": (True, None, 4, 2, False, 128, 128),
    "dead_rows": (False, (10, 40), 2, 2, False, 128, 128),
    "out_f32": (True, None, 2, 2, True, 128, 128),
    "short_q": (False, None, 2, 2, False, 64, 128),
}


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _inputs(h, h_kv, sq, sk, seed=0, b=2, d=64):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, h, sq, d)).astype(np.float32)
    k = r.normal(size=(b, h_kv, sk, d)).astype(np.float32)
    v = r.normal(size=(b, h_kv, sk, d)).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, causal, window, out_f32):
    return jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, 64, 64, True, out_f32, window)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_interpreted_kernel(case):
    causal, window, h, h_kv, out_f32, sq, sk = CASES[case]
    q, k, v = _inputs(h, h_kv, sq, sk, seed=len(case))
    out, lse = flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, 64, 64, out_f32, window)
    j_out, j_lse = _jax_flash(q, k, v, causal, window, out_f32)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **FWD_TOL)
    if case == "dead_rows":  # q < 10 sees no key: out 0, lse -1e30
        assert np.all(out.numpy()[:, :, :10] == 0)
        assert np.all(lse.numpy()[:, :, :10] == -1e30)


@pytest.mark.parametrize("case", ["causal", "window32", "band", "gqa",
                                  "dead_rows", "short_q"])
def test_gradients_match_interpreted_kernel(case):
    """d/d(q, k, v) of sum(out²) + sum(lse): the lse cotangent rides in the
    backward's delta, as in JAX's custom_vjp."""
    causal, window, h, h_kv, out_f32, sq, sk = CASES[case]
    q, k, v = _inputs(h, h_kv, sq, sk, seed=7 + len(case))

    def jax_loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, causal, 64, 64, True, out_f32,
                                 window)
        return jnp.sum(out ** 2) + jnp.sum(lse)

    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = FlashAttention.apply(*t, causal, window, out_f32, 64)
    ((out ** 2).sum() + lse.sum()).backward()
    for a, b in zip(t, j_grads):
        assert a.grad.shape == a.shape
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **GRAD_TOL)


def test_ragged_length_matches_dense_reference():
    """Any sequence length: s 100 (not a multiple of any tile) against the
    JAX dense reference, with GQA broadcast on the JAX side."""
    q, k, v = _inputs(4, 2, 100, 100, seed=3)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), True, 64, 64)
    rep = lambda t: jnp.repeat(jnp.asarray(t), 2, axis=1)  # noqa: E731
    ref = jax_attention_reference(jnp.asarray(q), rep(k), rep(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_bf16_plain_rounds_at_the_kernel_cast_points():
    """bf16 inputs: outputs in bf16, lse f32, grads in the input dtypes, and
    close to the f32 computation on the same (bf16-rounded) values."""
    q, k, v = [torch.from_numpy(a).bfloat16()
               for a in _inputs(2, 1, 128, 128, seed=4)]
    out, lse = flash_attention_with_lse(q, k, v, True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    out32, lse32 = flash_attention_with_lse(q.float(), k.float(), v.float(),
                                            True)
    # p rounded to bf16 (2**-9 relative) and the output rounded: a few
    # bf16 steps of max|v| ~ 4
    assert float((out.float() - out32).abs().max()) < 0.05
    torch.testing.assert_close(lse, lse32, atol=1e-5, rtol=1e-5)
    qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, _ = flash_attention_with_lse(*qs, True)
    out.float().square().sum().backward()
    assert [t.grad.dtype for t in qs] == [torch.bfloat16] * 3
    assert qs[1].grad.shape == k.shape


def test_band_normalization_and_live_pairs():
    assert _normalize_band(True, None) == (0, None)
    assert _normalize_band(False, None) == (None, None)
    assert _normalize_band(True, 8) == (0, 8)
    assert _normalize_band(False, (-3, 5)) == (-3, 5)
    for bad in [(True, (0, 4)), (False, 8), (True, 0), (False, (4, 4))]:
        with pytest.raises(ValueError):
            _normalize_band(*bad)
    s = 128
    assert band_live_pairs(s, s, (0, None)) == s * (s + 1) // 2
    assert band_live_pairs(s, s, (None, None)) == s * s
    assert band_live_pairs(s, s, (0, 32)) == 32 * 33 // 2 + (s - 32) * 32


def test_cpu_tensors_count_no_launch_and_other_devices_raise():
    reset_launch_counts()
    q, k, v = [torch.from_numpy(a) for a in _inputs(2, 2, 64, 64)]
    out, lse = flash_forward(q, k, v, (0, None))
    delta = torch.zeros_like(lse)
    flash_backward_dq(q, k, v, out, lse, delta, (0, None))
    flash_backward_dkv(q, k, v, out, lse, delta, (0, None))
    counts = launch_counts()
    assert counts["flash_forward"] == counts["flash_backward_dq"] == \
        counts["flash_backward_dkv"] == 0
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError):
        flash_forward(*meta, (0, None))
