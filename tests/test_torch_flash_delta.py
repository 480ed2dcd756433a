"""The port's delta-forming dq entry (``flash_backward_dq_delta``) against
the JAX package, and the backward without materialised zero cotangents.

The same seeded numpy inputs go through the JAX side — the forward in
interpret mode (``flash_attention_with_lse(..., interpret=True)``), then
``_bwd``'s delta ``sum(out·g) − g_lse`` and ``_flash_backward(...,
interpret=True)`` — and through the port's CPU path (the plain versions the
wrappers run for CPU tensors), fed the JAX forward's ``out`` and ``lse``.
Shapes: b 2, s 128, dh 64, blocks 64, f32, a non-zero lse cotangent.
Tolerances are tests/test_torch_flash.py's: the delta within 2e-5 (one f32
row sum of 64 products in another order), dq within the gradient
tolerance atol/rtol 5e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops.flash_attention import (_flash_backward,
                                         flash_attention_with_lse)
from torch_cases import settled_torch_cpu
from tpudist_torch.ops import FlashAttention, flash_backward_dq_delta
from tpudist_torch.ops.flash_attention import _normalize_band

DELTA_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)

# (causal, window, heads, kv heads)
CASES = {
    "causal": (True, None, 2, 2),
    "gqa": (True, None, 4, 2),
    "band": (False, (-16, 48), 2, 2),
    "dead_rows": (False, (10, 40), 2, 2),
}


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _inputs(h, h_kv, seed, b=2, s=128, d=64):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, h, s, d)).astype(np.float32)
    k = r.normal(size=(b, h_kv, s, d)).astype(np.float32)
    v = r.normal(size=(b, h_kv, s, d)).astype(np.float32)
    g = r.normal(size=(b, h, s, d)).astype(np.float32)
    g_lse = r.normal(size=(b, h, s)).astype(np.float32)
    return q, k, v, g, g_lse


@pytest.mark.parametrize("case", list(CASES))
def test_dq_delta_matches_jax_backward(case):
    """Delta equals JAX ``_bwd``'s ``sum(out·g) − g_lse`` and dq equals the
    interpreted ``_flash_backward`` on that delta."""
    causal, window, h, h_kv = CASES[case]
    q, k, v, g, g_lse = _inputs(h, h_kv, seed=11 + len(case))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = flash_attention_with_lse(jq, jk, jv, causal, 64, 64, True,
                                        False, window)
    j_delta = jnp.sum(out * jnp.asarray(g), axis=-1) - jnp.asarray(g_lse)
    j_dq = _flash_backward(jq, jk, jv, jnp.asarray(g), lse, j_delta,
                           causal=causal, block_q=64, block_k=64,
                           interpret=True, window=window)[0]
    t = [torch.from_numpy(np.array(a))
         for a in (q, k, v, g, lse, out, g_lse)]
    dq, delta = flash_backward_dq_delta(*t, _normalize_band(causal, window))
    assert delta.dtype == torch.float32 and delta.shape == lse.shape
    np.testing.assert_allclose(delta.numpy(), np.asarray(j_delta),
                               **DELTA_TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(j_dq), **GRAD_TOL)
    if case == "dead_rows":  # q < 10 sees no key: its dq is 0
        assert np.all(dq.numpy()[:, :, :10] == 0)


@pytest.mark.parametrize("unused", ["lse", "out"])
def test_unused_output_takes_no_zero_cotangent(unused):
    """With ``set_materialize_grads(False)`` an output the loss does not
    use reaches the backward as ``None``: the gradients equal those of the
    same loss with that output's explicit zero cotangent, bit for bit."""
    q, k, v, _, _ = _inputs(4, 2, seed=5)
    grads = []
    for explicit in (False, True):
        t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out, lse = FlashAttention.apply(*t, True, None, False, 64)
        loss = (out ** 2).sum() if unused == "lse" else lse.sum()
        if explicit:
            loss = loss + 0.0 * (lse if unused == "lse" else out).sum()
        loss.backward()
        grads.append([a.grad for a in t])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
