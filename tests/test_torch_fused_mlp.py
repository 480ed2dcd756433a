"""The port's fused toy-MLP forward (tpudist_torch/ops/fused_mlp.py) against
the JAX package.

On a CPU tensor the port's ``fused_mlp`` runs its plain version
(``mlp_reference``: ``x @ w + b`` and ``where``), held here against the JAX
Pallas kernel in interpret mode (``block_batch`` 256) and against the JAX
``mlp_reference`` on the same numpy inputs.  Both sides are f32 products
summed in f32 (the Pallas kernel at ``Precision.HIGHEST``), differing only
in summation order: ``rtol 1e-5, atol 1e-6`` on outputs of magnitude ~1
(the toy model) and ~10 (the 128-wide case, whose 128-term sums round
about 2**-24 · sqrt(128) relative each).  The CUDA kernel against the plain
version on the card is in tests/test_torch_cuda.py.
"""

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
    """Packing keeps every weight bit for bit at its true width (no lane
    padding): the buffer holds sum(d_in·d_out + d_out) floats, the table
    the widths, and unpacking gives the layers back."""
    for weights in (_toy_weights(), _wide_weights(depth=2)):
        tw = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in weights]
        packed = pack_params(tw)
        widths = (weights[0][0].shape[0],) + tuple(w.shape[1]
                                                   for w, _ in weights)
        assert packed.widths == widths
        assert packed.table.tolist() == list(widths)
        assert packed.table.dtype == torch.int32
        assert packed.max_layer_floats == max(w.size + b.size
                                              for w, b in weights)
        assert packed.params.numel() == sum(w.size + b.size
                                            for w, b in weights)
        for (w, b), (pw, pb) in zip(tw, unpack_params(packed)):
            assert torch.equal(w, pw) and torch.equal(b, pb)


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
