"""The port's kernel modules (tpudist_torch/ops) against the JAX package.

Each plain PyTorch version — what a wrapper runs for a CPU tensor — is held
against the JAX Pallas kernel in interpret mode and against the JAX
``*_reference``, on the same numpy inputs.  Tolerances are the JAX suite's
own (tests/test_paged_attention.py, tests/test_kernel_family.py): the two
sides share the dequantization, the -1e30 mask and f32 score math and
differ only in summation order, so f32 pools agree within ``atol 5e-6 /
rtol 1e-5`` and int8 pools (dequantized magnitudes up to ~25) within
``atol 5e-5 / rtol 1e-5``; written int8 blocks and the fused sampling
outputs are exact.

The CUDA kernels against their plain versions on the card are in
tests/test_torch_cuda.py.  The build tests here check the nvcc/ctypes
plumbing that needs no compiler.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops.fused_sample import (fused_sample_prep as jax_sample_prep,
                                      fused_sample_reference as
                                      jax_sample_reference)
from tpudist.ops.paged_attention import (paged_attention as jax_paged,
                                         paged_attention_reference as
                                         jax_paged_reference)
from tpudist.ops.paged_prefill import (paged_prefill_attention as
                                       jax_prefill,
                                       paged_prefill_reference as
                                       jax_prefill_reference)
from torch_cases import decode_case as _decode_case
from torch_cases import prefill_case as _prefill_case
from torch_cases import sample_case, settled_torch_cpu
from tpudist_torch.ops import (_build, fused_mlp, fused_residual_prep,
                               fused_sample_prep, launch_counts, pack_params,
                               paged_attention, paged_attention_reference,
                               paged_prefill_attention, reset_launch_counts)

REPO = Path(__file__).resolve().parent.parent
TOL = {"f32": dict(atol=5e-6, rtol=1e-5), "int8": dict(atol=5e-5, rtol=1e-5)}


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _np(x):
    return np.asarray(x)


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _check_decode(args, quant, interpret=True, **kw):
    """The plain version against the JAX reference and (``interpret``) the
    Pallas kernel in interpret mode — the slow leg, run on a subset."""
    tol = TOL["int8" if quant else "f32"]
    out = _np(paged_attention(*_torch(args), **kw))
    if interpret:
        np.testing.assert_allclose(
            out, _np(jax_paged(*_jax(args), interpret=True, **kw)), **tol)
    np.testing.assert_allclose(
        out, _np(jax_paged_reference(*_jax(args), **kw)), **tol)
    np.testing.assert_allclose(
        out, _np(paged_attention_reference(*_torch(args), **kw)), **tol)


def _check_prefill(args, quant, interpret=True, **kw):
    tol = TOL["int8" if quant else "f32"]
    out = [_np(t) for t in paged_prefill_attention(*_torch(args), **kw)]
    refs = [jax_prefill_reference(*_jax(args), **kw)]
    if interpret:
        refs.append(jax_prefill(*_jax(args), interpret=True, **kw))
    for ref in refs:
        ref = [_np(t) for t in ref]
        np.testing.assert_allclose(out[0], ref[0], **tol)
        for a, b in zip(out[1:3], ref[1:3]):
            if a.dtype == np.int8:
                np.testing.assert_array_equal(a, b)  # byte-identical
            else:
                np.testing.assert_allclose(a, b, **TOL["f32"])
        for a, b in zip(out[3:], ref[3:]):
            np.testing.assert_allclose(a, b, **TOL["f32"])


class TestPagedAttention:
    @pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
    @pytest.mark.parametrize("s", [1, 4])
    def test_property_sweep(self, quant, s):
        """{f32, int8} x window s x ragged occupancy, every layer."""
        args = _decode_case(S=4, nh=4, n_kv=2, s=s, dh=8, L=2, nb=9, bs=4,
                            M=4, quant=quant, seed=s)
        for layer in range(2):
            _check_decode(args, quant, interpret=layer == 1, layer=layer)

    def test_mid_window_fill(self):
        """Decode-scan steps t > 0: the mask sees the window's earlier
        tokens (col <= fill + i)."""
        args = _decode_case(S=3, nh=4, n_kv=2, s=1, dh=8, L=2, nb=7, bs=4,
                            M=4, quant=False, seed=11, fill_max=3)
        _check_decode(args, False, layer=1)

    @pytest.mark.parametrize("n_kv", [1, 2, 4])
    def test_gqa_group_shapes(self, n_kv):
        args = _decode_case(S=2, nh=4, n_kv=n_kv, s=2, dh=8, L=1, nb=7,
                            bs=4, M=3, quant=True, seed=n_kv)
        _check_decode(args, True, interpret=n_kv == 1, layer=0)

    def test_sliding_window(self):
        args = _decode_case(S=4, nh=2, n_kv=2, s=2, dh=8, L=2, nb=9, bs=4,
                            M=4, quant=False, seed=5, fill_max=2)
        _check_decode(args, False, layer=0, window=5)


class TestPagedPrefill:
    @pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
    def test_property_sweep(self, quant):
        """Fresh lane, dead lane, partial first block, every layer; int8
        blocks byte-identical to JAX's."""
        args = _prefill_case(S=4, nh=4, n_kv=2, dh=8, L=2, nb=24, bs=4,
                             M=6, P=8, quant=quant, seed=3)
        for layer in range(2):
            _check_prefill(args, quant, interpret=layer == 1, layer=layer)

    @pytest.mark.parametrize("n_kv", [1, 2, 4])
    def test_gqa_group_shapes(self, n_kv):
        args = _prefill_case(S=3, nh=4, n_kv=n_kv, dh=8, L=1, nb=18, bs=4,
                             M=6, P=8, quant=True, seed=n_kv)
        _check_prefill(args, True, interpret=n_kv == 1, layer=0)

    def test_sliding_window(self):
        args = _prefill_case(S=3, nh=2, n_kv=2, dh=8, L=2, nb=18, bs=4,
                             M=6, P=8, quant=False, seed=7)
        _check_prefill(args, False, layer=1, window=5)


class TestFusedSample:
    def _check(self, args, **kw):
        out = [_np(t) for t in fused_sample_prep(*_torch(args), **kw)]
        for ref in (jax_sample_prep(*_jax(args), interpret=True, **kw),
                    jax_sample_reference(*_jax(args), **kw)):
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(a, _np(b))

    @pytest.mark.parametrize("tk,tp", [(0, 0.0), (5, 0.0), (0, 0.9),
                                       (7, 0.8)])
    def test_grammar_and_filters_exact(self, tk, tp):
        """Masked, scaled-and-filtered and greedy outputs are EXACT, with
        the grammar rows gathered through (gidx, gstate)."""
        self._check(sample_case(seed=tk * 10 + int(tp * 10)), top_k=tk,
                    top_p=tp)

    def test_no_grammar(self):
        self._check(sample_case(seed=9)[:2])

    def test_argmax_ties_pick_lowest_index(self):
        """Tied maxima resolve to the lowest index, as jnp.argmax."""
        logits = np.zeros((3, 16), np.float32)
        logits[0, [3, 7, 11]] = 2.0
        logits[1, [15, 0]] = 1.0
        logits[2] = 5.0
        args = [logits, np.asarray([0.0, 0.5, 2.0], np.float32)]
        self._check(args)
        greedy = _np(fused_sample_prep(*_torch(args))[2])
        assert greedy.tolist() == [3, 0, 0]


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    """A CPU tensor goes to the plain version: no kernel launch counted."""
    reset_launch_counts()
    args = _decode_case(S=2, nh=2, n_kv=1, s=1, dh=8, L=1, nb=5, bs=4, M=2,
                        quant=False, seed=0)
    paged_attention(*_torch(args), layer=0)
    fused_sample_prep(torch.zeros(2, 8), torch.zeros(2))
    fused_residual_prep(torch.zeros(2, 1, 8), torch.zeros(2, 1, 8),
                        torch.zeros(2))
    fused_mlp(torch.zeros(2, 3), pack_params([(torch.zeros(3, 4),
                                               torch.zeros(4))]))
    assert launch_counts() == {"paged_attention": 0, "paged_prefill": 0,
                               "fused_sample": 0, "flash_forward": 0,
                               "flash_backward_dq": 0,
                               "flash_backward_dkv": 0, "fused_rope_qkv": 0,
                               "lora_delta": 0, "fused_residual_prep": 0,
                               "fused_mlp": 0}


def test_build_plumbing():
    """Per-kernel source hashes cover every header, the nvcc line targets
    sm_90a without fast math, and the library lands under build/."""
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        h = _build.source_hash(name)
        assert len(h) == 16 and h == _build.source_hash(name)
        path = _build.library_path(name)
        assert path.parent == REPO / "build" / "tpudist_torch"
        assert path.name == f"{name}-{h}.so"
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert len({_build.source_hash(n) for n in _build.KERNELS}) == \
        len(_build.KERNELS) == 8
    assert [_build.dtype_code(d) for d in (torch.float32, torch.bfloat16,
                                           torch.int8)] == [0, 1, 2]
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float16)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """Nothing under tpudist_torch/ nor chip_smoke.py (nor the scripts and
    tests that run on the GPU machine) imports jax, flax or the JAX
    package."""
    files = sorted((REPO / "tpudist_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
              REPO / "tests" / "torch_flash_faults.py",
              REPO / "tests" / "torch_lm_feed.py",
              REPO / "tests" / "torch_ring_parent.py",
              REPO / "tests" / "torch_ring_worker.py",
              REPO / "tests" / "torch_fsdp_worker.py",
              REPO / "tests" / "torch_pipeline_worker.py",
              REPO / "tests" / "torch_telemetry_cost.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "tpudist"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad
