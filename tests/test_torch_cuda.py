"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device.  The module imports no JAX (only torch, numpy and tpudist_torch), so
it also runs on the GPU machine, which has none:
``python -m pytest tests/test_torch_cuda.py --noconftest`` (the suite's
conftest imports JAX).

Tolerance: in bf16 the kernel rounds the unnormalized softmax
probabilities (online softmax) where the plain version rounds the
normalized weights, a 2**-9 relative step of each weight; both then round
the output.  Outputs agree within ``2**-7 * max|V| + 2**-8 * |out|``.
Written KV blocks, their scales and the sampling outputs are exact.
"""

import numpy as np
import pytest
import torch

from torch_cases import decode_case, prefill_case, sample_case
from tpudist_torch.ops import (fused_sample_prep, fused_sample_reference,
                               launch_counts, paged_attention,
                               paged_attention_reference,
                               paged_prefill_attention,
                               paged_prefill_reference, reset_launch_counts)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _on(dev, args):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]


def _assert_bf16_close(out, ref, pool_v, scale_v, fresh_v):
    vmax = (127.0 * float(scale_v.max()) if pool_v.dtype == torch.int8
            else float(pool_v.float().abs().max()))
    vmax = max(vmax, float(fresh_v.float().abs().max()))
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2 ** -7 * vmax + 2 ** -8 * ref.float().abs()).all())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n_kv", [1, 2])
def test_paged_attention_matches_plain(cuda, quant, n_kv):
    """Ragged cursors, sentinel tails, a mid-window fill, GQA, a window."""
    args = _on(cuda, decode_case(S=4, nh=4, n_kv=n_kv, s=2, dh=128, L=2,
                                 nb=40, bs=16, M=8, quant=quant, seed=1,
                                 fill_max=3))
    for i in (0, 8, 9):  # q and the window in bf16
        args[i] = args[i].to(torch.bfloat16)
    if not quant:
        args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    reset_launch_counts()
    out = paged_attention(*args, layer=1, window=20)
    ref = paged_attention_reference(*args, layer=1, window=20)
    assert launch_counts()["paged_attention"] == 1
    _assert_bf16_close(out, ref, args[2], args[4], args[9])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_prefill_matches_plain(cuda, quant):
    """Fresh, dead and partial-first-block lanes; written blocks exact."""
    args = _on(cuda, prefill_case(S=4, nh=4, n_kv=2, dh=128, L=2, nb=48,
                                  bs=16, M=8, P=16, quant=quant, seed=2))
    for i in (0, 1, 2):
        args[i] = args[i].to(torch.bfloat16)
    if not quant:
        args[3], args[4] = args[3].bfloat16(), args[4].bfloat16()
    out = paged_prefill_attention(*args, layer=0)
    ref = paged_prefill_reference(*args, layer=0)
    _assert_bf16_close(out[0], ref[0], args[4], args[6], args[2])
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_fused_sample_matches_plain(cuda):
    for args in (sample_case(seed=3), sample_case(seed=4)[:2]):
        args = _on(cuda, args)
        for a, b in zip(fused_sample_prep(*args),
                        fused_sample_reference(*args)):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_cuda_tensor_never_falls_back(cuda):
    """A CUDA tensor the kernel does not take raises; it never runs the
    plain version instead."""
    logits = torch.zeros(2, 8, device=cuda)
    with pytest.raises(NotImplementedError):
        fused_sample_prep(logits, torch.zeros(2, device=cuda), top_k=2)
    with pytest.raises(TypeError):
        fused_sample_prep(logits.double(), torch.zeros(2, device=cuda))
