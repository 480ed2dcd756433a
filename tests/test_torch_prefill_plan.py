"""The paged prefill's launch plan (``tpudist_torch.ops.paged_prefill``).

``_prefill_plan`` picks the attention arm of ``csrc/paged_prefill.cu`` (bf16
tensor-core tiles at head dims that are multiples of 16 up to 128; the
CUDA-core code otherwise), the query rows per CTA and the shared memory per CTA, which
``_check_smem`` holds to the 227 KB one H100 CTA may use.  Pure Python: the
kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import re

import pytest
import torch

from tpudist_torch.ops import _build
from tpudist_torch.ops.paged_prefill import (CC_ROWS, SMEM_LIMIT,
                                             TC_HEAD_DIMS, TC_ROWS,
                                             TC_STAGES, TC_TILE, PrefillPlan,
                                             _check_smem, _prefill_plan)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dh", [16, 32, 64, 128, 48, 80, 96, 112])
def test_bf16_at_tile_head_dims_takes_tensor_cores(dh):
    for R in (16, 64, 512):  # rows under, at and over one CTA's
        plan = _prefill_plan(BF16, dh, R, 16)
        assert plan == PrefillPlan(
            "tc", TC_ROWS,
            (TC_ROWS + 2 * TC_STAGES * TC_TILE) * (dh + 8) * 2)


@pytest.mark.parametrize("dtype,dh", [(F32, 128), (F32, 64), (F32, 16),
                                      (F32, 48), (BF16, 8), (F32, 8),
                                      (BF16, 40), (BF16, 256)])
def test_f32_and_other_head_dims_take_cuda_cores(dtype, dh):
    plan = _prefill_plan(dtype, dh, 64, 16)
    assert plan.arm == "cc" and plan.rows == CC_ROWS
    # fewer rows than a CTA's: the CTA is sized to them
    assert _prefill_plan(dtype, dh, 5, 16).rows == 5


# (compute dtype, head dim, R = group * P, KV block): the serving model
# (dh 128, P 64, MHA, block 16), the card tests' sweep (dh 32-128, GQA
# group 4, P 16-128, f32) and the CPU tests' tiny shapes (dh 8, block 4)
USED = [(BF16, 128, 64, 16), (BF16, 128, 512, 16), (BF16, 32, 16, 16),
        (BF16, 64, 128, 16), (BF16, 16, 256, 16), (F32, 128, 64, 16),
        (F32, 128, 512, 16), (F32, 8, 16, 4), (BF16, 8, 8, 4),
        (BF16, 48, 64, 16), (BF16, 80, 512, 16), (BF16, 112, 64, 16),
        (BF16, 256, 64, 16)]


@pytest.mark.parametrize("dtype,dh,R,bs", USED)
def test_shared_memory_fits_every_case_in_use(dtype, dh, R, bs):
    plan = _prefill_plan(dtype, dh, R, bs)
    assert plan.arm == ("tc" if dtype == BF16 and dh in TC_HEAD_DIMS
                        else "cc")
    assert 0 < plan.smem <= SMEM_LIMIT == 227 * 1024
    _check_smem(plan, dh, bs)


def test_check_smem_raises_where_the_plan_does_not_fit():
    plan = _prefill_plan(F32, 512, 64, 512)  # K/V blocks of 512 x 516 f32
    assert plan.arm == "cc" and plan.smem > SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        _check_smem(plan, 512, 512)
    with pytest.raises(ValueError, match="shared memory"):
        _check_smem(PrefillPlan("tc", 64, SMEM_LIMIT + 1), 128, 16)


def test_plan_constants_match_the_kernel_source():
    """The tile width, the tile buffers, the rows per CTA and the kernel's
    shared memory are the sources'."""
    src = (_build.CSRC / "paged_prefill.cu").read_text()
    common = (_build.CSRC / "paged_common.cuh").read_text()
    assert re.search(rf"constexpr int kTile = {TC_TILE};", src)
    assert re.search(rf"constexpr int kStages = {TC_STAGES};", src)
    assert re.search(r"constexpr int kRowWarps = (\d+);", src).group(1) \
        == str(TC_ROWS // 16)
    assert "(kRows + 2 * kStages * kTile) * (D + 8) * sizeof(bf16)" in src
    assert re.search(rf"constexpr int kRowsPerCta = {CC_ROWS};", common)
