"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device.  The module imports no JAX (only torch, numpy, tpudist_torch and
chip_smoke), so it also runs on the GPU machine, which has none:
``python -m pytest tests/test_torch_cuda.py --noconftest`` (the suite's
conftest imports JAX).

Tolerance: in bf16 the kernel rounds the unnormalized softmax
probabilities (online softmax) where the plain version rounds the
normalized weights, a 2**-9 relative step of each weight; both then round
the output.  Outputs agree within ``2**-7 * max|V| + 2**-8 * |out|``.
Written KV blocks, their scales and the sampling outputs are exact, top-k
included; a top-p kept set may differ only where the softmax mass before a
value lies within ``V * 2**-23`` of ``top_p`` (the kernel sums the sorted
row's probabilities in another order than a sequential cumsum; each of V
additions rounds by at most 2**-24 relative on either side).

Flash kernels (forward, dq, dk/dv) against their plain versions: the
bounds of ``chip_smoke.flash_agreement``, elementwise, per row and in
relative RMS, each stated and derived there.  lse is f32 on both sides:
``1e-4 + 1e-5 * |ref|``.  The backward's wgmma arm (bf16 at head dims 64
and 128) through ``chip_smoke.flash_case_readings``: also the delta its dq
kernel forms, within ``chip_smoke.DELTA_REL_MAX`` of the plain one, and
that kernel's dq bit for bit the given-delta arm's.

The paged decode's split walk (bf16 q over bf16 or int8 pools at head
dims 16-128) and the forced CUDA-core walk: the bf16 bound above, on
phase 3's cases (``chip_smoke.decode_readings``) and on ragged lanes over
several 128-key splits, the verify at s 5 and 9, GQA 8/2, windows and an
empty lane; a second call equal bit for bit (the merge counters are left
zero).  The flash forward's wgmma arm (bf16 at head dims 64 and 128) on
the backward's wgmma cases, its ``out_f32`` output included, and the
forced mma.sync forward at head dims 64 and 128: the flash bounds above.

The fused RoPE+QKV and LoRA gather-matmul kernels: the bounds of
``chip_smoke.linear_agreement`` (``LINEAR_BOUNDS``, derived there from
readings on the card).

Every shape the JAX kernels take: the flash kernels at head dims 1 to 256
(multiples of 8 through cp.async, others element by element; 200 and 256
on the backward's column chunks), ``fused_rope_qkv`` at any head dim (odd
ones with RoPE off) and any depth, ``lora_delta`` at any rank (padded to a
compiled width, past 64 in chunks), and the paged tensor-core arms at head
dims 48, 80, 96 and 112, each against its plain version at the bounds
above.

The fused toy-MLP kernel: ``chip_smoke.mlp_agreement`` — within 1e-5 of
its plain version and 1e-4 of a float64 numpy forward, relative to the
output's largest magnitude (both sides full f32, summed in another
order).  The toy demo on the card (world size 1 under the torchrun
contract, NCCL) converges as ``chip_smoke.demo_path`` holds it.  The toy
model split over ``[cuda:0, cuda:0]`` equals the unsplit model, forward
and gradients bit for bit; a checkpoint round trip on the card resumes
the unbroken run bit for bit, its restored tensors on the card.

The residual prep: ``chip_smoke.residual_close``, the CPU test's
tolerances (``pt``/``pd`` to ``rtol 2e-6, atol 1e-7``, empty-residual rows
bit for bit, ``exp(lr)`` to ``atol 1e-6``).  A small f32 speculative engine
on the card emits the greedy streams of the card's non-speculative engine.

The serving mesh: the kernels at the per-place shapes of phase 21
(``chip_smoke.mesh_kernel_readings``: 4 and 1 kv heads a place, the qkv
and B column slices) at the bounds above, and a small f32 engine over 1x2
places folded onto the card emitting the unsharded engine's greedy
streams, its per-place kernels launched twice as often.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (GRAMMAR_CASES, MLP_CASES, RESIDUAL_CASES,
                        SAMPLE_CASES, check_filters, decode_readings,
                        demo_path, flash_agreement, flash_case_readings,
                        grammar_inputs,
                        linear_agreement, lora_inputs, mlp_agreement,
                        mlp_inputs, prep_arms, qkv_inputs, residual_close,
                        ring_launches, sample_inputs)
from torch_cases import (decode_case, filter_case, flash_case, prefill_case,
                         sample_case, top_p_boundary_gap)
from tpudist_torch.bench import bench_fused_mlp
from tpudist_torch.ops import (FlashAttention, flash_backward_dkv,
                               flash_backward_dq, flash_backward_dq_delta,
                               flash_backward_reference,
                               flash_forward, flash_forward_reference,
                               fused_mlp, fused_residual_prep,
                               fused_residual_reference,
                               fused_rope_qkv, fused_rope_qkv_reference,
                               fused_sample_prep, fused_sample_reference,
                               launch_counts, lora_delta,
                               lora_delta_reference, mlp_reference,
                               pack_params, paged_attention,
                               paged_attention_reference,
                               paged_prefill_attention,
                               paged_prefill_reference, reset_launch_counts)
from tpudist_torch.ops.flash_attention import (_launch_dkv, _launch_dq,
                                               _launch_fwd)
from tpudist_torch.ops.fused_sample import (CLUSTER_SIZES, MAX_CLUSTER,
                                            SLICE_CAP, _launch_residual,
                                            _launch_sample)
from tpudist_torch.ops.fused_linear import (LORA_CLUSTER_MAX_RANK,
                                            LORA_DECODE_ROWS, _launch_lora,
                                            _launch_rope, _lora_arm,
                                            _rope_arm,
                                            lora_max_active_clusters,
                                            rope_max_active_clusters)
from tpudist_torch.ops.paged_attention import _paged_attention_on_arm
from tpudist_torch.ops.paged_prefill import _paged_prefill_on_arm
from tpudist_torch.train.__main__ import main as train_main

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
    assert paged_attention.launches_tc == 1  # the split walk
    _assert_bf16_close(out, ref, args[2], args[4], args[9])


def _decode_on(dev, nh, n_kv, s, dh, quant, seed, fill_max=0, M=64):
    """bf16 decode inputs over a 64-block table (1024 keys: 8 splits of the
    split walk), ragged cursors from an empty lane up."""
    args = _on(dev, decode_case(S=6, nh=nh, n_kv=n_kv, s=s, dh=dh, L=2,
                                nb=6 * M, bs=16, M=M, quant=quant,
                                seed=seed, fill_max=fill_max))
    for i in (0, 8, 9):
        args[i] = args[i].to(torch.bfloat16)
    if not quant:
        args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    return args


@pytest.mark.parametrize("window", [None, 20], ids=lambda w: f"w{w}")
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("s,nh,n_kv", [(1, 8, 8), (5, 8, 8), (9, 8, 8),
                                       (9, 8, 2), (1, 8, 2)],
                         ids=["s1", "s5", "s9", "s9_gqa8_2", "s1_gqa8_2"])
def test_paged_decode_split_walk_matches_plain(cuda, s, nh, n_kv, quant,
                                               window):
    """The split walk over lanes spanning several splits, an empty lane,
    the verify's s 5 and 9, GQA 8/2 (36 query rows: three row tiles) and a
    sliding window that leaves early splits dead; a second call equals the
    first bit for bit, and the forced CUDA-core walk still matches."""
    args = _decode_on(cuda, nh, n_kv, s, 128, quant, seed=s + 10 * n_kv,
                      fill_max=7 if s == 1 else 0)
    assert int(args[6][0]) == 0 and int(args[6].max()) > 3 * 128
    reset_launch_counts()
    out = paged_attention(*args, layer=1, window=window)
    again = paged_attention(*args, layer=1, window=window)
    cc = _paged_attention_on_arm("cc", *args, layer=1, window=window)
    ref = paged_attention_reference(*args, layer=1, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == 3
    assert paged_attention.launches_tc == 2
    assert torch.equal(out, again)
    _assert_bf16_close(out, ref, args[2], args[4], args[9])
    _assert_bf16_close(cc, ref, args[2], args[4], args[9])


@pytest.mark.parametrize("dh", [16, 32, 64, 48, 80, 96, 112])
@pytest.mark.parametrize("s", [1, 5])
def test_paged_decode_split_walk_head_dims(cuda, dh, s):
    args = _decode_on(cuda, 4, 2, s, dh, False, seed=dh + s, fill_max=3)
    reset_launch_counts()
    out = paged_attention(*args, layer=0, window=None)
    ref = paged_attention_reference(*args, layer=0, window=None)
    assert paged_attention.launches_tc == 1
    _assert_bf16_close(out, ref, args[2], args[4], args[9])


def test_paged_decode_phase3_cases(cuda):
    """chip_smoke phase 3's decode cases on the split walk and the
    CUDA-core walk (``decode_readings``)."""
    gen = torch.Generator(device=cuda).manual_seed(1234)
    r = decode_readings(torch, cuda, gen)
    assert r["ok"], r


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("s", [5, 9])
def test_paged_verify_window_matches_plain(cuda, quant, s):
    """The speculative verify's call: s = K + 1 queries a lane over a
    (K + 1)-column window buffer at fill 0, ragged cursors, a window."""
    args = _on(cuda, decode_case(S=4, nh=4, n_kv=2, s=s, dh=128, L=2,
                                 nb=40, bs=16, M=8, quant=quant, seed=s))
    for i in (0, 8, 9):
        args[i] = args[i].to(torch.bfloat16)
    if not quant:
        args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    for window in (None, 20):
        reset_launch_counts()
        out = paged_attention(*args, layer=1, window=window)
        ref = paged_attention_reference(*args, layer=1, window=window)
        assert launch_counts()["paged_attention"] == 1
        _assert_bf16_close(out, ref, args[2], args[4], args[9])


@pytest.mark.parametrize("shape,dtype", [
    ((3, 4, 17), torch.float32), ((8, 4, 256), torch.float32),
    ((2, 3, 32000), torch.float32), ((8, 2, 256), torch.bfloat16)])
def test_residual_prep_matches_plain(cuda, shape, dtype):
    r = np.random.default_rng(shape[2])
    lt = torch.from_numpy(r.normal(size=shape).astype(np.float32) * 3)
    ld = torch.from_numpy(r.normal(size=shape).astype(np.float32) * 3)
    ld[1] = lt[1]  # an empty residual
    temps = torch.from_numpy(
        np.asarray([0.0, 0.9, 1.4, 0.7] * 2, np.float32)[:shape[0]])
    lt, ld, temps = lt.to(cuda, dtype), ld.to(cuda, dtype), temps.to(cuda)
    reset_launch_counts()
    out = fused_residual_prep(lt, ld, temps)
    assert launch_counts()["fused_residual_prep"] == 1
    residual_close(torch, out, fused_residual_reference(lt, ld, temps), lt,
                   temps)


def test_spec_engine_on_the_card(cuda):
    """A small f32 LM served with the tied 1-layer draft (K = 4): greedy
    streams equal the card's non-speculative engine, the residual prep
    launches once a spec block and the paged decode kernel once a layer of
    every decode-arm forward."""
    from tpudist_torch.models import create_transformer
    from tpudist_torch.serve import SlotEngine

    model = create_transformer(0, device=cuda, vocab=64, d_model=128,
                               n_layers=2, n_heads=2, d_ff=256, max_len=128,
                               rope=True)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 64, size=int(rng.integers(1, 40))),
             int(rng.integers(2, 20))) for _ in range(6)]
    streams, blocks = {}, {}
    for spec in (1, None):
        eng = SlotEngine(model, num_slots=4, prefill_pad=16, kv_block=16,
                         spec_draft=spec, spec_k=4, device=cuda)
        reset_launch_counts()
        out, pending, slot_rid = {}, list(enumerate(reqs)), {}
        while pending or eng.num_occupied:
            items = []
            for slot in eng.free_slots():
                if not pending:
                    break
                rid, (p, n) = pending.pop(0)
                slot_rid[slot] = rid
                out[rid] = []
                items.append((slot, p, 0.0, 0, n))
            got = dict(eng.start_batch(items))
            got.update(eng.advance_prefill())
            for slot, tok in got.items():
                if tok is not None:
                    out[slot_rid[slot]].append(tok)
            if eng.num_active:
                for slot, toks in eng.decode_auto()[1].items():
                    out[slot_rid[slot]].extend(toks)
            for slot in list(slot_rid):
                if len(out[slot_rid[slot]]) >= reqs[slot_rid[slot]][1]:
                    assert len(out[slot_rid[slot]]) == \
                        reqs[slot_rid[slot]][1]
                    eng.evict(slot)
                    del slot_rid[slot]
        streams[spec] = [out[i] for i in range(len(reqs))]
        blocks[spec] = eng.n_spec_blocks
        counts, dec = launch_counts(), eng.decode_stats()
        assert counts["fused_residual_prep"] == eng.n_spec_blocks
        assert counts["paged_attention"] == (
            2 * dec["steps"] + dec["draft_decode_forwards"])
    assert streams[1] == streams[None]
    assert blocks[1] > 0 and blocks[None] == 0


def _prefill_lanes(P, bs=16, M=16):
    """(pos0, clen) of six lanes at max_len M * bs: a fresh lane, a dead
    lane at a block boundary, one token mid-block, a full chunk ending at
    max_len, a ragged chunk ending there mid-block, a ragged chunk from
    mid-block."""
    top = M * bs
    return ([0, 2 * bs, bs + 1, top - P, top - P // 2 - 3, 100],
            [P, 0, 1, P, P // 2 + 3, max(1, P - 5)])


def _prefill_on(dev, nh, n_kv, dh, P, quant, seed, dtype=torch.bfloat16):
    pos0, clen = _prefill_lanes(P)
    args = _on(dev, prefill_case(S=6, nh=nh, n_kv=n_kv, dh=dh, L=2, nb=100,
                                 bs=16, M=16, P=P, quant=quant, seed=seed,
                                 pos0=pos0, clen=clen))
    for i in (0, 1, 2):
        args[i] = args[i].to(dtype)
    if not quant:
        args[3], args[4] = args[3].to(dtype), args[4].to(dtype)
    return args


def _assert_prefill_equal_writes(out, ref):
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 40, 7], ids=lambda w: f"w{w}")
@pytest.mark.parametrize("P", [16, 64, 128])
@pytest.mark.parametrize("nh,n_kv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_paged_prefill_matches_plain(cuda, dh, nh, n_kv, P, window, quant):
    """The tensor-core arm over ragged lanes (clen 0 and 1, cursors at a
    block boundary, mid-block and near max_len), GQA tiles spanning q
    heads, windows wider and narrower than a block; written blocks exact."""
    args = _prefill_on(cuda, nh, n_kv, dh, P, quant, seed=dh + P + nh)
    reset_launch_counts()
    out = paged_prefill_attention(*args, layer=1, window=window)
    ref = paged_prefill_reference(*args, layer=1, window=window)
    assert launch_counts()["paged_prefill"] == 1
    assert paged_prefill_attention.launches_tc == 1
    _assert_bf16_close(out[0], ref[0], args[4], args[6], args[2])
    _assert_prefill_equal_writes(out, ref)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 40], ids=lambda w: f"w{w}")
@pytest.mark.parametrize("nh,n_kv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("dh", [48, 80, 96, 112])
def test_paged_prefill_new_head_dims_take_tensor_cores(cuda, dh, nh, n_kv,
                                                       window, quant):
    """The tensor-core arm at the head dims its instantiations widened to
    (48, 80, 96, 112: 6, 10, 12 and 14 eight-column fragments; chunks of a
    prefix tile that the 256 threads do not divide evenly) against the
    plain version; written blocks exact."""
    args = _prefill_on(cuda, nh, n_kv, dh, 64, quant, seed=dh + nh)
    reset_launch_counts()
    out = paged_prefill_attention(*args, layer=1, window=window)
    ref = paged_prefill_reference(*args, layer=1, window=window)
    assert paged_prefill_attention.launches_tc == 1
    _assert_bf16_close(out[0], ref[0], args[4], args[6], args[2])
    _assert_prefill_equal_writes(out, ref)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("s", [1, 5])
def test_paged_decode_dh256_mqa_on_cuda_cores(cuda, s, quant):
    """Gemma-2B's attention in serving (dh 256, 8 heads over one kv head):
    the decode plans the CUDA-core walk, which matches the plain version,
    with and without a window."""
    args = _decode_on(cuda, 8, 1, s, 256, quant, seed=256 + s, fill_max=3)
    for window in (None, 20):
        reset_launch_counts()
        out = paged_attention(*args, layer=1, window=window)
        ref = paged_attention_reference(*args, layer=1, window=window)
        assert (paged_attention.launches,
                paged_attention.launches_tc) == (1, 0)
        _assert_bf16_close(out, ref, args[2], args[4], args[9])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 40], ids=lambda w: f"w{w}")
def test_paged_prefill_dh256_mqa_on_cuda_cores(cuda, window, quant):
    """Gemma-2B's prefill chunk (dh 256, 8 heads over one kv head) plans the
    CUDA-core arm, which matches the plain version; written blocks
    exact."""
    args = _prefill_on(cuda, 8, 1, 256, 64, quant, seed=257)
    reset_launch_counts()
    out = paged_prefill_attention(*args, layer=1, window=window)
    ref = paged_prefill_reference(*args, layer=1, window=window)
    assert (paged_prefill_attention.launches_tc,
            paged_prefill_attention.launches_cc) == (0, 1)
    _assert_bf16_close(out[0], ref[0], args[4], args[6], args[2])
    _assert_prefill_equal_writes(out, ref)


def test_paged_prefill_bf16_dh128_takes_tensor_cores(cuda):
    """The serving call (bf16, dh 128, P 64) counts one tensor-core launch
    and none on the CUDA-core arm; without its block writes the attention
    is the same."""
    args = _prefill_on(cuda, 8, 8, 128, 64, False, seed=3)
    reset_launch_counts()
    out = paged_prefill_attention(*args, layer=0)
    assert (paged_prefill_attention.launches,
            paged_prefill_attention.launches_tc,
            paged_prefill_attention.launches_cc) == (1, 1, 0)
    ref = paged_prefill_reference(*args, layer=0)
    _assert_bf16_close(out[0], ref[0], args[4], args[6], args[2])
    alone = _paged_prefill_on_arm("tc", *args, layer=0, writes=False)
    torch.testing.assert_close(alone[0], out[0], atol=0, rtol=0)
    assert alone[1].shape[1] == 0


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_prefill_f32_takes_cuda_cores(cuda, quant):
    """f32 compute runs the CUDA-core arm in full f32: within 1e-5 of the
    plain version (both f32, summed in another order over at most 400
    columns), written blocks exact; the forced CUDA-core arm in bf16
    agrees as the tensor-core arm does."""
    args = _prefill_on(cuda, 8, 2, 64, 64, quant, seed=5,
                       dtype=torch.float32)
    reset_launch_counts()
    out = paged_prefill_attention(*args, layer=1, window=40)
    assert (paged_prefill_attention.launches_tc,
            paged_prefill_attention.launches_cc) == (0, 1)
    ref = paged_prefill_reference(*args, layer=1, window=40)
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=1e-5)
    _assert_prefill_equal_writes(out, ref)
    args = _prefill_on(cuda, 8, 2, 128, 64, quant, seed=6)
    out = _paged_prefill_on_arm("cc", *args, layer=1)
    ref = paged_prefill_reference(*args, layer=1)
    assert paged_prefill_attention.launches_cc == 2
    _assert_bf16_close(out[0], ref[0], args[4], args[6], args[2])
    _assert_prefill_equal_writes(out, ref)


def test_fused_sample_matches_plain(cuda):
    for args in (sample_case(seed=3), sample_case(seed=4)[:2]):
        args = _on(cuda, args)
        for a, b in zip(fused_sample_prep(*args),
                        fused_sample_reference(*args)):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("tk,tp", [(5, 0.0), (0, 0.9), (5, 0.9), (12, 0.0),
                                   (0, 0.5)])
def test_fused_sample_filters_match_plain(cuda, tk, tp):
    """top-k exact (ties at the k-th value survive); top-p within the
    stated margin of the threshold; masked and greedy outputs exact."""
    args = _on(cuda, filter_case(seed=tk + int(tp * 10)))
    out = fused_sample_prep(*args, top_k=tk, top_p=tp)
    ref = fused_sample_reference(*args, top_k=tk, top_p=tp)
    torch.testing.assert_close(out[0], ref[0], atol=0, rtol=0)
    torch.testing.assert_close(out[2], ref[2], atol=0, rtol=0)
    if tp == 0.0:
        torch.testing.assert_close(out[1], ref[1], atol=0, rtol=0)
        return
    topk_row = fused_sample_reference(*args, top_k=tk)[1].cpu().numpy()
    masses = top_p_boundary_gap(out[1].cpu().numpy(), ref[1].cpu().numpy(),
                                topk_row)
    V = args[0].shape[1]
    assert np.all(np.abs(masses - tp) <= V * 2.0 ** -23), masses
    kept = out[1] > torch.finfo(torch.float32).min
    torch.testing.assert_close(out[1][kept], ref[1][kept], atol=0, rtol=0)


def _sample_counts():
    return (fused_sample_prep.launches_row,
            fused_sample_prep.launches_cluster)


@pytest.mark.parametrize("case", SAMPLE_CASES, ids=[c[0] for c in SAMPLE_CASES])
def test_fused_sample_arms_match_plain(cuda, case):
    """Phase 3's shapes (a)-(f), (i) and (j) on both arms that take them,
    with and without grammar rows (``chip_smoke.sample_inputs``: ties
    straddling kth, a flat row, a temperature-0 row, a row masked whole):
    masked, greedy and top-k exact, top-p within ``check_filters``' margin,
    one launch on the arm given."""
    label, S, V, tk, tp = case
    args = sample_inputs(torch, cuda, torch.Generator(device=cuda)
                         .manual_seed(S + V), S, V)
    for arm, width in prep_arms("sample", S, V):
        for a in (args[:2], args):
            reset_launch_counts()
            out = _launch_sample(arm, width, *a, top_k=tk, top_p=tp)
            assert _sample_counts() == ((1, 0) if arm == "row" else (0, 1))
            check_filters(torch, out,
                          fused_sample_reference(*a, top_k=tk, top_p=tp),
                          fused_sample_reference(*a, top_k=tk)[1], tp)


@pytest.mark.parametrize("case", GRAMMAR_CASES,
                         ids=[c[0] for c in GRAMMAR_CASES])
def test_fused_sample_grammar_cases_match_plain(cuda, case):
    """Phase 3's grammar cases (g) and (h): the constrained server's pool
    at vocab 256, and a ``[5, 64, 32000]`` pool, on both arms
    (``chip_smoke.grammar_inputs``: sentinel rows, a one-token state, rows
    of varied density): masked, scaled and greedy equal to the plain
    version bit for bit, one launch on the arm given, counted as a grammar
    launch."""
    label, S, V, pool = case
    args = grammar_inputs(torch, cuda, torch.Generator(device=cuda)
                          .manual_seed(S + V), S, V, pool)
    ref = fused_sample_reference(*args)
    for arm, width in prep_arms("sample", S, V):
        reset_launch_counts()
        out = _launch_sample(arm, width, *args)
        assert _sample_counts() == ((1, 0) if arm == "row" else (0, 1))
        assert fused_sample_prep.launches_grammar == 1
        for x, y in zip(out, ref):
            assert torch.equal(x, y), (label, arm)


def test_constrained_engine_block_on_the_card(cuda):
    """One admission and one decode block of a constrained engine with
    top-3 logprobs on a small f32 LM, on the card and on the CPU (every
    kernel's plain version) from the same weights: first tokens, the
    block's tokens, ``gidx`` / ``gstate`` and the logprobs ids equal,
    values within 1e-4; every sampling launch carried the grammar pool."""
    from tpudist_torch.constrain import (ConstrainConfig, compile_grammar,
                                         default_vocab)
    from tpudist_torch.models import create_transformer
    from tpudist_torch.serve import SlotEngine

    vocab = default_vocab(64, 1)
    tg = compile_grammar(regex="[A-F]{2,6}-[0-9]{1,3}", vocab=vocab,
                         eos_id=1, max_states=32)
    schema = compile_grammar(json_schema={"type": "array",
                                          "items": {"type": "integer"}},
                             vocab=vocab, eos_id=1, max_states=32)
    rng = np.random.default_rng(3)
    items = [(0, rng.integers(2, 64, size=9), 0.0, 0, 20, (), True, None,
              tg),
             (1, rng.integers(2, 64, size=30), 0.0, 1, 20, (), True, None,
              None),
             (2, rng.integers(2, 64, size=4), 0.0, 2, 20, (), True, None,
              schema),
             (3, rng.integers(2, 64, size=12), 0.0, 3, 20, (), True, None,
              tg)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = create_transformer(0, device=dev, vocab=64, d_model=128,
                                   n_layers=2, n_heads=2, d_ff=256,
                                   max_len=128, rope=True)
        eng = SlotEngine(model, num_slots=4, prefill_pad=16, kv_block=16,
                         decode_block=8,
                         constrain=ConstrainConfig(vocab, 2, 32),
                         logprobs=3, device=dev)
        reset_launch_counts()
        first = dict(eng.start_batch(items))
        while eng.prefilling_slots():
            first.update(eng.advance_prefill())
        info, block = eng.decode_block()
        out[dev.type] = (first, block, eng.state.gidx.tolist(),
                         eng.state.gstate.tolist(), info["logprobs"])
        if dev.type == "cuda":
            assert launch_counts()["fused_sample"] > 0
            assert fused_sample_prep.launches_grammar == launch_counts()[
                "fused_sample"]
    card, cpu = out["cuda"], out["cpu"]
    assert card[:4] == cpu[:4]
    for s, rows in cpu[4].items():
        for (ids, vals), (cids, cvals) in zip(rows, card[4][s]):
            assert cids == ids
            np.testing.assert_allclose(cvals, vals, rtol=1e-4, atol=1e-4)
    assert tg.walk([cpu[0][0]] + cpu[1][0]) is not None


def _equal_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("tk,tp", [(0, 0.0), (50, 0.0), (0, 0.9),
                                   (50, 0.9)])
@pytest.mark.parametrize("V", [256, 32000])
def test_fused_sample_nan_and_inf_rows(cuda, V, tk, tp):
    """A NaN row (arg-max at the first NaN; the filters keep what the plain
    version keeps), a row all -inf, a row with a +inf, rows with -inf
    entries: equal to the plain version on both arms, NaN where NaN (a row
    whose maximum is NaN or infinite keeps the top value alone as its
    top-p cutoff, as the plain version's NaN softmax does)."""
    r = np.random.default_rng(V + tk)
    lg = torch.from_numpy((r.normal(size=(6, V)) * 2).astype(np.float32))
    lg[0, [5, V // 2]] = float("nan")
    lg[1] = float("-inf")
    lg[2, 7] = float("inf")
    lg[3, ::3] = float("-inf")
    lg[4, 1::2] = float("-inf")
    lg, temps = lg.to(cuda), torch.tensor([1.0, 0.7, 1.3, 0.0, 2.0, 1.0],
                                          device=cuda)
    ref = fused_sample_reference(lg, temps, top_k=tk, top_p=tp)
    topk_row = fused_sample_reference(lg, temps, top_k=tk)[1].cpu().numpy()
    for arm, width in prep_arms("sample", 6, V):
        out = _launch_sample(arm, width, lg, temps, top_k=tk, top_p=tp)
        assert _equal_nan(out[0], ref[0]) and torch.equal(out[2], ref[2])
        if tp == 0.0:
            assert _equal_nan(out[1], ref[1])
            continue
        o, f = out[1].cpu(), ref[1].cpu()
        assert _equal_nan(o[:3], f[:3])  # NaN, -inf, +inf maxima: exact
        masses = top_p_boundary_gap(o[3:].numpy(), f[3:].numpy(),
                                    topk_row[3:])
        assert np.all(np.abs(masses - tp) <= V * 2.0 ** -23), masses
        kept = o[3:] > torch.finfo(torch.float32).min
        assert torch.equal(o[3:][kept], f[3:][kept])


@pytest.mark.parametrize("C", CLUSTER_SIZES)
@pytest.mark.parametrize("V", [1, 5, 1001, 4099])
def test_fused_sample_cluster_arm_edges(cuda, V, C):
    """The cluster arm where V is not a multiple of 4 * C (the last CTA's
    slice short), V < C (CTAs with no values) and V = 1, at S 3 and 40,
    every filter setting, against the plain version."""
    for S in (3, 40):
        args = sample_inputs(torch, cuda, torch.Generator(device=cuda)
                             .manual_seed(V * C + S), S, V)
        for tk, tp in ((0, 0.0), (2, 0.0), (0, 0.9), (3, 0.5)):
            out = _launch_sample("cluster", C, *args, top_k=tk, top_p=tp)
            check_filters(torch, out,
                          fused_sample_reference(*args, top_k=tk, top_p=tp),
                          fused_sample_reference(*args, top_k=tk)[1], tp)


def test_fused_sample_s40_long_vocab_filters(cuda):
    """The verify's 40 rows at vocab 32000 with both filters, on the planned
    cluster arm: one launch, equal to the plain version."""
    args = sample_inputs(torch, cuda, torch.Generator(device=cuda)
                         .manual_seed(40), 40, 32000)
    reset_launch_counts()
    out = fused_sample_prep(*args, top_k=50, top_p=0.9)
    assert _sample_counts() == (0, 1)
    check_filters(torch, out,
                  fused_sample_reference(*args, top_k=50, top_p=0.9),
                  fused_sample_reference(*args, top_k=50)[1], 0.9)


def test_preps_past_the_shared_memory_slice(cuda):
    """Rows longer than a cluster of ``MAX_CLUSTER`` CTAs holds in shared
    memory (``SLICE_CAP`` values a CTA, the residual's half as many pairs):
    the rest of each slice waits in the outputs, and both preps still
    equal their plain versions."""
    V = MAX_CLUSTER * SLICE_CAP + 40961
    args = sample_inputs(torch, cuda, torch.Generator(device=cuda)
                         .manual_seed(7), 3, V)
    for tk, tp in ((0, 0.0), (50, 0.9)):
        check_filters(torch, fused_sample_prep(*args, top_k=tk, top_p=tp),
                      fused_sample_reference(*args, top_k=tk, top_p=tp),
                      fused_sample_reference(*args, top_k=tk)[1], tp)
    V = MAX_CLUSTER * SLICE_CAP // 2 + 20481
    lt = torch.randn(1, 2, V, device=cuda) * 3
    ld = torch.randn(1, 2, V, device=cuda) * 3
    ld[0, 1] = lt[0, 1]  # an empty residual
    temps = torch.tensor([0.8], device=cuda)
    residual_close(torch, fused_residual_prep(lt, ld, temps),
                   fused_residual_reference(lt, ld, temps), lt, temps)


@pytest.mark.parametrize("case", RESIDUAL_CASES,
                         ids=[c[0] for c in RESIDUAL_CASES])
def test_residual_prep_arms_match_plain(cuda, case):
    """Phase 3d's shapes on both arms that take them: ``residual_close``,
    one launch on the arm given."""
    label, k, V, dtype = case
    r = np.random.default_rng(V + k)
    lt = torch.from_numpy(r.normal(size=(8, k, V)).astype(np.float32) * 3)
    ld = torch.from_numpy(r.normal(size=(8, k, V)).astype(np.float32) * 3)
    ld[2] = lt[2]
    lt[3, 0, ::5] = float("-inf")
    dt = getattr(torch, dtype)
    lt, ld = lt.to(cuda, dt), ld.to(cuda, dt)
    temps = torch.tensor([0, 0.7, 1.3, 0.7, 0, 1.3, 0.7, 1.3], device=cuda)
    for arm, width in prep_arms("residual", 8 * k, V):
        reset_launch_counts()
        out = _launch_residual(arm, width, lt, ld, temps)
        assert (fused_residual_prep.launches_row,
                fused_residual_prep.launches_cluster) == (
                    (1, 0) if arm == "row" else (0, 1))
        residual_close(torch, out, fused_residual_reference(lt, ld, temps),
                       lt, temps)


def test_cuda_tensor_never_falls_back(cuda):
    """A CUDA tensor the kernel does not take raises; it never runs the
    plain version instead."""
    logits = torch.zeros(2, 5000, device=cuda)
    gallow = torch.ones(1, 1, 4999, dtype=torch.bool, device=cuda)
    gidx = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # a grammar row of another vocab
        fused_sample_prep(logits, torch.zeros(2, device=cuda), gallow, gidx,
                          gidx, top_k=2)
    with pytest.raises(TypeError):
        fused_sample_prep(logits.double(), torch.zeros(2, device=cuda))
    q = torch.zeros(1, 2, 16, 264, device=cuda)  # head_dim past 256
    with pytest.raises(ValueError, match="A6f"):
        flash_forward(q, q, q, (0, None))
    with pytest.raises(TypeError):
        flash_forward(q.half(), q.half(), q.half(), (0, None))
    q = torch.zeros(1, 2, 16, 32, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError):  # dh 32: no kernel forms delta there
        flash_backward_dq_delta(q, q, q, q, lse, q, None, (0, None))
    with pytest.raises(ValueError):  # dh 32: no wgmma forward
        _launch_fwd("wgmma", q, q, q, (0, None))
    args = _decode_on(cuda, 4, 2, 1, 128, False, seed=0)
    args[0], args[8], args[9] = (args[i].float() for i in (0, 8, 9))
    with pytest.raises(ValueError):  # f32 q: no split walk
        _paged_attention_on_arm("tc", *args, layer=0)


# (dtype, heads, kv heads, seq, head dim, band)
FLASH_CASES = {
    "causal_bf16_d128": (torch.bfloat16, 4, 4, 256, 128, (0, None)),
    "window_gqa_bf16_d64": (torch.bfloat16, 4, 2, 300, 64, (0, 48)),
    "band_gqa_bf16_d128": (torch.bfloat16, 4, 1, 200, 128, (-40, 70)),
    "ragged_full_bf16_d128": (torch.bfloat16, 2, 2, 100, 128, (None, None)),
    "dead_rows_bf16_d64": (torch.bfloat16, 2, 2, 130, 64, (10, 40)),
    "causal_gqa_f32_d64": (torch.float32, 4, 2, 150, 64, (0, None)),
    "window_f32_d128": (torch.float32, 2, 2, 130, 128, (0, 32)),
    "causal_bf16_d32": (torch.bfloat16, 4, 4, 200, 32, (0, None)),
    "band_gqa_bf16_d16": (torch.bfloat16, 4, 2, 150, 16, (-20, 30)),
    "window_gqa_f32_d32": (torch.float32, 4, 2, 140, 32, (0, 40)),
    "ragged_full_f32_d16": (torch.float32, 2, 2, 90, 16, (None, None)),
    # every head dim up to 256: the padded mma.sync widths (8 in 16, 24 in
    # 32, 40 in 64, 80 in 96, 200 in 256), the widths of public models (80,
    # 96, 256), odd and non-multiple-of-8 widths (element-wise loads and
    # stores), GQA, MQA and windows
    "causal_bf16_d80": (torch.bfloat16, 4, 4, 200, 80, (0, None)),
    "window_gqa_bf16_d96": (torch.bfloat16, 4, 2, 150, 96, (0, 40)),
    "mqa_causal_bf16_d256": (torch.bfloat16, 4, 1, 200, 256, (0, None)),
    "band_bf16_d200": (torch.bfloat16, 2, 2, 130, 200, (-20, 64)),
    "causal_bf16_d8": (torch.bfloat16, 2, 2, 100, 8, (0, None)),
    "gqa_causal_bf16_d24": (torch.bfloat16, 4, 2, 140, 24, (0, None)),
    "window_bf16_d40": (torch.bfloat16, 2, 2, 150, 40, (0, 32)),
    "causal_bf16_d3": (torch.bfloat16, 2, 2, 90, 3, (0, None)),
    "ragged_full_bf16_d17": (torch.bfloat16, 2, 1, 77, 17, (None, None)),
    "gqa_causal_bf16_d100": (torch.bfloat16, 4, 2, 130, 100, (0, None)),
    "mqa_band_bf16_d130": (torch.bfloat16, 4, 1, 100, 130, (-10, 50)),
    "causal_f32_d80": (torch.float32, 4, 4, 130, 80, (0, None)),
    "mqa_causal_f32_d256": (torch.float32, 4, 1, 100, 256, (0, None)),
    "window_gqa_f32_d96": (torch.float32, 4, 2, 120, 96, (0, 40)),
    "band_f32_d200": (torch.float32, 2, 2, 90, 200, (-20, 64)),
    "causal_f32_d8": (torch.float32, 2, 2, 70, 8, (0, None)),
    "gqa_f32_d24": (torch.float32, 4, 2, 80, 24, (0, None)),
    "causal_f32_d3": (torch.float32, 2, 2, 60, 3, (0, None)),
    "mqa_full_f32_d130": (torch.float32, 4, 1, 70, 130, (None, None)),
}


def _flash_close(out, ref, dtype, grad=True, vmax=0.0):
    r = flash_agreement(torch, out, ref, dtype, grad, vmax)
    assert r["elementwise_ok"] and r["rows_ok"] and r["rms_ok"], r


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, case):
    """Forward, dq and dk/dv kernels against the plain versions on the card:
    causal, window, band, GQA, ragged lengths, dead rows, head dims 16 to
    128, bf16 and f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype, h, h_kv, s, d, band = FLASH_CASES[case]
    q, k, v, g = [t.to(dtype) for t in _on(cuda, flash_case(
        h, h_kv, s, d, seed=len(case)))]
    reset_launch_counts()
    out, lse = flash_forward(q, k, v, band)
    ref, ref_lse = flash_forward_reference(q, k, v, band)
    torch.cuda.synchronize()
    _flash_close(out, ref, dtype, grad=False,
                 vmax=float(v.float().abs().max()))
    assert bool(((lse - ref_lse).abs() <= 1e-4 + 1e-5 * ref_lse.abs())
                .all())
    delta = (ref.float() * g.float()).sum(-1).contiguous()
    dq = flash_backward_dq(q, k, v, g, ref_lse, delta, band)
    dk, dv = flash_backward_dkv(q, k, v, g, ref_lse, delta, band)
    rq, rk, rv = flash_backward_reference(q, k, v, g, ref_lse, delta, band)
    torch.cuda.synchronize()
    for a, b in ((dq, rq), (dk, rk), (dv, rv)):
        assert a.dtype == dtype and a.shape == b.shape
        _flash_close(a, b, dtype)
    assert launch_counts()["flash_forward"] == 1
    assert launch_counts()["flash_backward_dq"] == 1
    assert launch_counts()["flash_backward_dkv"] == 1


# the backward's wgmma arm: (b, heads, kv heads, seq, head dim, band)
WGMMA_CASES = {
    "one_tile_d64": (1, 2, 2, 64, 64, (None, None)),
    "one_tile_d128": (1, 2, 2, 64, 128, (None, None)),
    "ragged130_causal_d128": (2, 4, 4, 130, 128, (0, None)),
    "ragged1000_full_d64": (1, 4, 4, 1000, 64, (None, None)),
    "ragged2047_causal_d128": (1, 2, 2, 2047, 128, (0, None)),
    "gqa8_2_causal_d64": (1, 8, 2, 256, 64, (0, None)),
    "gqa8_1_window40_d128": (1, 8, 1, 300, 128, (0, 40)),
    "band_gqa_d64": (2, 4, 2, 200, 64, (-20, 64)),
    "dead_rows_d128": (2, 2, 2, 130, 128, (10, 40)),
}


@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_flash_wgmma_arm_matches_plain(cuda, case):
    """dq, dk/dv and the delta-forming dq on the wgmma arm against the
    plain versions (``chip_smoke.flash_case_readings``): one tile, ragged
    lengths, GQA 8/2 and 8/1, a window, a band, dead rows, head dims 64 and
    128; every backward launch counts on the wgmma arm."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, h_kv, s, d, band = WGMMA_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    reset_launch_counts()
    r = flash_case_readings(torch, gen, (case, b, h, h_kv, s, d, "bf16",
                                         band))
    assert r["arm"] == r["fwd_arm"] == "wgmma" and r["ok"], r
    assert "out_f32" in r  # the forward's f32 output held as well
    # two forwards (bf16 and f32 out), both on the wgmma arm
    assert flash_forward.launches == flash_forward.launches_wgmma == 2
    # dq given delta, dq forming it, dq on the formed delta; one dk/dv
    assert flash_backward_dq.launches == 3
    assert flash_backward_dq.launches_wgmma == 3
    assert flash_backward_dkv.launches == 1
    assert flash_backward_dkv.launches_wgmma == 1


@pytest.mark.parametrize("d", [64, 128])
def test_flash_mma_arm_still_matches_plain(cuda, d):
    """The mma.sync arm that the wgmma arm replaced at head dims 64 and 128
    (phase 3b times the two on the same inputs), forced: it agrees with
    the plain version and counts no wgmma launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    band = (0, None)
    q, k, v, g = [t.bfloat16() for t in _on(cuda, flash_case(4, 2, 200, d,
                                                             seed=d))]
    ref, lse = flash_forward_reference(q, k, v, band)
    delta = (ref.float() * g.float()).sum(-1).contiguous()
    reset_launch_counts()
    dq = _launch_dq("mma", q, k, v, g, lse, delta, band)
    dk, dv = _launch_dkv("mma", q, k, v, g, lse, delta, band)
    rq, rk, rv = flash_backward_reference(q, k, v, g, lse, delta, band)
    torch.cuda.synchronize()
    for a, b in ((dq, rq), (dk, rk), (dv, rv)):
        _flash_close(a, b, torch.bfloat16)
    assert launch_counts()["flash_backward_dq"] == 1
    assert flash_backward_dq.launches_wgmma == 0
    assert flash_backward_dkv.launches_wgmma == 0


@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_mma_arm_still_matches_plain(cuda, d):
    """The forward's mma.sync arm that the wgmma arm replaced at head dims
    64 and 128 (phase 3b times the two on the same inputs), forced: it
    agrees with the plain version and counts no wgmma launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = [t.bfloat16() for t in _on(cuda, flash_case(4, 2, 200, d,
                                                             seed=d + 1))]
    vmax = float(v.float().abs().max())
    for band in ((0, None), (-20, 64), (None, None)):
        reset_launch_counts()
        out, lse = _launch_fwd("mma", q, k, v, band)
        o32, _ = _launch_fwd("mma", q, k, v, band, out_f32=True)
        ref, rlse = flash_forward_reference(q, k, v, band)
        r32, _ = flash_forward_reference(q, k, v, band, out_f32=True)
        torch.cuda.synchronize()
        _flash_close(out, ref, torch.bfloat16, grad=False, vmax=vmax)
        _flash_close(o32, r32, torch.bfloat16, grad=False, vmax=vmax)
        assert bool(((lse - rlse).abs() <= 1e-4 + 1e-5 * rlse.abs()).all())
        assert flash_forward.launches == 2
        assert flash_forward.launches_wgmma == 0


@pytest.mark.parametrize("d,dtype,wgmma", [
    (128, torch.bfloat16, True), (64, torch.bfloat16, True),
    (32, torch.bfloat16, False), (128, torch.float32, False),
    (80, torch.bfloat16, False), (256, torch.bfloat16, False),
    (256, torch.float32, False)],
    ids=["bf16_d128", "bf16_d64", "bf16_d32", "f32_d128", "bf16_d80",
         "bf16_d256", "f32_d256"])
def test_flash_backward_arm_by_head_dim(cuda, d, dtype, wgmma):
    """FlashAttention's backward launches one dq and one dk/dv kernel, on
    the wgmma arm (dq forming delta) for bf16 at head dims 64 and 128."""
    q, k, v, g = [t.to(dtype) for t in _on(cuda, flash_case(4, 2, 192, d,
                                                            seed=3))]
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launch_counts()
    out, _ = FlashAttention.apply(*a, True)
    out.backward(g)
    torch.cuda.synchronize()
    assert launch_counts()["flash_backward_dq"] == 1
    assert launch_counts()["flash_backward_dkv"] == 1
    assert flash_forward.launches_wgmma == int(wgmma)
    assert flash_backward_dq.launches_wgmma == int(wgmma)
    assert flash_backward_dkv.launches_wgmma == int(wgmma)


def test_flash_unused_lse_on_the_card(cuda):
    """An unused lse reaches the backward as ``None`` (a null dlse in the
    delta-forming kernel): the gradients equal those with an explicit zero
    lse cotangent, bit for bit."""
    q, k, v, _ = [t.bfloat16() for t in _on(cuda, flash_case(4, 2, 200,
                                                             128, seed=4))]
    grads = []
    for explicit in (False, True):
        a = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, lse = FlashAttention.apply(*a, True)
        loss = out.float().square().sum()
        if explicit:
            loss = loss + 0.0 * lse.sum()
        loss.backward()
        grads.append([t.grad for t in a])
    for x, y in zip(*grads):
        assert torch.equal(x, y)


def test_flash_autograd_matches_dense_autograd(cuda):
    """FlashAttention (kernels both ways, lse cotangent included) against
    autograd through the plain dense forward, f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = _on(cuda, flash_case(4, 2, 192, 64, seed=9))
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = FlashAttention.apply(*a, True, 64)
    ((out ** 2).sum() + lse.sum()).backward()
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    rout, rlse = flash_forward_reference(*b, (0, 64))
    ((rout ** 2).sum() + rlse.sum()).backward()
    for x, y in zip(a, b):
        _flash_close(x.grad, y.grad, torch.float32)


@pytest.mark.parametrize("extra", [
    [], ["--n_kv_heads", "2", "--sliding_window", "128", "--rope",
         "--precision", "bf16"]], ids=["defaults", "gqa_window_rope_bf16"])
def test_entry_point_trains_on_the_card(cuda, capsys, extra):
    """``python -m tpudist_torch.train`` with its own defaults (d_model 128,
    4 heads: head dim 32, seq 512, 2 layers) trains through the flash
    kernels: the loss falls (4.8 -> 0.6 in 30 steps on the CPU's plain
    path) and each kernel launches once per layer and step."""
    reset_launch_counts()
    final = train_main(extra + ["--total_iterations", "30",
                                "--log_every", "10"])
    out = capsys.readouterr().out
    first = float(out.split("iteration 0: loss/lm ")[1].split()[0])
    assert np.isfinite(final) and final < first - 1.0
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        assert launch_counts()[name] == 2 * 30


# (S, T, heads, kv heads, head dim, dtype, rope, delta, bool mask)
QKV_CASES = {
    "decode_bf16_d128": (8, 1, 8, 8, 128, torch.bfloat16, True, True, False),
    "prefill_gqa_bf16": (4, 64, 8, 2, 128, torch.bfloat16, True, True, True),
    "ragged_bf16_d64": (3, 37, 4, 2, 64, torch.bfloat16, True, True, False),
    "norope_bf16_d64": (5, 3, 4, 4, 64, torch.bfloat16, False, False,
                        False),
    "norope_delta_bf16": (2, 70, 2, 1, 128, torch.bfloat16, False, True,
                          True),
    "gqa_f32_d64": (3, 5, 4, 2, 64, torch.float32, True, True, True),
    "ragged_f32_d128": (2, 66, 2, 2, 128, torch.float32, True, False,
                        False),
}


@pytest.mark.parametrize("case", list(QKV_CASES))
def test_fused_rope_qkv_matches_plain(cuda, case):
    """Ragged S and T (row tiles cut mid-slot), GQA, rope off, with and
    without the masked delta, int32 and bool masks, bf16 and f32."""
    S, T, nh, n_kv, dh, dtype, rope, extra, on_bool = QKV_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    offs = [int(x) for x in np.random.default_rng(len(case)).integers(
        0, 2000, size=S)]
    args = qkv_inputs(torch, cuda, gen, S, T, nh, n_kv, dh, dtype, offs,
                      extra, on_bool)
    kw = dict(n_heads=nh, n_kv=n_kv, dh=dh, rope=rope)
    reset_launch_counts()
    out = fused_rope_qkv(*args, **kw)
    ref = fused_rope_qkv_reference(*args, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["fused_rope_qkv"] == 1
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    for a, b in zip(out, ref):
        assert a.dtype == dtype and a.shape == b.shape and a.is_contiguous()
        r = linear_agreement(torch, a, b, dt)
        assert r["ok"], r


# the new arms' cases (S, T, heads, kv heads, head dim, rope, delta, bool
# mask): the split arm at S·T 8 (decode), 40 (the T 5 verify), 64 (its
# last row count), a ragged S 3 x T 5, GQA 8/2, rope off; the wgmma arm at
# head dims 64 and 128, S·T 65 (a row tile cut mid-slot), 512 (prefill)
# and 1000, GQA, rope off, with and without the delta
ROPE_ARM_CASES = {
    "split_decode_S8": ("split", 8, 1, 8, 8, 128, True, True, False),
    "split_verify_T5": ("split", 8, 5, 8, 8, 128, True, True, True),
    "split_64_rows": ("split", 4, 16, 8, 8, 128, True, True, False),
    "split_ragged_3x5": ("split", 3, 5, 8, 8, 128, True, True, True),
    "split_gqa_8_2": ("split", 8, 1, 8, 2, 128, True, True, False),
    "split_norope_dh64": ("split", 8, 5, 8, 8, 64, False, True, True),
    "split_no_delta": ("split", 6, 1, 4, 2, 64, True, False, False),
    "wgmma_dh64_M65": ("wgmma", 5, 13, 8, 8, 64, True, True, False),
    "wgmma_dh128_M65": ("wgmma", 5, 13, 8, 2, 128, True, True, True),
    "wgmma_prefill_512": ("wgmma", 8, 64, 8, 8, 128, True, True, False),
    "wgmma_gqa_M1000": ("wgmma", 8, 125, 8, 2, 128, True, True, True),
    "wgmma_dh64_M1000_norope": ("wgmma", 8, 125, 4, 4, 64, False, True,
                                False),
    "wgmma_no_delta": ("wgmma", 4, 70, 8, 8, 128, True, False, False),
}


@pytest.mark.parametrize("case", list(ROPE_ARM_CASES))
def test_fused_rope_qkv_arm_matches_plain_and_mma(cuda, case):
    """The split and wgmma arms, as the plan picks them, against the plain
    version and against the forced mma.sync arm they replaced; the launch
    counts by arm follow the plan."""
    arm, S, T, nh, n_kv, dh, rope, extra, on_bool = ROPE_ARM_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    offs = [int(x) for x in np.random.default_rng(len(case)).integers(
        0, 2000, size=S)]
    args = qkv_inputs(torch, cuda, gen, S, T, nh, n_kv, dh, torch.bfloat16,
                      offs, extra, on_bool)
    kw = dict(n_heads=nh, n_kv=n_kv, dh=dh, rope=rope)
    assert _rope_arm(S * T, dh, nh * dh, torch.bfloat16) == arm
    reset_launch_counts()
    out = fused_rope_qkv(*args, **kw)
    mma = _launch_rope("mma", *args, **kw)
    ref = fused_rope_qkv_reference(*args, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["fused_rope_qkv"] == 2
    assert fused_rope_qkv.launches_split == (arm == "split")
    assert fused_rope_qkv.launches_wgmma == (arm == "wgmma")
    for a, m, b in zip(out, mma, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert a.is_contiguous()
        for other in (b, m):
            r = linear_agreement(torch, a, other, "bf16")
            assert r["ok"], r


# every head dim and depth (S, T, heads, kv heads, head dim, d_model,
# dtype, rope, delta, bool mask, arm): Phi-2's 80 at d 2560 (decode and a
# prefill chunk, the mma.sync arm), Gemma-2B's 256 at d 2048 with MQA (the
# split arm at decode, mma.sync at prefill), 96 at d 96, a head of 48 over
# d 200 (a partial last depth tile), 24 over d 100 (rows not on 16 bytes:
# element copies), an odd head dim with RoPE off, and f32
QKV_SHAPE_CASES = {
    "phi2_decode_dh80": (8, 1, 32, 32, 80, 2560, torch.bfloat16, True, True,
                         False, "mma"),
    "phi2_prefill_dh80": (2, 64, 32, 32, 80, 2560, torch.bfloat16, True,
                          True, True, "mma"),
    "gemma_decode_dh256": (8, 1, 8, 1, 256, 2048, torch.bfloat16, True, True,
                           False, "split"),
    "gemma_prefill_dh256": (2, 64, 8, 1, 256, 2048, torch.bfloat16, True,
                            True, True, "mma"),
    "dh96_d96": (3, 5, 1, 1, 96, 96, torch.bfloat16, True, True, False,
                 "mma"),
    "dh48_d200": (4, 7, 4, 2, 48, 200, torch.bfloat16, True, True, True,
                  "mma"),
    "dh24_d100": (3, 9, 4, 4, 24, 100, torch.bfloat16, True, False, False,
                  "mma"),
    "norope_dh7_d60": (3, 5, 3, 1, 7, 60, torch.bfloat16, False, True,
                       False, "mma"),
    "f32_dh80_d2560": (2, 5, 32, 32, 80, 2560, torch.float32, True, True,
                       False, "f32"),
    "f32_norope_dh7_d30": (2, 9, 2, 2, 7, 30, torch.float32, False, True,
                           True, "f32"),
}


@pytest.mark.parametrize("case", list(QKV_SHAPE_CASES))
def test_fused_rope_qkv_every_head_dim_and_depth(cuda, case):
    """Head dims that are not multiples of 32 and depths that are not
    multiples of 64 on the arm the plan picks, against the plain version
    (and, for bf16 off the mma.sync arm, against that arm too)."""
    (S, T, nh, n_kv, dh, d, dtype, rope, extra, on_bool,
     arm) = QKV_SHAPE_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    offs = [int(x) for x in np.random.default_rng(len(case)).integers(
        0, 2000, size=S)]
    args = qkv_inputs(torch, cuda, gen, S, T, nh, n_kv, dh, dtype, offs,
                      extra, on_bool, d=d)
    kw = dict(n_heads=nh, n_kv=n_kv, dh=dh, rope=rope)
    assert _rope_arm(S * T, dh, d, dtype) == arm
    reset_launch_counts()
    outs = [fused_rope_qkv(*args, **kw)]
    if arm not in ("mma", "f32"):
        outs.append(_launch_rope("mma", *args, **kw))
    ref = fused_rope_qkv_reference(*args, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["fused_rope_qkv"] == len(outs)
    assert fused_rope_qkv.launches_split == (arm == "split")
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    for out in outs:
        for a, b in zip(out, ref):
            assert a.dtype == dtype and a.shape == b.shape
            r = linear_agreement(torch, a, b, dt)
            assert r["ok"], r


@pytest.mark.parametrize("T", [1, 5])
def test_fused_rope_qkv_split_rows_do_not_depend_on_the_batch(cuda, T):
    """A row's split-arm sum does not depend on S·T: each slot alone gives
    the rows it gives among all eight, bit for bit (so the verify's rows
    sum as the decode step's)."""
    gen = torch.Generator(device=cuda).manual_seed(40 + T)
    args = qkv_inputs(torch, cuda, gen, 8, T, 8, 8, 128, torch.bfloat16,
                      [3, 70, 9, 1500, 0, 12, 640, 33])
    kw = dict(n_heads=8, n_kv=8, dh=128)
    q, k, v = _launch_rope("split", *args, **kw)
    for s in (0, 5, 7):
        one = [a[s:s + 1] if a is not None else None for a in args]
        one[1] = args[1]
        q1, k1, v1 = _launch_rope("split", *one, **kw)
        assert torch.equal(q1[0], q[s]) and torch.equal(k1[0], k[s])
        assert torch.equal(v1[0], v[s])
    assert rope_max_active_clusters(8 * T, 1024, 3072) >= 1


# (S, T, d_in, d_out, dtype, rank, ids) over an 8-block pool: 8 = sentinel
LORA_CASES = {
    "decode_bf16_r8": (8, 1, 1024, 4096, torch.bfloat16, 8,
                       [0, 8, 1, 8, 2, 3, 8, 0]),
    "prefill_bf16_r8": (3, 64, 4096, 1024, torch.bfloat16, 8, [7, 8, 7]),
    "ragged_bf16_r16": (2, 19, 300, 333, torch.bfloat16, 16, [5, 2]),
    "ragged_f32_r2": (3, 37, 256, 200, torch.float32, 2, [1, 8, 7]),
    "sentinel_f32_r64": (2, 5, 512, 260, torch.float32, 64, [8, 8]),
    # the cluster arm's edges: the speculative verify's T 5 at wi widths,
    # T at the arm's last row count and one past it (the staged arm), one
    # slot, a depth that 8 CTAs x 4 do not divide, odd depths at ranks 1
    # and 2 (no 16-byte loads), rank 64, f32
    "verify_wi_T5": (8, 5, 1024, 4096, torch.bfloat16, 8,
                     [0, 8, 1, 8, 2, 3, 8, 0]),
    "cluster_T8": (4, 8, 1024, 3072, torch.bfloat16, 8, [0, 8, 3, 1]),
    "staged_T9": (4, 9, 1024, 3072, torch.bfloat16, 8, [0, 8, 3, 1]),
    "one_slot_wo": (1, 1, 4096, 1024, torch.bfloat16, 8, [3]),
    "d_in_1000": (8, 1, 1000, 3000, torch.bfloat16, 8,
                  [0, 8, 1, 8, 2, 3, 8, 0]),
    "cluster_r1_odd": (3, 2, 1001, 500, torch.bfloat16, 1, [0, 8, 3]),
    "cluster_r2_odd": (3, 3, 1002, 500, torch.bfloat16, 2, [0, 8, 3]),
    "cluster_r64": (2, 4, 2048, 1000, torch.bfloat16, 64, [5, 8]),
    "cluster_f32_r16": (3, 3, 512, 260, torch.float32, 16, [1, 8, 7]),
    "cluster_narrow": (2, 7, 20, 9, torch.float32, 4, [1, 8]),
    # any rank: 3 and 12 padded to the widths 4 and 16, 128 and 200 in
    # chunks of 64 (the last 8 wide), on both arms, bf16 and f32; a rank
    # past the cluster arm's shared memory on the staged arm at decode
    "cluster_r3": (8, 1, 2560, 7680, torch.bfloat16, 3,
                   [0, 8, 1, 8, 2, 3, 8, 0]),
    "cluster_r12": (8, 1, 2048, 2560, torch.bfloat16, 12,
                    [0, 8, 1, 8, 2, 3, 8, 0]),
    "cluster_r128": (8, 1, 2560, 7680, torch.bfloat16, 128,
                     [0, 8, 1, 8, 2, 3, 8, 0]),
    "verify_r128_T5": (4, 5, 2560, 2560, torch.bfloat16, 128, [0, 8, 1, 2]),
    "cluster_r200": (3, 2, 1000, 777, torch.bfloat16, 200, [1, 8, 4]),
    "staged_r12": (3, 64, 2048, 2560, torch.bfloat16, 12, [5, 8, 2]),
    "staged_r128": (2, 64, 2560, 7680, torch.bfloat16, 128, [1, 8]),
    "staged_r200": (2, 33, 1000, 777, torch.bfloat16, 200, [1, 8]),
    "cluster_f32_r3_odd": (3, 3, 1001, 500, torch.float32, 3, [0, 8, 3]),
    "cluster_f32_r200": (2, 4, 512, 260, torch.float32, 200, [8, 6]),
    "staged_f32_r100": (2, 20, 300, 333, torch.float32, 100, [2, 5]),
    "decode_r4100_staged": (2, 1, 64, 40, torch.float32, 4100, [1, 8]),
}


@pytest.mark.parametrize("case", list(LORA_CASES))
def test_lora_delta_matches_plain(cuda, case):
    """Ragged T and widths, sentinel and repeated ids, ranks 1 to 4100,
    bf16 and f32, first and last layer."""
    S, T, d_in, d_out, dtype, rank, ids = LORA_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    args = lora_inputs(torch, cuda, gen, S, T, d_in, d_out, dtype, rank,
                       ids)
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    reset_launch_counts()
    for layer in (0, 7):
        out = lora_delta(*args, layer=layer)
        ref = lora_delta_reference(*args, layer=layer)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (S, T, d_out)
        r = linear_agreement(torch, out, ref, dt)
        assert r["ok"], r
    assert launch_counts()["lora_delta"] == 2
    assert lora_delta.launches_cluster == (
        2 if _lora_arm(T, rank) == "cluster" else 0)
    assert (_lora_arm(T, rank) == "cluster") == (
        T <= LORA_DECODE_ROWS and rank <= LORA_CLUSTER_MAX_RANK)


@pytest.mark.parametrize("case", ["decode_bf16_r8", "verify_wi_T5",
                                  "cluster_r64", "cluster_f32_r16",
                                  "cluster_r3", "cluster_r128",
                                  "cluster_f32_r200"])
def test_lora_delta_staged_arm_at_decode_rows(cuda, case):
    """The staged kernel the cluster arm replaced at decode and verify rows
    (forced, as phase 3c times it) agrees with the plain version too, and
    the cluster arm's card can hold a cluster at once."""
    S, T, d_in, d_out, dtype, rank, ids = LORA_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    args = lora_inputs(torch, cuda, gen, S, T, d_in, d_out, dtype, rank,
                       ids)
    reset_launch_counts()
    out = _launch_lora("staged", *args, 3)
    torch.cuda.synchronize()
    r = linear_agreement(torch, out, lora_delta_reference(*args, layer=3),
                         "bf16" if dtype == torch.bfloat16 else "f32")
    assert r["ok"], r
    assert launch_counts()["lora_delta"] == 1
    assert lora_delta.launches_cluster == 0
    assert lora_max_active_clusters(S) >= 1


def test_fused_linear_wrong_inputs_raise(cuda):
    """What the kernels do not take raises; nothing falls back to the plain
    versions."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    h, w, offs, e, on = qkv_inputs(torch, cuda, gen, 2, 3, 4, 4, 64,
                                   torch.bfloat16, [0, 1])
    kw = dict(n_heads=4, n_kv=4, dh=64)
    with pytest.raises(TypeError):
        fused_rope_qkv(h.half(), w.half(), offs, **kw)
    with pytest.raises(TypeError):
        fused_rope_qkv(h, w, offs.long(), **kw)
    with pytest.raises(TypeError):
        fused_rope_qkv(h, w.float(), offs, **kw)
    with pytest.raises(ValueError):
        fused_rope_qkv(h, w, offs.cpu(), **kw)
    # head dim 48 (not a multiple of 32) runs on the mma.sync arm
    h48, w48, offs48, _, _ = qkv_inputs(torch, cuda, gen, 2, 3, 4, 4, 48,
                                        torch.bfloat16, [0, 1])
    kw48 = dict(n_heads=4, n_kv=4, dh=48)
    for a, b in zip(fused_rope_qkv(h48, w48, offs48, **kw48),
                    fused_rope_qkv_reference(h48, w48, offs48, **kw48)):
        assert linear_agreement(torch, a, b, "bf16")["ok"]
    # an odd head dim cannot rotate (its halves do not split); RoPE off it
    # runs
    h7, w7, offs7, _, _ = qkv_inputs(torch, cuda, gen, 2, 3, 4, 4, 7,
                                     torch.bfloat16, [0, 1])
    with pytest.raises(ValueError, match="A6f"):
        fused_rope_qkv(h7, w7, offs7, n_heads=4, n_kv=4, dh=7)
    fused_rope_qkv(h7, w7, offs7, n_heads=4, n_kv=4, dh=7, rope=False)
    with pytest.raises(ValueError, match="arm"):  # 66 rows
        _launch_rope("split", h.repeat(1, 11, 1), w, offs, **kw)
    with pytest.raises(ValueError, match="arm"):
        _launch_rope("f32", h, w, offs, **kw)
    x, a, b, ids = lora_inputs(torch, cuda, gen, 2, 3, 64, 32,
                               torch.bfloat16, 8, [0, 8])
    with pytest.raises(TypeError):
        lora_delta(x.half(), a, b, ids, layer=0)
    with pytest.raises(TypeError):
        lora_delta(x, a.bfloat16(), b, ids, layer=0)
    with pytest.raises(TypeError):
        lora_delta(x, a, b, ids.long(), layer=0)
    with pytest.raises(ValueError):
        lora_delta(x, a.cpu(), b, ids, layer=0)
    # rank 3 (no compiled width of its own) runs at width 4
    x3, a3, b3, ids3 = lora_inputs(torch, cuda, gen, 2, 3, 64, 32,
                                   torch.bfloat16, 3, [0, 8])
    assert linear_agreement(torch, lora_delta(x3, a3, b3, ids3, layer=0),
                            lora_delta_reference(x3, a3, b3, ids3, layer=0),
                            "bf16")["ok"]


def test_adapter_engine_on_the_card(cuda):
    """A small bf16 LM served with fused RoPE+QKV and two adapters on the
    card: base lanes equal the engine without adapters token for token,
    and the two kernels launch once / three times per layer and forward."""
    from tpudist_torch.models import create_transformer
    from tpudist_torch.models.lora import make_adapter_factors
    from tpudist_torch.serve import SlotEngine

    model = create_transformer(0, device=cuda, dtype=torch.bfloat16,
                               vocab=64, d_model=128, n_layers=2, n_heads=2,
                               d_ff=256, max_len=128, rope=True)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 64, size=int(rng.integers(1, 40))), 12)
            for _ in range(6)]
    names = ["a", None, "b", None, "a", "b"]
    streams = {}
    for adapters in (True, False):
        eng = SlotEngine(model, num_slots=4, prefill_pad=16, kv_block=16,
                         fused_rope=True, adapters=adapters,
                         lora_kernel=adapters, device=cuda)
        if adapters:
            for i, name in enumerate(("a", "b")):
                eng.load_adapter(name, make_adapter_factors(
                    torch.Generator().manual_seed(i), model, 8, scale=0.5))
        reset_launch_counts()
        out = {}
        pending = list(enumerate(reqs))
        slot_rid = {}
        while pending or eng.num_occupied:
            items = []
            for slot in eng.free_slots():
                if not pending:
                    break
                rid, (p, n) = pending.pop(0)
                slot_rid[slot] = rid
                out[rid] = []
                items.append((slot, p, 0.0, 0, n, (), None,
                              names[rid] if adapters else None))
            got = dict(eng.start_batch(items))
            got.update(eng.advance_prefill())
            for slot, tok in got.items():
                if tok is not None:
                    out[slot_rid[slot]].append(tok)
            if eng.num_active:
                for slot, toks in eng.decode_auto()[1].items():
                    out[slot_rid[slot]].extend(toks)
            for slot in list(slot_rid):
                if len(out[slot_rid[slot]]) >= 12:
                    eng.evict(slot)
                    del slot_rid[slot]
        counts = launch_counts()
        fw = eng.n_forwards
        assert counts["fused_rope_qkv"] == 2 * fw
        assert counts["lora_delta"] == (6 * fw if adapters else 0)
        streams[adapters] = [out[i][:12] for i in range(len(reqs))]
    for i, name in enumerate(names):
        if name is None:
            assert streams[True][i] == streams[False][i]


# the register-blocked arm's and the tiled arm's edges (name, weights,
# batch): one row; a batch that is neither a multiple of the 4 rows a thread
# nor of a CTA's 512; one layer; widths 17 and 33 either side of the arms'
# bound; 9 layers; 40 layers of width 32 (widths past the kernel's by-value
# 32 and weights past its 48 KB staging); the tiled arm's 64-row tiles with
# a ragged last tile, and a few rows through mixed widths
MLP_EDGE_CASES = (("toy b1", "toy", 1), ("toy ragged b70001", "toy", 70001),
                  ("one layer 5x7", (5, 7), 999),
                  ("width 17", (2, 17, 1), 4096),
                  ("width 33", (2, 33, 1), 4096),
                  ("9 layers", (3,) + (9,) * 8 + (2,), 5000),
                  ("deep 40x32", (4,) + (32,) * 40 + (3,), 3000),
                  ("wide ragged b8385", "wide", 8385),
                  ("mixed 100/128 b77", (2, 100, 128, 1), 77))


@pytest.mark.parametrize("case", MLP_CASES + MLP_EDGE_CASES,
                         ids=[c[0] for c in MLP_CASES + MLP_EDGE_CASES])
def test_fused_mlp_matches_plain(cuda, case):
    """Phase 3e's shapes and the arms' edges: the kernel against its plain
    version and float64 numpy, one launch counted a call."""
    _, kind, batch = case
    weights, x = mlp_inputs(torch, kind, batch, cuda)
    packed = pack_params(weights)
    reset_launch_counts()
    with torch.no_grad():
        out = fused_mlp(x, packed)
        ref = mlp_reference(x, weights)
    torch.cuda.synchronize()
    assert out.shape == (batch, packed.d_out)
    mlp_agreement(torch, out, ref, weights, x)
    assert launch_counts()["fused_mlp"] == 1


def test_fused_mlp_wrong_inputs_raise(cuda):
    """A CUDA input the kernel does not take raises: no fall back to the
    plain version, no launch counted."""
    weights, x = mlp_inputs(torch, "toy", 64, cuda)
    packed = pack_params(weights)
    reset_launch_counts()
    with pytest.raises(TypeError):
        fused_mlp(x.double(), packed)
    with pytest.raises(TypeError):
        fused_mlp(torch.zeros(2, 64, device=cuda)[:, :2], packed)
    with pytest.raises(ValueError):
        fused_mlp(x, pack_params([(w.cpu(), b.cpu()) for w, b in weights]))
    with pytest.raises(ValueError, match="128"):
        pack_params([(torch.zeros(2, 129, device=cuda),
                      torch.zeros(129, device=cuda))])
    assert fused_mlp(x[:0], packed).shape == (0, 1)
    assert launch_counts()["fused_mlp"] == 0


def test_bench_fused_mlp_on_the_card(cuda):
    """The bench's checks pass on the card; every timed call launched the
    kernel."""
    reset_launch_counts()
    out = bench_fused_mlp(4096, "cuda")
    assert out["max_rel_err_vs_f64"] <= 1e-4
    assert out["plain_rel_err_vs_f64"] <= 1e-5
    assert launch_counts()["fused_mlp"] >= out["kernel_calls"] > 0


def test_toy_demo_on_the_card(cuda):
    """``python -m tpudist_torch.examples.demo`` at world size 1 under the
    torchrun contract on the NCCL group converges (phase 10)."""
    res = demo_path("ici")
    assert res["rows"] == 1000


def test_split_on_the_card_equals_unsplit(cuda):
    """The toy model in two layer groups over ``[cuda:0, cuda:0]`` equals
    the unsplit model on the card, forward and gradients bit for bit (the
    same products in the same order)."""
    from tpudist_torch.models import create_toy_model
    from tpudist_torch.models.split_mlp import split_toy_model

    whole = create_toy_model(0, device=cuda)
    split = split_toy_model(whole, [cuda, cuda])
    assert all(p.device.type == "cuda" for p in split.parameters())
    x = torch.randn(1000, 2, generator=torch.Generator().manual_seed(1)).to(
        cuda)
    a, b = whole(x), split(x)
    assert torch.equal(a, b)
    a.square().mean().backward()
    b.square().mean().backward()
    for (n, p), (m, q) in zip(whole.named_parameters(),
                              split.named_parameters()):
        assert n == m and torch.equal(p.grad, q.grad)


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """20 iterations of the demo's training on the card, unbroken, against
    10 saving every 5 and a restore into fresh states on the card resumed
    to 20: the restored tensors live on the card, and the parameters, Adam
    moments and losses equal the unbroken run's bit for bit."""
    import json

    from tpudist_torch.checkpoint import CheckpointConfig, CheckpointManager
    from tpudist_torch.config import get_args
    from tpudist_torch.examples.common import build_training
    from tpudist_torch.runtime.mesh import data_parallel_mesh
    from tpudist_torch.train import run_training
    from tpudist_torch.utils import MetricsLogger

    def training(n):
        args = get_args(["--seed", "0", "--batch_size", "128",
                         "--total_iterations", str(n)])
        states, step, loader, cfg, chunk = build_training(
            args, data_parallel_mesh(device="cuda"))
        cfg.sync_every, cfg.progress_bar = 8, False
        return states, step, loader, cfg, chunk

    def run(n, label, **kw):
        states, step, loader, cfg, chunk = training(n)
        states = kw.pop("states", states)
        path = tmp_path / label / "metrics.jsonl"
        states, _ = run_training(states, step, loader, "cuda",
                                 MetricsLogger(jsonl_path=path), cfg, chunk,
                                 **kw)
        return states, [{k: v for k, v in json.loads(line).items()
                         if k.startswith("loss/")}
                        for line in path.read_text().splitlines()]

    whole, rows = run(20, "whole")
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "ck"),
                                             save_every=5))
    run(10, "first", ckpt=mgr)
    fresh = training(20)[0]
    assert mgr.restore(fresh)["iteration"] == 10
    for st in fresh.values():
        assert all(v.is_cuda for v in st.model.state_dict().values())
        assert all(v.is_cuda for s in st.optimizer.state.values()
                   for k, v in s.items() if k != "step")
    resumed, tail = run(20, "resumed", states=fresh, start_iteration=10)
    assert tail == rows[10:]
    for n in whole:
        for (k, v), (_, w) in zip(whole[n].model.state_dict().items(),
                                  resumed[n].model.state_dict().items()):
            assert torch.equal(v, w), k
        for p, q in zip(whole[n].model.parameters(),
                        resumed[n].model.parameters()):
            sa, sb = whole[n].optimizer.state[p], resumed[n].optimizer.state[q]
            assert torch.equal(sa["exp_avg"], sb["exp_avg"])
            assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_prefetch_to_device_on_the_card(cuda):
    """``prefetch_to_device`` onto the card yields tensors equal to the
    source's, in order, with a pinned buffer never refilled before its copy
    landed: a spin on the side stream holds every copy back while the drain
    thread cycles through its 5 buffers (``host_buffer + depth + 2``) for 12
    batches, so a refill that did not wait on the copy's event would land
    a later batch in an earlier one's copy."""
    from tpudist_torch.data import prefetch_to_device

    src = [np.full((256, 4096), i, np.int32) for i in range(12)]
    it = prefetch_to_device(iter(src), cuda, depth=2, host_buffer=1)
    with torch.cuda.stream(it.stream):
        torch.cuda._sleep(400_000_000)  # ~0.2 s at the H100's ~2 GHz
    got = list(it)
    assert len(got) == len(src)
    for i, t in enumerate(got):
        assert t.device.type == "cuda"
        assert torch.equal(t.cpu(), torch.from_numpy(src[i])), i
    pairs = prefetch_to_device(((a, a[:1]) for a in src[:3]), cuda)
    for i, (x, y) in enumerate(pairs):
        assert int(x[0, 0]) == int(y[0, 0]) == i
    it.close()


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_launches_and_gradients_on_the_card(cuda, policy):
    """A step under remat recomputes every flash forward in the backward:
    per layer two forward launches, one dq and one dk/dv, all on the wgmma
    arm (bf16, head dim 64); its gradients equal the step without remat bit
    for bit (the recompute repeats the same deterministic kernels)."""
    from tpudist_torch.models import create_transformer, lm_loss

    geom = dict(vocab=64, d_model=128, n_layers=2, n_heads=2, d_ff=256,
                max_len=256)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (2, 256)).astype(np.int32)).to(cuda)
    grads = {}
    for remat in (False, True):
        model = create_transformer(0, device=cuda, dtype=torch.bfloat16,
                                   param_dtype=torch.float32, trainable=True,
                                   remat=remat, remat_policy=policy, **geom)
        reset_launch_counts()
        lm_loss(model(tokens), tokens).backward()
        counts = launch_counts()
        want = {"flash_forward": 4 if remat else 2, "flash_backward_dq": 2,
                "flash_backward_dkv": 2}
        for name, n in want.items():
            assert counts[name] == n, (name, counts[name])
        assert flash_forward.launches_wgmma == want["flash_forward"]
        assert flash_backward_dq.launches_wgmma == 2
        assert flash_backward_dkv.launches_wgmma == 2
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name


@pytest.mark.parametrize("opt", ["adafactor", "lion"])
def test_optimizer_steps_on_the_card_equal_the_cpu(cuda, opt):
    """Five adafactor or lion steps (warmup-cosine, global-norm clip, decay
    0.1) on tensors on the card against the same steps on the CPU, which
    ``tests/test_torch_train.py`` holds to optax: the same bound,
    ``rtol 1e-6, atol 1e-7`` (the same f32 formulas; the means and norms
    sum in another order)."""
    from tpudist_torch.train import build_optimizer

    r = np.random.default_rng(12)
    shapes = {"m": (128, 130), "w": (4, 3), "b": (3,)}
    init = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    kw = dict(optimizer=opt, schedule="warmup_cosine", warmup_steps=2,
              total_steps=8, grad_clip=1.0, weight_decay=0.1)
    sides = {}
    for dev in ("cpu", cuda):
        params = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in init.items()}
        sides[str(dev)] = (params, *build_optimizer(list(params.values()),
                                                    1e-2, **kw))
    for g in grads:
        for params, o, sched in sides.values():
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k].copy()).to(p.device)
            o.step()
            sched.step()
        cpu, card = sides["cpu"][0], sides[str(cuda)][0]
        for k in shapes:
            np.testing.assert_allclose(card[k].detach().cpu().numpy(),
                                       cpu[k].detach().numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


# the ring's hop shapes (phase 17): a later hop's band (None, window −
# step·shard) leaves only a corner of the block live (rows with no live key
# come back as out 0 and lse -1e30): (b, h, h_kv, s, dh, dtype, band)
RING_HOP_CASES = {
    "wgmma corner": (1, 8, 2, 2048, 128, "bf16", (None, 512 - 2048)),
    "wgmma unmasked": (1, 8, 8, 2048, 128, "bf16", (None, None)),
    "mma corner dh 80": (1, 4, 4, 512, 80, "bf16", (None, 100 - 512)),
    "f32 corner": (1, 4, 2, 512, 64, "f32", (None, 64 - 512)),
}


@pytest.mark.parametrize("case", list(RING_HOP_CASES))
def test_ring_hop_shapes_match_plain(cuda, case):
    """The flash kernels at the ring's hop shapes against their plain
    versions (``chip_smoke.flash_case_readings``: out, lse, the f32 output
    the ring merges, dq, dk/dv, the delta-forming dq), dead rows exactly 0
    and -1e30."""
    b, h, h_kv, s, d, dt, band = RING_HOP_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(17)
    r = flash_case_readings(torch, gen, (case, b, h, h_kv, s, d, dt, band))
    assert r["ok"], r
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v = (torch.randn(b, n, s, d, generator=gen, device=cuda)
               .to(dtype) for n in (h, h_kv, h_kv))
    out, lse = flash_forward(q, k, v, band, out_f32=True)
    if band[1] is not None:
        dead = torch.arange(s, device=cuda) >= s + band[1] - 1
        assert bool((out[:, :, dead] == 0).all())
        assert bool((lse[:, :, dead] == -1e30).all())


@pytest.mark.parametrize("layout", ["causal", "window 300", "zigzag",
                                    "non-causal gqa"])
def test_ring_of_four_shards_matches_single_flash(cuda, layout):
    """Ring attention over a LocalRing of 4 on the flash kernels (forward
    and backward, flash launches counted) against the single-call flash
    attention over the whole sequence, at the flash bounds."""
    from tpudist_torch.parallel import (LocalRing, make_ring_attention,
                                        make_zigzag_ring_attention,
                                        zigzag_indices)

    b, h, s, d, n = 2, 8, 1024, 128, 4
    h_kv = 2 if "gqa" in layout else h
    causal = layout != "non-causal gqa"
    window = 300 if layout == "window 300" else None
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, g = (torch.randn(b, h, s, d, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    k, v = (torch.randn(b, h_kv, s, d, generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
    if layout == "zigzag":
        pi = torch.as_tensor(zigzag_indices(s, n), device=cuda).long()
        attn = make_zigzag_ring_attention(LocalRing(n))
    else:
        pi = torch.arange(s, device=cuda)
        attn = make_ring_attention(LocalRing(n), causal=causal,
                                   window=window)
    # causal 10 (4 diagonal hops, then 3 + 2 + 1 live ones); window 300
    # over shards of 256 stops after hop 2: 4 + 3 + 2; zigzag and
    # non-causal a launch per shard and hop
    want_launches = ring_launches(n, causal, window, s // n,
                                  layout == "zigzag")
    assert want_launches == {"causal": 10, "window 300": 9}.get(layout,
                                                                n * n)

    def run(fn, ts, cot):
        leaves = [t.detach().requires_grad_(True) for t in ts]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, cot))

    reset_launch_counts()
    got = run(attn, [t[:, :, pi].contiguous() for t in (q, k, v)],
              g[:, :, pi].contiguous())
    counts = launch_counts()
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        assert counts[name] == want_launches, counts
    want = run(lambda *a: FlashAttention.apply(*a, causal, window)[0],
               [q, k, v], g)
    vmax = float(v.float().abs().max())
    for i, (x, y) in enumerate(zip(got, want)):
        _flash_close(x, y[:, :, pi], torch.bfloat16, grad=i > 0, vmax=vmax)


def test_flash_at_the_tp_shard_shape(cuda):
    """The flash kernels at the TP shard's shape (phase 7's attention at
    half its heads: b 8, h 4, s 2048, dh 128, bf16, causal) against their
    plain versions (``chip_smoke.flash_case_readings``), on the wgmma arms."""
    from chip_smoke import TP_FLASH_CASE, flash_case_readings

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(18)
    r = flash_case_readings(torch, gen, TP_FLASH_CASE)
    assert r["ok"] and r["arm"] == r["fwd_arm"] == "wgmma", r


# the folded TP run against the unsharded one, a few times above what an
# H100 80GB HBM3 at 700 W read (the same in three runs): the loss 3.42e-5
# apart, the worst gradient (pos_embed) 8.52e-3 by relative norm
FOLDED_TP_LOSS_RTOL = 2e-4
FOLDED_TP_GRAD_RTOL = 3e-2


def folded_tp_readings(cuda) -> dict:
    """One forward and backward of a small bf16-over-f32 model, unsharded
    and with a model axis of 2 folded onto the card: each run's flash
    launches, the TP loss's relative gap and each gradient's relative
    distance ``|g_tp - g| / |g|`` (by norm) from the unsharded run's."""
    from tpudist_torch.models import create_transformer, lm_loss
    from tpudist_torch.models.transformer import transformer_tp_sharding
    from tpudist_torch.parallel import shard_state
    from tpudist_torch.runtime.mesh import data_model_mesh
    from tpudist_torch.train import build_optimizer

    geom = dict(vocab=64, d_model=256, n_layers=2, n_heads=4, d_ff=512,
                max_len=256)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 256)).astype(np.int32)).to(cuda)
    grads, losses, counts = {}, {}, {}
    for tp in (False, True):
        model = create_transformer(0, device=cuda, dtype=torch.bfloat16,
                                   param_dtype=torch.float32, trainable=True,
                                   **geom)
        fwd = model
        if tp:
            opt, _ = build_optimizer(model.parameters(), 1e-3)
            fwd = shard_state(model, opt, transformer_tp_sharding(
                data_model_mesh(2, devices=[cuda, cuda]), model, opt))
        reset_launch_counts()
        loss = lm_loss(fwd(tokens), tokens)
        loss.backward()
        counts[tp] = {n: launch_counts()[n] for n in (
            "flash_forward", "flash_backward_dq", "flash_backward_dkv")}
        losses[tp] = float(loss.detach())
        if tp:
            grads[tp] = {n: fwd._whole(n, [t.grad for t in fwd.pieces[n]],
                                       fwd._shapes[n]).float()
                         for n in fwd._order}
        else:
            grads[tp] = {n: p.grad.float()
                         for n, p in model.named_parameters()}
    return dict(
        counts=counts, wgmma=flash_forward.launches_wgmma,
        loss_gap=abs(losses[True] - losses[False]) / abs(losses[False]),
        grad_rel={n: float((grads[True][n] - g).norm() / g.norm())
                  for n, g in grads[False].items()})


def test_folded_tp_block_equals_unsharded_on_the_card(cuda):
    """A model axis of 2 folded onto the card: the TP step's loss and
    every gradient against the unsharded model's (bf16 compute over f32
    masters; each shard's flash launches at its own head count: twice the
    launches, all wgmma), within ``FOLDED_TP_LOSS_RTOL`` and
    ``FOLDED_TP_GRAD_RTOL``."""
    r = folded_tp_readings(cuda)
    counts = r["counts"]
    assert counts[True] == {n: 2 * v for n, v in counts[False].items()}
    assert r["wgmma"] == counts[True]["flash_forward"]
    assert r["loss_gap"] <= FOLDED_TP_LOSS_RTOL, r["loss_gap"]
    worst = max(r["grad_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= FOLDED_TP_GRAD_RTOL, worst


def test_moe_layer_on_the_card_equals_dense_reference(cuda):
    """The expert-parallel layer over 4 places folded onto the card, top-1
    at a capacity factor of 4 (nothing drops), against the dense reference
    on the same bf16 weights: within ``MOE_REF_BOUND`` of the largest
    output magnitude, and its top-2 gradients finite."""
    from chip_smoke import MOE_REF_BOUND
    from tpudist_torch.models.transformer import (dense_moe_reference,
                                                  moe_expert_fn)
    from tpudist_torch.parallel import make_moe
    from tpudist_torch.runtime.mesh import data_model_mesh

    gen = torch.Generator(device=cuda).manual_seed(19)
    e, d, f = 4, 256, 512
    params = {"router": torch.randn(d, e, generator=gen, device=cuda),
              "experts": {
                  "w": torch.randn(e, d, f, generator=gen, device=cuda) / 16,
                  "wo": torch.randn(e, f, d, generator=gen, device=cuda)
                  / 22}}
    params = {"router": params["router"].bfloat16(),
              "experts": {k: v.bfloat16()
                          for k, v in params["experts"].items()}}
    x = torch.randn(2048, d, generator=gen, device=cuda).bfloat16()
    mesh = data_model_mesh(e, devices=[cuda] * e)
    y, stats = make_moe(mesh, moe_expert_fn, k=1,
                        capacity_factor=float(e))(params, x)
    ref = dense_moe_reference(params, x)
    assert float(stats.dropped_fraction) == 0.0
    vmax = float(ref.float().abs().max())
    assert float((y.float() - ref.float()).abs().max()) <= \
        MOE_REF_BOUND * vmax
    leaves = [params["router"]] + list(params["experts"].values())
    for t in leaves:
        t.requires_grad_(True)
    y2, st2 = make_moe(mesh, moe_expert_fn, k=2)(params, x)
    (y2.float().square().sum() + st2.balance_loss).backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)


def test_overlapped_tp_mlp_on_the_card(cuda):
    """``make_tp_mlp(overlap='ring'|'bidir')`` at model 2 and 4 folded onto
    the card against ``'off'`` in bf16, within ``m·OVERLAP_BOUND`` of the
    output's largest magnitude (``chip_smoke.overlap_mlp_readings``'s
    bound)."""
    from chip_smoke import OVERLAP_BOUND
    from tpudist_torch.parallel import init_mlp_params, make_tp_mlp
    from tpudist_torch.runtime.mesh import data_model_mesh

    gen = torch.Generator().manual_seed(20)
    params = {k: v.to(cuda).bfloat16()
              for k, v in init_mlp_params(gen, 256, 1024).items()}
    x = torch.randn(512, 256, generator=gen).to(cuda).bfloat16()
    for m in (2, 4):
        mesh = data_model_mesh(m, devices=[cuda] * m)
        off = make_tp_mlp(mesh, overlap="off")(params, x).float()
        for mode in ("ring", "bidir"):
            out = make_tp_mlp(mesh, overlap=mode)(params, x).float()
            gap = float((out - off).abs().max())
            assert gap <= m * OVERLAP_BOUND * float(off.abs().max()), \
                (m, mode, gap)


def test_ring_under_tp_on_the_card(cuda):
    """A TP block over 2 places folded onto the card under a LocalRing of
    4: each shard's ring makes ``ring_launches`` flash launches a layer on
    the wgmma arm (twice the unsharded ring's), and the loss stays within
    ``FOLDED_TP_LOSS_RTOL`` of the ring without TP."""
    from tpudist_torch.models import create_transformer, lm_loss
    from tpudist_torch.models.transformer import (RingCausal,
                                                  transformer_tp_sharding)
    from tpudist_torch.parallel import (LocalRing, SeqLayout,
                                        make_ring_attention, shard_state)
    from tpudist_torch.runtime.mesh import data_model_mesh
    from tpudist_torch.train import build_optimizer

    geom = dict(vocab=64, d_model=256, n_layers=2, n_heads=4, d_ff=512,
                max_len=1024)
    ring = LocalRing(4)
    layout = SeqLayout(ring, 1024)
    toks = np.random.default_rng(5).integers(0, 64, (2, 1024)).astype(
        np.int32)
    tokens, targets = (torch.from_numpy(a).to(cuda)
                       for a in layout.place(toks))
    ctx = RingCausal(False, make_ring_attention(ring, causal=True),
                     layout.positions)
    losses, counts = {}, {}
    for tp in (False, True):
        model = create_transformer(0, device=cuda, dtype=torch.bfloat16,
                                   param_dtype=torch.float32, trainable=True,
                                   **geom)
        fwd = model
        if tp:
            opt, _ = build_optimizer(model.parameters(), 1e-3)
            fwd = shard_state(model, opt, transformer_tp_sharding(
                data_model_mesh(2, devices=[cuda, cuda]), model, opt))
        reset_launch_counts()
        loss = layout.loss(fwd(tokens, ctx), targets)
        loss.backward()
        counts[tp] = {n: launch_counts()[n] for n in (
            "flash_forward", "flash_backward_dq", "flash_backward_dkv")}
        losses[tp] = float(loss.detach())
    per = ring_launches(4, True, None, 256) * geom["n_layers"]
    assert counts[False] == {n: per for n in counts[False]}
    assert counts[True] == {n: 2 * per for n in counts[True]}
    assert abs(losses[True] - losses[False]) / abs(losses[False]) <= \
        FOLDED_TP_LOSS_RTOL


# the folded pipeline against the unpipelined step: bf16 products at the
# microbatch's rows where the unpipelined step has the whole batch's
PIPELINE_LOSS_RTOL = 2e-4


@pytest.mark.parametrize("case", ["pipeline micro b 2", "pipeline micro b 1"])
def test_flash_at_the_pipeline_micro_shapes(cuda, case):
    """The flash kernels at phase 20's microbatch shapes (phase 7's
    attention at 2 and 1 rows: h 8, s 2048, dh 128, bf16, causal) against
    their plain versions (``chip_smoke.flash_case_readings``), on the
    wgmma arms."""
    from chip_smoke import PP_FLASH_CASES, flash_case_readings

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(20)
    r = flash_case_readings(torch, gen, dict(
        (c[0], c) for c in PP_FLASH_CASES)[case])
    assert r["ok"] and r["arm"] == r["fwd_arm"] == "wgmma", r


@pytest.mark.parametrize("schedule,micro,chunks", [
    ("gpipe", 4, 1), ("1f1b", 4, 1), ("interleaved", 8, 2)])
def test_folded_pipeline_equals_unpipelined_on_the_card(cuda, schedule,
                                                        micro, chunks):
    """A bf16-over-f32 model of 8 layers at dh 64 with 4 stages folded onto
    the card, two steps of each schedule against the unpipelined step from
    the same weights on the same batches: the losses within
    ``PIPELINE_LOSS_RTOL``; the flash launches of phase 20's table (a dead
    unit launches nothing; 1F1B recomputes each forward), all wgmma."""
    from tpudist_torch.models import create_transformer
    from tpudist_torch.parallel import make_pp_lm_train_step
    from tpudist_torch.runtime.mesh import MeshConfig, make_mesh
    from tpudist_torch.train import build_optimizer, make_lm_train_step

    geom = dict(vocab=64, d_model=256, n_layers=8, n_heads=4, d_ff=512,
                max_len=256)
    rng = np.random.default_rng(2)
    batches = [torch.from_numpy(rng.integers(0, 64, (8, 256)).astype(
        np.int32)).to(cuda) for _ in range(2)]
    losses, counts = {}, {}
    for kind in ("plain", schedule):
        model = create_transformer(0, device=cuda, dtype=torch.bfloat16,
                                   param_dtype=torch.float32, trainable=True,
                                   **geom)
        opt, _ = build_optimizer(model.parameters(), 1e-3)
        if kind == "plain":
            step = make_lm_train_step(model, opt)
        else:
            step = make_pp_lm_train_step(
                make_mesh(MeshConfig(stage=4), device=cuda), model, opt,
                n_stages=4, num_microbatches=micro, schedule=schedule,
                n_chunks=chunks)
        reset_launch_counts()
        losses[kind] = [float(step(t)) for t in batches]
        counts[kind] = {n: launch_counts()[n] for n in (
            "flash_forward", "flash_backward_dq", "flash_backward_dkv")}
        wgmma = flash_forward.launches_wgmma
    L, M = geom["n_layers"], micro
    fwd = L * M * (1 if schedule == "gpipe" else 2)
    assert counts[schedule] == {"flash_forward": 2 * fwd,
                                "flash_backward_dq": 2 * L * M,
                                "flash_backward_dkv": 2 * L * M}
    assert wgmma == counts[schedule]["flash_forward"]
    np.testing.assert_allclose(losses[schedule], losses["plain"],
                               rtol=PIPELINE_LOSS_RTOL)


def test_kernels_at_the_mesh_place_shapes(cuda):
    """Phase 21's per-place shapes, each kernel on its planned arm within
    its bound (the function raises otherwise)."""
    from chip_smoke import mesh_kernel_readings

    out = mesh_kernel_readings(torch, cuda)
    assert {k: len(v) for k, v in out.items()} == {
        "paged_attention": 2, "paged_prefill": 2, "fused_rope_qkv": 4,
        "lora_delta": 4}


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_folded_mesh_engine_on_the_card(cuda, mesh):
    """An f32 LM (4 heads of 64, RoPE) served on the kernel arms with
    fused RoPE+QKV over ``mesh`` folded onto the card: every greedy stream
    the unsharded engine's, ``peek_logits`` within 1e-5, and the per-place
    kernels at twice the unsharded launches, the sampling prep at its."""
    from tpudist_torch.models import create_transformer
    from tpudist_torch.serve import SlotEngine

    model = create_transformer(0, device=cuda, vocab=64, d_model=256,
                               n_layers=2, n_heads=4, d_ff=512, max_len=128,
                               rope=True)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 64, size=int(rng.integers(1, 40))), 12)
            for _ in range(6)]
    runs = {}
    for m in (None, mesh):
        eng = SlotEngine(model, num_slots=4, prefill_pad=16, kv_block=16,
                         fused_rope=True, device=cuda, mesh=m)
        reset_launch_counts()
        out, peeks, pending, slot_rid = {}, [], list(enumerate(reqs)), {}
        while pending or eng.num_occupied:
            items = []
            for slot in eng.free_slots():
                if not pending:
                    break
                rid, (p, n) = pending.pop(0)
                slot_rid[slot], out[rid] = rid, []
                items.append((slot, p, 0.0, 0, n))
            got = dict(eng.start_batch(items))
            got.update(eng.advance_prefill())
            for slot, tok in got.items():
                if tok is not None:
                    out[slot_rid[slot]].append(tok)
            if eng.num_active:
                peeks.append(eng.fns.peek_logits(eng.state, eng.cache))
                for slot, toks in eng.decode_auto()[1].items():
                    out[slot_rid[slot]].extend(toks)
            for slot in list(slot_rid):
                if len(out[slot_rid[slot]]) >= 12:
                    eng.evict(slot)
                    del slot_rid[slot]
        runs[m] = ([out[i][:12] for i in range(len(reqs))], peeks,
                   launch_counts())
    (want, wpeeks, wc), (got, gpeeks, gc) = runs[None], runs[mesh]
    assert got == want
    assert len(gpeeks) == len(wpeeks)
    for a, b in zip(gpeeks, wpeeks):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for k in ("fused_rope_qkv", "paged_attention", "paged_prefill"):
        assert gc[k] == 2 * wc[k] > 0, k
    assert gc["fused_sample"] == wc["fused_sample"] > 0


def test_telemetry_adds_no_launch_on_the_card(cuda, tmp_path, monkeypatch):
    """A small f32 server on the kernel arms, the same requests queued
    before start twice: with telemetry, the endpoints and a scrape of
    ``/statusz``, and with ``TPUDIST_TELEMETRY=0``.  The streams and the
    launch counts are the same; the session recorded a ``decode_block``
    span and a lifeline a request."""
    import json

    from tpudist_torch import telemetry
    from tpudist_torch.models import create_transformer
    from tpudist_torch.serve import InferenceServer, ServeConfig
    from tpudist_torch.telemetry import statusz

    model = create_transformer(0, device=cuda, vocab=64, d_model=256,
                               n_layers=2, n_heads=4, d_ff=512, max_len=128,
                               rope=True)
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, 64, size=int(rng.integers(1, 40))), 12)
            for _ in range(6)]
    runs = {}
    for on in (True, False):
        monkeypatch.setenv("TPUDIST_TELEMETRY", "1" if on else "0")
        monkeypatch.setenv("TPUDIST_METRICS_PORT", "0")
        if on:
            telemetry.start(tmp_path / "t")
        server = InferenceServer(model, ServeConfig(
            num_slots=4, prefill_pad=16, kv_block=16), device=cuda,
            install_signal_handler=False)
        hs = [server.submit(p, max_new=n) for p, n in reqs]
        reset_launch_counts()
        server.start()
        if on:
            assert "kv" in statusz.active().statusz()["serve"]
        for h in hs:
            assert h.wait(300) and h.finish_reason == "length"
        torch.cuda.synchronize()
        runs[on] = ([h.tokens for h in hs], launch_counts())
        server.close(60)
        statusz.stop()
        if on:
            telemetry.finish(write_report=False)
    assert runs[True] == runs[False]
    assert runs[True][1]["paged_attention"] > 0
    names = [json.loads(x)["name"] for x in
             (tmp_path / "t" / "rank0_gen0.jsonl").read_text().splitlines()]
    assert "decode_block" in names and names.count("req_decode") == len(reqs)


def test_preemption_save_and_resume_on_the_card(cuda, tmp_path,
                                                monkeypatch):
    """The Trainer's LM loop on the card (bf16 compute over f32 masters):
    ``sigterm@step:3`` with a save every 2 stops at 3 with a forced save
    stamped ``preempted``, its tensors restored onto the card by the
    resume, which ends at the unbroken run's loss bit for bit."""
    from tpudist_torch.models import create_transformer
    from tpudist_torch.runtime import faults
    from tpudist_torch.trainer import LMTrainerModule, Trainer

    class Tiny(LMTrainerModule):
        def configure_lm(self, generator):
            return create_transformer(
                0, device=cuda, trainable=True, dtype=torch.bfloat16,
                param_dtype=torch.float32, vocab=64, d_model=256,
                n_layers=2, n_heads=2, d_ff=512, max_len=128)

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 64, size=(4, 128)).astype(np.int32)
               for _ in range(8)]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TPUDIST_TELEMETRY", "0")
    kw = dict(max_steps=8, progress_bar=False, dry_run=True, device="cuda")
    whole = Trainer(**kw).fit(Tiny(), batches)
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("TPUDIST_FAULT", "sigterm@step:3")
    first = Trainer(checkpoint_dir=ck, checkpoint_every=2, **kw)
    first.fit(Tiny(), batches)
    faults.disarm()
    monkeypatch.delenv("TPUDIST_FAULT")
    assert first.preempted
    meta = torch.load(tmp_path / "ck" / "step_3.pt", weights_only=True)[
        "meta"]
    assert meta["preempted"] is True and meta["iteration"] == 3
    monkeypatch.setenv("TPUDIST_RESTART_COUNT", "1")
    second = Trainer(checkpoint_dir=ck, resume=True, **kw)
    got = second.fit(Tiny(), batches)
    assert not second.preempted
    assert got == whole
    assert next(second.final_states["lm"].model.parameters()).is_cuda


#: the lane-transfer arms on the card: the plain kernel engine, the int8
#: pool, phase 4b's adapter arm (fused RoPE+QKV and the LoRA gather-matmul)
#: and the spec arm (the residual prep on the sampled lane, the imported
#: lanes' drafts cold-started by draft_arm)
LANE_ARMS = {
    "plain": {}, "int8": dict(kv_int8=True),
    "adapter": dict(fused_rope=True, adapters=True, lora_kernel=True),
    "spec": dict(spec_draft=1, spec_k=4),
}


@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_lane_export_import_on_the_card(cuda, arm):
    """``export_slot`` → ``import_slot`` on a bf16 engine with head dim
    128: a greedy and a sampled lane exported after their first decode
    block, imported into other slots of an engine that evicted them and
    into a fresh engine, continue bit for bit over 3 decode blocks — the
    unbroken run's tokens on the arms without a draft; on the spec arm,
    whose imported drafts start cold, the two imports' tokens.  On the
    plain arm the bf16 greedy lane rides the wire form
    (``serialize_package``) into the fresh engine."""
    from tpudist_torch.models import create_transformer
    from tpudist_torch.models.lora import make_adapter_factors
    from tpudist_torch.serve import (SlotEngine, deserialize_package,
                                     serialize_package)

    kw = LANE_ARMS[arm]
    model = create_transformer(0, device=cuda, dtype=torch.bfloat16,
                               vocab=256, d_model=256, n_layers=2,
                               n_heads=2, d_ff=512, max_len=256, rope=True)
    factors = make_adapter_factors(torch.Generator().manual_seed(7), model,
                                   8)
    rng = np.random.default_rng(1)
    items = [(0, rng.integers(0, 256, size=70), 0.0, 3, 40, (), True,
              "a0" if kw.get("adapters") else None),
             (1, rng.integers(0, 256, size=23), 0.9, 4, 40, (), True, None)]

    def engine():
        eng = SlotEngine(model, num_slots=4, prefill_pad=32, kv_block=16,
                         decode_block=4, device=cuda, **kw)
        if kw.get("adapters"):
            eng.load_adapter("a0", factors)
        return eng

    def warm():
        eng = engine()
        eng.start_batch(items)
        while eng.prefilling_slots():
            eng.advance_prefill()
        eng.decode_auto()
        return eng

    def blocks(eng, slots):
        out = {s: [] for s in slots}
        for _ in range(3):
            for s, toks in eng.decode_auto()[1].items():
                out[s] += toks
        return [out[s] for s in slots]

    unbroken = warm()
    want = blocks(unbroken, [0, 1])
    moved = warm()
    pkgs = [moved.export_slot(s) for s in (0, 1)]
    # a paged lane travels as its pool stores it: int8 blocks and their
    # scales on the int8 arm
    want_dtype = torch.int8 if kw.get("kv_int8") else torch.bfloat16
    assert all(p["lane"].k.dtype == want_dtype for p in pkgs)
    fresh = engine()
    wire = deserialize_package(serialize_package(pkgs[0]))
    assert torch.equal(wire["lane"][0].view(torch.uint8),
                       pkgs[0]["lane"][0].cpu().view(torch.uint8))
    fresh.import_slot(2, wire if arm == "plain" else pkgs[0])
    fresh.import_slot(3, pkgs[1])
    for s in (0, 1):
        moved.evict(s)
    moved.import_slot(3, pkgs[0])
    moved.import_slot(2, pkgs[1])
    reset_launch_counts()
    got_fresh = blocks(fresh, [2, 3])
    counts = launch_counts()
    got_moved = blocks(moved, [3, 2])
    assert got_fresh == got_moved
    assert all(len(t) >= 3 for t in got_fresh)
    assert counts["paged_attention"] > 0 and counts["fused_sample"] > 0
    if arm == "spec":
        assert counts["fused_residual_prep"] > 0
    else:
        assert got_fresh == want
    if arm == "adapter":
        assert counts["fused_rope_qkv"] > 0 and counts["lora_delta"] > 0


@pytest.mark.parametrize("handoff", ["serial", "device"])
def test_disagg_server_on_the_card(cuda, handoff):
    """A bf16 ``DisaggServer`` (1 prefill worker, 2 decode workers) at
    decode block 1 serves greedy and sampled requests bit for bit as the
    ``InferenceServer`` does, through the paged prefill, the sampling prep
    and the paged decode kernels; the ``"device"`` handoff hands CUDA
    tensors over, the ``"serial"`` one host bytes."""
    from tpudist_torch.models import create_transformer
    from tpudist_torch.serve import (DisaggServer, InferenceServer,
                                     ServeConfig)

    model = create_transformer(0, device=cuda, dtype=torch.bfloat16,
                               vocab=256, d_model=256, n_layers=2,
                               n_heads=2, d_ff=512, max_len=256, rope=True)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 256, size=int(n)), 12, t)
            for n, t in zip((5, 40, 70, 100), (0.0, 0.9, 0.0, 0.9))]
    geom = dict(num_slots=4, prefill_pad=32, kv_block=16, decode_block=1)

    def run(server):
        server.start()
        try:
            hs = [server.submit(p, max_new=n, temperature=t, seed=i)
                  for i, (p, n, t) in enumerate(reqs)]
            assert all(h.wait(300) for h in hs)
            return [h.tokens for h in hs], server.stats()
        finally:
            assert server.close(60)

    want, _ = run(InferenceServer(model, ServeConfig(**geom), device=cuda,
                                  install_signal_handler=False))
    reset_launch_counts()
    got, st = run(DisaggServer(
        model, ServeConfig(disagg=True, prefill_slots=2, decode_workers=2,
                           handoff=handoff, **geom),
        device=cuda, install_signal_handler=False))
    counts = launch_counts()
    assert got == want
    assert st["handoffs"] == len(reqs)
    assert (st["handoff_bytes"] > 0) == (handoff == "serial")
    for name in ("paged_attention", "paged_prefill", "fused_sample"):
        assert counts[name] > 0, counts


def _small_lm(cuda, dtype, **extra):
    from tpudist_torch.models import create_transformer

    return create_transformer(0, device=cuda, dtype=dtype, vocab=256,
                              d_model=256, n_layers=2, n_heads=2, d_ff=512,
                              max_len=256, rope=True, **extra)


def _serve_on(server, reqs, swaps=()):
    """``reqs`` (prompt, max_new, temperature) on a started server, each
    candidate of ``swaps`` landed once the burst has emitted 8 more
    tokens; the streams, the swaps' records and the server's stats."""
    import time

    try:
        hs = [server.submit(p, max_new=n, temperature=t, seed=i)
              for i, (p, n, t) in enumerate(reqs)]
        infos = []
        for i, cand in enumerate(swaps):
            deadline = time.monotonic() + 300
            while (sum(len(h.tokens) for h in hs) < 8 * (i + 1)
                   and not all(h.done for h in hs)):
                assert time.monotonic() < deadline
                time.sleep(0.001)
            infos.append(server.swap_draft(cand))
        assert all(h.wait(300) for h in hs)
        return [h.tokens for h in hs], infos, server.stats()
    finally:
        assert server.close(60)


def test_moe_engine_on_the_card(cuda):
    """An f32 MoE model (4 experts a block, a ``moe_fn``-free top-1 FFN)
    served on the kernel arms — the paged decode, the paged prefill and
    the sampling prep — emits the greedy streams of its JAX-default arms
    on the card (the dense cache, the teacher-forced prefill, the unfused
    tail; no kernel launched there)."""
    from tpudist_torch.serve import InferenceServer, ServeConfig

    model = _small_lm(cuda, torch.float32, n_experts=4)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 256, size=int(n)), 16, 0.0)
            for n in (5, 40, 70, 100)]
    geom = dict(num_slots=4, prefill_pad=32, kv_block=16, decode_block=4)
    reset_launch_counts()
    want, _, _ = _serve_on(InferenceServer(model, ServeConfig(
        paged=False, attn_kernel="gather", prefill_kernel=False,
        sample_kernel=False, **geom), device=cuda,
        install_signal_handler=False).start(), reqs)
    assert not any(launch_counts().values())
    reset_launch_counts()
    got, _, st = _serve_on(InferenceServer(
        model, ServeConfig(**geom), device=cuda,
        install_signal_handler=False).start(), reqs)
    counts = launch_counts()
    assert got == want
    for name in ("paged_attention", "paged_prefill", "fused_sample"):
        assert counts[name] > 0, counts
    assert st["kv"]["blocks_in_use"] == 0


@pytest.mark.parametrize("arms", ["kernel f32", "dense bf16"])
def test_draft_swap_on_the_card(cuda, arms):
    """Two noised same-geometry drafts swapped into a spec server with
    requests in flight: the target's weights bit-equal, the slot programs
    the same object, the draft the last candidate, and the greedy streams
    those of the run before the swaps — bit for bit on the dense arms,
    whose decode the block schedule cannot move, and on the kernel arms in
    f32, where a moved verify window rounds below any gap between two
    logits."""
    from tpudist_torch.serve import InferenceServer, ServeConfig

    dtype = torch.float32 if arms == "kernel f32" else torch.bfloat16
    model = _small_lm(cuda, dtype)
    knobs = (dict(paged=False, attn_kernel="gather", prefill_kernel=False,
                  sample_kernel=True) if arms == "dense bf16" else {})
    cfg = ServeConfig(num_slots=4, prefill_pad=32, kv_block=16,
                      decode_block=4, spec=True, spec_draft_layers=1,
                      spec_k=4, **knobs)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 256, size=int(n)), 24, 0.0)
            for n in (5, 40, 70, 100)]
    target = {k: v.clone() for k, v in model.state_dict().items()}
    want, _, _ = _serve_on(InferenceServer(model, cfg, device=cuda,
                                           install_signal_handler=False)
                           .start(), reqs)
    server = InferenceServer(model, cfg, device=cuda,
                             install_signal_handler=False).start()
    eng, fns = server.engine, server.engine.fns
    gen = torch.Generator(device=cuda).manual_seed(7)
    _, sd = server.draft_ref()
    cands = [{k: (v.float() * (1 + 0.05 * torch.randn(
        v.shape, generator=gen, device=cuda))).to(v.dtype)
        for k, v in sd.items()} for _ in range(2)]
    reset_launch_counts()
    got, infos, st = _serve_on(server, reqs, cands)
    assert got == want
    assert [i["draft_swaps"] for i in infos] == [1, 2]
    assert st["spec"]["draft_swaps"] == 2 and eng.fns is fns
    assert all(torch.equal(v, target[k])
               for k, v in model.state_dict().items())
    assert all(torch.equal(v, cands[1][k])
               for k, v in eng.draft_model.state_dict().items())
    counts = launch_counts()
    assert counts["fused_residual_prep"] > 0
    assert (counts["paged_attention"] > 0) == (arms == "kernel f32")
