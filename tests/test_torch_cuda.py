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

The fused toy-MLP kernel: ``chip_smoke.mlp_agreement`` — within 1e-5 of
its plain version and 1e-4 of a float64 numpy forward, relative to the
output's largest magnitude (both sides full f32, summed in another
order).  The toy demo on the card (world size 1 under the torchrun
contract, NCCL) converges as ``chip_smoke.demo_path`` holds it.

The residual prep: ``chip_smoke.residual_close``, the CPU test's
tolerances (``pt``/``pd`` to ``rtol 2e-6, atol 1e-7``, empty-residual rows
bit for bit, ``exp(lr)`` to ``atol 1e-6``).  A small f32 speculative engine
on the card emits the greedy streams of the card's non-speculative engine.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (MLP_CASES, decode_readings, demo_path,
                        flash_agreement, flash_case_readings,
                        linear_agreement, lora_inputs, mlp_agreement,
                        mlp_inputs, qkv_inputs, residual_close)
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
from tpudist_torch.ops.fused_linear import (LORA_DECODE_ROWS, _launch_lora,
                                            _launch_rope, _rope_arm,
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


@pytest.mark.parametrize("dh", [16, 32, 64])
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


def test_cuda_tensor_never_falls_back(cuda):
    """A CUDA tensor the kernel does not take raises; it never runs the
    plain version instead."""
    logits = torch.zeros(2, 5000, device=cuda)
    with pytest.raises(ValueError):
        fused_sample_prep(logits, torch.zeros(2, device=cuda), top_k=2)
    with pytest.raises(TypeError):
        fused_sample_prep(logits.double(), torch.zeros(2, device=cuda))
    q = torch.zeros(1, 2, 16, 48, device=cuda)  # head_dim 48: no kernel
    with pytest.raises(ValueError):
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
    (32, torch.bfloat16, False), (128, torch.float32, False)],
    ids=["bf16_d128", "bf16_d64", "bf16_d32", "f32_d128"])
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
}


@pytest.mark.parametrize("case", list(LORA_CASES))
def test_lora_delta_matches_plain(cuda, case):
    """Ragged T and widths, sentinel and repeated ids, ranks 2 to 64, bf16
    and f32, first and last layer."""
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
    assert lora_delta.launches_cluster == (2 if T <= LORA_DECODE_ROWS else 0)


@pytest.mark.parametrize("case", ["decode_bf16_r8", "verify_wi_T5",
                                  "cluster_r64", "cluster_f32_r16"])
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
    h48, w48, offs48, _, _ = qkv_inputs(torch, cuda, gen, 2, 3, 4, 4, 48,
                                        torch.bfloat16, [0, 1])
    with pytest.raises(ValueError, match="multiples of 32"):
        fused_rope_qkv(h48, w48, offs48, n_heads=4, n_kv=4, dh=48)
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
    x3, a3, b3, ids3 = lora_inputs(torch, cuda, gen, 2, 3, 64, 32,
                                   torch.bfloat16, 3, [0, 8])
    with pytest.raises(ValueError, match="ranks"):
        lora_delta(x3, a3, b3, ids3, layer=0)


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
