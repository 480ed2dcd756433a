"""The port at the head dims and LoRA ranks the JAX kernels take beyond the
CUDA kernels' earlier instantiations, against the JAX package on the CPU.

The same numpy inputs (seeded) go through the JAX package (its Pallas
kernels in interpret mode, as its own suite runs them) and through the
port's CPU path (the plain versions the wrappers run for CPU tensors):

- flash attention, forward (out, lse) and the gradients of ``sum(out²) +
  sum(lse)``, at head dims 8, 24, 40, 80, 96 and 256, f32 and bf16,
  causal, GQA 4:1, MQA and a sliding window, seq 128 and one or two
  batches.  f32 takes the JAX suite's own tolerances (tests/test_ops.py):
  forward within atol/rtol 2e-5, gradients within 5e-5 — the two sides
  share the -1e30 mask and the f32 softmax and differ only in summation
  order.  bf16 rounds at other points in the two frameworks (the JAX
  kernel's online softmax rounds each 64-key block's probabilities against
  that block's running max, the plain version against the row's); its
  values are held to ``BF16_FWD`` / ``BF16_GRAD`` of the largest reference
  magnitude, a few bf16 steps (2**-8);
- ``fused_rope_qkv`` at head dims 24, 80 and 96 over d_model 96 and 160,
  with and without the masked delta, and with RoPE off at odd head dims
  (5 and 7), at the JAX suite's ``atol = rtol = 1e-6`` (f32);
- ``lora_delta`` at ranks 3, 12 and 128 (every layer, sentinel ids), held
  to 2e-6 of the output's largest magnitude (two f32 contractions summed
  in another order);
- the slice's model, small: ``TransformerLM`` with RoPE at head dim 80
  (d_model 160, 2 heads) and at head dim 256 with MQA (d_model 512, 2
  heads, 1 KV head), 2 layers, vocab 64, the weights carried across by
  ``params_from_flax``.  Five Adam steps against the JAX
  ``make_lm_train_step`` (the interpreted flash kernel as its attention)
  and against the same port run in float64: each loss within rtol 1e-5
  and each parameter's change within 1e-3 by relative norm of the float64
  run (tests/test_torch_train.py's f32 bounds), and within ``LM_RTOL_JAX``
  and ``LM_CHANGE_JAX`` of JAX's, which the f32 JAX step leaves the
  float64 run by at dh 256 (the constants say by how much); and
  greedy streams of the kernel-path ``SlotEngine`` (paged decode and
  prefill kernels, fused sampling, fused RoPE+QKV, the LoRA kernel; four
  rank-12 adapters loaded, half the lanes on one) equal to the JAX kernel
  engine's, built as tests/test_torch_adapters.py builds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tpudist.models import create_transformer as jax_create
from tpudist.models.lora import make_adapter_factors as jax_factors
from tpudist.ops.flash_attention import flash_attention as jax_flash
from tpudist.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_lse)
from tpudist.ops.fused_linear import fused_rope_qkv as jax_rope_qkv
from tpudist.ops.fused_linear import lora_delta as jax_lora_delta
from tpudist.serve import SlotEngine as JaxSlotEngine
from tpudist.train.lm import init_lm_state, make_lm_train_step as jax_step
from torch_cases import settled_torch_cpu
from tpudist_torch.models import (TransformerLM, adapter_factors_from_jax,
                                  params_from_flax)
from tpudist_torch.ops import (FlashAttention, fused_rope_qkv, lora_delta)
from tpudist_torch.ops.flash_attention import (MAX_HEAD_DIM, PAD_HEAD_DIMS,
                                               SMEM_LIMIT, f32_smem,
                                               mma_smem, pad_head_dim)
from tpudist_torch.serve import SlotEngine
from tpudist_torch.train import build_optimizer, make_lm_train_step

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
BF16_FWD, BF16_GRAD = 2 ** -6, 2 ** -5
QKV_TOL = dict(atol=1e-6, rtol=1e-6)
LORA_REL = 2e-6
# the head dims the flash kernels compile in (the bf16 mma.sync tiles'
# kExact, the f32 kernels' kD); other head dims run padded or at run time
EXACT_HEAD_DIMS = (16, 32, 64, 128)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


# ---------------------------------------------------------------- flash

# (head dim, dtype, heads, kv heads, causal, window, batch)
FLASH_CASES = {
    "d8_f32_gqa4": (8, "f32", 4, 1, True, None, 2),
    "d24_bf16_mqa_window": (24, "bf16", 2, 1, True, 48, 1),
    "d40_f32_window": (40, "f32", 2, 2, True, 32, 2),
    "d80_f32_causal": (80, "f32", 2, 2, True, None, 1),
    "d80_bf16_gqa4": (80, "bf16", 4, 1, True, None, 1),
    "d96_f32_mqa": (96, "f32", 4, 1, True, None, 1),
    "d96_bf16_window": (96, "bf16", 2, 2, True, 40, 1),
    "d256_f32_mqa": (256, "f32", 2, 1, True, None, 1),
    "d256_bf16_gqa4": (256, "bf16", 4, 1, True, None, 1),
}


def _flash_inputs(d, h, h_kv, b, seed, s=128):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d))]


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_matches_interpreted_kernel(case):
    """Forward and gradients of ``sum(out²) + sum(lse)`` (the lse cotangent
    rides in the backward's delta) at the case's head dim."""
    d, dt, h, h_kv, causal, window, b = FLASH_CASES[case]
    q, k, v = _flash_inputs(d, h, h_kv, b, seed=d + h_kv)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dt == "bf16"
                else (jnp.float32, torch.float32))

    def jax_loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, causal, 64, 64, True, False,
                                 window)
        o32 = out.astype(jnp.float32)
        return jnp.sum(o32 ** 2) + jnp.sum(lse), (o32, lse)

    (_, (j_out, j_lse)), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    t = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    out, lse = FlashAttention.apply(*t, causal, window, False, 64)
    ((out.float() ** 2).sum() + lse.sum()).backward()
    assert out.dtype == tdt and lse.dtype == torch.float32
    pairs = [(out, j_out, False), (lse, j_lse, False)] + [
        (a.grad, g, True) for a, g in zip(t, j_grads)]
    for got, want, grad in pairs:
        got = got.detach().float().numpy()
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert got.shape == want.shape
        if dt == "f32":
            np.testing.assert_allclose(got, want,
                                       **(GRAD_TOL if grad else FWD_TOL))
        else:
            bound = (BF16_GRAD if grad else BF16_FWD) * np.abs(want).max()
            assert np.abs(got - want).max() <= bound, (case, grad)


def test_flash_plans_cover_every_head_dim():
    """Every head dim 1..256 has a padded mma.sync width that holds it, and
    every arm's CTA fits the card's shared memory there (the launch's own
    check passes); the padded widths, the head dims compiled in and the
    widest head dim are the kernel sources'."""
    import re

    from tpudist_torch.ops import _build
    from tpudist_torch.ops.flash_attention import _check_smem

    for d in range(1, MAX_HEAD_DIM + 1):
        p = pad_head_dim(d)
        assert p >= d and p % 16 == 0 and p in PAD_HEAD_DIMS
        for kind in ("fwd", "dq", "dkv"):
            assert mma_smem(kind, d) <= SMEM_LIMIT, (kind, d)
            assert f32_smem(kind, d) <= SMEM_LIMIT, (kind, d)
            for arm in ("mma", "f32"):
                _check_smem("flash", kind, arm, d)
    with pytest.raises(ValueError, match="A6f"):
        pad_head_dim(MAX_HEAD_DIM + 1)
    common = (_build.CSRC / "flash_common.cuh").read_text()
    assert re.search(rf"constexpr int kMaxHeadDim = {MAX_HEAD_DIM};", common)
    widths = [int(w) for w in re.findall(r"d <= (\d+)\s*\?", common)]
    assert tuple(widths + [MAX_HEAD_DIM]) == PAD_HEAD_DIMS
    fwd = (_build.CSRC / "flash_attention.cu").read_text()
    bwd = (_build.CSRC / "flash_backward.cu").read_text()
    for src, name in ((fwd, "TPD_FWD_BF16"), (bwd, "TPD_DQ_BF16"),
                      (bwd, "TPD_DKV_BF16")):
        assert tuple(int(w) for w in re.findall(
            rf"{name}_PAD\((\d+)\)\n", src)) == PAD_HEAD_DIMS
        assert tuple(int(w) for w in re.findall(
            rf"{name}_EXACT\((\d+)\)\n", src)) == EXACT_HEAD_DIMS
    for src, name in ((fwd, "TPD_FWD_F32"), (bwd, "TPD_DQ_F32"),
                      (bwd, "TPD_DKV_F32")):
        assert tuple(int(w) for w in re.findall(
            rf"{name}\((\d+)\)\n", src)) == EXACT_HEAD_DIMS + (0,)
    # past 128 the backward's columns split over CTAs in chunks of 128
    assert re.search(r"constexpr int kColChunk = 128;", bwd)


def test_flash_launch_refuses_a_cta_past_shared_memory(monkeypatch):
    """The launch's plan check raises, naming the arm, where a CTA would
    need more shared memory than one CTA may use (a lower limit stands in
    for a wider tile); the wgmma arms' two head dims are not checked."""
    import importlib

    fa = importlib.import_module("tpudist_torch.ops.flash_attention")
    monkeypatch.setattr(fa, "SMEM_LIMIT", fa.f32_smem("dkv", 64))
    fa._check_smem("flash_backward_dkv", "dkv", "f32", 64)
    with pytest.raises(ValueError, match="f32 arm"):
        fa._check_smem("flash_backward_dkv", "dkv", "f32", 66)
    with pytest.raises(ValueError, match="mma arm"):
        fa._check_smem("flash_forward", "fwd", "mma", 200)
    fa._check_smem("flash_forward", "fwd", "wgmma", 128)


def test_flash_cpu_takes_any_head_dim_and_cuda_refuses_past_256():
    """The plain version runs at head dim 300 (the JAX kernel has no
    limit); the CUDA wrapper's check refuses it before any launch, naming
    ROADMAP A6f."""
    from tpudist_torch.ops.flash_attention import _geometry

    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(300, 2, 1, 1, 0,
                                                          s=16))
    out, lse = FlashAttention.apply(q, k, v, True)
    assert out.shape == q.shape and bool(torch.isfinite(lse).all())
    with pytest.raises(ValueError, match="A6f"):
        _geometry("flash_forward", q, k, v)
    for d in (1, 3, 80, 256):
        qq = torch.zeros(1, 2, 4, d)
        assert _geometry("flash_forward", qq, qq[:, :1], qq[:, :1])[3] == d


# ------------------------------------------------------ fused_rope_qkv

# (head dim, d_model, heads, kv heads, rope, delta)
QKV_CASES = {
    "dh24_d96": (24, 96, 4, 2, True, True),
    "dh80_d160": (80, 160, 2, 2, True, True),
    "dh80_d160_mqa_base": (80, 160, 2, 1, True, False),
    "dh96_d96": (96, 96, 1, 1, True, True),
    "dh96_d160_norope": (96, 160, 2, 1, False, True),
    "dh7_d96_norope": (7, 96, 4, 2, False, True),
    "dh5_d160_norope": (5, 160, 3, 3, False, False),
}


@pytest.mark.parametrize("case", list(QKV_CASES))
def test_fused_rope_qkv_matches_interpreted_kernel(case):
    dh, d, nh, n_kv, rope, with_extra = QKV_CASES[case]
    r = np.random.default_rng(dh + d)
    S, T, dtot = 3, 4, (nh + 2 * n_kv) * dh
    h = r.normal(size=(S, T, d)).astype(np.float32)
    w = (r.normal(size=(d, dtot)) * d ** -0.5).astype(np.float32)
    offs = np.asarray([0, 3, 11], np.int32)
    extra = ((r.normal(size=(S, T, dtot)) * 0.1).astype(np.float32)
             if with_extra else None)
    on = np.asarray([1, 0, 1], np.int32) if with_extra else None
    kw = dict(n_heads=nh, n_kv=n_kv, dh=dh, rope=rope)
    want = jax_rope_qkv(*(None if a is None else jnp.asarray(a)
                          for a in (h, w, offs, extra, on)),
                        interpret=True, **kw)
    got = fused_rope_qkv(*(None if a is None else torch.from_numpy(a)
                           for a in (h, w, offs, extra, on)), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **QKV_TOL)


def test_fused_rope_qkv_odd_head_dim_needs_rope_off():
    """An odd head dim cannot split in halves for the rotation: RoPE on
    raises (naming ROADMAP A6f) whatever the device; RoPE off runs."""
    h, w = torch.zeros(1, 2, 21), torch.zeros(21, 5 * 7)
    offs = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="A6f"):
        fused_rope_qkv(h, w, offs, n_heads=3, n_kv=1, dh=7)
    q, k, v = fused_rope_qkv(h, w, offs, n_heads=3, n_kv=1, dh=7, rope=False)
    assert q.shape == (1, 3, 2, 7) and k.shape == v.shape == (1, 1, 2, 7)


# ----------------------------------------------------------- lora_delta


@pytest.mark.parametrize("rank", [3, 12, 128])
def test_lora_delta_matches_interpreted_kernel(rank):
    """Every layer, a sentinel id (B = 5 clamps to block 4); the rank runs
    at its compiled width on CUDA (4, 16, and 64 in two chunks)."""
    r = np.random.default_rng(rank)
    S, T, L, B, d_in, d_out = 3, 4, 2, 5, 48, 40
    x = r.normal(size=(S, T, d_in)).astype(np.float32)
    pa = (r.normal(size=(L, B, d_in, rank)) * d_in ** -0.5).astype(
        np.float32)
    pb = (r.normal(size=(L, B, rank, d_out)) * 0.05).astype(np.float32)
    ids = np.asarray([2, 5, 0], np.int32)
    for layer in range(L):
        got = lora_delta(*(torch.from_numpy(a) for a in (x, pa, pb, ids)),
                         layer=layer).numpy()
        want = np.asarray(jax_lora_delta(*map(jnp.asarray, (x, pa, pb, ids)),
                                         layer=layer, interpret=True))
        assert got.shape == want.shape == (S, T, d_out)
        assert np.abs(got - want).max() <= LORA_REL * np.abs(want).max()


# ------------------------------------------------------- the slice's LMs

# the two small LMs: head dim 80 (Phi-2's) and head dim 256 with MQA
# (Gemma-2B's), RoPE over the full head dim as the repo's LM rotates
LMS = {
    "dh80": dict(vocab=64, d_model=160, n_layers=2, n_heads=2, d_ff=320,
                 max_len=64, rope=True),
    "dh256_mqa": dict(vocab=64, d_model=512, n_layers=2, n_heads=2,
                      n_kv_heads=1, d_ff=512, max_len=64, rope=True),
}
SEQ, BATCH, STEPS, LR = 32, 2, 5, 1e-3
#: the port's f32 losses against the same port run in float64: the f32
#: rounding of the host's BLAS, amplified by Adam's first updates.  It is
#: host-dependent: over the 5 steps of dh256_mqa at most 7.8e-7 relative on
#: an AMD EPYC host, and 1.3447e-5 at its third step (index 2: 4.929017
#: against 4.928950) on an Intel Xeon host, where the JAX f32 loss of that
#: step is 1.3447e-5 from the float64 run as well (the other steps stay
#: within 4.6e-6); about twice the larger drift
LM_RTOL_F64 = 3e-5
#: the JAX f32 losses against the port's: the JAX step (the interpreted
#: Pallas flash, f32 sums) leaves the float64 run by up to 1.3e-5 relative
#: at dh256_mqa's third step on an AMD EPYC host, where the port stays
#: within 6e-7 of it; twice the sum of the two
LM_RTOL_JAX = 3e-5
#: each parameter's change after the steps, by relative norm: the port's
#: against its float64 run, and against JAX's.  Adam's first updates
#: divide each gradient by its own size, so the f32 rounding of the small
#: ones moves their rows by up to the learning rate, and dh256_mqa's
#: tok_embed leaves the float64 run as the host's rounding goes: on an AMD
#: EPYC host the port by at most 1.2e-4 and JAX by 4.1e-3, on an Intel
#: Xeon host the port by 4.13e-3 while staying within 4.0e-4 of JAX's
#: (every other parameter within 4.1e-4 of float64 on both hosts); both
#: bounds about twice the larger drift
LM_CHANGE_F64, LM_CHANGE_JAX = 1e-2, 1e-2


def _interpreted_flash(q, k, v):
    return jax_flash(q, k, v, True, 64, 64, True)


_interpreted_flash.supports_gqa = True


@pytest.mark.parametrize("lm", list(LMS))
def test_lm_train_steps_match_jax(lm):
    cfg = LMS[lm]
    module, params = jax_create(jax.random.PRNGKey(0), seq_len=SEQ,
                                attention_fn=_interpreted_flash, **cfg)
    tx = optax.adam(LR)
    state = init_lm_state(params, tx)
    step = jax_step(module.apply, tx,
                    Mesh(np.array(jax.devices()[:1]), ("data",)))
    model = TransformerLM(param_dtype=torch.float32, **cfg)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    assert model.head_dim == {"dh80": 80, "dh256_mqa": 256}[lm]
    opt, sched = build_optimizer(model.parameters(), LR)
    tstep = make_lm_train_step(model, opt, scheduler=sched)
    f64 = TransformerLM(param_dtype=torch.float64, dtype=torch.float64,
                        **cfg)
    f64.load_state_dict({k: v.double() for k, v in params_from_flax(
        jax.device_get(params)).items()})
    f64.requires_grad_(True)
    opt64, sched64 = build_optimizer(f64.parameters(), LR)
    step64 = make_lm_train_step(f64, opt64, scheduler=sched64)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    r = np.random.default_rng(len(lm))
    for _ in range(STEPS):
        tokens = r.integers(0, cfg["vocab"], size=(BATCH, SEQ)).astype(
            np.int32)
        state, jloss = step(state, jnp.asarray(tokens))
        loss = tstep(torch.from_numpy(tokens))
        exact = float(step64(torch.from_numpy(tokens)))
        np.testing.assert_allclose(float(loss), exact, rtol=LM_RTOL_F64)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LM_RTOL_JAX)
    ref = params_from_flax(jax.device_get(state.params))
    exact = f64.state_dict()
    got = model.state_dict()
    assert set(got) == set(ref) == set(exact)
    for name, want in ref.items():
        moved = got[name].double() - start[name].double()
        for other, bound in ((exact[name], LM_CHANGE_F64),
                             (want.double(), LM_CHANGE_JAX)):
            want_moved = other - start[name].double()
            rel = float((moved - want_moved).norm() / want_moved.norm())
            assert rel <= bound, (name, rel, bound)


FULL = dict(paged=True, attn_kernel="paged", prefill_kernel=True,
            sample_kernel=True, fused_rope=True, adapters=True,
            lora_kernel=True)
ENGINE_KW = dict(num_slots=2, prefill_pad=8, kv_block=4, decode_block=2,
                 adapter_blocks=4, adapter_rank=12)
NAMES = ["a0", None, "a3", None]


def _drive(eng, requests, names):
    """Continuous batching: admit into free slots, decode, evict each lane
    at its budget; the same calls on the JAX and the port engine."""
    pending = list(enumerate(requests))
    out = {rid: [] for rid, _ in pending}
    slot_rid, slot_budget = {}, {}

    def deliver(slot, toks):
        rid = slot_rid[slot]
        out[rid].extend(toks)
        if len(out[rid]) >= slot_budget[slot]:
            out[rid] = out[rid][:slot_budget[slot]]
            eng.evict(slot)
            del slot_rid[slot], slot_budget[slot]

    while pending or eng.num_occupied:
        free, items = eng.free_slots(), []
        while free and pending:
            rid, (prompt, max_new) = pending.pop(0)
            slot = free.pop(0)
            slot_rid[slot], slot_budget[slot] = rid, max_new
            items.append((slot, prompt, 0.0, 0, max_new, (), None,
                          names[rid]))
        for slot, tok in eng.start_batch(items).items():
            if tok is not None:
                deliver(slot, [tok])
        for slot, tok in eng.advance_prefill().items():
            deliver(slot, [tok])
        if eng.num_active:
            _, blocks = eng.decode_auto()
            for slot, toks in list(blocks.items()):
                if slot in slot_rid:
                    deliver(slot, toks)
    return [out[i] for i in range(len(requests))]


@pytest.mark.parametrize("lm", list(LMS))
def test_lm_greedy_streams_equal_the_jax_kernel_engine(lm):
    """Four requests (prompts of 3-12 tokens, chunked past the prefill pad
    of 8, 3-6 new tokens), four rank-12 adapters loaded, two of them on
    half the lanes: the port's kernel-path engine gives the JAX kernel
    engine's greedy streams."""
    cfg = dict(LMS[lm], max_len=32)
    jmod, jparams = jax_create(jax.random.PRNGKey(1), seq_len=16, **cfg)
    model = TransformerLM(**cfg)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    model.requires_grad_(False)
    factors = {f"a{i}": jax_factors(jax.random.PRNGKey(100 + i), jmod, 12)
               for i in range(4)}
    r = np.random.default_rng(len(lm))
    reqs = [(r.integers(0, cfg["vocab"], size=plen).astype(np.int32), n)
            for plen, n in zip((3, 12, 9, 5), (4, 3, 5, 6))]
    jeng = JaxSlotEngine(jmod, jparams, **FULL, **ENGINE_KW)
    eng = SlotEngine(model, **FULL, **ENGINE_KW, device="cpu")
    for name, f in factors.items():
        jeng.load_adapter(name, {k: np.asarray(v) for k, v in f.items()})
        eng.load_adapter(name, adapter_factors_from_jax(
            {k: np.asarray(v) for k, v in f.items()}))
    want = _drive(jeng, reqs, NAMES)
    got = _drive(eng, reqs, NAMES)
    assert got == want
    assert all(len(s) == n for s, (_, n) in zip(got, reqs))
    assert eng.adapter_stats()["rank"] == 12
