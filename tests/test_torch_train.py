"""The port's LM training slice against the JAX package, on the CPU.

- The slice as a whole: the same flax weights (``params_from_flax``) and
  token batches through the JAX ``make_lm_train_step`` (one-device mesh,
  ``optax.adam(1e-3)``, the interpreted Pallas flash kernel as the model's
  attention, tagged ``supports_gqa``) and through the port's step with
  Adam, for three steps.  Each parameter's change over the three steps is
  held to JAX's change by relative norm, ``|Δ_port − Δ_jax| / |Δ_jax|``
  (Adam's first steps hang on the gradients' signs, so a bound on the
  parameters themselves would pass almost any update).  Bounds from the
  observed readings on the CPU: f32 and RoPE agree to 3.1e-5 at worst and
  are held to 1e-3, losses (2.1e-7 apart) to rtol 1e-5; the bf16-compute
  case rounds at different points in the two frameworks, reads 0.13 at
  worst (median 0.05) and is held to 0.3, its losses (1.6e-4 apart) to
  rtol 2e-3.  Planted faults fail each bound: half the batch left out
  reads 0.84-0.88 at worst (losses 1.6% apart), one leaf left frozen 1.0.
- Schedules and optimizers against optax (rtol 1e-6 / atol 1e-9), the
  corpus loader against JAX's (identical batches), the FLOPs accounting
  (equal counts), the LM losses (atol 1e-6) and the entry point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tpudist.data.lm import make_lm_loader as jax_make_lm_loader
from tpudist.models.transformer import (create_transformer as
                                        jax_create_transformer,
                                        lm_loss as jax_lm_loss,
                                        lm_loss_with_targets as
                                        jax_lm_loss_with_targets)
from tpudist.ops.flash_attention import flash_attention as jax_flash
from tpudist.train.lm import init_lm_state, make_lm_train_step as jax_step
from tpudist.train.optim import build_optimizer as jax_build_optimizer
from tpudist.train.optim import build_schedule as jax_schedule
from tpudist.utils import flops as jax_flops
from torch_cases import settled_torch_cpu
from tpudist_torch.data import make_lm_loader
from tpudist_torch.models import (TransformerLM, create_transformer,
                                  lm_loss, lm_loss_with_targets,
                                  params_from_flax)
from tpudist_torch.train import (build_optimizer, build_schedule,
                                 make_lm_eval_step, make_lm_train_step)
from tpudist_torch.train.__main__ import (build_training, get_args,
                                         main as train_main)
from tpudist_torch.utils import flops

GEOM = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_len=128)
SEQ, BATCH, STEPS, LR = 128, 4, 3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _interpreted_flash(q, k, v):
    return jax_flash(q, k, v, True, 64, 64, True)


_interpreted_flash.supports_gqa = True


def _batches(seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, GEOM["vocab"], size=(BATCH, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def _flat_flax(tree):
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


@pytest.mark.parametrize("case", ["f32", "bf16", "rope"])
def test_three_steps_match_jax_train_step(case):
    dtype = jnp.bfloat16 if case == "bf16" else jnp.float32
    rope = case == "rope"
    module, params = jax_create_transformer(
        jax.random.PRNGKey(0), seq_len=SEQ, attention_fn=_interpreted_flash,
        dtype=dtype, rope=rope, **GEOM)
    tx = optax.adam(LR)
    state = init_lm_state(params, tx)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    step = jax_step(module.apply, tx, mesh)

    model = TransformerLM(dtype=torch.bfloat16 if case == "bf16"
                          else torch.float32, param_dtype=torch.float32,
                          rope=rope, **GEOM)
    sd = params_from_flax(jax.device_get(params))
    model.load_state_dict(sd)
    opt, sched = build_optimizer(model.parameters(), LR)
    tstep = make_lm_train_step(model, opt, scheduler=sched)

    start = _flat_flax(jax.device_get(params))
    rtol, bound = (2e-3, 0.3) if case == "bf16" else (1e-5, 1e-3)
    for tokens in _batches(seed=len(case)):
        state, jloss = step(state, jnp.asarray(tokens))
        loss = tstep(torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    ref = _flat_flax(jax.device_get(state.params))
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(ref)
    for name, want in ref.items():
        moved, want_moved = got[name] - start[name], want - start[name]
        rel = np.linalg.norm(moved - want_moved) / np.linalg.norm(want_moved)
        assert rel <= bound, (name, rel)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_flax_weights_load_into_f32_masters_without_a_cast():
    _, params = jax_create_transformer(jax.random.PRNGKey(1), seq_len=SEQ,
                                       **GEOM)
    model = TransformerLM(dtype=torch.bfloat16, param_dtype=torch.float32,
                          **GEOM)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    flat = _flat_flax(jax.device_get(params))
    for name, t in model.state_dict().items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), flat[name])


def test_accum_steps_average_microbatch_gradients():
    """accum_steps 2 on a batch of 4 equals one step on the whole batch up
    to summation order (the mean over two halves of equal size)."""
    tokens = torch.from_numpy(_batches(seed=5)[0])
    out = []
    for accum in (1, 2):
        model = create_transformer(3, device="cpu", trainable=True,
                                   param_dtype=torch.float32, **GEOM)
        opt, _ = build_optimizer(model.parameters(), LR)
        loss = make_lm_train_step(model, opt, accum_steps=accum)(tokens)
        out.append((float(loss), model.state_dict()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for name, t in out[0][1].items():
        np.testing.assert_allclose(t.numpy(), out[1][1][name].numpy(),
                                   atol=2 * LR)
    model = create_transformer(3, device="cpu", trainable=True, **GEOM)
    opt, _ = build_optimizer(model.parameters(), LR)
    with pytest.raises(ValueError):
        make_lm_train_step(model, opt, accum_steps=3)(tokens)


def test_eval_step_and_frozen_models():
    model = create_transformer(0, device="cpu", **GEOM)
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError):
        make_lm_train_step(model, torch.optim.Adam([torch.zeros(1)]))
    tokens = torch.from_numpy(_batches()[0])
    loss = make_lm_eval_step(model)(tokens)
    assert loss.shape == () and np.isfinite(float(loss))
    # remat is ported (its gradients are held in test_torch_long_context):
    # the model takes it, and an unknown policy is refused as JAX refuses it
    assert TransformerLM(remat=True, remat_policy="dots", **GEOM).remat
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerLM(remat=True, remat_policy="everything", **GEOM)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_optax(schedule):
    kw = dict(schedule=schedule, warmup_steps=5, total_steps=40,
              min_lr_ratio=0.1)
    ours, ref = build_schedule(3e-4, **kw), jax_schedule(3e-4, **kw)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        want = float(ref(step)) if callable(ref) else ref
        got = ours(step) if callable(ours) else ours
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    opt, sched = build_optimizer([torch.zeros(2, requires_grad=True)], 3e-4,
                                 **kw)
    for step in range(8):
        want = float(ref(step)) if callable(ref) else ref
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want,
                                   rtol=1e-6, atol=1e-12)
        opt.step()
        if sched is not None:
            sched.step()


# adafactor and lion over several steps, each under a warmup-cosine schedule
# and a global-norm clip, on a factored 128 x 130 matrix and an unfactored
# vector (and a 4 x 3 matrix below adafactor's factoring size)
OPTAX_STEPS = {"adam": 1, "adamw": 1, "grad_clip": 1, "adafactor": 5,
               "adafactor_decay": 5, "lion": 5, "lion_decay": 5}


@pytest.mark.parametrize("kind", list(OPTAX_STEPS))
def test_optimizer_update_matches_optax(kind):
    """The port's update against optax's, step by step: adam, adamw and
    the clip as before (one step), adafactor and lion through the JAX
    package's own ``build_optimizer`` (``rtol=1e-6, atol=1e-7`` as the
    adam cases: both run the same f32 formulas, ``β₂(t)`` included)."""
    r = np.random.default_rng(11)
    params = {"w": r.normal(size=(4, 3)).astype(np.float32),
              "b": r.normal(size=(3,)).astype(np.float32)}
    if kind.startswith(("adafactor", "lion")):
        params["m"] = r.normal(size=(128, 130)).astype(np.float32)
    steps = OPTAX_STEPS[kind]
    grads = [{k: (r.normal(size=v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    kw = {"adam": {}, "adamw": dict(optimizer="adamw", weight_decay=0.1),
          "grad_clip": dict(grad_clip=1.0)}.get(kind)
    if kw is None:
        kw = dict(optimizer=kind.split("_")[0], schedule="warmup_cosine",
                  warmup_steps=2, total_steps=8, grad_clip=1.0,
                  weight_decay=0.1 if kind.endswith("decay") else 0.0)
        tx = jax_build_optimizer(1e-2, **kw)
    elif kind == "adamw":
        tx = optax.adamw(1e-2, weight_decay=0.1,
                         mask=lambda t: jax.tree.map(lambda p: p.ndim > 1, t))
    elif kind == "grad_clip":
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
    else:
        tx = optax.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt, sched = build_optimizer(list(tp.values()), 1e-2, **kw)
    for g in grads:
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        opt.step()
        if sched is not None:
            sched.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_lm_loader_matches_jax(tmp_path):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(2).integers(0, 500, size=5000)
            .astype(np.uint16))
    for shards, shard, seed, frac in ((1, 0, 0, 0.0), (2, 1, 7, 0.1),
                                      (3, 2, 3, 0.25)):
        kw = dict(seq_len=32, batch_size=4, num_shards=shards,
                  shard_id=shard, seed=seed, eval_fraction=frac)
        w, it, ev = make_lm_loader(path, **kw)
        jw, jit, jev = jax_make_lm_loader(path, **kw)
        assert len(w) == len(jw)
        np.testing.assert_array_equal(ev, jev)
        for _ in range(60):  # several epochs of each shard
            np.testing.assert_array_equal(next(it), next(jit))
    raw = tmp_path / "tokens.bin"
    np.arange(300, dtype=np.uint16).tofile(raw)
    w, it, _ = make_lm_loader(raw, seq_len=10, batch_size=2, seed=1)
    jw, jit, _ = jax_make_lm_loader(raw, seq_len=10, batch_size=2, seed=1)
    np.testing.assert_array_equal(next(it), next(jit))
    # num_workers > 0: the native gather pool, batch for batch the same
    w, it, ev = make_lm_loader(path, seq_len=32, batch_size=4, num_shards=2,
                               shard_id=1, seed=7, num_workers=2)
    jw, jit, jev = jax_make_lm_loader(path, seq_len=32, batch_size=4,
                                      num_shards=2, shard_id=1, seed=7,
                                      num_workers=2)
    assert type(it).__name__ == type(jit).__name__ == \
        "PrefetchingTokenBatches"
    for _ in range(60):
        np.testing.assert_array_equal(next(it), next(jit))
    it.close()
    jit.close()


def test_flops_accounting_matches_jax():
    for s, win in ((2048, None), (2048, 512), (100, 1000)):
        assert flops.attention_live_pairs(s, window=win) == \
            jax_flops.attention_live_pairs(s, window=win)
    assert flops.attention_live_pairs(64, causal=False) == \
        jax_flops.attention_live_pairs(64, causal=False)
    geom = dict(batch=8, seq_len=2048, d_model=1024, n_layers=8, d_ff=4096,
                vocab=256)
    for fwd_only in (False, True):
        assert flops.transformer_train_flops(fwd_only=fwd_only, **geom) == \
            jax_flops.transformer_train_flops(fwd_only=fwd_only, **geom)
    total = flops.transformer_train_flops(**geom)
    assert abs(total / 1e12 - 11.57) < 0.01  # the geometry's 11.57 TFLOP
    pc = dict(d_model=1024, n_layers=8, d_ff=4096, vocab=256, max_len=2048)
    assert flops.transformer_param_count(**pc) == \
        jax_flops.transformer_param_count(**pc)
    assert flops.mfu(total, 0.05, 1, peak_per_chip=989e12) == \
        jax_flops.mfu(total, 0.05, 1, peak_per_chip=989e12)
    assert flops.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.chip_hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert flops.chip_peak_flops("TPU v5 lite") is None


def test_lm_losses_match_jax():
    r = np.random.default_rng(4)
    logits = r.normal(size=(2, 9, 11)).astype(np.float32)
    tokens = r.integers(0, 11, size=(2, 9)).astype(np.int32)
    targets = tokens.copy()
    targets[0, 3] = targets[1, -1] = -1
    np.testing.assert_allclose(
        float(lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens))),
        float(jax_lm_loss(jnp.asarray(logits), jnp.asarray(tokens))),
        atol=1e-6)
    np.testing.assert_allclose(
        float(lm_loss_with_targets(torch.from_numpy(logits),
                                   torch.from_numpy(targets))),
        float(jax_lm_loss_with_targets(jnp.asarray(logits),
                                       jnp.asarray(targets))), atol=1e-6)


def test_entry_point_trains_on_cpu_and_refuses_the_rest(capsys, tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)  # the metrics rows land under runs/
    small = ["--device", "cpu", "--seq_len", "32", "--d_model", "32",
             "--n_layers", "1", "--n_heads", "2", "--d_ff", "64", "--vocab",
             "16", "--batch_size", "4", "--lr", "3e-3", "--log_every", "5"]
    final = train_main(small + ["--total_iterations", "25"])
    out = capsys.readouterr().out
    first = float(out.split("iteration 0: loss/lm ")[1].split()[0])
    assert f"final lm loss: {final:.4f}" in out and final < first - 0.5
    corpus = tmp_path / "c.npy"
    np.save(corpus, (np.arange(4096) % 16).astype(np.int32))
    assert np.isfinite(train_main(small + ["--total_iterations", "2",
                                           "--data_path", str(corpus)]))
    # --remat, --generate, the ring's flags, --fsdp and MoE are ported
    moe = get_args(small + ["--moe_experts", "4", "--moe_topk", "2"])
    assert (moe.moe_experts, moe.moe_topk) == (4, 2)
    assert np.isfinite(train_main(small + ["--total_iterations", "2",
                                           "--moe_experts", "2"]))
    assert get_args(small + ["--fsdp"]).fsdp
    sharded = train_main(small + ["--total_iterations", "2", "--fsdp"])
    assert np.isfinite(sharded)
    assert "fsdp: " in capsys.readouterr().out
    ring = get_args(small + ["--seq_shards", "2", "--zigzag",
                             "--inner_block", "16"])
    assert (ring.seq_shards, ring.zigzag, ring.inner_block) == (2, True, 16)
    with pytest.raises(SystemExit, match="excludes"):
        build_training(ring)
    assert np.isfinite(train_main(small + ["--seq_shards", "2",
                                           "--total_iterations", "2"]))
    args = get_args(small + ["--remat", "--remat_policy", "dots",
                             "--generate", "8"])
    assert args.remat and args.remat_policy == "dots" and args.generate == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_main(small[2:] + ["--total_iterations", "1"])
