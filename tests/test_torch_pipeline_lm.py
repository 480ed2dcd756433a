"""The port's pipelined LM (``tpudist_torch.parallel.pipeline_lm``) against
the JAX package's, on the CPU, and over gloo.

- The layouts: ``stack_block_params``, ``unstack_block_params``,
  ``stack_block_params_interleaved`` and ``pp_state_sharding`` against
  JAX's on the same weights (the port states them over its state dicts).
- ``make_pp_lm_apply``'s logits against JAX's on a ``(data 1, stage 4)``
  mesh, from the JAX init's weights (``rtol 1e-5``).
- ``make_pp_lm_train_step`` for GPipe, 1F1B and interleaved (V 2) against
  JAX's over 3 Adam steps on ``TestLMInterleaved.CFG8``'s LM: the losses
  at ``rtol 1e-5``, each parameter's change by relative norm ``1e-3``
  (``tests/test_torch_train.py``'s bounds); also RoPE + GQA + a sliding
  window under 1F1B, and MoE blocks under GPipe.  The port folds the
  stages onto the CPU.  JAX's refusals.
- Over gloo (``tests/torch_pipeline_worker.py``): world 2 (stage 2) and
  world 4 (stage 4, and data 2 × stage 2), each schedule equal to the
  folded run (losses ``rtol 1e-6``; weights to ``1e-6`` absolute, or by
  change ``1e-3`` where the microbatches are cut otherwise), the
  replicated embedding, norm and head bit-equal on every rank, a clipped
  run, and a ``pp`` checkpoint resumed under ``dp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from test_torch_fsdp import _hold_changes
from torch_cases import settled_torch_cpu
from torch_launch import REPO, launch_ranks, torchrun_envs
from torch_pipeline_worker import (GEOM, REPLICATED, STEPS, build,
                                   case_name)
from tpudist.models import create_transformer as jax_create
from tpudist.parallel import deinterleave_block_params as jax_deinterleave
from tpudist.parallel import make_pp_lm_apply as jax_apply
from tpudist.parallel import make_pp_lm_train_step as jax_step
from tpudist.parallel import pp_state_sharding as jax_pp_sharding
from tpudist.parallel import stack_block_params as jax_stack
from tpudist.parallel import stack_block_params_interleaved as jax_stack_i
from tpudist.parallel import unstack_block_params as jax_unstack
from tpudist.train import init_lm_state
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.parallel import (deinterleave_block_params,
                                    make_pp_lm_apply, make_pp_lm_train_step,
                                    pp_state_sharding, stack_block_params,
                                    stack_block_params_interleaved,
                                    unstack_block_params)
from tpudist_torch.runtime.mesh import MeshConfig, make_mesh
from tpudist_torch.train import build_optimizer, make_lm_train_step

LR = 1e-3
CFG8 = dict(vocab=64, d_model=32, n_layers=8, n_heads=4, d_ff=64, max_len=32)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def _case(**over):
    cfg = dict(CFG8, **over)
    module, params = jax_create(jax.random.PRNGKey(0), seq_len=32, **cfg)
    return module, params, cfg


def _port(params, cfg):
    model = TransformerLM(param_dtype=torch.float32, **cfg)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model.requires_grad_(True)


def _sd(tree):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(tree)).items()}


def _jax_mesh(stages, data=1):
    return Mesh(np.asarray(jax.devices()[:data * stages]).reshape(
        data, stages), ("data", "stage"))


def test_layouts_equal_jax():
    _, params, cfg = _case()
    sd = params_from_flax(jax.device_get(params))
    for n_stages, chunks in ((4, 1), (2, 1), (4, 2), (2, 2)):
        if chunks == 1:
            want, got = jax_stack(params, n_stages), stack_block_params(
                sd, n_stages)
        else:
            want = jax_stack_i(params, n_stages, chunks)
            got = stack_block_params_interleaved(sd, n_stages, chunks)
        S, per = next(iter(got["blocks"].values())).shape[:2]
        assert (S, per) == jax.tree.leaves(want["blocks"])[0].shape[:2]
        for s in range(S):
            for j in range(per):
                blk = jax.tree.map(lambda a: a[s, j], want["blocks"])
                ref = _sd({**want["rest"], "block_0": blk})
                for name, a in got["blocks"].items():
                    np.testing.assert_array_equal(
                        a[s, j].numpy(), ref[f"blocks.0.{name}"])
        assert sorted(got["rest"]) == sorted(
            k for k in sd if not k.startswith("blocks."))
        blocks = got["blocks"] if chunks == 1 else deinterleave_block_params(
            got["blocks"], n_stages)
        back = unstack_block_params({"blocks": blocks, "rest": got["rest"]})
        assert sorted(back) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        jback = jax_unstack({"blocks": want["blocks"] if chunks == 1
                             else jax_deinterleave(want["blocks"], n_stages),
                             "rest": want["rest"]})
        assert _sd(jback).keys() == sd.keys()
    with pytest.raises(ValueError, match="8 blocks do not split into 3"):
        jax_stack(params, 3)
    with pytest.raises(ValueError, match="8 blocks do not split into 3"):
        stack_block_params(sd, 3)
    # the state layout: every block leaf on the stage axis, the rest whole
    tx = optax.adam(LR)
    state = init_lm_state(jax_stack(params, 4), tx)
    jspecs = jax_pp_sharding(_jax_mesh(4), state)
    staged = {tuple(jspecs.params["blocks"][k]["kernel" if "kernel" in
                                               jspecs.params["blocks"][k]
                                               else "scale"].spec)
              for k in jspecs.params["blocks"]}
    rest = {tuple(s.spec) for s in jax.tree.leaves(jspecs.params["rest"])}
    assert staged == {("stage",)} and rest == {()}
    model = _port(params, cfg)
    opt, _ = build_optimizer(model.parameters(), LR)
    layout = pp_state_sharding(make_mesh(MeshConfig(stage=4), device="cpu"),
                               model, opt)
    for k, spec in layout.specs.items():
        blockish = "blocks." in k.replace("/", ".")
        assert spec == (("stage",) if blockish and not k.startswith(
            "opt/count") else ()), k
    assert [list(layout.blocks_of(s)) for s in range(4)] == [
        [2 * s, 2 * s + 1] for s in range(4)]
    inter = pp_state_sharding(make_mesh(MeshConfig(stage=4), device="cpu"),
                              model, n_chunks=2)
    # device d's chunk c is global stage c·4 + d, as JAX interleaves
    assert [[inter.blocks_of(d, c)[0] for c in range(2)]
            for d in range(4)] == [[d, 4 + d] for d in range(4)]


def test_apply_equals_jax():
    module, params, cfg = _case()
    tokens = np.random.default_rng(0).integers(0, 64, size=(8, 32)).astype(
        np.int32)
    jmesh = _jax_mesh(4)
    want = np.asarray(jax.jit(jax_apply(jmesh, module, n_stages=4))(
        jax_stack(params, 4), jnp.asarray(tokens)))
    model = _port(params, cfg)
    apply = make_pp_lm_apply(make_mesh(MeshConfig(stage=4), device="cpu"),
                             model, n_stages=4)
    got = apply(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="must divide into 4"):
        apply(torch.zeros(6, 32, dtype=torch.long))


STEP_CASES = {
    "gpipe": ("gpipe", 4, 4, 1, {}),
    "1f1b": ("1f1b", 4, 4, 1, {}),
    "interleaved": ("interleaved", 4, 8, 2, {}),
    "rope_gqa_window": ("1f1b", 2, 4, 1, dict(rope=True, n_kv_heads=2,
                                              sliding_window=8)),
    "moe_gpipe": ("gpipe", 2, 4, 1, dict(n_experts=2)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_equals_jax(case):
    schedule, S, M, V, over = STEP_CASES[case]
    module, params, cfg = _case(**over)
    tx = optax.adam(LR)
    pp = jax_stack_i(params, S, V) if V > 1 else jax_stack(params, S)
    state = init_lm_state(pp, tx)
    jmesh = _jax_mesh(S)
    sharding = jax_pp_sharding(jmesh, state)
    state = jax.device_put(state, sharding)
    jstep = jax_step(jmesh, module, tx, n_stages=S, num_microbatches=M,
                     schedule=schedule, n_chunks=V, donate_state=False,
                     state_sharding=sharding)
    model = _port(params, cfg)
    start = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    opt, _ = build_optimizer(model.parameters(), LR)
    step = make_pp_lm_train_step(
        make_mesh(MeshConfig(stage=S), device="cpu"), model, opt,
        n_stages=S, num_microbatches=M, schedule=schedule, n_chunks=V)
    rng = np.random.default_rng(3)
    for _ in range(3):
        t = rng.integers(0, 64, size=(8, 32)).astype(np.int32)
        state, jloss = jstep(state, jnp.asarray(t))
        np.testing.assert_allclose(float(step(torch.from_numpy(t))),
                                   float(jloss), rtol=1e-5)
    blocks = state.params["blocks"]
    if V > 1:
        blocks = jax_deinterleave(blocks, S)
    want = _sd(jax_unstack({"blocks": blocks, "rest": state.params["rest"]}))
    got = {f"w/{k}": v.detach().numpy()
           for k, v in step.runtime.model_view.state_dict().items()}
    _hold_changes(got, want, start, 1e-3)


def test_train_step_refusals():
    module, params, cfg = _case()
    tx = optax.adam(LR)
    jmesh = _jax_mesh(4)
    model = _port(params, cfg)
    opt, _ = build_optimizer(model.parameters(), LR)
    mesh = make_mesh(MeshConfig(stage=4), device="cpu")
    for kw, msg in ((dict(schedule="zigzag"), "gpipe|1f1b|interleaved"),
                    (dict(schedule="1f1b", n_chunks=2),
                     "requires schedule='interleaved'")):
        with pytest.raises(ValueError, match=msg):
            jax_step(jmesh, module, tx, n_stages=4, **kw)
        with pytest.raises(ValueError, match=msg):
            make_pp_lm_train_step(mesh, model, opt, n_stages=4, **kw)
    moe_mod, moe_params, moe_cfg = _case(n_experts=2)
    moe = _port(moe_params, moe_cfg)
    mopt, _ = build_optimizer(moe.parameters(), LR)
    for schedule in ("1f1b", "interleaved"):
        with pytest.raises(ValueError, match="does not support MoE"):
            jax_step(jmesh, moe_mod, tx, n_stages=4, schedule=schedule)
        with pytest.raises(ValueError, match="does not support MoE"):
            make_pp_lm_train_step(mesh, moe, mopt, n_stages=4,
                                  schedule=schedule)
    with pytest.raises(ValueError, match="8 blocks do not split into 3"):
        make_pp_lm_train_step(make_mesh(MeshConfig(stage=3), device="cpu"),
                              model, opt, n_stages=3)
    with pytest.raises(ValueError, match="n_stages=2 but the mesh"):
        make_pp_lm_train_step(mesh, model, opt, n_stages=2)
    with pytest.raises(ValueError, match="stack_block_params_interleaved"):
        make_pp_lm_train_step(mesh, model, opt, n_stages=4, n_chunks=2,
                              num_microbatches=8, schedule="interleaved",
                              state_sharding=pp_state_sharding(mesh, model))
    step = make_pp_lm_train_step(mesh, model, opt, n_stages=4)
    with pytest.raises(ValueError, match="batch 6 must divide into 4"):
        step(torch.zeros(6, 32, dtype=torch.long))


# -- over gloo ------------------------------------------------------------------

W2 = ["gpipe|2|4|1|0", "1f1b|2|4|1|0", "interleaved|2|4|2|0",
      "1f1b|2|4|1|0.05", "ckpt|2|4|1|0"]
W4 = ["gpipe|4|4|1|0", "1f1b|4|4|1|0", "interleaved|4|8|2|0",
      "1f1b|2|4|1|0", "gpipe|2|4|1|0", "interleaved|2|4|2|0"]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The worker's input (a seeded model's weights and batches) and each
    world's runs: ``(inp path, {world: out dir})``."""
    from tpudist_torch.models import create_transformer

    root = tmp_path_factory.mktemp("pp_gloo")
    model = create_transformer(0, device="cpu", **GEOM)
    np.savez(root / "inp.npz", batches=np.random.default_rng(1).integers(
        0, GEOM["vocab"], size=(STEPS, 8, GEOM["max_len"])).astype(np.int32),
        **{f"w/{k}": v.numpy() for k, v in model.state_dict().items()})
    out = {}
    for world, cases in ((2, W2), (4, W4)):
        d = root / f"w{world}"
        d.mkdir()
        launch_ranks("torch_pipeline_worker", [
            "--inp", str(root / "inp.npz"), "--out", str(d), "--cases",
            ",".join(cases)], REPO / "tests", torchrun_envs(world))
        out[world] = d
    return root / "inp.npz", out


def _folded(inp, case):
    schedule, S, M, V, clip = case.split("|")
    schedule = "1f1b" if schedule == "ckpt" else schedule
    model, opt = build(inp, float(clip))
    step = make_pp_lm_train_step(
        make_mesh(MeshConfig(stage=int(S)), device="cpu"), model, opt,
        n_stages=int(S), num_microbatches=int(M), schedule=schedule,
        n_chunks=int(V))
    losses = [float(step(torch.from_numpy(t.astype(np.int64))))
              for t in inp["batches"]]
    return losses, {k: v.detach().numpy()
                    for k, v in model.state_dict().items()}


@pytest.mark.parametrize("world,case", [(2, c) for c in W2] +
                         [(4, c) for c in W4])
def test_gloo_equals_folded(gloo, world, case):
    """Each rank's losses equal the folded run's, every rank holds the
    same replicated parameters bit for bit, and the gathered weights are
    the folded run's."""
    inp_path, out = gloo
    inp = np.load(inp_path)
    runs = [np.load(out[world] / f"{case_name(case)}_r{r}.npz")
            for r in range(world)]
    losses, weights = _folded(inp, case)
    for r in runs:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-6)
        for k in REPLICATED:
            np.testing.assert_array_equal(r[f"rep/{k}"],
                                          runs[0][f"rep/{k}"])
    stages = int(case.split("|")[1])
    if world == stages:  # the same microbatches: the same sums
        for k, v in weights.items():
            np.testing.assert_allclose(runs[0][f"w/{k}"], v, atol=1e-6,
                                       err_msg=k)
    else:  # data 2: each row's microbatches are half as tall, the
        # gradients summed in another order: Adam's first steps divide
        # them by their own size, so compare the changes (the bound the
        # port holds against JAX)
        start = {k[2:]: inp[k] for k in inp.files if k.startswith("w/")}
        _hold_changes(runs[0], weights, start, 1e-3)


def test_gloo_checkpoint_resumes_under_dp(gloo):
    """The world-2 1F1B run's checkpoint (whole tensors, gathered from both
    stages) restores into a replicated world-1 run: the run's weights and
    Adam moments, and two more steps equal an unbroken dp run's."""
    from tpudist_torch.checkpoint import CheckpointConfig, CheckpointManager
    from tpudist_torch.train.step import ModelState

    inp_path, out = gloo
    inp = np.load(inp_path)
    saved = np.load(out[2] / f"{case_name('ckpt|2|4|1|0')}_r0.npz")
    model, opt = build(inp)
    mgr = CheckpointManager(CheckpointConfig(str(out[2] / "ckpt"),
                                             async_save=False))
    meta = mgr.restore({"lm": ModelState(model, model, opt)})
    mgr.close()
    assert meta["iteration"] == STEPS
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved[f"w/{k}"])
    ref, ropt = build(inp)
    rstep = make_lm_train_step(ref, ropt)
    batches = inp["batches"]
    for t in batches:
        rstep(torch.from_numpy(t.astype(np.int64)))
    for p, q in zip(model.parameters(), ref.parameters()):
        a, b = opt.state[p], ropt.state[q]
        assert float(a["step"]) == float(b["step"]) == STEPS
        np.testing.assert_allclose(a["exp_avg"].numpy(),
                                   b["exp_avg"].numpy(), rtol=1e-4,
                                   atol=1e-8)
    step = make_lm_train_step(model, opt)
    for t in batches[:2]:
        tok = torch.from_numpy(t.astype(np.int64))
        np.testing.assert_allclose(float(step(tok)), float(rstep(tok)),
                                   rtol=1e-5)
