"""The port's tensor parallelism (``tpudist_torch.parallel.tensor_parallel``,
``TPBlock`` and ``transformer_tp_sharding``) against the JAX package's, on
the CPU: the ``model`` axis is the devices of one process (here every shard
on the CPU), the JAX side a ``model`` mesh of the suite's virtual devices.

- The MLP pair: ``tp_mlp_shard`` through ``make_tp_mlp`` at model 2 and 4
  (and with ``batch_axis='data'``) against JAX ``make_tp_mlp``: outputs and
  gradients at ``rtol 1e-5`` (f32; one sum in another order).  The specs of
  ``mlp_param_sharding``; the overlapped bodies' entry points (held against
  JAX in ``tests/test_torch_overlap.py``) and their refusals.
- The whole transformer at model 2 and 4 (MHA) and GQA 4/2 at model 2,
  from the JAX init's weights (d 64, 2 layers, seq 32, batch 8): the loss
  and every parameter's gradient against JAX ``value_and_grad`` under
  ``transformer_tp_sharding`` (``rtol 1e-5``, gradients by relative norm
  ``1e-4``), then 3 Adam steps against the JAX step under that layout
  (losses ``rtol 1e-5``, changes ``1e-3``, ``tests/test_torch_train.py``'s
  bounds).  Each shard attends over its own ``h/M`` heads.
- TP x FSDP at data 2 x model 2 over gloo (``tests/torch_fsdp_worker.py``)
  against JAX's ``merge_shardings`` step on a data 2 x model 2 mesh.
- TP of a block with an MoE FFN (dense reference, and ``make_moe`` over
  the model devices) and with an injected ``mlp_fn`` at model 2: three
  Adam steps against JAX's ``transformer_tp_sharding`` step.
- The refusals: kv heads that do not divide, the serving arms, the ring
  beside the model axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from test_torch_fsdp import _hold_changes, _mesh
from torch_cases import settled_torch_cpu
from torch_fsdp_worker import GEOMS, LR, STEPS
from torch_launch import REPO, launch_ranks, torchrun_envs
from tpudist.models.transformer import create_transformer as jax_create
from tpudist.models.transformer import lm_loss as jax_lm_loss
from tpudist.models.transformer import transformer_tp_sharding as jax_tp
from tpudist.parallel import fsdp_sharding as jax_fsdp
from tpudist.parallel import init_mlp_params as jax_init_mlp
from tpudist.parallel import make_tp_mlp as jax_make_tp_mlp
from tpudist.parallel import merge_shardings as jax_merge
from tpudist.parallel import mlp_param_sharding as jax_mlp_sharding
from tpudist.train.lm import init_lm_state, make_lm_train_step as jax_step
from tpudist_torch.models import (TransformerLM, lm_loss, params_from_flax)
from tpudist_torch.models.transformer import (DenseDecode, TPBlock,
                                              _Causal,
                                              transformer_tp_sharding)
from tpudist_torch.parallel import (make_tp_mlp, mlp_param_sharding,
                                    overlap_fsdp_mlp, shard_mlp_params,
                                    shard_state, tp_mlp_overlap_shard)
from tpudist_torch.runtime.mesh import data_model_mesh
from tpudist_torch.train import build_optimizer, make_lm_train_step


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("batch_axis", [None, "data"])
def test_tp_mlp_equals_jax(m, batch_axis):
    params = jax_init_mlp(jax.random.PRNGKey(3), 16, 64)
    params = {k: v + 0.01 * (i + 1) for i, (k, v) in enumerate(
        sorted(params.items()))}  # non-zero biases
    x = np.random.default_rng(4).normal(size=(8, 16)).astype(np.float32)
    g = np.random.default_rng(5).normal(size=(8, 16)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:m]), axis_names=("model",))
    jmlp = jax_make_tp_mlp(mesh, overlap="off")
    sharded = jax.device_put(params, jax_mlp_sharding(mesh, params))

    def jloss(p, x):
        return jnp.sum(jmlp(p, x) * g)

    want = np.asarray(jmlp(sharded, jnp.asarray(x)))
    jgrads = jax.grad(jloss, argnums=(0, 1))(sharded, jnp.asarray(x))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    mlp = make_tp_mlp(data_model_mesh(m, device="cpu"),
                      batch_axis=batch_axis)
    out = mlp(tp, tx)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    out.backward(torch.from_numpy(g))
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrads[0][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[1]),
                               rtol=1e-5, atol=1e-6)
    specs = jax_mlp_sharding(mesh, params)
    for k, spec in mlp_param_sharding(None, params).items():
        assert spec == tuple(specs[k].spec) + (None,) * (
            len(spec) - len(specs[k].spec)), k


def test_overlapped_bodies_raise(monkeypatch):
    """The overlapped bodies are ported: ``make_tp_mlp(overlap=...)`` and
    the knob give the pair's numbers (``tests/test_torch_overlap.py`` holds
    them against JAX); what still raises are JAX's refusals — a batch axis
    beside the overlapped body, an unknown explicit mode, the FSDP MLP over
    a rank's own devices."""
    mesh = data_model_mesh(2, device="cpu")
    params = {k: torch.tensor(np.asarray(v)) for k, v in
              jax_init_mlp(jax.random.PRNGKey(3), 16, 64).items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(8, 16)).astype(np.float32))
    off = make_tp_mlp(mesh, overlap="off")(params, x)
    for mode in ("ring", "bidir"):
        out = make_tp_mlp(mesh, overlap=mode)(params, x)
        np.testing.assert_allclose(out.numpy(), off.numpy(), rtol=1e-5,
                                   atol=1e-5)
        with pytest.raises(ValueError, match="batch_axis"):
            make_tp_mlp(mesh, batch_axis="data", overlap=mode)
        with pytest.raises(ValueError, match="ranks of an axis"):
            overlap_fsdp_mlp(mesh, axis_name="model", overlap=mode)
    outs = tp_mlp_overlap_shard(shard_mlp_params(params, mesh.devices),
                                list(x.chunk(2)), mode="ring")
    np.testing.assert_allclose(torch.cat(outs).numpy(), off.numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="overlap"):
        make_tp_mlp(mesh, overlap="spiral")
    assert overlap_fsdp_mlp(mesh) is None
    monkeypatch.setenv("TPUDIST_OVERLAP", "ring")
    np.testing.assert_allclose(make_tp_mlp(mesh)(params, x).numpy(),
                               off.numpy(), rtol=1e-5, atol=1e-5)


GEOM = GEOMS["d64"]


def _tp_case(n_kv):
    cfg = dict(GEOM, n_kv_heads=n_kv)
    module, params = jax_create(jax.random.PRNGKey(0), seq_len=32, **cfg)
    model = TransformerLM(param_dtype=torch.float32, **cfg)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    tokens = np.random.default_rng(7).integers(0, 32, size=(8, 32)).astype(
        np.int32)
    return module, params, model.requires_grad_(True), tokens


@pytest.mark.parametrize("m,n_kv", [(2, None), (4, None), (2, 2)])
def test_tp_transformer_equals_jax(monkeypatch, m, n_kv):
    """The loss, every gradient and three Adam steps under the Megatron
    layout against JAX's, from the same weights."""
    module, params, model, tokens = _tp_case(n_kv)
    mesh = Mesh(np.asarray(jax.devices()[:m]), axis_names=("model",))
    tx = optax.adam(LR)
    state = init_lm_state(params, tx)
    sharding = jax_tp(mesh, state)
    state = jax.device_put(state, sharding)
    jtok = jnp.asarray(tokens)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(module.apply(p, jtok), jtok)))(state.params)
    jgrads = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(jg)).items()}
    start = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}

    opt, _ = build_optimizer(model.parameters(), LR)
    layout = transformer_tp_sharding(data_model_mesh(m, device="cpu"),
                                     model, opt)
    rt = shard_state(model, opt, layout)
    assert all(isinstance(b, TPBlock) for b in model.blocks)
    heads = []
    real = _Causal.attend

    def counting(self, layer, q, k, v, rotated=False):
        heads.append((q.shape[1], k.shape[1]))
        return real(self, layer, q, k, v, rotated)

    monkeypatch.setattr(_Causal, "attend", counting)
    loss = lm_loss(rt(torch.from_numpy(tokens).long()),
                   torch.from_numpy(tokens).long())
    monkeypatch.undo()
    n_kv = n_kv or GEOM["n_heads"]
    assert heads == [(GEOM["n_heads"] // m, n_kv // m)] * (
        m * GEOM["n_layers"])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    for name in rt._order:
        grads = [t.grad for t in rt.pieces[name]]
        got = rt._whole(name, grads, rt._shapes[name]).numpy()
        assert _rel(got, jgrads[name]) <= 1e-4, name

    jstep = jax_step(module.apply, tx, mesh, donate_state=False,
                     state_sharding=sharding)
    _, _, model2, _ = _tp_case(None if n_kv == GEOM["n_heads"] else n_kv)
    opt2, _ = build_optimizer(model2.parameters(), LR)
    step = make_lm_train_step(model2, opt2, state_sharding=(
        transformer_tp_sharding(data_model_mesh(m, device="cpu"), model2,
                                opt2)))
    rng = np.random.default_rng(8)
    for _ in range(STEPS):
        t = rng.integers(0, 32, size=(8, 32)).astype(np.int32)
        state, jloss = jstep(state, jnp.asarray(t))
        np.testing.assert_allclose(float(step(torch.from_numpy(t).long())),
                                   float(jloss), rtol=1e-5)
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(state.params)).items()}
    got = {f"w/{k}": v.detach().numpy()
           for k, v in step.runtime.model_view.state_dict().items()}
    _hold_changes(got, want, start, 1e-3)


TP_FFN_CASES = ["moe_dense", "moe_fn", "mlp_fn"]


def _tp_ffn_models(case, mesh):
    """The JAX module and the port's model of ``case`` at model 2 (data 1
    in JAX's ``mesh``): two experts a block without and with a
    ``moe_fn`` (``make_moe`` over the model devices, top-1), or the
    overlapped FSDP MLP injected as ``mlp_fn``."""
    from tpudist.models.transformer import moe_expert_fn as jax_expert_fn
    from tpudist.parallel import make_moe as jax_make_moe
    from tpudist.train.lm import fsdp_overlap_mlp_fn as jax_mlp_fn
    from tpudist_torch.models import moe_expert_fn
    from tpudist_torch.parallel import make_moe
    from tpudist_torch.train.lm import fsdp_overlap_mlp_fn

    cfg = dict(GEOM, n_experts=2) if case.startswith("moe") else dict(GEOM)
    pmesh = data_model_mesh(2, device="cpu")
    jfn = pfn = None
    if case == "moe_fn":
        jfn = jax_make_moe(mesh, jax_expert_fn, k=1)
        pfn = make_moe(pmesh, moe_expert_fn, k=1)
    elif case == "mlp_fn":
        jfn = jax_mlp_fn(mesh, overlap="ring")
        pfn = fsdp_overlap_mlp_fn(pmesh, overlap="ring")
    key = "moe_fn" if case == "moe_fn" else "mlp_fn"
    module, params = jax_create(jax.random.PRNGKey(0), seq_len=32,
                                **{**cfg, key: jfn})
    model = TransformerLM(param_dtype=torch.float32, **cfg)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    setattr(model, key, pfn)
    return module, params, model.requires_grad_(True), pmesh


@pytest.mark.parametrize("case", TP_FFN_CASES)
def test_tp_moe_and_mlp_fn_equal_jax(case):
    """TP of a block with an MoE FFN (the expert stacks split on their
    expert axis over ``model``, the router replicated; the dense reference
    or ``make_moe`` over the same model devices) and of a block with an
    injected ``mlp_fn`` (JAX runs it: the partitioner feeds the
    ``mlp_fn`` its own layout), at model 2: three Adam steps under
    ``transformer_tp_sharding`` against JAX's (losses ``rtol 1e-5``,
    changes ``1e-3``)."""
    mesh = _mesh((1, 2), ("data", "model"))
    module, params, model, pmesh = _tp_ffn_models(case, mesh)
    start = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    tx = optax.adam(LR)
    state = init_lm_state(params, tx)
    sharding = jax_tp(mesh, state)
    state = jax.device_put(state, sharding)
    if case.startswith("moe"):
        w = sharding.params["params"]["block_0"]["moe"]
        assert tuple(w["w"].spec) == ("model",)
        assert tuple(w["router"].spec) == ()
    jstep = jax_step(module.apply, tx, mesh, donate_state=False,
                     state_sharding=sharding)
    opt, _ = build_optimizer(model.parameters(), LR)
    layout = transformer_tp_sharding(pmesh, model, opt)
    step = make_lm_train_step(model, opt, state_sharding=layout)
    assert all(isinstance(b, TPBlock) for b in model.blocks)
    if case.startswith("moe"):
        assert layout.leaves["blocks.0.moe.w"].split() == (0, "model")
        assert [p.shape[0] for p in model.blocks[0].pieces("moe.w")] == \
            [1, 1]
    rng = np.random.default_rng(8)
    for _ in range(STEPS):
        t = rng.integers(0, 32, size=(8, 32)).astype(np.int32)
        state, jloss = jstep(state, jnp.asarray(t))
        np.testing.assert_allclose(float(step(torch.from_numpy(t).long())),
                                   float(jloss), rtol=1e-5)
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(state.params)).items()}
    got = {f"w/{k}": v.detach().numpy()
           for k, v in step.runtime.model_view.state_dict().items()}
    _hold_changes(got, want, start, 1e-3)
    # the replicated block of the same weights, from the TP block
    blk = model.blocks[0].to_block()
    for k, v in model.blocks[0].state_dict().items():
        assert torch.equal(blk.state_dict()[k], v), k


def test_tp_refusals():
    _, _, model, _ = _tp_case(2)
    with pytest.raises(ValueError, match="n_kv_heads 2 does not divide"):
        TPBlock(model.blocks[0], ["cpu"] * 4)
    blk = TPBlock(model.blocks[0], ["cpu"] * 2)
    x = torch.zeros(1, 1, GEOM["d_model"])
    with pytest.raises(ValueError, match="training arm only"):
        blk(x, DenseDecode(model, 1, "cpu"))
    whole = blk.to_block()
    for k, v in model.blocks[0].state_dict().items():
        assert torch.equal(whole.state_dict()[k], v)
        assert torch.equal(blk.state_dict()[k], v)


def test_tp_times_fsdp_over_gloo_equals_jax(tmp_path):
    """TP over a model axis of 2 in each of 2 processes, FSDP over the
    two (``merge_shardings``) against JAX's merged step on data 2 x model
    2: the losses at ``rtol 1e-5``, the changes at ``1e-3``."""
    module, params = jax_create(jax.random.PRNGKey(0), seq_len=32, **GEOM)
    batches = np.random.default_rng(1).integers(0, 32, size=(
        STEPS, 8, 32)).astype(np.int32)
    arrays = {f"d64/{k}": v.numpy() for k, v in params_from_flax(
        jax.device_get(params)).items()}
    np.savez(tmp_path / "inp.npz", d64_batches=batches, **arrays)
    launch_ranks("torch_fsdp_worker", ["--inp", str(tmp_path / "inp.npz"),
                                       "--out", str(tmp_path), "--cases",
                                       "merged|adam|0"],
                 REPO / "tests", torchrun_envs(2))
    got = np.load(tmp_path / "merged_adam_0.npz")
    mesh = _mesh((2, 2), ("data", "model"))
    tx = optax.adam(LR)
    state = init_lm_state(params, tx)
    merged = jax_merge(jax_tp(mesh, state), jax_fsdp(mesh, state))
    state = jax.device_put(state, merged)
    step = jax_step(module.apply, tx, mesh, donate_state=False,
                    state_sharding=merged)
    losses = []
    for t in batches:
        state, loss = step(state, jnp.asarray(t))
        losses.append(float(loss))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(state.params)).items()}
    _hold_changes(got, want, {k[4:]: v for k, v in arrays.items()}, 1e-3)
