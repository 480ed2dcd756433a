"""The port's MoE (``tpudist_torch.parallel.moe``, ``MoEFFN``, the LM
step's ``aux`` and ``moe_balance_weight``, ``demo_long_context
--moe_experts``) against the JAX package's, on the CPU.

- ``make_moe`` on a model axis of 4 (folded onto one process) against the
  JAX layer on 4 virtual devices: the output, ``MoEStats`` and the
  gradients of ``Σ y·g + balance``, at top-1 and top-2, with and without
  dropped assignments, and with ties in the router's logits (all tied, and
  two experts' columns equal: ``lax.top_k`` takes the lower index).
  Bounds ``rtol 1e-5`` elementwise on the outputs and stats, and by
  relative norm on the gradients (f32 sums over the tokens in another
  order: the JAX combine is an einsum, the port's a gather and a sum of
  ``k`` rows).
- ``dense_moe_reference`` (the FFN without a ``moe_fn``) against JAX's;
  the MoE LM (``params_from_flax`` carries the ``moe`` subtree): 3 Adam
  steps of ``make_lm_train_step(aux=True, moe_balance_weight=
  0.01)`` against JAX's (losses and each ``aux`` statistic ``rtol 1e-5``,
  changes ``1e-3``); the same steps under remat and under FSDP at world 1
  (the balance loss differentiated through the ZeRO-3 unit) equal the
  plain step bit for bit.
- ``demo_long_context --moe_experts 8 --moe_topk 2 --moe_balance 0.01``
  against the JAX demo in process (data 1 x model 8): the ``loss/lm`` and
  ``moe/*`` rows.
- The refusals: the flags' guards, the compressed reduce, adapters;
  tensor parallelism of an MoE model; and ``make_slot_decode`` of an MoE
  model, which now decodes as JAX's ``generate()`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from test_torch_fsdp import _hold_changes
from test_torch_long_context import _jax_demo_rows, no_launch_env
from torch_cases import settled_torch_cpu
from torch_launch import metric_rows
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist.models.transformer import create_transformer as jax_create
from tpudist.models import generate as jax_generate
from tpudist.models.transformer import dense_moe_reference as \
    jax_dense_reference
from tpudist.models.transformer import moe_expert_fn as jax_expert_fn
from tpudist.parallel import make_moe as jax_make_moe
from tpudist.train.lm import init_lm_state, make_lm_train_step as jax_step
from tpudist_torch.examples import demo_long_context as port_demo
from tpudist_torch.models import (TransformerLM, dense_moe_reference,
                                  make_slot_decode, moe_expert_fn,
                                  params_from_flax)
from tpudist_torch.models.transformer import transformer_tp_sharding
from tpudist_torch.parallel import fsdp_sharding, make_moe
from tpudist_torch.runtime.mesh import data_model_mesh
from tpudist_torch.serve.engine import SlotEngine
from tpudist_torch.train import build_optimizer, make_lm_train_step

assert no_launch_env  # a fixture of this module too

EXPERTS, D, F, TOKENS = 4, 16, 32, 64
#: the LM's experts: a model axis of 2 (the layer's own cases take 4)
LM_EXPERTS = 2
LM = dict(vocab=32, d_model=32, n_layers=1, n_heads=2, d_ff=64, max_len=32,
          n_experts=LM_EXPERTS)
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def _params(router="normal"):
    rng = np.random.default_rng(0)
    r = rng.standard_normal((D, EXPERTS)).astype(np.float32)
    if router == "zeros":
        r = np.zeros_like(r)
    elif router == "twin":  # experts 1 and 3 tie on every token
        r[:, 3] = r[:, 1]
    return {"router": r,
            "experts": {
                "w": (rng.standard_normal((EXPERTS, D, F)) / 4).astype(
                    np.float32),
                "wo": (rng.standard_normal((EXPERTS, F, D)) / 6).astype(
                    np.float32)}}


@pytest.mark.parametrize("k,capacity,router", [
    (1, 0.5, "normal"), (2, 1.0, "normal"), (2, 8.0, "twin"),
    (1, 1.25, "zeros")])
def test_make_moe_equals_jax(k, capacity, router):
    params = _params(router)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((TOKENS, D)).astype(np.float32)
    g = rng.standard_normal((TOKENS, D)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:EXPERTS]), axis_names=("model",))
    jmoe = jax_make_moe(mesh, jax_expert_fn, k=k, capacity_factor=capacity)
    jp = jax.tree.map(jnp.asarray, params)
    y, stats = jmoe(jp, jnp.asarray(x))

    def loss(p):
        yy, st = jmoe(p, jnp.asarray(x))
        return jnp.sum(yy * g) + st.balance_loss

    grads = jax.grad(loss)(jp)
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    moe = make_moe(data_model_mesh(EXPERTS, device="cpu"), moe_expert_fn,
                   k=k, capacity_factor=capacity)
    got, st = moe(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-6)
    for name in stats._fields:
        np.testing.assert_allclose(getattr(st, name).detach().numpy(),
                                   np.asarray(getattr(stats, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    ((got * torch.from_numpy(g)).sum() + st.balance_loss).backward()
    for name, t, want in (("router", tp["router"], grads["router"]),
                          ("w", tp["experts"]["w"], grads["experts"]["w"]),
                          ("wo", tp["experts"]["wo"],
                           grads["experts"]["wo"])):
        want = np.asarray(want)
        rel = np.linalg.norm(t.grad.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (name, rel)
    if capacity <= 1.0:
        assert float(stats.dropped_fraction) > 0


def _lm_case():
    # jitted: one compile where the eager init compiles op by op
    params = jax.jit(JaxLM(**LM).init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 32), jnp.int32))
    sd = params_from_flax(jax.device_get(params))
    assert {"blocks.0.moe.router", "blocks.0.moe.w",
            "blocks.0.moe.wo"} <= set(sd)
    return params, sd


def _port_lm(sd, moe=True, k=2, **kw):
    model = TransformerLM(param_dtype=torch.float32, **LM, **kw)
    model.load_state_dict(sd)
    if moe:
        model.moe_fn = make_moe(data_model_mesh(LM_EXPERTS, device="cpu"),
                                moe_expert_fn, batch_axis="data", k=k)
    return model.requires_grad_(True)


def _batches():
    return np.random.default_rng(2).integers(0, 32, size=(3, 8, 32)).astype(
        np.int32)


@pytest.mark.parametrize("router", ["normal", "twin"])
def test_dense_moe_reference_equals_jax(router):
    """The MoE FFN without a ``moe_fn``: every expert on every token, the
    top-1 gate (ties to the lower index)."""
    params = _params(router)
    x = np.random.default_rng(3).standard_normal((TOKENS, D)).astype(
        np.float32)
    want = jax_dense_reference(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x))
    got = dense_moe_reference(jax.tree.map(torch.from_numpy, params),
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def jax_moe_steps():
    """JAX's aux step: 3 Adam steps on data 1 x model 2, top-2, balance
    weight 0.01."""
    params, sd = _lm_case()
    mesh = Mesh(np.asarray(jax.devices()[:LM_EXPERTS]).reshape(
        1, LM_EXPERTS), axis_names=("data", "model"))
    moe_fn = jax_make_moe(mesh, jax_expert_fn, batch_axis="data", k=2)
    module = JaxLM(moe_fn=moe_fn, **LM)
    tx = optax.adam(LR)
    state = init_lm_state(params, tx)
    step = jax_step(module.apply, tx, mesh, aux=True, donate_state=False,
                    moe_balance_weight=0.01)
    losses, auxes = [], []
    for t in _batches():
        state, loss, aux = step(state, jnp.asarray(t))
        losses.append(float(loss))
        auxes.append({k: np.asarray(v) for k, v in aux.items()})
    final = {f"w/{k}": v.numpy() for k, v in params_from_flax(
        jax.device_get(state.params)).items()}
    return sd, losses, auxes, final


def _port_steps(sd, variant):
    model = _port_lm(sd, remat=variant == "remat")
    opt, _ = build_optimizer(model.parameters(), LR)
    layout = (fsdp_sharding(data_model_mesh(LM_EXPERTS, device="cpu"),
                            model, opt) if variant == "fsdp" else None)
    step = make_lm_train_step(model, opt, aux=True, moe_balance_weight=0.01,
                              state_sharding=layout)
    losses, auxes = [], []
    for t in _batches():
        loss, aux = step(torch.from_numpy(t))
        losses.append(float(loss))
        auxes.append({k: v.numpy() for k, v in aux.items()})
    view = model if step.runtime is None else step.runtime.model_view
    return losses, auxes, {f"w/{k}": v.detach().numpy()
                           for k, v in view.state_dict().items()}


def test_moe_lm_aux_step_equals_jax(jax_moe_steps):
    sd, losses, auxes, final = jax_moe_steps
    got, got_aux, weights = _port_steps(sd, "plain")
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    for g, w in zip(got_aux, auxes):
        assert set(g) == set(w) == {"moe_dropped_fraction",
                                    "moe_expert_load", "moe_balance_loss"}
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    assert got_aux[0]["moe_expert_load"].shape == (LM_EXPERTS,)
    start = {k: v.numpy() for k, v in sd.items()}
    _hold_changes(weights, {k[2:]: v for k, v in final.items()}, start,
                  1e-3)


@pytest.mark.parametrize("variant", ["remat", "fsdp"])
def test_moe_lm_aux_step_variants_equal_plain(jax_moe_steps, variant):
    """Under remat the balance loss reaches the router through the
    recomputed blocks; under FSDP at world 1 through the ZeRO-3 unit's
    extra outputs: the same steps as the plain one, bit for bit."""
    sd = jax_moe_steps[0]
    want = _port_steps(sd, "plain")
    got = _port_steps(sd, variant)
    assert got[0] == want[0]
    for key in want[2]:
        np.testing.assert_array_equal(got[2][key], want[2][key], key)


def test_dense_model_aux_is_empty_and_refusals():
    model = TransformerLM(param_dtype=torch.float32,
                          **dict(LM, n_experts=0)).requires_grad_(True)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    opt, _ = build_optimizer(model.parameters(), LR)
    step = make_lm_train_step(model, opt, aux=True)
    loss, aux = step(torch.from_numpy(_batches()[0]))
    assert aux == {} and np.isfinite(float(loss))
    with pytest.raises(ValueError, match="grad_reduce_dtype"):
        make_lm_train_step(model, opt, grad_reduce_dtype=torch.bfloat16,
                           moe_balance_weight=0.01)
    # serving an MoE model is ported: make_slot_decode's dense programs
    # decode as JAX's (the dense top-1 reference), greedy tokens equal
    jmod, jparams = jax_create(jax.random.PRNGKey(3), seq_len=16, **LM)
    moe = TransformerLM(param_dtype=torch.float32, **LM)
    moe.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jparams)))
    moe.requires_grad_(False)
    fns = make_slot_decode(moe, 2, 8, None, attn_kernel="gather",
                           prefill_kernel=False)
    prompts = np.random.default_rng(1).integers(
        0, LM["vocab"], (2, 5)).astype(np.int32)
    want = np.asarray(jax_generate(jmod, jparams, jnp.asarray(prompts),
                                   6))[:, 5:]
    eng = SlotEngine(moe, num_slots=2, prefill_pad=8, paged=False,
                     device="cpu")
    assert type(eng.fns) is type(fns)
    out = {s: [t] for s, t in eng.start_batch(
        [(s, prompts[s], 0.0, s, 6) for s in range(2)]).items()}
    while any(len(v) < 6 for v in out.values()):
        for s, toks in eng.decode_auto()[1].items():
            out[s].extend(toks)
    np.testing.assert_array_equal([out[0][:6], out[1][:6]], want)
    with pytest.raises(ValueError, match="MoE"):
        SlotEngine(moe, adapters=True, paged=False, device="cpu")
    opt, _ = build_optimizer(moe.parameters(), LR)
    # the Megatron layout of an MoE model is ported (A6c's last slice):
    # the expert stacks split on the expert axis, the router replicated
    layout = transformer_tp_sharding({"model": 2}, moe, opt)
    assert layout.leaves["blocks.0.moe.w"].split() == (0, "model")
    assert layout.leaves["blocks.0.moe.wo"].split() == (0, "model")
    assert layout.leaves["blocks.0.moe.router"].split()[1] is None
    for argv, msg in ((["--moe_experts", "2", "--seq_shards", "2"],
                       "dp, not sp"),
                      (["--moe_experts", "2", "--moe_topk", "3"],
                       "--moe_topk 3"),
                      (["--moe_topk", "2"], "need --moe_experts")):
        with pytest.raises(SystemExit, match=msg):
            port_demo._check_flags(port_demo.get_args(argv))


def _carried_moe_model(args, device):
    """The port demo's model holding the JAX demo's init weights."""
    _, params = jax_create(
        jax.random.PRNGKey(args.seed), seq_len=args.seq_len,
        vocab=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        max_len=args.seq_len, n_experts=args.moe_experts)
    model = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, d_ff=args.d_ff, max_len=args.seq_len,
        n_experts=args.moe_experts, param_dtype=torch.float32)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model.to(device).requires_grad_(True)


def test_demo_moe_equals_jax_demo(tmp_path, no_launch_env):
    argv = ["--dry_run", "--seed", "0", "--seq_len", "32", "--d_model",
            "32", "--n_layers", "1", "--vocab", "32", "--lr", "1e-3",
            "--batch_size", "8", "--total_iterations", "3", "--moe_experts",
            "8", "--moe_topk", "2", "--moe_balance", "0.01"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _jax_demo_rows(tmp_path / "jax", argv, no_launch_env)
    no_launch_env.chdir(tmp_path / "port")
    no_launch_env.setattr(port_demo, "build_model", _carried_moe_model)
    port_demo.main(argv + ["--device", "cpu"])
    got = metric_rows(tmp_path / "port" / "runs" / "demo_long_context" /
                      "metrics.jsonl")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) - {"_time"} == set(w) - {"_time"}
        for key in ("loss/lm", "moe/dropped_fraction", "moe/load_max",
                    "moe/balance_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
