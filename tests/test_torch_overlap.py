"""The port's collective matmuls (``tpudist_torch.parallel.overlap``), the
overlapped TP MLP and the overlapped FSDP MLP against the JAX package's
``tpudist.parallel.overlap``, on the CPU.

- ``overlap_mode`` against JAX's on the ``TPUDIST_OVERLAP`` knob and the
  call-site argument: the same mode, or a ``ValueError`` where JAX raises.
- ``ag_matmul`` (each gather, ring and bidir) and ``matmul_rs`` at ring
  sizes 1-4 over a ``LocalRing`` (the ``model`` axis folded onto one
  process) against the JAX primitives inside ``shard_map`` on that many
  virtual devices, the decode-shaped leading dims, ``pad_rows``, the TP
  chain's gradients, and the refusals.  Bounds are JAX's own
  (``tests/test_overlap.py``): ``EXACT`` for the gathers that assemble
  chunks, ``REASSOC`` for the ones that sum partial products.
- ``make_tp_mlp(overlap=...)`` (ring at model 2, bidir at 4) against its
  ``off`` body and the JAX overlapped MLP, and the knob.
- Over gloo at world 2 and 4 (``tests/torch_overlap_worker.py``, one
  launch a world): the primitives over a ``ProcessGroupRing`` against the
  dense products and JAX's gradients; the overlapped FSDP LM step against
  JAX's (losses ``rtol 1e-5``, the first step's ``wi``/``wo`` gradients,
  each parameter's change after 3 steps; bidir at world 2, ring at world
  4), with no gather of ``wi``/``wo`` in the runtime's count; at world 2
  the same MLP under DDP (the FSDP run's losses at ``rtol 1e-6``), and the
  MoE
  layer with ``batch_axis='data'`` against JAX's on a data 2 x model 4
  mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from test_torch_fsdp import _hold_changes
from torch_cases import settled_torch_cpu
from torch_fsdp_worker import GEOMS, LR, STEPS
from torch_launch import REPO, launch_ranks, torchrun_envs
from torch_overlap_worker import MOE_CAPACITY, MOE_EXPERTS, MOE_K
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist.models.transformer import lm_loss as jax_lm_loss
from tpudist.models.transformer import moe_expert_fn as jax_expert_fn
from tpudist.parallel import ag_matmul as jax_ag_matmul
from tpudist.parallel import compat_shard_map
from tpudist.parallel import fsdp_sharding as jax_fsdp
from tpudist.parallel import init_mlp_params as jax_init_mlp
from tpudist.parallel import make_moe as jax_make_moe
from tpudist.parallel import make_tp_mlp as jax_make_tp_mlp
from tpudist.parallel import matmul_rs as jax_matmul_rs
from tpudist.parallel import mlp_param_sharding as jax_mlp_sharding
from tpudist.parallel import overlap_fsdp_mlp as jax_overlap_fsdp_mlp
from tpudist.parallel import overlap_mode as jax_overlap_mode
from tpudist.train.lm import init_lm_state, make_lm_train_step as jax_step
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.parallel import (LocalRing, ag_matmul, fsdp_sharding,
                                    make_tp_mlp, matmul_rs, overlap_fsdp_mlp,
                                    overlap_mode, shard_state)
from tpudist_torch.runtime.mesh import data_model_mesh, data_parallel_mesh
from tpudist_torch.train import build_optimizer, make_lm_train_step

EXACT = dict(rtol=1e-6, atol=1e-6)
REASSOC = dict(rtol=1e-5, atol=1e-5)
MODES = ("ring", "bidir")


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


# -- the knob -------------------------------------------------------------

#: (TPUDIST_OVERLAP, the call-site argument); None = unset / not given
OVERLAP_CASES = [
    ("bogus", None), ("0", None), ("Ring", None), (" bidir ", None),
    ("false", None), (None, "false"), (None, "RING"), (None, ""),
    (None, "bogus"), (None, None), ("", None), ("off", None), ("NO", None),
    ("ring", "off"), ("bogus", " Bidir\n"), (None, "0"), (None, "no"),
    (None, "spiral"), ("OFF", None), ("ring", None),
]


@pytest.mark.parametrize("env,arg", OVERLAP_CASES)
def test_overlap_mode_equals_jax(monkeypatch, env, arg):
    if env is None:
        monkeypatch.delenv("TPUDIST_OVERLAP", raising=False)
    else:
        monkeypatch.setenv("TPUDIST_OVERLAP", env)
    try:
        want = jax_overlap_mode(arg)
    except ValueError:
        with pytest.raises(ValueError, match="overlap"):
            overlap_mode(arg)
        return
    assert overlap_mode(arg) == want


# -- the primitives on a LocalRing ----------------------------------------


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("model",))


def _sharded(body, mesh, in_specs, out_specs):
    return jax.jit(compat_shard_map(body, mesh=mesh, in_specs=in_specs,
                                    out_specs=out_specs))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


#: gather -> (x, w) global shapes, and the split of x and w (axis or None)
GATHERS = {"lhs": ((24, 8), (8, 12), 0, None),
           "rhs": ((6, 8), (8, 24), None, 1),
           "contract": ((6, 24), (24, 6), None, 0)}


def _pieces(a, axis, n):
    return [torch.from_numpy(a)] * n if axis is None else [
        torch.from_numpy(np.ascontiguousarray(c))
        for c in np.split(a, n, axis)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gather", sorted(GATHERS))
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ag_matmul_equals_jax(n, gather, mode):
    xs_, ws_, xa, wa = GATHERS[gather]
    x, w = _rand(n, *xs_), _rand(10 + n, *ws_)
    spec = {None: P(None, None), 0: P("model", None), 1: P(None, "model")}
    f = _sharded(lambda a, b: jax_ag_matmul(a, b, axis_name="model",
                                            mode=mode, gather=gather),
                 _jax_mesh(n), (spec[xa], spec[wa]), P(None, None))
    want = np.asarray(f(x, w))
    tol = REASSOC if gather == "contract" else EXACT
    outs = ag_matmul(_pieces(x, xa, n), _pieces(w, wa, n),
                     axis=LocalRing(n), mode=mode, gather=gather)
    assert len(outs) == n
    for o in outs:
        np.testing.assert_allclose(o.numpy(), want, **tol)
    np.testing.assert_allclose(want, x @ w, **tol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_matmul_rs_equals_jax(n, mode):
    x, w = _rand(20 + n, 12, 8 * n), _rand(30 + n, 8 * n, 6)
    f = _sharded(lambda a, b: jax_matmul_rs(a, b, axis_name="model",
                                            mode=mode),
                 _jax_mesh(n), (P(None, "model"), P("model", None)),
                 P("model", None))
    want = np.asarray(f(x, w))
    out = matmul_rs(_pieces(x, 1, n), _pieces(w, 0, n), axis=LocalRing(n),
                    mode=mode)
    np.testing.assert_allclose(torch.cat(out).numpy(), want, **REASSOC)
    np.testing.assert_allclose(want, x @ w, **REASSOC)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gather", ["rhs", "contract"])
def test_leading_dims_and_pad_rows(gather, mode):
    """The decode shapes: ``[slots, 1, d]`` rows for rhs/contract, rows
    zero-padded to the ring for ``matmul_rs(pad_rows=True)`` (and refused
    without it), against the JAX primitives at ring 4."""
    n, mesh = 4, _jax_mesh(4)
    x, w = _rand(3, 4, 1, 8), _rand(4, 8, 32)
    wa = 1 if gather == "rhs" else 0
    wspec = P(None, "model") if gather == "rhs" else P("model", None)
    f = _sharded(lambda a, b: jax_ag_matmul(a, b, axis_name="model",
                                            mode=mode, gather=gather),
                 mesh, (P(None, None, None), wspec), P(None, None, None))
    want = np.asarray(f(x, w))
    outs = ag_matmul([torch.from_numpy(x)] * n, _pieces(w, wa, n),
                     axis=LocalRing(n), mode=mode, gather=gather)
    tol = REASSOC if gather == "contract" else EXACT
    for o in outs:
        assert tuple(o.shape) == (4, 1, 32)
        np.testing.assert_allclose(o.numpy(), want, **tol)
    xp, wp = _rand(5, 12, 8), _rand(6, 8, 16)
    g = _sharded(lambda a, b: jax_matmul_rs(a, b, axis_name="model",
                                            mode=mode, pad_rows=True),
                 mesh, (P(None, "model"), P("model", None)),
                 P("model", None))
    want = np.asarray(g(xp[:6], wp))
    out = torch.cat(matmul_rs(_pieces(xp[:6], 1, n), _pieces(wp, 0, n),
                              axis=LocalRing(n), mode=mode, pad_rows=True))
    assert tuple(out.shape) == (8, 16)
    np.testing.assert_allclose(out.numpy(), want, **REASSOC)
    np.testing.assert_allclose(out[6:].numpy(), 0.0, atol=1e-6)
    with pytest.raises(ValueError, match="pad_rows"):
        matmul_rs(_pieces(xp[:6], 1, n), _pieces(wp, 0, n),
                  axis=LocalRing(n), mode=mode)


def _tp_chain_inputs():
    return _rand(40, 24, 8), _rand(41, 8, 36), _rand(42, 36, 8)


def _jax_tp_chain_grads(mode, n):
    """JAX's overlapped TP chain's loss and gradients on ``n`` places."""
    x, w1, w2 = _tp_chain_inputs()

    def loss(xx, a, b):
        def body(xl, al, bl):
            h = jax_ag_matmul(xl, al, axis_name="model", mode=mode,
                              gather="lhs")
            out = jax_matmul_rs(h, bl, axis_name="model", mode=mode)
            return jax.lax.psum(jnp.sum(out * out), "model")

        return compat_shard_map(
            body, mesh=_jax_mesh(n),
            in_specs=(P("model", None), P(None, "model"), P("model", None)),
            out_specs=P())(xx, a, b)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(x, w1, w2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_tp_chain_gradients_equal_jax(n, mode):
    """Backward through the lhs gather and the reduce-scatter: the hops'
    transposes give JAX's cotangents."""
    x, w1, w2 = _tp_chain_inputs()
    want_loss, want = _jax_tp_chain_grads(mode, n)
    xs = [t.requires_grad_(True) for t in _pieces(x, 0, n)]
    a = [t.requires_grad_(True) for t in _pieces(w1, 1, n)]
    b = [t.requires_grad_(True) for t in _pieces(w2, 0, n)]
    ring = LocalRing(n)
    h = ag_matmul(xs, a, axis=ring, mode=mode, gather="lhs")
    out = matmul_rs(h, b, axis=ring, mode=mode)
    loss = sum((o * o).sum() for o in out)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = [torch.cat([t.grad for t in ts], dim)
           for ts, dim in ((xs, 0), (a, 1), (b, 0))]
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_refusals():
    ring, x, w = LocalRing(2), [torch.zeros(4, 8)] * 2, [torch.zeros(8, 4)] * 2
    with pytest.raises(ValueError, match="mode"):
        ag_matmul(x, w, axis=ring, mode="spiral")
    with pytest.raises(ValueError, match="gather"):
        ag_matmul(x, w, axis=ring, gather="diag")
    with pytest.raises(ValueError, match="2-D"):
        ag_matmul([torch.zeros(2, 4, 8)] * 2, w, axis=ring, gather="lhs")
    with pytest.raises(ValueError, match="contract"):
        ag_matmul(x, w, axis=ring, gather="contract")
    with pytest.raises(ValueError, match="w.shape"):
        ag_matmul([torch.zeros(4, 16)] * 2, [torch.zeros(8, 1)] * 2,
                  axis=ring, mode="bidir", gather="contract")
    with pytest.raises(ValueError, match="w.shape"):
        matmul_rs(x, [torch.zeros(8, 1)] * 2, axis=ring, mode="bidir")
    with pytest.raises(ValueError, match="divisible"):
        matmul_rs([torch.zeros(3, 8)] * 2, w, axis=ring)
    with pytest.raises(ValueError, match="place"):
        ag_matmul(x[:1], w[:1], axis=ring)


# -- the overlapped TP MLP ------------------------------------------------


@pytest.mark.parametrize("m,mode", [(2, "ring"), (4, "bidir")])
def test_overlapped_tp_mlp_equals_off_and_jax(m, mode):
    params = jax_init_mlp(jax.random.PRNGKey(0), 32, 128)
    params = {k: v + 0.01 * (i + 1) for i, (k, v) in enumerate(
        sorted(params.items()))}  # non-zero biases
    x = _rand(1, 64, 32)
    g = _rand(2, 64, 32)
    mesh = _jax_mesh(m)
    sharded = jax.device_put(params, jax_mlp_sharding(mesh, params))
    want = np.asarray(jax_make_tp_mlp(mesh, overlap=mode)(sharded, x))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    pmesh = data_model_mesh(m, device="cpu")
    out = make_tp_mlp(pmesh, overlap=mode)(tp, tx)
    np.testing.assert_allclose(out.detach().numpy(), want, **REASSOC)
    out.backward(torch.from_numpy(g))
    grads = {k: v.grad.clone() for k, v in tp.items()}
    gx = tx.grad.clone()
    for v in list(tp.values()) + [tx]:
        v.grad = None
    off = make_tp_mlp(pmesh, overlap="off")(tp, tx)
    np.testing.assert_allclose(out.detach().numpy(), off.detach().numpy(),
                               **REASSOC)
    off.backward(torch.from_numpy(g))
    for k, v in tp.items():
        np.testing.assert_allclose(grads[k].numpy(), v.grad.numpy(),
                                   **REASSOC)
    np.testing.assert_allclose(gx.numpy(), tx.grad.numpy(), **REASSOC)


def test_overlapped_bodies_knob_and_refusals(monkeypatch):
    mesh = data_model_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="batch_axis"):
        make_tp_mlp(mesh, batch_axis="data", overlap="ring")
    with pytest.raises(ValueError, match="divide"):
        make_tp_mlp(mesh, overlap="ring")(
            {"w1": torch.zeros(4, 8), "b1": torch.zeros(8),
             "w2": torch.zeros(8, 4), "b2": torch.zeros(4)},
            torch.zeros(3, 4))
    with pytest.raises(ValueError, match="ranks of an axis"):
        overlap_fsdp_mlp(mesh, axis_name="model", overlap="ring")
    monkeypatch.setenv("TPUDIST_OVERLAP", "bidir")
    fn = overlap_fsdp_mlp(data_parallel_mesh(device="cpu"))
    assert fn is not None and fn.overlap == "bidir"
    monkeypatch.setenv("TPUDIST_OVERLAP", "sideways")  # a typo: off
    assert overlap_fsdp_mlp(data_parallel_mesh(device="cpu")) is None
    model = TransformerLM(param_dtype=torch.float32, n_experts=2,
                          **GEOMS["d64"])
    with pytest.raises(ValueError, match="MoE"):
        model.mlp_fn = fn


def test_fsdp_overlap_world_one_keeps_wi_wo_local():
    """At world 1 the ring has one place (the plain matmuls): the ZeRO-3
    runtime hands the blocks their ``wi``/``wo`` pieces instead of
    gathering them, and the step equals the plain FSDP step bit for bit."""
    gen = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.1 for k, v in
          TransformerLM(**GEOMS["d64"]).state_dict().items()}
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 32, size=(4, 32)))
    runs = {}
    for overlapped in (False, True):
        model = TransformerLM(param_dtype=torch.float32, **GEOMS["d64"])
        model.load_state_dict(sd)
        model.requires_grad_(True)
        mesh = data_parallel_mesh(device="cpu")
        if overlapped:
            model.mlp_fn = overlap_fsdp_mlp(mesh, overlap="ring")
        opt, _ = build_optimizer(model.parameters(), LR)
        step = make_lm_train_step(model, opt, state_sharding=fsdp_sharding(
            mesh, model, opt))
        runs[overlapped] = ([float(step(tokens)) for _ in range(2)],
                            step.runtime)
    assert runs[True][0] == runs[False][0]
    plain, local = runs[False][1], runs[True][1]
    ffn = sum(t.numel() * 4 for name, ts in plain.pieces.items()
              if name.endswith((".wi", ".wo")) for t in ts)
    # two gathers of every block a step (forward and backward)
    assert plain.counts["gather_bytes"] - local.counts["gather_bytes"] == \
        2 * 2 * ffn
    assert all(u.local for u in local._units.values())
    assert not any(u.local for u in plain._units.values())
    with pytest.raises(ValueError, match="along d_ff"):
        model = TransformerLM(param_dtype=torch.float32, **GEOMS["d64"])
        model.mlp_fn = overlap_fsdp_mlp(data_parallel_mesh(device="cpu"),
                                        overlap="ring")
        opt, _ = build_optimizer(model.parameters(), LR)
        layout = fsdp_sharding(data_parallel_mesh(device="cpu"), model, opt)
        key = "blocks.0.wi"
        leaf = layout.leaves[key]
        layout.leaves[key] = type(leaf)(leaf.shape, leaf.transposed,
                                        leaf.itemsize, (None, "data"))
        shard_state(model, opt, layout)


# -- over gloo ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_d64():
    """The dense d64 JAX model and its init (jitted: one compile where the
    eager init compiles op by op)."""
    module = JaxLM(**GEOMS["d64"])
    return module, jax.jit(module.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 32), jnp.int32))


def _inputs(path, jax_d64):
    _, params = jax_d64
    arrays = {f"d64/{k}": v.numpy() for k, v in params_from_flax(
        jax.device_get(params)).items()}
    batches = np.random.default_rng(1).integers(0, 32, size=(
        STEPS, 8, 32)).astype(np.int32)
    x, w1, w2 = _tp_chain_inputs()
    rng = np.random.default_rng(9)
    moe = {"moe_router": rng.standard_normal((16, MOE_EXPERTS)),
           "moe_w": rng.standard_normal((MOE_EXPERTS, 16, 32)) / 4,
           "moe_wo": rng.standard_normal((MOE_EXPERTS, 32, 16)) / 6,
           "moe_x": rng.standard_normal((64, 16)),
           "moe_g": rng.standard_normal((64, 16))}
    np.savez(path, d64_batches=batches, tp_x=x, tp_w1=w1, tp_w2=w2,
             lhs_x=_rand(50, 16, 8), lhs_w=_rand(51, 8, 12),
             rhs_x=_rand(52, 6, 8), rhs_w=_rand(53, 8, 16),
             con_x=_rand(54, 6, 16), con_w=_rand(55, 16, 6),
             rs_x=_rand(56, 16, 16), rs_w=_rand(57, 16, 6),
             pad_x=_rand(58, 6, 16), pad_w=_rand(59, 16, 6),
             **{k: v.astype(np.float32) for k, v in moe.items()}, **arrays)
    return np.load(path)


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory, jax_d64):
    """One launch a world: world 2 runs every case, world 4 the primitives
    and the FSDP cases."""
    from concurrent.futures import ThreadPoolExecutor

    root = tmp_path_factory.mktemp("overlap")
    inp = _inputs(root / "inp.npz", jax_d64)
    runs = {2: "prims,fsdp|bidir,ddp|bidir,moe", 4: "prims,fsdp|ring"}
    for world in runs:
        (root / f"w{world}").mkdir()
    # the two worlds at once: each launch waits on its own processes
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(
                launch_ranks, "torch_overlap_worker",
                ["--inp", str(root / "inp.npz"), "--out",
                 str(root / f"w{world}"), "--cases", cases],
                REPO / "tests", torchrun_envs(world))
                for world, cases in runs.items()]:
            f.result()
    return inp, {world: root / f"w{world}" for world in runs}


def _ranks(d, case, world):
    return [np.load(d / f"{case.replace('|', '_')}_r{r}.npz")
            for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_primitives_over_gloo(gloo_runs, world):
    inp, dirs = gloo_runs
    runs = _ranks(dirs[world], "prims", world)
    for mode in MODES:
        for key, tol in (("lhs", EXACT), ("rhs", EXACT),
                         ("con", REASSOC)):
            want = inp[f"{key}_x"] @ inp[f"{key}_w"]
            for r in runs:
                np.testing.assert_allclose(r[f"{key}_{mode}"], want, **tol)
        got = np.concatenate([r[f"rs_{mode}"] for r in runs])
        np.testing.assert_allclose(got, inp["rs_x"] @ inp["rs_w"],
                                   **REASSOC)
        got = np.concatenate([r[f"pad_{mode}"] for r in runs])
        np.testing.assert_allclose(got[:6], inp["pad_x"] @ inp["pad_w"],
                                   **REASSOC)
        np.testing.assert_allclose(got[6:], 0.0, atol=1e-6)
        _, want = _jax_tp_chain_grads(mode, world)
        for name, r_want, dim in zip(("x", "w1", "w2"), want, (0, 1, 0)):
            got = np.concatenate([r[f"tp_{mode}_g{name}"] for r in runs],
                                 dim)
            np.testing.assert_allclose(got, np.asarray(r_want), rtol=1e-4,
                                       atol=1e-4)


def _params_np(tree):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(tree)).items()}


@pytest.fixture(scope="module")
def jax_first_grads(jax_d64):
    """The first batch's gradient of the global mean loss (the dense
    JAX model: the overlapped MLP's gradients equal it within the
    reassociation bound)."""
    module, params = jax_d64
    tok0 = jnp.asarray(np.random.default_rng(1).integers(
        0, 32, size=(STEPS, 8, 32)).astype(np.int32)[0])
    return _params_np(jax.jit(jax.grad(lambda p: jax_lm_loss(
        module.apply(p, tok0), tok0)))(params))


def _jax_overlap_lm(jax_d64, world, mode):
    """JAX's overlapped FSDP step over a data mesh of ``world``: the
    losses and the final weights."""
    _, params = jax_d64
    mesh = Mesh(np.asarray(jax.devices()[:world]), axis_names=("data",))
    module = JaxLM(mlp_fn=jax_overlap_fsdp_mlp(mesh, overlap=mode),
                   **GEOMS["d64"])
    batches = np.random.default_rng(1).integers(0, 32, size=(
        STEPS, 8, 32)).astype(np.int32)
    tx = optax.adam(LR)
    state = init_lm_state(params, tx)
    sharding = jax_fsdp(mesh, state)
    state = jax.device_put(state, sharding)
    step = jax_step(module.apply, tx, mesh, donate_state=False,
                    state_sharding=sharding)
    losses = []
    for t in batches:
        state, loss = step(state, jnp.asarray(t))
        losses.append(float(loss))
    return losses, _params_np(state.params)


@pytest.mark.parametrize("world,mode", [(2, "bidir"), (4, "ring")])
def test_overlapped_lm_step_over_gloo_equals_jax(gloo_runs, jax_d64,
                                                 jax_first_grads, world,
                                                 mode):
    """The overlapped FSDP step against JAX's; at world 2 the same MLP
    with the weights replicated under DDP (each block cutting its pieces)
    equals the FSDP run's losses."""
    inp, dirs = gloo_runs
    got = _ranks(dirs[world], f"fsdp|{mode}", world)[0]
    losses, final = _jax_overlap_lm(jax_d64, world, mode)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    start = {k[4:]: inp[k] for k in inp.files if k.startswith("d64/")}
    _hold_changes(got, final, start, 1e-3)
    if (world, mode) == (2, "bidir"):
        ddp = _ranks(dirs[2], "ddp|bidir", 2)[0]
        np.testing.assert_allclose(ddp["losses"], got["losses"], rtol=1e-6)
        _hold_changes(ddp, final, start, 1e-3)
    grads = jax_first_grads
    for name in grads:
        if name.endswith((".wi", ".wo")):
            g, w = got[f"g/{name}"], grads[name]
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-5, name
    # the collectives of the first step gather every ZeRO-3 leaf but the
    # blocks' wi and wo: each block twice (forward, backward), the root once
    model = TransformerLM(param_dtype=torch.float32, **GEOMS["d64"])
    opt, _ = build_optimizer(model.parameters(), LR)
    plan = fsdp_sharding({"data": world}, model, opt)
    want = 0
    for name, leaf in plan.params.items():
        if leaf.split()[1] != "data" or name.endswith((".wi", ".wo")):
            continue
        want += int(np.prod(leaf.shape)) * 4 * (
            2 if name.startswith("blocks.") else 1)
    assert int(got["count/gather_bytes"]) == want


def test_moe_batch_axis_data_over_gloo_equals_jax(gloo_runs):
    """``make_moe(batch_axis='data')`` at world 2 (a model axis of 4 folded
    onto each rank) against JAX's on data 2 x model 4: each rank's rows of
    the output, the stats averaged over ``data``, and the gradients of
    ``mean_data(Σ y·g) + balance``."""
    inp, dirs = gloo_runs
    runs = _ranks(dirs[2], "moe", 2)
    mesh = Mesh(np.asarray(jax.devices()[:2 * MOE_EXPERTS]).reshape(
        2, MOE_EXPERTS), axis_names=("data", "model"))
    moe = jax_make_moe(mesh, jax_expert_fn, batch_axis="data", k=MOE_K,
                       capacity_factor=MOE_CAPACITY)
    params = {"router": jnp.asarray(inp["moe_router"]),
              "experts": {"w": jnp.asarray(inp["moe_w"]),
                          "wo": jnp.asarray(inp["moe_wo"])}}
    x = jax.device_put(jnp.asarray(inp["moe_x"]),
                       NamedSharding(mesh, P("data", None)))
    g = jnp.asarray(inp["moe_g"])
    y, stats = moe(params, x)

    def loss(p):
        yy, st = moe(p, x)
        return jnp.sum(yy * g) / 2 + st.balance_loss

    grads = jax.grad(loss)(params)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in runs]),
                               np.asarray(y), **REASSOC)
    for r in runs:
        for name in stats._fields:
            np.testing.assert_allclose(r[f"stat/{name}"],
                                       np.asarray(getattr(stats, name)),
                                       **REASSOC)
    assert 0 < float(stats.dropped_fraction) < 1
    for name, want in (("router", grads["router"]),
                       ("w", grads["experts"]["w"]),
                       ("wo", grads["experts"]["wo"])):
        np.testing.assert_allclose(runs[0][f"g/{name}"], np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
