"""The port's sharded training state (``tpudist_torch.parallel.fsdp`` and
``.zero``) against the JAX package's ``tpudist.parallel.fsdp``, on the CPU
at JAX's ``TestFSDP`` size (d 64, 2 layers, 4 heads, d_ff 128, vocab 32,
seq 32, batch 8; Adafactor at d 128, where its matrices factor).

- The layout: every parameter's spec (on the JAX-shaped view) and
  ``state_bytes_per_device`` equal JAX's ``fsdp_sharding``,
  ``zero1_sharding`` and ``merge_shardings`` on the same tree, at
  ``min_size`` 1024 and 64, for each optimizer and a schedule.
- FSDP and ZeRO-1 over gloo at world 2 and 4 (``tests/
  torch_fsdp_worker.py``, one launch a world), 3 steps from the JAX init's
  weights, for adam, adamw, adafactor and lion, with and without a
  global-norm clip of 0.1 (active here: the norms run above 1), against
  the JAX step under FSDP on the suite's virtual devices (whose losses
  JAX's ZeRO-1 gives too, held here at JAX's own ``rtol 2e-6``):
  losses at ``rtol 1e-5`` and each parameter's change at relative norm
  ``1e-3`` (``tests/test_torch_train.py``'s bounds; readings below
  ``4e-6``).  Lion's signs give way where a momentum sits at rounding
  noise, so its changes are held at ``2e-2``.
- ``grad_reduce_dtype=bf16`` at world 2 against JAX's compressed step
  (losses ``rtol 1e-5``; the f32 step lies further off) and its refusals.
- A checkpoint saved under ``fsdp`` at world 2 resumed under ``dp`` at
  world 1; the collectives counted in a step.
- ``demo_long_context --fsdp`` against the JAX demo in process (one
  process; with ``--seq_shards 4``; the ``fsdp: X MiB`` line), and over
  gloo at world 2 and at world 4 with ``--seq_shards 2`` against one
  process (``rtol 1e-6``, as the ring's gloo cases).
- The Trainer's ``fsdp`` and ``zero1`` on the LM path against the JAX
  Trainer's, and on the toy path against ``dp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from test_torch_long_context import (BASE, _carried_model, _hold_rows,
                                     _jax_demo_rows, _load_example,
                                     no_launch_env)
from torch_cases import settled_torch_cpu
from torch_fsdp_worker import GEOMS, LR, STEPS, build, geom_of
from torch_launch import REPO, launch_ranks, metric_rows, torchrun_envs
from tpudist.models.transformer import create_transformer as jax_create
from tpudist.models.transformer import transformer_tp_sharding as jax_tp
from tpudist.parallel import fsdp_sharding as jax_fsdp
from tpudist.parallel import merge_shardings as jax_merge
from tpudist.parallel import state_bytes_per_device as jax_bytes
from tpudist.parallel import zero1_sharding as jax_zero1
from tpudist.train.lm import init_lm_state, make_lm_train_step as jax_step
from tpudist.train.optim import build_optimizer as jax_build_optimizer
from tpudist_torch.examples import demo_long_context as port_demo
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.models.transformer import transformer_tp_sharding
from tpudist_torch.parallel import (fsdp_sharding, merge_shardings,
                                    state_bytes_per_device, zero1_sharding)
from tpudist_torch.train import build_optimizer, make_lm_train_step

assert no_launch_env  # a fixture of this module too

OPTIMIZERS = ("adam", "adamw", "adafactor", "lion")
CLIP = 0.1


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def flax_path(name: str) -> tuple:
    """The flax param path of a port parameter name."""
    top = {"tok_embed": ("tok_embed", "embedding"),
           "pos_embed": ("pos_embed", "embedding"),
           "ln_f": ("LayerNorm_0", "scale"), "head": ("head", "kernel")}
    if name in top:
        return top[name]
    _, i, leaf = name.split(".")
    sub = {"ln1": ("LayerNorm_0", "scale"), "ln2": ("LayerNorm_1", "scale")}
    return (f"block_{i}",) + sub.get(leaf, (leaf, "kernel"))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_spec(sharding, ndim) -> tuple:
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def jax_inits():
    """The JAX init of each geometry: ``{geom: (module, params)}``."""
    return {g: jax_create(jax.random.PRNGKey(0), seq_len=32, **cfg)
            for g, cfg in GEOMS.items()}


def _batches(geom):
    return np.random.default_rng(1 if geom == "d64" else 2).integers(
        0, 32, size=(STEPS, 8, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def inp(jax_inits, tmp_path_factory):
    """The worker's input: the JAX init's weights and the batches."""
    path = tmp_path_factory.mktemp("fsdp_inp") / "inp.npz"
    arrays = {}
    for g, (_, params) in jax_inits.items():
        for k, v in params_from_flax(jax.device_get(params)).items():
            arrays[f"{g}/{k}"] = v.numpy()
        arrays[f"{g}_batches"] = _batches(g)
    np.savez(path, **arrays)
    return path


CASES = [f"{lay}|{opt}|{clip}" for lay in ("fsdp", "zero1")
         for opt in OPTIMIZERS for clip in ("0", str(CLIP))]
EXTRA_W2 = ["compressed|adam|0", "ckpt|adam|0"]


@pytest.fixture(scope="module")
def gloo_runs(inp, tmp_path_factory):
    """Every case of :data:`CASES` at world 2 and 4 (plus
    :data:`EXTRA_W2` at world 2): ``{world: out dir}``."""
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"fsdp_w{world}")
        cases = CASES + (EXTRA_W2 if world == 2 else [])
        launch_ranks("torch_fsdp_worker", ["--inp", str(inp), "--out",
                                           str(d), "--cases",
                                           ",".join(cases)],
                     REPO / "tests", torchrun_envs(world), timeout=600)
        out[world] = d
    return out


def _load(d, case):
    return np.load(d / (case.replace("|", "_") + ".npz"))


def _jax_run(jax_inits, geom, tx, mesh, layout=None, **kw):
    """The JAX step's losses and final params over :func:`_batches`."""
    module, params = jax_inits[geom]
    state = init_lm_state(params, tx)
    sharding = None if layout is None else layout(mesh, state)
    if sharding is not None:
        state = jax.device_put(state, sharding)
    step = jax_step(module.apply, tx, mesh, donate_state=False,
                    state_sharding=sharding, **kw)
    losses = []
    for tokens in _batches(geom):
        state, loss = step(state, jnp.asarray(tokens))
        losses.append(float(loss))
    return np.array(losses), {
        k: v.numpy() for k, v in params_from_flax(
            jax.device_get(state.params)).items()}


def _hold_changes(got, want, start, bound):
    for name, w in want.items():
        moved, want_moved = got[f"w/{name}"] - start[name], w - start[name]
        rel = np.linalg.norm(moved - want_moved) / np.linalg.norm(want_moved)
        assert rel <= bound, (name, rel)


def _start(jax_inits, geom):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(jax_inits[geom][1])).items()}


def _mesh(n, axes=("data",)):
    devs = np.asarray(jax.devices()[:int(np.prod(n))]).reshape(n)
    return Mesh(devs, axis_names=axes)


# -- the layout ---------------------------------------------------------------


def _port_model(geom):
    return TransformerLM(param_dtype=torch.float32, **GEOMS[geom])


@pytest.mark.parametrize("kind", ["fsdp", "zero1", "merged"])
@pytest.mark.parametrize("min_size", [1024, 64])
@pytest.mark.parametrize("optimizer,schedule", [
    ("adam", "constant"), ("adam", "cosine"), ("adafactor", "constant"),
    ("lion", "constant")])
def test_layout_equals_jax(jax_inits, kind, min_size, optimizer, schedule):
    """Each parameter's spec on the JAX-shaped view and the bytes a device
    equal JAX's on the same tree (an 8-device ``data`` mesh, or data 4 x
    model 2 for the merge of TP and FSDP)."""
    geom = geom_of(optimizer)
    _, params = jax_inits[geom]
    tx = jax_build_optimizer(LR, optimizer=optimizer, schedule=schedule)
    state = init_lm_state(params, tx)
    model = _port_model(geom)
    opt, _ = build_optimizer(model.parameters(), LR, optimizer=optimizer,
                             schedule=schedule)
    if kind == "merged":
        mesh, sizes = _mesh((4, 2), ("data", "model")), {"data": 4,
                                                         "model": 2}
        want = jax_merge(jax_tp(mesh, state),
                         jax_fsdp(mesh, state, min_size=min_size))
        got = merge_shardings(transformer_tp_sharding(sizes, model, opt),
                              fsdp_sharding(sizes, model, opt,
                                            min_size=min_size))
    else:
        mesh, sizes = _mesh(8), {"data": 8}
        rule, port_rule = ((jax_fsdp, fsdp_sharding) if kind == "fsdp"
                           else (jax_zero1, zero1_sharding))
        want = rule(mesh, state, min_size=min_size)
        got = port_rule(sizes, model, opt, min_size=min_size)
    assert state_bytes_per_device(got) == jax_bytes(state, want)
    for name, leaf in got.params.items():
        ref = _get(want.params["params"], flax_path(name))
        assert leaf.jax_spec == _jax_spec(ref, len(leaf.shape)), name
    if kind == "fsdp":
        # the square proj shards the same logical dimension: flax's `in`
        leaf = got.params["blocks.0.proj"]
        assert leaf.jax_spec == ("data", None) and leaf.spec == (None,
                                                                 "data")


# -- FSDP and ZeRO-1 over gloo ------------------------------------------------


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("clip", [0.0, CLIP])
def test_sharded_steps_equal_jax(jax_inits, gloo_runs, optimizer, clip):
    """FSDP and ZeRO-1 at world 2 and 4 against the JAX step under FSDP on
    a data-2 mesh (JAX's step gives the same numbers under any layout:
    :func:`test_jax_layouts_agree` and ``tests/test_parallel.py``)."""
    geom = geom_of(optimizer)
    tx = jax_build_optimizer(LR, optimizer=optimizer, grad_clip=clip)
    want, wparams = _jax_run(jax_inits, geom, tx, _mesh(2), jax_fsdp)
    start = _start(jax_inits, geom)
    bound = 2e-2 if optimizer == "lion" else 1e-3
    for lay in ("fsdp", "zero1"):
        case = f"{lay}|{optimizer}|{'0' if clip == 0 else clip}"
        for world in (2, 4):
            got = _load(gloo_runs[world], case)
            np.testing.assert_allclose(got["losses"], want, rtol=1e-5,
                                       err_msg=f"{case} w{world}")
            _hold_changes(got, wparams, start, bound)


def test_jax_layouts_agree(jax_inits):
    """The yardstick's own invariance: JAX's step under ZeRO-1 on a data-4
    mesh gives its FSDP data-2 losses (``rtol 2e-6``, JAX's own bound)."""
    tx = jax_build_optimizer(LR, optimizer="adam", grad_clip=CLIP)
    fsdp, _ = _jax_run(jax_inits, "d64", tx, _mesh(2), jax_fsdp)
    zero1, _ = _jax_run(jax_inits, "d64", tx, _mesh(4), jax_zero1)
    np.testing.assert_allclose(zero1, fsdp, rtol=2e-6)


def test_collectives_counted_in_a_step(gloo_runs, inp):
    """FSDP: a gather a block forward and backward plus the root's, a
    reduce-scatter a block and the root's, one all-reduce of the replicated
    norms; ZeRO-1: one reduce-scatter and one all-gather."""
    n_layers = GEOMS["d64"]["n_layers"]
    for world in (2, 4):
        f = _load(gloo_runs[world], "fsdp|adam|0")
        assert int(f["count/gathers"]) == 2 * n_layers + 1
        assert int(f["count/reduce_scatters"]) == n_layers + 1
        assert int(f["count/all_reduces"]) == 1
        z = _load(gloo_runs[world], "zero1|adam|0")
        assert (int(z["count/reduce_scatters"]), int(z["count/all_gathers"]),
                int(z["count/gathers"])) == (1, 1, 0)


def test_compressed_reduce_equals_jax(jax_inits, gloo_runs):
    """``grad_reduce_dtype=bf16`` at world 2 against JAX's compressed step
    on a data-2 mesh; the f32 step is further off than the bound."""
    tx = optax.adam(LR)
    want, wparams = _jax_run(jax_inits, "d64", tx, _mesh(2),
                             grad_reduce_dtype=jnp.bfloat16)
    f32, _ = _jax_run(jax_inits, "d64", tx, _mesh(2))
    got = _load(gloo_runs[2], "compressed|adam|0")
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert np.max(np.abs(f32 - want) / np.abs(want)) > 1e-5
    _hold_changes(got, wparams, _start(jax_inits, "d64"), 1e-2)


def test_compressed_reduce_refusals_and_world_one_rounding():
    """JAX's refusals, and the gradients rounded to bf16 at world 1."""
    model, opt = _tiny()
    for kw in (dict(state_sharding=fsdp_sharding({"data": 1}, model, opt)),
               dict(accum_steps=2), dict(aux=True), dict(ctx=object())):
        with pytest.raises(ValueError, match="grad_reduce_dtype"):
            make_lm_train_step(model, opt, grad_reduce_dtype=torch.bfloat16,
                               **kw)
    step = make_lm_train_step(model, opt, grad_reduce_dtype=torch.bfloat16)
    seen = {}
    opt.register_step_pre_hook(lambda o, a, k: seen.update(
        g=[p.grad.clone() for p in model.parameters()]))
    step(torch.from_numpy(_batches("d64")[0]).long())
    for g in seen["g"]:
        assert torch.equal(g, g.bfloat16().float())


def _tiny(optimizer="adam"):
    model = TransformerLM(param_dtype=torch.float32, **GEOMS["d64"])
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    model.requires_grad_(True)
    return model, build_optimizer(model.parameters(), LR,
                                  optimizer=optimizer)[0]


def test_fsdp_checkpoint_resumes_under_dp(gloo_runs, inp, tmp_path):
    """The checkpoint of the world-2 FSDP run (whole tensors) restores
    into a replicated world-1 run: the weights the sharded run ended with,
    the moments of an unbroken world-1 run, and two more steps equal that
    run's."""
    from tpudist_torch.checkpoint import CheckpointConfig, CheckpointManager
    from tpudist_torch.train.step import ModelState

    data = np.load(inp)
    saved = _load(gloo_runs[2], "ckpt|adam|0")
    model, opt = build(data, "d64", "adam", 0.0)
    mgr = CheckpointManager(CheckpointConfig(
        str(gloo_runs[2] / "ckpt"), async_save=False))
    meta = mgr.restore({"lm": ModelState(model, model, opt)})
    assert meta["iteration"] == STEPS
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved[f"w/{k}"])
    ref, ropt = build(data, "d64", "adam", 0.0)
    rstep = make_lm_train_step(ref, ropt)
    batches = data["d64_batches"]
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
    mgr.close()


def test_sharded_state_dicts_round_trip():
    """The runtime's views: whole tensors out, the same tensors back in,
    under FSDP, ZeRO-1 and TP, for Adam and Adafactor's factored slots."""
    from tpudist_torch.runtime.mesh import data_model_mesh

    tokens = torch.from_numpy(_batches("d128")[0]).long()
    for optimizer in ("adam", "adafactor"):
        for kind in ("fsdp", "zero1", "tp"):
            model = TransformerLM(param_dtype=torch.float32,
                                  **GEOMS["d128"])
            torch.manual_seed(0)
            for p in model.parameters():
                torch.nn.init.normal_(p, std=0.05)
            model.requires_grad_(True)
            opt, _ = build_optimizer(model.parameters(), LR,
                                     optimizer=optimizer)
            if kind == "tp":
                layout = transformer_tp_sharding(
                    data_model_mesh(2, device="cpu"), model, opt)
            else:
                rule = fsdp_sharding if kind == "fsdp" else zero1_sharding
                layout = rule({"data": 1}, model, opt, min_size=64)
            step = make_lm_train_step(model, opt, state_sharding=layout)
            step(tokens)
            msd = step.runtime.model_view.state_dict()
            osd = step.optimizer.state_dict()
            assert list(msd) == [n for n, _ in
                                 _port_model("d128").named_parameters()]
            step.runtime.model_view.load_state_dict(msd)
            step.optimizer.load_state_dict(osd)
            again = step.optimizer.state_dict()
            for i, st in osd["state"].items():
                for k, v in st.items():
                    assert torch.equal(torch.as_tensor(v),
                                       torch.as_tensor(again["state"][i][k]))
            for k, v in step.runtime.model_view.state_dict().items():
                assert torch.equal(v, msd[k]), (optimizer, kind, k)


@pytest.mark.parametrize("trainer_cast", [False, True])
def test_zero3_block_frees_what_its_graph_saves(trainer_cast):
    """bf16 compute over f32 masters under ZeRO-3 (the model's own compute
    dtype, or the Trainer's cast over an f32 model): every tensor of a
    block weight's full shape that the graph saves is a gathered tensor
    the block frees after its forward — none outlives it, so no rank holds
    the blocks' whole weights between the forward and the backward — and
    two steps give the unsharded step's losses and weights bit for bit."""
    from tpudist_torch.models import create_transformer, lm_loss
    from tpudist_torch.trainer.trainer import BF16Apply

    geom = dict(vocab=40, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                max_len=48)
    dtype = torch.float32 if trainer_cast else torch.bfloat16
    wrap = BF16Apply if trainer_cast else None
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 40, (2, 16))).long()
    runs = {}
    for sharded in (False, True):
        model = create_transformer(0, device="cpu", dtype=dtype,
                                   param_dtype=torch.float32,
                                   trainable=True, **geom)
        shapes = {tuple(p.shape)[::o] for blk in model.blocks
                  for p in blk.parameters() if p.dim() == 2 for o in (1, -1)}
        opt, _ = build_optimizer(model.parameters(), LR)
        layout = (fsdp_sharding({"data": 1}, model, opt, min_size=64)
                  if sharded else None)
        step = make_lm_train_step(model, opt, wrap=wrap,
                                  state_sharding=layout)
        if sharded:
            saved = []

            def pack(t):
                saved.append(t)
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = lm_loss(step.replica(tokens), tokens)
            # at world 1 a shard is the whole f32 master: the state
            masters = {s.untyped_storage().data_ptr()
                       for u in step.runtime._all_units() for s in u.shards}
            weights = [t for t in saved if t.dim() == 2
                       and tuple(t.shape) in shapes
                       and t.untyped_storage().data_ptr() not in masters]
            assert len(weights) >= 4 * geom["n_layers"]
            whole = [tuple(t.shape) for t in weights
                     if t.untyped_storage().nbytes()]
            assert not whole, whole
            loss.backward()
            step.optimizer.zero_grad()
            weights = step.runtime.model_view.state_dict
        else:
            weights = model.state_dict
        losses = [float(step(tokens)) for _ in range(2)]
        runs[sharded] = losses, {k: v.clone() for k, v in weights().items()}
    assert runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), k


# -- the entry points ---------------------------------------------------------


def _port_rows(cwd, argv, monkeypatch, capsys=None):
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(port_demo, "build_model", _carried_model)
    port_demo.main(argv + ["--device", "cpu"])
    return metric_rows(cwd / "runs" / "demo_long_context" / "metrics.jsonl")


def _mib(out: str) -> str:
    return out.split("fsdp: ")[1].split(" MiB")[0]


@pytest.mark.parametrize("extra", [[], ["--seq_shards", "4"]])
def test_fsdp_demo_equals_jax_demo(tmp_path, no_launch_env, capsys, extra):
    """``--fsdp`` (and beside a ring of 4) in one process against the JAX
    demo on the virtual devices (data 8, or data 2 x seq 4) from the same
    weights: the losses at ``rtol 1e-5``; the port's bytes at JAX's data
    size print JAX's line."""
    argv = BASE + ["--batch_size", "8", "--fsdp"] + extra
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _jax_demo_rows(tmp_path / "jax", argv, no_launch_env)
    jax_line = _mib(capsys.readouterr().out)
    got = _port_rows(tmp_path / "port", argv, no_launch_env)
    _hold_rows(got, want, 1e-5)
    assert "fsdp: " in capsys.readouterr().out
    args = port_demo.get_args(argv + ["--device", "cpu"])
    model = port_demo.build_model(args, torch.device("cpu"))
    opt, _ = build_optimizer(model.parameters(), args.lr)
    data = 8 // (4 if extra else 1)
    x = state_bytes_per_device(fsdp_sharding({"data": data}, model, opt))
    assert f"{x / 2**20:.1f}" == jax_line


@pytest.mark.parametrize("world,seq", [(2, 1), (4, 2)])
def test_fsdp_demo_over_gloo_equals_one_process(tmp_path, no_launch_env,
                                                world, seq):
    """``--fsdp`` at world 2, and at world 4 beside a ring of 2 (data 2 x
    seq 2: shards over the data group, gradients summed over the seq
    group too), against one process (``rtol 1e-6``); the printed bytes
    are JAX's at the data axis's size."""
    argv = BASE + ["--batch_size", "8", "--fsdp", "--seq_shards", str(seq)]
    (tmp_path / "one").mkdir()
    (tmp_path / "many").mkdir()
    no_launch_env.chdir(tmp_path / "one")
    port_demo.main(argv + ["--device", "cpu"])
    want = metric_rows(tmp_path / "one" / "runs" / "demo_long_context" /
                       "metrics.jsonl")
    outs = launch_ranks("tpudist_torch.examples.demo_long_context",
                        argv + ["--device", "cpu"], tmp_path / "many",
                        torchrun_envs(world))
    got = metric_rows(tmp_path / "many" / "runs" / "demo_long_context" /
                      "metrics.jsonl")
    _hold_rows(got, want, 1e-6)
    _, params = jax_create(jax.random.PRNGKey(0), seq_len=64, vocab=64,
                           d_model=64, n_layers=2, max_len=64)
    state = init_lm_state(params, optax.adam(1e-3))
    data = world // seq
    jx = jax_bytes(state, jax_fsdp(_mesh(data), state))
    assert _mib(outs[0]) == f"{jx / 2**20:.1f}"


def test_trainer_sharded_lm_equals_jax_and_toy_equals_dp(tmp_path,
                                                         no_launch_env):
    """The Trainer's LM path under ``fsdp`` and ``zero1`` (``shard_min_size``
    64) against the JAX Trainer's (data 8) from the same weights, 8 steps
    at ``rtol 2e-5`` (``tests/test_torch_long_context.py``'s bound); the
    toy path under both against ``dp``; ``final_states`` whole; a
    checkpoint saved under ``fsdp`` resumes under ``zero1``."""
    from test_torch_long_context import CarriedChainLM, trainer_args
    from tpudist.trainer import Trainer as JaxTrainer
    from tpudist_torch.examples.demo_trainer import (ChainLoader,
                                                     ToyTrainerModule)
    from tpudist_torch.examples.demo_trainer import main as trainer_main
    from tpudist_torch.trainer import Trainer

    no_launch_env.chdir(tmp_path)
    jdemo = _load_example("demo_trainer")
    argv = ["--seed", "0", "--dry_run", "--batch_size", "8", "--seq_len",
            "32", "--vocab", "32", "--d_model", "32", "--n_layers", "2",
            "--total_iterations", "8"]
    jmodule = jdemo.ChainLMModule(jdemo.get_args(argv))
    _, params = jmodule.configure_lm(jax.random.PRNGKey(0))
    kw = dict(max_steps=8, dry_run=True, seed=0, progress_bar=False,
              shard_min_size=64)
    module = CarriedChainLM(trainer_args(argv + ["--device", "cpu"]),
                            params_from_flax(jax.device_get(params)))
    loader = dict(batch=8, seq=32, vocab=32, seed=0)
    for strategy in ("fsdp", "zero1"):
        JaxTrainer(group=f"jax_{strategy}", strategy=strategy, **kw).fit(
            jmodule, jdemo.ChainLoader(**loader))
        t = Trainer(group=f"port_{strategy}", strategy=strategy,
                    device="cpu", **kw)
        t.fit(module, ChainLoader(**loader))
        want = metric_rows(f"runs/jax_{strategy}/metrics.jsonl")
        got = metric_rows(f"runs/port_{strategy}/metrics.jsonl")
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["loss/lm"], w["loss/lm"], rtol=2e-5)
        final = t.final_states["lm"].model
        assert isinstance(final, torch.nn.Module)
        assert all(p.numel() for p in final.parameters())
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4)
    Trainer(group="ck", strategy="fsdp", device="cpu",
            **dict(kw, max_steps=4), **ck).fit(module, ChainLoader(**loader))
    Trainer(group="ck", strategy="zero1", device="cpu", resume=True,
            **ck, **kw).fit(module, ChainLoader(**loader))
    resumed = metric_rows("runs/ck/metrics.jsonl")
    fsdp_rows = metric_rows("runs/port_fsdp/metrics.jsonl")
    np.testing.assert_allclose([r["loss/lm"] for r in resumed],
                               [r["loss/lm"] for r in fsdp_rows], rtol=1e-6)
    toy = {s: Trainer(strategy=s, device="cpu", max_steps=20, dry_run=True,
                      seed=0, progress_bar=False, group=f"toy_{s}",
                      shard_min_size=64).fit(ToyTrainerModule(),
                                             _toy_loader())
           for s in ("dp", "fsdp", "zero1")}
    for s in ("fsdp", "zero1"):
        for k in toy["dp"]:
            np.testing.assert_allclose(toy[s][k], toy["dp"][k], rtol=1e-6)
    for s in ("fsdp", "zero1"):
        losses = trainer_main(["--device", "cpu", "--strategy", s,
                               "--dry_run", "--seed", "0",
                               "--total_iterations", "6", "--batch_size",
                               "8"])
        assert np.isfinite(losses["lm"])


def _toy_loader():
    from tpudist_torch.config import get_args
    from tpudist_torch.examples.common import build_loader

    args = get_args(["--device", "cpu", "--batch_size", "32", "--seed", "0",
                     "--dry_run"])
    return build_loader(args, seed=0)
