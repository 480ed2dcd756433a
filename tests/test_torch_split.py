"""One toy model split across devices (``tpudist_torch.models.split_mlp``,
``tpudist_torch.examples.demo_model_split``) against the JAX package's
model-split demo (``examples/demo_model_split.py``: the ToyMLP sharded over
the ``model`` axis of the 8-device CPU mesh).

Tolerances:

- the split forward against the unsplit module: bit for bit (the same
  products in the same order, a move between the groups); against flax's
  ``ToyMLP.apply``: ``rtol 1e-6, atol 1e-6``, as ``test_torch_toy.py``
  holds the unsplit module (f32 sums of at most 10 terms in another order);
- 40 iterations of the demo's training against the JAX demo's from the
  same weights (carried across by ``toy_params_from_flax``): losses to
  ``rtol 2e-5``, the bound ``test_torch_toy.py`` derives for the unsplit
  path — XLA's sharded products sum the hidden layers in another order
  again, which stays within it;
- 2 ranks over gloo (DDP with ``device_ids=None``) against 1 rank at the
  same global batch: ``rtol 1e-6``, the same samples summed in another
  order, as ``test_torch_toy.py`` holds the unsplit demo.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.config import get_args as jax_get_args
from tpudist.models.split_mlp import split_state_sharding
from tpudist.models.toy_mlp import create_toy_model as jax_toy_model
from tpudist.runtime.mesh import data_model_mesh as jax_data_model_mesh
from tpudist.train.loop import run_training as jax_run_training
from tpudist.utils.metrics import init_metrics as jax_init_metrics
from torch_cases import settled_torch_cpu
from torch_launch import (LAUNCH_ENV, REPO, launch_ranks, metric_rows,
                          torchrun_envs)
from tpudist_torch.examples.common import build_training
from tpudist_torch.examples.demo_model_split import get_args
from tpudist_torch.examples.demo_model_split import main as split_main
from tpudist_torch.models import ToyMLP, toy_params_from_flax
from tpudist_torch.models.split_mlp import (SplitToyMLP, split_toy_model,
                                            stage_sizes)
from tpudist_torch.runtime.mesh import data_model_mesh
from tpudist_torch.train import run_training
from tpudist_torch.train.step import ddp_device_ids
from tpudist_torch.utils import init_metrics

NAMES = ("model_X", "model_Y")


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture()
def no_launch_env(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _jax_common():
    """The JAX demos' shared ``examples/common.py``."""
    spec = importlib.util.spec_from_file_location(
        "jax_examples_common", REPO / "examples" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,s,want", [(5, 2, [3, 2]), (5, 3, [2, 2, 1]),
                                      (5, 1, [5]), (5, 5, [1] * 5),
                                      (4, 2, [2, 2])])
def test_stage_sizes(n, s, want):
    assert stage_sizes(n, s) == want


@pytest.mark.parametrize("n,s", [(5, 0), (5, 6)])
def test_stage_sizes_refuse(n, s):
    with pytest.raises(ValueError, match="cannot split"):
        stage_sizes(n, s)


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_split_forward_equals_unsplit_and_flax(stages):
    """The split module's forward on the CPU (every stage the CPU) against
    the unsplit module and flax's apply, from weights loaded into the
    split module by ``toy_params_from_flax``."""
    module, params = jax_toy_model(jax.random.PRNGKey(3))
    flat = toy_params_from_flax(jax.device_get(params))
    split = SplitToyMLP(["cpu"] * stages)
    split.load_state_dict(flat)
    assert [len(idx) for _, idx in split.stages] == stage_sizes(5, stages)
    whole = ToyMLP()
    whole.load_state_dict(flat)
    assert split_toy_model(whole, ["cpu"] * stages).state_dict().keys() == \
        whole.state_dict().keys()
    x = np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32)
    with torch.no_grad():
        got = split(torch.from_numpy(x))
        assert torch.equal(got, whole(torch.from_numpy(x)))
    want = np.asarray(module.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ddp_device_ids():
    """``None`` on the CPU and for a module spanning two devices (here the
    CPU and ``meta``, the only two a CPU-only build has)."""
    assert ddp_device_ids(ToyMLP()) is None
    model = ToyMLP()
    model.dense_4.to("meta")
    assert ddp_device_ids(model) is None


@pytest.mark.parametrize("log_every", [1, 3])
def test_split_demo_training_equals_jax(tmp_path, monkeypatch, log_every):
    """The demos' training bodies for 40 iterations, metrics rows compared:
    JAX ``build_training`` with ``split_state_sharding`` on the
    ``('data', 'model')`` mesh of 8 CPU devices, model axis 2, and the
    port's ``build_training(split=True)`` on ``data_model_mesh(2)`` with
    the JAX weights loaded into the split modules."""
    monkeypatch.setenv("TPUDIST_TELEMETRY", "0")
    monkeypatch.setenv("WANDB_MODE", "dryrun")
    monkeypatch.chdir(tmp_path)
    argv = ["--seed", "0", "--total_iterations", "40", "--log_every",
            str(log_every), "--dry_run"]
    jargs = jax_get_args(argv)
    jmesh = jax_data_model_mesh(model_size=2)
    jstates, jstep, jloader, jcfg, jchunk = _jax_common().build_training(
        jargs, jmesh, state_sharding_fn=split_state_sharding)
    jcfg.progress_bar = False
    # the step donates the states: keep the initial weights first
    init = {n: toy_params_from_flax(jax.device_get(jstates[n].params))
            for n in NAMES}
    _, jfinal = jax_run_training(
        jstates, jstep, jloader, jmesh,
        jax_init_metrics(group="jax", dry_run=True), jcfg,
        chunk_step_fn=jchunk)

    args = get_args(argv + ["--device", "cpu"])
    mesh = data_model_mesh(2, device="cpu")
    states, step, loader, cfg, chunk = build_training(args, mesh, split=True)
    for n in NAMES:
        assert isinstance(states[n].model, SplitToyMLP)
        states[n].model.load_state_dict(init[n])
    cfg.progress_bar = False
    _, final = run_training(states, step, loader, mesh,
                            init_metrics(group="port", dry_run=True), cfg,
                            chunk)
    want = metric_rows("runs/jax/metrics.jsonl")
    got = metric_rows("runs/port/metrics.jsonl")
    assert len(got) == len(want) == len(range(0, 40, log_every))
    for g, w in zip(got, want):
        assert g["_step"] == w["_step"] and set(g) == set(w)
        for n in NAMES:
            np.testing.assert_allclose(g[f"loss/{n}"], w[f"loss/{n}"],
                                       rtol=2e-5)
    for n in NAMES:
        np.testing.assert_allclose(final[n], jfinal[n], rtol=2e-5)


def test_split_demo_two_ranks_equal_one_rank(tmp_path, no_launch_env):
    """``demo_model_split --model_parallel 2`` for 20 iterations: 2 ranks
    × 256 over gloo (DDP over the two-stage modules) log the losses of 1
    rank × 512."""
    iters = 20
    base = ["--device", "cpu", "--dry_run", "--seed", "0",
            "--total_iterations", str(iters)]
    no_launch_env.chdir(tmp_path)
    split_main(base + ["--batch_size", "512"])
    want = metric_rows(tmp_path / "runs" / "demo_model_split" /
                       "metrics.jsonl")
    cwd = tmp_path / "two"
    cwd.mkdir()
    outs = launch_ranks("tpudist_torch.examples.demo_model_split",
                        base + ["--batch_size", "256"], cwd,
                        torchrun_envs(2))
    assert "world=2" in outs[0] and "backend=gloo" in outs[0]
    got = metric_rows(cwd / "runs" / "demo_model_split" / "metrics.jsonl")
    assert len(got) == len(want) == iters
    for g, w in zip(got, want):
        for n in NAMES:
            np.testing.assert_allclose(g[f"loss/{n}"], w[f"loss/{n}"],
                                       rtol=1e-6)
