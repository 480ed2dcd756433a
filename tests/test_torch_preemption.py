"""The SIGTERM preemption save of the port's loops against JAX's, driven
by the fault grammar (``TPUDIST_FAULT=sigterm@step:K``) in one process:
the toy loop on both of its paths saves the iteration and meta JAX's
``run_training`` saves under the same drill and resumes to JAX's losses.
The Trainer's LM loop under the same drill is held in
``test_torch_faults.py``."""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from torch_cases import settled_torch_cpu
from tpudist.checkpoint import setup_checkpointing as jax_setup_ckpt
from tpudist.data import ShardedLoader as JaxLoader
from tpudist.data import ShardPlan as JaxPlan
from tpudist.data import make_toy_data as jax_toy_data
from tpudist.models import create_toy_model as jax_toy_model
from tpudist.runtime import faults as jax_faults
from tpudist.runtime import preemption as jax_preemption
from tpudist.train import TrainLoopConfig as JaxLoopConfig
from tpudist.train import init_model_states as jax_init_states
from tpudist.train import make_multi_model_train_step as jax_step
from tpudist.train import make_scanned_train_step as jax_scanned
from tpudist.train import run_training as jax_run_training
from tpudist_torch.checkpoint import setup_checkpointing
from tpudist_torch.data import ShardedLoader, ShardPlan, make_toy_data
from tpudist_torch.models import ToyMLP, toy_params_from_flax
from tpudist_torch.runtime import faults, preemption
from tpudist_torch.train import (TrainLoopConfig, build_optimizer,
                                 init_model_states,
                                 make_multi_model_train_step,
                                 make_scanned_train_step, run_training)

NAMES = ("model_X", "model_Y")
#: the toy step's port-vs-JAX tolerance (``test_torch_toy.py``)
TOY_RTOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture(autouse=True)
def drill_env(monkeypatch, tmp_path):
    """No ambient chaos, restart or launch env; telemetry into the test's
    directory; both registries disarmed and both handlers reset after."""
    for name in ("TPUDIST_FAULT", "TPUDIST_RESTART_COUNT",
                 "TPUDIST_WATCHDOG_S", "RANK", "WORLD_SIZE",
                 "TPUDIST_NUM_PROCESSES", "TPUDIST_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUDIST_TELEMETRY_DIR", str(tmp_path / "tele"))
    monkeypatch.setenv("WANDB_MODE", "dryrun")
    monkeypatch.chdir(tmp_path)
    yield monkeypatch
    for mod in (faults, jax_faults):
        mod.disarm()
    for mod in (preemption, jax_preemption):
        mod.reset()
        mod.clear_last_run_preempted()


@functools.lru_cache(maxsize=None)
def _jax_toy(mesh):
    """The JAX models and their compiled steps, built once: every drill
    run reuses the same jitted functions."""
    kx, ky = jax.random.split(jax.random.PRNGKey(0))
    pairs = jax_toy_model(kx), jax_toy_model(ky)
    tx = optax.adam(1e-3)
    apply_fns = {n: m.apply for n, (m, _) in zip(NAMES, pairs)}
    return (pairs, tx, jax_step(apply_fns, tx, mesh, donate_state=False),
            jax_scanned(apply_fns, tx, mesh, donate_state=False))


def _port_states(pairs):
    models = {}
    for n, (_, p) in zip(NAMES, pairs):
        models[n] = ToyMLP()
        models[n].load_state_dict(toy_params_from_flax(jax.device_get(p)))
    return init_model_states(models, lambda p: build_optimizer(p, 1e-3))


def _jax_run(mesh, ckpt_dir, scanned, total, resume):
    pairs, tx, step, chunk = _jax_toy(mesh)
    states = jax_init_states(
        {n: (m.apply, p) for n, (m, p) in zip(NAMES, pairs)}, tx)
    data = jax_toy_data(seed=0)
    loader = JaxLoader(data, 64, JaxPlan(len(data), 1, 0, seed=0))
    mgr, states, start = jax_setup_ckpt(states, ckpt_dir, resume=resume,
                                        mesh=mesh)
    cfg = JaxLoopConfig(total_iterations=total, progress_bar=False,
                        sync_every=4, device_cache=scanned)
    try:
        _, final = jax_run_training(
            states, step, loader, mesh, None, cfg, ckpt=mgr,
            start_iteration=start, chunk_step_fn=chunk)
        from tpudist.checkpoint.manager import abstract_like

        _, meta = mgr.restore(abstract_like(states))
    finally:
        mgr.close()
    return final, meta, jax_preemption.last_run_preempted()


def _port_run(pairs, ckpt_dir, scanned, total, resume):
    states = _port_states(pairs)
    data = make_toy_data(seed=0)
    loader = ShardedLoader(data, 64, ShardPlan(len(data), 1, 0, seed=0))
    mgr, states, start = setup_checkpointing(states, ckpt_dir,
                                             resume=resume)
    cfg = TrainLoopConfig(total_iterations=total, progress_bar=False,
                          sync_every=4, device_cache=scanned)
    try:
        _, final = run_training(
            states, make_multi_model_train_step(), loader, "cpu", None, cfg,
            make_scanned_train_step(), ckpt=mgr, start_iteration=start)
        meta = mgr.restore(_port_states(pairs))
    finally:
        mgr.close()
    return final, meta, preemption.last_run_preempted()


@pytest.mark.parametrize("scanned", [False, True], ids=["per_step",
                                                         "scanned"])
def test_toy_drill_equals_jax(dp_mesh, tmp_path, drill_env, scanned):
    """``sigterm@step:2`` at a sync cadence of 4: both loops save at the
    same boundary (4 per step, the window edge 8 scanned) with the same
    meta and the sticky preempted record; each resumes to 12, ending at
    JAX's losses."""
    pairs = _jax_toy(dp_mesh)[0]
    drill_env.setenv("TPUDIST_FAULT", "sigterm@step:2")
    jfinal, jmeta, jpre = _jax_run(dp_mesh, str(tmp_path / "jck"), scanned,
                                   12, False)
    final, meta, pre = _port_run(pairs, str(tmp_path / "ck"), scanned, 12,
                                 False)
    assert jpre and pre
    assert jmeta["preempted"] is True and meta["preempted"] is True
    assert jmeta["iteration"] == meta["iteration"] == (8 if scanned else 4)
    assert {k: meta[k] for k in jmeta} == dict(jmeta)
    drill_env.delenv("TPUDIST_FAULT")
    drill_env.setenv("TPUDIST_RESTART_COUNT", "1")
    jfinal, jmeta, jpre = _jax_run(dp_mesh, str(tmp_path / "jck"), scanned,
                                   12, True)
    final, meta, pre = _port_run(pairs, str(tmp_path / "ck"), scanned, 12,
                                 True)
    assert not jpre and not pre
    assert jmeta["iteration"] == meta["iteration"] == 12
    assert "preempted" not in meta
    for n in NAMES:
        np.testing.assert_allclose(final[n], jfinal[n], rtol=TOY_RTOL)
