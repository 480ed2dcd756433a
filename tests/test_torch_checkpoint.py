"""Checkpoint / resume of the port (``tpudist_torch.checkpoint``, the
loop's ``ckpt``/``start_iteration``, the demos' flags) against the
contract the JAX package's manager keeps (``tests/test_checkpoint.py``).

A run that saves and resumes equals the unbroken run bit for bit — the
parameters, the Adam moments and every logged loss — on the per-step
path and on the device-cached path (windows of 16 cut at the saves every
3 iterations), resumed mid-epoch: the loader's order is a pure function of
``(seed, epoch)`` and the toy step draws no random numbers, so no RNG
state needs saving, and these tests are what shows it.  A checkpoint
written by 2 ranks resumes at 1 at the same global batch within ``rtol
1e-6`` of the unbroken 1-rank run (the same samples summed in another
order, as ``test_torch_toy.py`` holds 2 ranks against 1).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudist.checkpoint import checkpoint_dir_for as jax_checkpoint_dir_for
from tpudist.checkpoint import \
    resolve_checkpoint_location as jax_resolve_location
from torch_cases import settled_torch_cpu
from torch_launch import LAUNCH_ENV, launch_ranks, metric_rows, torchrun_envs
from tpudist_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                      CheckpointRestoreError,
                                      checkpoint_dir_for,
                                      resolve_checkpoint_location,
                                      setup_checkpointing)
from tpudist_torch.checkpoint import manager as manager_mod
from tpudist_torch.config import get_args
from tpudist_torch.examples.common import build_training
from tpudist_torch.examples.demo import main as demo_main
from tpudist_torch.runtime.mesh import data_parallel_mesh
from tpudist_torch.train import run_training
from tpudist_torch.utils import MetricsLogger

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


def _training(iterations, batch=64, seed=0):
    """The demo's training at ``batch`` on the CPU, windows of 16."""
    args = get_args(["--device", "cpu", "--seed", str(seed),
                     "--batch_size", str(batch), "--total_iterations",
                     str(iterations)])
    states, step, loader, cfg, chunk = build_training(
        args, data_parallel_mesh(device="cpu"))
    cfg.sync_every, cfg.progress_bar = 16, False
    return states, step, loader, cfg, chunk


def _assert_tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b


def _assert_states_equal(a, b):
    for n in NAMES:
        _assert_tree_equal(a[n].model.state_dict(), b[n].model.state_dict())
        _assert_tree_equal(a[n].optimizer.state_dict(),
                           b[n].optimizer.state_dict())


def _losses(path):
    return [{k: v for k, v in r.items() if k.startswith("loss/")}
            for r in metric_rows(path)]


def _run(tmp_path, label, iterations, scanned, *, ckpt=None, start=0,
         states=None):
    states_, step, loader, cfg, chunk = _training(iterations)
    path = tmp_path / label / "metrics.jsonl"
    states, _ = run_training(
        states or states_, step, loader, "cpu", MetricsLogger(jsonl_path=path),
        cfg, chunk if scanned else None, ckpt=ckpt, start_iteration=start)
    return states, _losses(path)


@pytest.mark.parametrize("scanned", [False, True])
@pytest.mark.parametrize("async_save", [False, True])
def test_resume_equals_unbroken_run_bit_for_bit(tmp_path, scanned,
                                                async_save):
    """20 iterations unbroken, against 10 iterations saving every 3 (and
    at the end), then resumes from the last save (iteration 10) and from
    the cadence save of iteration 9 (mid-epoch: 8 batches an epoch), each
    to 20."""
    whole, rows = _run(tmp_path, "whole", 20, scanned)
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / "ck"), save_every=3,
        async_save=async_save))
    _, first = _run(tmp_path, "first", 10, scanned, ckpt=mgr)
    assert first == rows[:10]
    assert mgr.all_steps() == [6, 9, 10]  # the last three kept
    for step in (10, 9):
        fresh = _training(20)[0]
        meta = mgr.restore(fresh, step=step)
        assert meta["iteration"] == step and meta["seed"] is None
        resumed, tail = _run(tmp_path, f"from{step}", 20, scanned,
                             start=step, states=fresh)
        assert tail == rows[step:]
        _assert_states_equal(resumed, whole)


def test_stray_tmp_and_unparsed_names_are_ignored(tmp_path):
    states = _training(1)[0]
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path),
                                             async_save=False))
    mgr.save(4, states, {"iteration": 4, "epoch": 0})
    (tmp_path / "step_7.tmp").write_bytes(b"half a write")
    (tmp_path / "step_x.pt").write_bytes(b"not a step")
    assert mgr.all_steps() == [4] and mgr.latest_step == 4
    assert mgr.restore(_training(1)[0])["iteration"] == 4


def test_keep_last_n(tmp_path):
    states = _training(1)[0]
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path), max_to_keep=2, async_save=True))
    for s in range(1, 6):
        assert mgr.save(s, states, {"iteration": s, "epoch": 0})
    assert not mgr.save(5, states, {"iteration": 5, "epoch": 0})
    mgr.wait_until_finished()
    assert mgr.all_steps() == [4, 5]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4.pt",
                                                          "step_5.pt"]


def test_corrupt_latest_falls_back(tmp_path, capsys):
    """A torn latest step restores the previous one (the states then equal
    what was saved there); an explicit step does not fall back; with every
    step torn, ``CheckpointRestoreError``."""
    states, step, loader, cfg, chunk = _training(6)
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path), save_every=3, async_save=False))
    run_training(states, step, loader, "cpu", None, cfg, chunk, ckpt=mgr)
    latest = tmp_path / "step_6.pt"
    latest.write_bytes(latest.read_bytes()[:1000])
    fresh = _training(6)[0]
    assert mgr.restore(fresh)["iteration"] == 3
    assert "degraded restore: step 3" in capsys.readouterr().err
    want, step, loader, cfg, chunk = _training(3)
    run_training(want, step, loader, "cpu", None, cfg, chunk)
    _assert_states_equal(fresh, want)
    with pytest.raises(RuntimeError):  # the zip reader's, no fallback
        mgr.restore(fresh, step=6)
    (tmp_path / "step_3.pt").write_bytes(b"garbage")
    with pytest.raises(CheckpointRestoreError):
        mgr.restore(fresh)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(CheckpointConfig(
            directory=str(tmp_path / "empty"))).restore(fresh)


def test_async_and_sync_saves_write_identical_files(tmp_path):
    """The async snapshot is taken before the next step changes the
    parameters in place: its file equals the synchronous save's."""
    states, step, loader, cfg, chunk = _training(4)
    run_training(states, step, loader, "cpu", None, cfg, chunk)
    meta = {"iteration": 4, "epoch": 0}
    a = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "a"),
                                           async_save=True), seed=0)
    s = CheckpointManager(CheckpointConfig(directory=str(tmp_path / "s"),
                                           async_save=False), seed=0)
    a.save(4, states, meta)
    s.save(4, states, meta)
    # mutate in place while the async write may still run
    for n in NAMES:
        with torch.no_grad():
            for p in states[n].model.parameters():
                p.add_(1.0)
    a.wait_until_finished()
    assert (tmp_path / "a" / "step_4.pt").read_bytes() == \
        (tmp_path / "s" / "step_4.pt").read_bytes()


def test_transient_write_errors_are_retried(tmp_path, monkeypatch):
    states = _training(1)[0]
    real, calls = torch.save, []

    def flaky(obj, f):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("blip")
        return real(obj, f)

    monkeypatch.setattr(manager_mod.torch, "save", flaky)
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / "r"), async_save=False,
        save_retry_backoff_s=0.0))
    mgr.save(1, states, {"iteration": 1, "epoch": 0})
    assert mgr.all_steps() == [1] and len(calls) == 2
    calls.clear()
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / "n"), async_save=True, save_retries=0))
    mgr.save(1, states, {"iteration": 1, "epoch": 0})
    with pytest.raises(OSError, match="blip"):
        mgr.wait_until_finished()


ENV_CASES = [
    ({}, None, 0, False),
    ({}, "given", 5, True),
    ({"scratch_dir": "/s", "exp_name": "e"}, None, 5, False),
    ({"scratch_dir": "/s"}, None, 0, True),
    ({"exp_name": "e", "project_name": "p"}, None, 1, False),
    ({"scratch_dir": "/s", "exp_name": "e", "project_name": "p"}, None, 0,
     False),
    ({}, None, 0, True),
    ({"scratch_dir": "/s"}, None, 0, False),
]


def test_checkpoint_config_equals_jax():
    import dataclasses

    from tpudist.checkpoint import CheckpointConfig as JaxConfig

    assert [(f.name, f.default) for f in dataclasses.fields(
        CheckpointConfig)] == [(f.name, f.default)
                               for f in dataclasses.fields(JaxConfig)]


@pytest.mark.parametrize("env,directory,every,resume", ENV_CASES)
def test_checkpoint_location_equals_jax(monkeypatch, env, directory, every,
                                        resume):
    for k in ("scratch_dir", "exp_name", "project_name"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert checkpoint_dir_for() == jax_checkpoint_dir_for()
    assert checkpoint_dir_for("/x", "y") == jax_checkpoint_dir_for("/x", "y")
    try:
        want = jax_resolve_location(directory, save_every=every,
                                    resume=resume)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:40]):
            resolve_checkpoint_location(directory, save_every=every,
                                        resume=resume)
        return
    assert resolve_checkpoint_location(directory, save_every=every,
                                       resume=resume) == want


def _demo(cwd, *extra):
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        return demo_main(["--device", "cpu", "--dry_run", "--seed", "0",
                          *extra])
    finally:
        os.chdir(here)


def _demo_losses(cwd):
    return _losses(Path(cwd) / "runs" / "demo_dp" / "metrics.jsonl")


def test_demo_resume_gives_the_unbroken_rows(tmp_path, no_launch_env):
    """``demo --checkpoint_every 5`` for 12 iterations, then ``--resume``
    to 20: the metrics file holds the unbroken run's 20 rows, bit for bit;
    a resume under another seed refuses."""
    _demo(tmp_path / "whole", "--total_iterations", "20")
    ck = str(tmp_path / "ck")
    _demo(tmp_path / "broken", "--total_iterations", "12",
          "--checkpoint_dir", ck, "--checkpoint_every", "5")
    assert sorted(os.listdir(ck)) == ["step_10.pt", "step_12.pt",
                                      "step_5.pt"]
    _demo(tmp_path / "broken", "--total_iterations", "20",
          "--checkpoint_dir", ck, "--checkpoint_every", "5", "--resume")
    assert _demo_losses(tmp_path / "broken") == _demo_losses(
        tmp_path / "whole")
    assert CheckpointManager(CheckpointConfig(ck)).all_steps() == [12, 15,
                                                                   20]
    with pytest.raises(ValueError, match="resume with --seed 0"):
        demo_main(["--device", "cpu", "--dry_run", "--seed", "1",
                   "--total_iterations", "20", "--checkpoint_dir", ck,
                   "--resume"])


def test_saved_at_two_ranks_resumed_at_one(tmp_path, no_launch_env):
    """2 ranks × 256 over gloo save at iteration 10; 1 rank × 512 resumes
    to 20 and logs the unbroken 1-rank run's rows 10-19."""
    _demo(tmp_path / "whole", "--total_iterations", "20", "--batch_size",
          "512")
    ck = str(tmp_path / "ck")
    two = tmp_path / "two"
    two.mkdir()
    launch_ranks("tpudist_torch.examples.demo",
                 ["--device", "cpu", "--dry_run", "--seed", "0",
                  "--total_iterations", "10", "--batch_size", "256",
                  "--checkpoint_dir", ck, "--checkpoint_every", "5"],
                 two, torchrun_envs(2))
    _demo(tmp_path / "one", "--total_iterations", "20", "--batch_size",
          "512", "--checkpoint_dir", ck, "--resume")
    want = _demo_losses(tmp_path / "whole")[10:]
    got = _demo_losses(tmp_path / "one")
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6)


def test_setup_checkpointing_without_resume_starts_at_zero(tmp_path):
    states = _training(1)[0]
    mgr, same, start = setup_checkpointing(states, str(tmp_path),
                                           save_every=2)
    assert same is states and start == 0 and mgr.latest_step is None
    assert mgr.seed is None and mgr.config.save_every == 2
