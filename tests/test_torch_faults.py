"""The port's fault grammar, watchdog and runtime seams against JAX's:
``faults.parse`` equal on every grammar example and on bad specs (type
and text); ``init_fail`` retried through the init backoff until the
process group comes up; ``ckpt_corrupt`` falling back to the earlier
step; ``host_delay`` stalling the host collective inside its span; the
watchdog never firing while petted, granting the first deadline's slack,
and a stall exiting 124 with every thread's stack in the crash record;
and the Trainer's LM loop under ``sigterm@step:K``."""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from torch_cases import settled_torch_cpu
from tpudist.runtime import bootstrap as jax_bootstrap
from tpudist.runtime import faults as jax_faults
from tpudist.runtime import preemption as jax_preemption
from tpudist.trainer import LMTrainerModule as JaxLMModule
from tpudist.trainer import Trainer as JaxTrainer
from tpudist_torch import telemetry
from tpudist_torch.checkpoint import CheckpointConfig, CheckpointManager
from tpudist_torch.comm.collectives import host_allreduce_sum
from tpudist_torch.models import ToyMLP, TransformerLM
from tpudist_torch.models.convert import params_from_flax
from tpudist_torch.runtime import bootstrap, faults, preemption, watchdog
from tpudist_torch.runtime.bootstrap import ProcessContext
from tpudist_torch.train import build_optimizer, init_model_states
from tpudist_torch.trainer import LMTrainerModule, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the small LM's port-vs-JAX loss tolerance after 6 Adam steps
LM_RTOL = 1e-4
LM = dict(vocab=32, d_model=32, n_layers=1, n_heads=2, d_ff=64, max_len=16)
SEQ, BATCH, LM_STEPS = 16, 8, 6

GOOD = [
    "kill@step:7,rank:1", "sigterm@step:5", "ckpt_corrupt@step:10",
    "host_delay@ms:500", "init_fail@attempts:2",
    "ckpt_corrupt@step:16;kill@step:19",
    "serve_worker_kill@call:8,pool:1,worker:0", "handoff_corrupt@nth:2",
    "host_tier_corrupt@nth:1", "replica_kill@nth:1",
    "replica_kill@nth:2,tick:3", "draft_swap_corrupt@nth:1",
    "sigterm@step:1,attempt:1", " kill @ step:3 ; ",
    "kill@step:7,rank:1;sigterm@step:5;ckpt_corrupt@step:10;"
    "host_delay@ms:500;init_fail@attempts:2",
]
BAD = ["explode@step:1", "kill@when:1", "kill@step:soon", "kill",
       "host_delay@step:1", "", ";;", "serve_worker_kill@pool:1",
       "handoff_corrupt@call:1", "kill@step", "init_fail@attempts:x"]


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
                 "TPUDIST_NUM_PROCESSES", "TPUDIST_PROCESS_ID",
                 "TPUDIST_HOST_TIMEOUT_S"):
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


@pytest.mark.parametrize("spec", GOOD)
def test_parse_equals_jax(spec):
    got = [(s.kind, s.params) for s in faults.parse(spec)]
    assert got == [(s.kind, s.params) for s in jax_faults.parse(spec)]


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_fail_as_jax(spec):
    with pytest.raises(jax_faults.FaultSpecError) as want:
        jax_faults.parse(spec)
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse(spec)
    assert str(got.value) == str(want.value)
    assert issubclass(faults.FaultSpecError, ValueError)


def test_retry_backoff_equals_jax():
    """The jittered exponential backoff: the same delays for the same
    draws, the last failure re-raised past the budget."""
    def run(mod):
        delays, calls = [], []

        def fn(attempt):
            calls.append(attempt)
            if attempt < 3:
                raise OSError(f"blip {attempt}")
            return "up"

        draws = iter([0.1, 0.9, 0.5])
        out = mod._retry_with_backoff(fn, retries=3, backoff_s=0.25,
                                      what="x", sleep=delays.append,
                                      rng=lambda: next(draws))
        with pytest.raises(OSError):
            mod._retry_with_backoff(lambda a: (_ for _ in ()).throw(
                OSError("down")), retries=1, backoff_s=0.0, what="y",
                sleep=delays.append)
        return out, calls, delays

    assert run(bootstrap) == run(jax_bootstrap)


def test_init_fail_is_retried_until_init(tmp_path):
    """``init_fail@attempts:2`` at a world-1 gloo launch: the first two
    rendezvous raise the injected transient error, the third joins the
    group; the stream holds the ``init`` span and two ``retry`` events."""
    faults.arm("init_fail@attempts:2")
    ctx = ProcessContext(process_id=0, num_processes=1,
                         coordinator_address=f"localhost:"
                                             f"{bootstrap.find_free_port()}",
                         local_rank=0, local_world_size=1,
                         launch_source="explicit")
    telemetry.start(tmp_path / "t")
    try:
        bootstrap.initialize(ctx, device="cpu", init_backoff_s=0.0)
        assert torch.distributed.is_initialized()
        assert faults._PLAN[0].fired == 2
    finally:
        bootstrap.shutdown()
        telemetry.finish(write_report=False)
    recs = [json.loads(x) for x in
            (tmp_path / "t" / "rank0_gen0.jsonl").read_text().splitlines()]
    names = [r["name"] for r in recs]
    assert names.count("retry") == 2 and names.count("init") == 1
    assert [r for r in recs if r["name"] == "init"][0]["world"] == 1


def _toy_states():
    gen = torch.Generator().manual_seed(0)
    model = ToyMLP()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return init_model_states({"m": model},
                             lambda p: build_optimizer(p, 1e-3))


def test_ckpt_corrupt_falls_back_to_the_earlier_step(tmp_path):
    """``ckpt_corrupt@step:2`` garbles step 2 after its write: the step is
    still listed, restore logs the corruption and loads step 1; a forced
    save at a saved step stamps its meta as an overlay, as JAX's does."""
    states = _toy_states()
    faults.arm("ckpt_corrupt@step:2")
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / "cc"), async_save=False))
    assert mgr.save(1, states, {"iteration": 1})
    assert mgr.save(2, states, {"iteration": 2})
    assert faults._PLAN[0].fired == 1
    assert mgr.latest_step == 2
    assert mgr.restore(_toy_states())["iteration"] == 1
    assert not mgr.save(1, states, {"iteration": 1, "x": 1})
    assert mgr.save(1, states, {"iteration": 1, "preempted": True},
                    force=True)
    assert mgr.restore(_toy_states(), step=1)["preempted"] is True
    mgr.close()


def test_host_delay_stalls_the_host_collective(tmp_path):
    """``host_delay@ms:150`` stalls every host collective inside its
    ``host_collective`` span."""
    faults.arm("host_delay@ms:150")
    telemetry.start(tmp_path / "t")
    try:
        t0 = time.monotonic()
        assert float(host_allreduce_sum(np.float64(2.0))) == 2.0
        assert time.monotonic() - t0 >= 0.15
    finally:
        telemetry.finish(write_report=False)
    spans = [json.loads(x) for x in
             (tmp_path / "t" / "rank0_gen0.jsonl").read_text().splitlines()
             if '"host_collective"' in x]
    assert spans[0]["op"] == "host_allreduce_sum" and spans[0]["dur"] >= 0.15


def test_watchdog_pets_slack_and_stall():
    """Petted faster than its deadline the watchdog never fires; before
    the first pet ``first_deadline_s`` grants its slack; a stall after
    that aborts with exit 124."""
    codes = []
    wd = watchdog.Watchdog(0.2, poll_interval_s=0.02, abort=codes.append)
    with wd:
        for _ in range(20):
            time.sleep(0.03)
            wd.pet()
    assert not wd.stalled and codes == []
    wd = watchdog.Watchdog(0.2, poll_interval_s=0.02, first_deadline_s=1.0,
                           abort=codes.append)
    with wd:
        time.sleep(0.5)  # past the stall deadline, inside the slack
        assert not wd.stalled
        assert watchdog.freshness()[wd.name]["fresh"]
        wd.pet()
        deadline = time.monotonic() + 5.0
        while not wd.stalled and time.monotonic() < deadline:
            time.sleep(0.02)
    assert wd.stalled and watchdog.WATCHDOG_EXIT_CODE == 124
    assert codes == [124]


def test_watchdog_stall_exits_124_with_the_stacks(tmp_path):
    """A real stall in a child process: exit 124 through ``os._exit``, and
    the crash record holds every thread's stack."""
    err = tmp_path / "err_%r.json"
    code = ("import time; from tpudist_torch.runtime import watchdog\n"
            "watchdog.Watchdog(0.3, name='child').start()\n"
            "time.sleep(30)\n")
    env = dict(os.environ, TPUDIST_ERROR_FILE=str(err),
               TPUDIST_TELEMETRY="0", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 124, proc.stderr
    rec = json.loads((tmp_path / "err_0.json").read_text())
    assert rec["exc_type"] == "WatchdogStall"
    assert any("MainThread" in k for k in rec["stacks"])
    # the main thread's stack stands at the sleep (line 3)
    assert 'File "<string>", line 3' in rec["traceback"]


class _TinyJaxLM(JaxLMModule):
    def configure_lm(self, rng):
        from tpudist.models import create_transformer

        return create_transformer(rng, seq_len=SEQ, **LM)


class _TinyLM(LMTrainerModule):
    """The JAX module's initial weights, carried across."""

    def __init__(self, flat):
        self.flat = flat

    def configure_lm(self, generator):
        model = TransformerLM(param_dtype=torch.float32, **LM)
        model.load_state_dict(self.flat)
        return model


def _tokens():
    r = np.random.default_rng(0)
    return [r.integers(0, LM["vocab"], size=(BATCH, SEQ)).astype(np.int32)
            for _ in range(6)]


def test_trainer_lm_drill_resumes_to_jax(tmp_path, drill_env):
    """The Trainer's LM loop under ``sigterm@step:3`` and
    ``checkpoint_every=2``: it stops at step 3 with a forced save stamped
    ``preempted``, ``Trainer.preempted`` set; resumed at restart 1 it runs
    to step 6, where its loss is the JAX Trainer's unbroken loss."""
    jmod = _TinyJaxLM()
    _, params = jmod.configure_lm(jax.random.PRNGKey(0))
    want = JaxTrainer(max_steps=LM_STEPS, progress_bar=False,
                      dry_run=True).fit(jmod, _tokens())
    flat = params_from_flax(jax.device_get(params))
    kw = dict(max_steps=LM_STEPS, progress_bar=False, dry_run=True,
              device="cpu", checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every=2)
    drill_env.setenv("TPUDIST_FAULT", "sigterm@step:3")
    first = Trainer(**kw)
    first.fit(_TinyLM(flat), _tokens())
    assert first.preempted
    saved = sorted(p.name for p in (tmp_path / "ck").glob("step_*.pt"))
    assert saved == ["step_2.pt", "step_3.pt"]
    meta = torch.load(tmp_path / "ck" / "step_3.pt",
                      weights_only=True)["meta"]
    assert meta["preempted"] is True and meta["iteration"] == 3
    drill_env.delenv("TPUDIST_FAULT")
    drill_env.setenv("TPUDIST_RESTART_COUNT", "1")
    second = Trainer(resume=True, **kw)
    got = second.fit(_TinyLM(flat), _tokens())
    assert not second.preempted
    np.testing.assert_allclose(got["lm"], want["lm"], rtol=LM_RTOL)
