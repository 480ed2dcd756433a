"""The port's pipeline entry points against the JAX package's, on the CPU:
``tpudist_torch.examples.demo_pipeline`` and the Trainer's ``pp``.

- ``demo_pipeline`` per schedule (GPipe, 1F1B, interleaved at ``--chunks
  2``) in one process (the four stages folded onto the CPU) against the
  JAX demo in process on the suite's 8-device mesh (data 2 × stage 4),
  from the JAX init's weights: the metric rows' losses at ``rtol 1e-5``
  (the JAX data axis splits the same global batch; the mean is the
  same); its guards.
- ``Trainer(strategy='pp')`` on the LM module (1F1B and interleaved)
  against the JAX Trainer's (data 4 × stage 2), 8 steps at ``rtol 2e-5``
  (``tests/test_torch_long_context.py``'s bound), ``final_states`` whole;
  JAX's refusals: bf16, and the toy module.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_long_context import (CarriedChainLM, _load_example,
                                     no_launch_env, trainer_args)
from test_torch_3d import _carried
from torch_cases import settled_torch_cpu
from torch_launch import metric_rows
from tpudist.models.transformer import create_transformer as jax_create
from tpudist_torch.examples import demo_pipeline as port_demo
from tpudist_torch.models import params_from_flax

assert no_launch_env  # a fixture of this module too

ARGV = ["--dry_run", "--seed", "0", "--seq_len", "16", "--d_model", "32",
        "--vocab", "32", "--lr", "1e-3", "--total_iterations", "3",
        "--stages", "4"]


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_demo_pipeline_equals_jax_demo(tmp_path, no_launch_env, schedule):
    import tpudist.runtime.bootstrap as bs

    argv = ARGV + ["--schedule", schedule]
    mod = _load_example("demo_pipeline")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    no_launch_env.chdir(tmp_path / "jax")
    no_launch_env.setattr("sys.argv", ["prog"] + argv)
    bs._INITIALIZED_CTX = None
    mod.main()
    want = metric_rows(tmp_path / "jax" / "runs" / "demo_pipeline" /
                       "metrics.jsonl")
    _, params = jax_create(jax.random.PRNGKey(0), seq_len=16, vocab=32,
                           d_model=32, n_layers=8, n_heads=4, d_ff=128,
                           max_len=16)
    no_launch_env.chdir(tmp_path / "port")
    no_launch_env.setattr(port_demo, "create_transformer", _carried(params))
    port_demo.main(argv + ["--device", "cpu"])
    got = metric_rows(tmp_path / "port" / "runs" / "demo_pipeline" /
                      "metrics.jsonl")
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want] \
        == [0, 2]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=1e-5)


def test_demo_pipeline_guards():
    for argv, msg in ((["--n_layers", "6"], "must divide into 4"),
                      (["--schedule", "interleaved", "--n_layers", "4"],
                       "must divide into 8"),
                      (["--batch_size", "6"], "must divide into 4 micro")):
        with pytest.raises(SystemExit, match=msg):
            port_demo.resolve_schedule(port_demo.get_args(
                ["--device", "cpu", "--stages", "4"] + argv))
    args = port_demo.get_args(["--device", "cpu"])
    assert (args.stages, args.schedule, args.chunks, args.batch_size,
            args.n_layers, args.d_model, args.seq_len, args.vocab,
            args.lr) == (4, "1f1b", 2, 16, 8, 128, 64, 64, 3e-4)
    assert port_demo.resolve_schedule(port_demo.get_args(
        ["--device", "cpu", "--schedule", "interleaved"])) == (2, 8)


def test_trainer_pp_equals_jax_trainer(tmp_path, no_launch_env):
    from tpudist.trainer import Trainer as JaxTrainer
    from tpudist_torch.examples.demo_trainer import (ChainLoader,
                                                     ToyTrainerModule)
    from tpudist_torch.trainer import Trainer

    no_launch_env.chdir(tmp_path)
    jdemo = _load_example("demo_trainer")
    argv = ["--seed", "0", "--dry_run", "--batch_size", "16", "--seq_len",
            "32", "--vocab", "32", "--d_model", "32", "--n_layers", "4",
            "--total_iterations", "8"]
    jmodule = jdemo.ChainLMModule(jdemo.get_args(argv))
    _, params = jmodule.configure_lm(jax.random.PRNGKey(0))
    module = CarriedChainLM(trainer_args(argv + ["--device", "cpu"]),
                            params_from_flax(jax.device_get(params)))
    kw = dict(max_steps=8, dry_run=True, seed=0, progress_bar=False,
              strategy="pp", pipeline_stages=2)
    loader = dict(batch=16, seq=32, vocab=32, seed=0)
    for schedule in ("1f1b", "interleaved"):
        JaxTrainer(group=f"jax_{schedule}", pp_schedule=schedule,
                   **kw).fit(jmodule, jdemo.ChainLoader(**loader))
        t = Trainer(group=f"port_{schedule}", pp_schedule=schedule,
                    device="cpu", **kw)
        t.fit(module, ChainLoader(**loader))
        want = metric_rows(f"runs/jax_{schedule}/metrics.jsonl")
        got = metric_rows(f"runs/port_{schedule}/metrics.jsonl")
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["loss/lm"], w["loss/lm"], rtol=2e-5)
        final = t.final_states["lm"].model
        assert all(p.numel() for p in final.parameters())
    with pytest.raises(ValueError, match="precision='bf16'"):
        Trainer(device="cpu", precision="bf16", **kw).fit(
            module, ChainLoader(**loader))
    with pytest.raises(ValueError, match="needs an LMTrainerModule"):
        Trainer(device="cpu", **kw).fit(ToyTrainerModule(), None)
