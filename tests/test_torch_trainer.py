"""The Trainer facade (``tpudist_torch.trainer``,
``tpudist_torch.examples.demo_trainer``) against the JAX package's
(``tpudist.trainer``, ``examples/demo_trainer.py``), and the profiling
helpers (``tpudist_torch.utils.profiling``) against
``tpudist.utils.profiling``.

The JAX demo's module draws both models from ``jax.random.split`` of the
seed, the port's one after the other from a ``torch.Generator``: the
parity runs carry the JAX module's weights across (``toy_params_from_flax``)
and train 40 steps of the reference's Lightning shape (batch 128, Adam 1e-3
a model) on both facades.  Tolerances:

- fp32 with the module's Adam computed as optax computes it
  (:class:`OptaxAdam`: the bias corrections ``1 - b**t`` in f32), both
  ``strategy`` ``dp`` and ``dp_model``: ``rtol 2e-5``, the bound
  ``test_torch_toy.py`` derives for the same step on the same mesh (read:
  2.2e-7 over the 40 steps);
- fp32 with the demo module's own Adam (``torch.optim.Adam``, whose bias
  corrections are float64): ``rtol 3e-5``.  optax's f32 ``1 - 0.999**t``
  is 1.3e-5 relative off at t = 1, so JAX's step sizes are up to 6.4e-6
  off and its trajectory leaves a float64 run of the same steps by 2.1e-5
  at step 40 on these weights and data, where the port's stays within
  3.0e-7 of it; the two facades read 2.1e-5 apart at step 40;
- bf16: both facades cast the f32 masters and the inputs to bf16 at apply
  time and the output back to f32, but XLA and PyTorch's CPU kernels
  round the bf16 products' sums and bias adds at different points, each a
  bf16 step (2**-8 relative) of a value.  The first row (the forward of
  the same weights on the same batch) reads 1.0e-4 apart, bound 3e-4 — an
  f32 forward of the same weights reads 7.4e-4 off, so a dropped cast
  fails it; Adam then carries each side's rounding into its own
  trajectory: 2.9e-3 apart at worst over the 40 steps, bound 1e-2.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from tpudist.comm.collectives import MetricBackend as JaxMetricBackend
from tpudist.trainer import Trainer as JaxTrainer
from tpudist.utils.metrics import MetricsLogger as JaxMetricsLogger
from tpudist.utils.profiling import StageTimer as JaxStageTimer
from torch_cases import settled_torch_cpu
from torch_launch import LAUNCH_ENV, REPO, metric_rows
from tpudist_torch.examples.common import build_loader
from tpudist_torch.examples.demo_trainer import get_args
from tpudist_torch.examples.demo_trainer import main as trainer_main
from tpudist_torch.models import ToyMLP, toy_params_from_flax
from tpudist_torch.train.optim import build_optimizer
from tpudist_torch.trainer import (BF16Apply, LMTrainerModule, Trainer,
                                   TrainerModule)
from tpudist_torch.utils import MetricsLogger, StageTimer, trace
from tpudist_torch.utils.profiling import TRACE_FILE

NAMES = ("model_X", "model_Y")


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture()
def no_launch_env(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUDIST_TELEMETRY", "0")
    monkeypatch.setenv("WANDB_MODE", "dryrun")
    return monkeypatch


def _jax_demo_trainer():
    """The JAX package's ``examples/demo_trainer.py`` as a module."""
    path = REPO / "examples" / "demo_trainer.py"
    spec = importlib.util.spec_from_file_location("jax_demo_trainer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class CarriedModule(TrainerModule):
    """The JAX demo module's weights in the port's ToyMLPs, one Adam at
    1e-3 a model (``demo_pytorch_lightning.py:35-40``)."""

    def __init__(self, flat):
        self.flat = flat

    def configure_models(self, generator):
        models = {}
        for n in NAMES:
            models[n] = ToyMLP()
            models[n].load_state_dict(self.flat[n])
        return models

    def configure_optimizers(self):
        adam = functools.partial(build_optimizer, lr=1e-3)
        return {n: adam for n in NAMES}


def _jax_weights(jmod, seed=0):
    models = jmod.ToyTrainerModule().configure_models(
        jax.random.PRNGKey(seed))
    return {n: toy_params_from_flax(jax.device_get(p))
            for n, (_, p) in models.items()}


class OptaxAdam(torch.optim.Optimizer):
    """Adam as ``optax.adam`` computes it: the bias corrections
    ``1 - b**t`` in f32 (``torch.optim.Adam`` takes them in float64)."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self):
        for g in self.param_groups:
            f32 = functools.partial(torch.tensor, dtype=torch.float32)
            for p in g["params"]:
                st = self.state[p]
                if not st:
                    st.update(t=0, m=torch.zeros_like(p),
                              v=torch.zeros_like(p))
                st["t"] += 1
                st["m"].mul_(g["b1"]).add_(p.grad, alpha=1 - g["b1"])
                st["v"].mul_(g["b2"]).addcmul_(p.grad, p.grad,
                                               value=1 - g["b2"])
                m_hat = st["m"] / (1 - f32(g["b1"]) ** st["t"])
                v_hat = st["v"] / (1 - f32(g["b2"]) ** st["t"])
                p.sub_(g["lr"] * m_hat / (v_hat.sqrt() + g["eps"]))


class OptaxAdamModule(CarriedModule):
    def configure_optimizers(self):
        return {n: lambda p: (OptaxAdam(p), None) for n in NAMES}


def _fit_both(strategy, precision, module=None, steps=40):
    """The JAX Trainer and the port's (with ``module``, default
    :class:`CarriedModule`), 40 steps from the same weights on the same
    data, in the working directory: both facades' metric rows."""
    jmod = _jax_demo_trainer()
    argv = ["--seed", "0", "--total_iterations", str(steps), "--dry_run"]
    jargs = jmod.get_args(argv)
    kw = dict(max_steps=steps, strategy=strategy, precision=precision,
              dry_run=True, seed=0, progress_bar=False)
    JaxTrainer(group="jax", metric_backend=JaxMetricBackend.ICI, **kw).fit(
        jmod.ToyTrainerModule(), jmod.build_loader(jargs, seed=0))
    trainer = Trainer(group="port", device="cpu", **kw)
    losses = trainer.fit((module or CarriedModule)(_jax_weights(jmod)),
                         build_loader(get_args(argv + ["--device", "cpu"]),
                                      seed=0))
    trainer.teardown()
    assert set(losses) == set(NAMES)
    assert set(trainer.final_states) == set(NAMES)
    return (metric_rows("runs/jax/metrics.jsonl"),
            metric_rows("runs/port/metrics.jsonl"))


@pytest.mark.parametrize("strategy,module,rtol", [
    ("dp", OptaxAdamModule, 2e-5), ("dp_model", OptaxAdamModule, 2e-5),
    ("dp", CarriedModule, 3e-5)])
def test_trainer_fp32_equals_jax(tmp_path, no_launch_env, strategy, module,
                                 rtol):
    no_launch_env.chdir(tmp_path)
    want, got = _fit_both(strategy, "fp32", module)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert g["_step"] == w["_step"] and set(g) == set(w)
        for n in NAMES:
            np.testing.assert_allclose(g[f"loss/{n}"], w[f"loss/{n}"],
                                       rtol=rtol)


def test_trainer_bf16_equals_jax(tmp_path, no_launch_env):
    no_launch_env.chdir(tmp_path)
    want, got = _fit_both("dp", "bf16")
    assert len(got) == len(want) == 40
    for i, (g, w) in enumerate(zip(got, want)):
        for n in NAMES:
            np.testing.assert_allclose(g[f"loss/{n}"], w[f"loss/{n}"],
                                       rtol=3e-4 if i == 0 else 1e-2)


def test_bf16_apply_casts_and_reaches_the_masters():
    """The wrapped module computes on bf16 copies, returns f32, and its
    gradients land on the f32 parameters."""
    model = ToyMLP()
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():  # ToyMLP() leaves its kernels unset
        torch.nn.init.normal_(p, generator=gen)
    wrapped = BF16Apply(model)
    x = torch.randn(8, 2)
    out = wrapped(x)
    assert out.dtype == torch.float32
    with torch.no_grad():
        ref = model.to(torch.bfloat16)(x.bfloat16()).float()
    model.float()
    assert torch.equal(out.detach(), ref)
    out.sum().backward()
    assert model.dense_0.kernel.grad.dtype == torch.float32
    assert list(wrapped.parameters()) == list(model.parameters())


@pytest.mark.parametrize("strategy,item", [("fsdp", "A6c"), ("zero1", "A6c"),
                                           ("pp", "A6c"), ("auto", "A8")])
def test_unported_strategies_raise(no_launch_env, tmp_path, strategy, item):
    """``auto`` (A8) raises; ``fsdp``, ``zero1`` and ``pp``, which A6c's
    second and last slices port, train: the demo's LM module (``pp`` the LM
    module only, refusing the toy one as JAX does)."""
    ported = strategy in ("fsdp", "zero1", "pp")
    if strategy == "pp":
        # JAX's refusal: the toy contract has no block stack
        with pytest.raises(ValueError, match="needs an LMTrainerModule"):
            Trainer(strategy=strategy, device="cpu").fit(TrainerModule(),
                                                         None)
    elif ported:
        # the base module has no models: the strategy reaches it
        with pytest.raises(NotImplementedError):
            Trainer(strategy=strategy, device="cpu").fit(TrainerModule(),
                                                         None)
    else:
        with pytest.raises(NotImplementedError, match=item):
            Trainer(strategy=strategy, device="cpu").fit(TrainerModule(),
                                                         None)
    # the LM path (6b) is ported: an LM module reaches configure_lm
    with pytest.raises(NotImplementedError):
        Trainer(device="cpu").fit(LMTrainerModule(), None)
    if not ported:
        with pytest.raises(NotImplementedError, match=item):
            Trainer(strategy=strategy, device="cpu").fit(LMTrainerModule(),
                                                         None)
    with pytest.raises(ValueError, match="unknown strategy"):
        Trainer(strategy="ddp", device="cpu").fit(TrainerModule(), None)
    if ported:
        no_launch_env.chdir(tmp_path)  # the metrics rows land under runs/
        losses = trainer_main(["--device", "cpu", "--strategy", strategy,
                               "--dry_run", "--seed", "0",
                               "--total_iterations", "30", "--batch_size",
                               "8"])
        assert set(losses) == {"lm"} and losses["lm"] < 3.0


def test_trainer_fields_equal_jax():
    """The JAX facade's fields and defaults, plus ``device``."""
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(Trainer)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainer)}
    assert ours.pop("device") == "cuda"
    assert ours["metric_backend"].value == theirs.pop("metric_backend").value
    ours.pop("metric_backend")
    assert ours == theirs


@pytest.mark.parametrize("argv", [
    [],
    ["--precision", "bf16", "--strategy", "dp_model", "--seed", "3"],
    ["--strategy", "pp", "--stages", "4", "--pp_schedule", "interleaved",
     "--seq_len", "16", "--vocab", "8", "--d_model", "32", "--n_layers", "2"],
    ["--batch_size", "64", "--checkpoint_dir", "c", "--checkpoint_every",
     "5", "--resume", "--profile_dir", "p", "--backend", "gloo"],
])
def test_demo_trainer_parser_equals_jax(argv):
    ours = vars(get_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(_jax_demo_trainer().get_args(argv))


def _demo_rows(cwd, *extra):
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        trainer_main(["--device", "cpu", "--dry_run", "--seed", "0",
                      *extra])
    finally:
        os.chdir(here)
    return [{k: v for k, v in r.items() if k.startswith("loss/")}
            for r in metric_rows(cwd / "runs" / "demo_trainer" /
                                 "metrics.jsonl")]


@pytest.mark.parametrize("dataloader", ["distributed", "standard"])
def test_demo_trainer_resume_bit_for_bit(tmp_path, no_launch_env,
                                         dataloader):
    """``demo_trainer`` 20 steps unbroken, against 12 steps saving every 5
    and ``--resume`` to 20: the same 20 rows, bit for bit, on the
    device-cached path (``distributed``) and the per-step path
    (``standard``: every rank the whole dataset)."""
    base = ["--dataloader", dataloader]
    whole = _demo_rows(tmp_path / "whole", *base, "--total_iterations", "20")
    ck = str(tmp_path / "ck")
    flags = [*base, "--checkpoint_dir", ck, "--checkpoint_every", "5"]
    _demo_rows(tmp_path / "broken", *flags, "--total_iterations", "12")
    got = _demo_rows(tmp_path / "broken", *flags, "--total_iterations", "20",
                     "--resume")
    assert len(whole) == 20 and got == whole


# ---------------------------------------------------------------------------
# profiling


def test_trace_writes_under_process_0(tmp_path, no_launch_env):
    with trace(str(tmp_path / "prof")):
        torch.ones(4).add(1)
    out = tmp_path / "prof" / "process_0" / TRACE_FILE
    assert out.is_file() and out.stat().st_size > 0
    with trace(None):
        pass
    assert sorted(os.listdir(tmp_path)) == ["prof"]


def test_demo_trainer_profile_dir(tmp_path, no_launch_env):
    _demo_rows(tmp_path, "--total_iterations", "3", "--profile_dir",
               str(tmp_path / "p"))
    assert (tmp_path / "p" / "process_0" / TRACE_FILE).stat().st_size > 0


def test_stage_timer_emits_the_jax_row(tmp_path):
    rows = []
    for timer_cls, logger_cls, name in ((JaxStageTimer, JaxMetricsLogger,
                                         "jax"),
                                        (StageTimer, MetricsLogger, "port")):
        timer = timer_cls()
        with timer.phase("build"):
            pass
        with timer.phase("load"):
            pass
        with timer.phase("build"):
            pass
        logger = logger_cls(jsonl_path=tmp_path / name / "metrics.jsonl")
        durations = timer.emit(logger)
        logger.finish()
        assert set(durations) == {"build", "load"}
        rows.append(metric_rows(tmp_path / name / "metrics.jsonl"))
    assert [set(r) for r in rows[0]] == [set(r) for r in rows[1]]
    assert set(rows[1][0]) == {"_step", "_time", "stage/build", "stage/load"}
    assert StageTimer().emit(MetricsLogger()) == {}
