"""The port's LM entry point whole against the JAX package, on the CPU, at
a small size (2 layers, d 64, seq 64, batch 8).

- ``tpudist_torch.examples.demo_long_context`` against the JAX
  ``examples/demo_long_context.py`` (in process, on the suite's 8-device
  virtual mesh, ``--seq_shards 1``), from the JAX init's weights carried
  across (``params_from_flax``): synthetic batches under ``--remat
  --remat_policy dots``, and a corpus with ``--eval_fraction``, the
  ``loss/eval`` rows included.  Bound: the losses at ``rtol 1e-5``, the one
  ``tests/test_torch_train.py`` holds the single-device f32 step to.
- The same entry point at world 2 over gloo (two processes, DDP) against
  world 1: the synthetic global batch split over the ranks, and the corpus
  at a per-rank batch of 4 against world 1's 8 (the strided shards' union
  is world 1's batch; the 16 held-out windows are 2 eval batches of 8 or 4
  of 4).  Bound ``rtol 1e-6``: the same mean gradient summed in another
  order.
- Remat: the port's gradients under each policy equal its gradients without
  remat bit for bit (f32), and the JAX ``remat=True`` gradients by relative
  norm (bound 1e-5; the two frameworks' f32 sums differ in order).
- ``--generate``: greedy tokens equal the JAX ``generate``'s; sampled runs
  are held on the filtered logits the draw is taken from
  (:func:`filter_logits` against those the JAX ``sample_logits`` hands
  ``jax.random.categorical``), since the two generators differ.
- The Trainer's LM path against the JAX Trainer's, and its resume from a
  mid-epoch checkpoint against the unbroken run, bit for bit.
"""

import importlib
import importlib.util
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models.transformer import create_transformer as jax_create
from tpudist.models.transformer import lm_loss as jax_lm_loss
from tpudist.trainer import Trainer as JaxTrainer
from torch_cases import settled_torch_cpu
from torch_launch import (LAUNCH_ENV, REPO, launch_ranks, metric_rows,
                          torchrun_envs)
from tpudist_torch.examples import demo_long_context as port_demo
from tpudist_torch.examples.demo_trainer import ChainLMModule, ChainLoader
from tpudist_torch.examples.demo_trainer import get_args as trainer_args
from tpudist_torch.models import (CacheFullError, TransformerLM,
                                  filter_logits, generate, lm_loss,
                                  params_from_flax)
from tpudist_torch.models.transformer import DenseDecode
from tpudist_torch.trainer import Trainer

# the module (the package re-exports its function under the same name)
jax_generate_mod = importlib.import_module("tpudist.models.generate")

GEOM = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_len=64)
SEQ = 64
BASE = ["--dry_run", "--seed", "0", "--seq_len", str(SEQ), "--d_model",
        "64", "--n_layers", "2", "--vocab", "64", "--lr", "1e-3",
        "--total_iterations", "8"]
CORPUS_WINDOWS = 160  # eval_fraction 0.1: 144 training windows, 16 held out


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


def _load_example(name):
    path = REPO / "examples" / f"{name}.py"
    sys.path.insert(0, str(path.parent))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(path.parent))
    return mod


def _jax_demo_rows(cwd, argv, monkeypatch):
    """The JAX demo's metric rows, run in process (the
    ``tests/test_transformer.py`` pattern)."""
    import tpudist.runtime.bootstrap as bs

    mod = _load_example("demo_long_context")
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    bs._INITIALIZED_CTX = None
    mod.main()
    return metric_rows(cwd / "runs" / "demo_long_context" / "metrics.jsonl")


def _carried_model(args, device):
    """The port's model of ``args`` holding the JAX demo's init weights."""
    _, params = jax_create(
        jax.random.PRNGKey(args.seed), seq_len=args.seq_len,
        vocab=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        max_len=args.seq_len, rope=args.rope, n_kv_heads=args.n_kv_heads)
    model = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, d_ff=args.d_ff, max_len=args.seq_len,
        rope=args.rope, n_kv_heads=args.n_kv_heads, remat=args.remat,
        remat_policy=args.remat_policy, param_dtype=torch.float32)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model.to(device).requires_grad_(True)


def _port_rows(cwd, argv, monkeypatch, carried=False):
    monkeypatch.chdir(cwd)
    if carried:
        monkeypatch.setattr(port_demo, "build_model", _carried_model)
    port_demo.main(argv + ["--device", "cpu"])
    return metric_rows(cwd / "runs" / "demo_long_context" / "metrics.jsonl")


def _corpus(path):
    tokens = np.random.default_rng(3).integers(
        0, 64, size=CORPUS_WINDOWS * SEQ).astype(np.int32)
    np.save(path, tokens)
    return ["--data_path", str(path), "--eval_fraction", "0.1",
            "--eval_every", "3"]


def _hold_rows(got, want, rtol, keys=("loss/lm", "loss/eval")):
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["iteration"] == w["iteration"] and set(g) - {"_time"} == \
            set(w) - {"_time"}
        for k in keys:
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("mode", ["synthetic", "corpus"])
def test_demo_equals_jax_demo(tmp_path, no_launch_env, mode):
    extra = (["--remat", "--remat_policy", "dots"] if mode == "synthetic"
             else _corpus(tmp_path / "c.npy"))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _jax_demo_rows(tmp_path / "jax", BASE + ["--batch_size", "8"]
                          + extra, no_launch_env)
    got = _port_rows(tmp_path / "port", BASE + ["--batch_size", "8"]
                     + extra, no_launch_env, carried=True)
    _hold_rows(got, want, 1e-5)
    if mode == "corpus":
        assert sum("loss/eval" in r for r in got) == 3  # iterations 0, 3, 6


@pytest.mark.parametrize("mode", ["synthetic", "corpus"])
def test_two_ranks_over_gloo_equal_one_rank(tmp_path, no_launch_env, mode):
    extra = [] if mode == "synthetic" else _corpus(tmp_path / "c.npy")
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()
    want = _port_rows(tmp_path / "one", BASE + ["--batch_size", "8"] + extra,
                      no_launch_env)
    # synthetic: the global batch of 8 split 4 + 4; corpus: 4 a rank
    per_rank = "8" if mode == "synthetic" else "4"
    outs = launch_ranks("tpudist_torch.examples.demo_long_context",
                        BASE + ["--batch_size", per_rank, "--device", "cpu"]
                        + extra, tmp_path / "two", torchrun_envs(2))
    assert "[rank 0/2]" in outs[0] and "final lm loss" in outs[1]
    got = metric_rows(tmp_path / "two" / "runs" / "demo_long_context" /
                      "metrics.jsonl")
    _hold_rows(got, want, 1e-6)


def _grads(model, tokens):
    lm_loss(model(tokens), tokens).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_gradients_equal_plain_and_jax(policy):
    tokens = np.random.default_rng(1).integers(0, 64, (8, SEQ)).astype(
        np.int32)
    jmod, params = jax_create(jax.random.PRNGKey(2), seq_len=SEQ, remat=True,
                              remat_policy=policy, **GEOM)
    jgrads = jax.grad(lambda p: jax_lm_loss(jmod.apply(p, tokens),
                                            tokens))(params)
    want = params_from_flax(jax.device_get(jgrads))
    sd = params_from_flax(jax.device_get(params))
    t = torch.from_numpy(tokens)
    plain, remat = (TransformerLM(remat=r, remat_policy=policy, **GEOM)
                    for r in (False, True))
    for m in (plain, remat):
        m.load_state_dict(sd)
    g0, g1 = _grads(plain, t), _grads(remat, t)
    assert set(g0) == set(want)
    for name, g in want.items():
        assert torch.equal(g1[name], g0[name]), name
        rel = float((g1[name] - g).norm() / g.norm())
        assert rel <= 1e-5, (name, rel)


GEN_CASES = {"learned": {}, "rope_gqa": dict(rope=True, n_kv_heads=2),
             "window": dict(sliding_window=5)}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_greedy_equals_jax(case):
    cfg = dict(GEOM, **GEN_CASES[case])
    jmod, params = jax_create(jax.random.PRNGKey(4), seq_len=SEQ, **cfg)
    prompt = np.random.default_rng(5).integers(0, 64, (2, 8)).astype(
        np.int32)
    want = np.asarray(jax_generate_mod.generate(jmod, params,
                                                jnp.asarray(prompt), 12))
    model = TransformerLM(**cfg)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    got = generate(model, torch.from_numpy(prompt), 12)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="max_len"):
        generate(model, torch.from_numpy(prompt), SEQ)
    ctx = DenseDecode(model, 1, "cpu")
    ctx.pos = SEQ - 1
    with torch.no_grad():
        model(torch.zeros(1, 1, dtype=torch.int32), ctx)
        ctx.pos += 1
        with pytest.raises(CacheFullError):
            model(torch.zeros(1, 1, dtype=torch.int32), ctx)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 5, None), (1.0, None, 0.9), (0.8, 10, 0.5), (1.3, None, 0.0),
    (1.0, 200, 1.0)])
def test_filtered_logits_equal_jax(monkeypatch, temperature, top_k, top_p):
    logits = np.random.default_rng(6).normal(size=(3, 100)).astype(
        np.float32) * 3
    logits[1, 10:13] = logits[1].max()  # ties at the top
    seen = []

    def categorical(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jax_generate_mod.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p)
    got = filter_logits(torch.from_numpy(logits), temperature=temperature,
                        top_k=top_k, top_p=top_p)
    np.testing.assert_allclose(got.numpy(), seen[0], rtol=1e-6)


class CarriedChainLM(ChainLMModule):
    """The JAX demo's ChainLMModule weights in the port's model, Adam as
    optax computes it."""

    def __init__(self, args, flat):
        super().__init__(args)
        self.flat = flat

    def configure_lm(self, generator):
        model = super().configure_lm(generator)
        model.load_state_dict(self.flat)
        return model

    def configure_optimizers(self):
        from test_torch_trainer import OptaxAdam

        return lambda p: (OptaxAdam(p, lr=self.args.lr), None)


def test_trainer_lm_equals_jax_and_resumes(tmp_path, no_launch_env):
    """16 steps of the chain task (one epoch, batch 8) on both facades from
    the same weights (fp32, Adam as optax computes it: ``rtol 2e-5``, the
    toy Trainer's bound); then 10 steps saving every 5 and a resume to 16
    equal the unbroken port run bit for bit."""
    no_launch_env.chdir(tmp_path)
    jdemo = _load_example("demo_trainer")
    argv = ["--seed", "0", "--dry_run", "--batch_size", "8", "--seq_len",
            "32", "--vocab", "32", "--d_model", "32", "--n_layers", "2",
            "--total_iterations", "16"]
    jargs = jdemo.get_args(argv)
    jmodule = jdemo.ChainLMModule(jargs)
    _, params = jmodule.configure_lm(jax.random.PRNGKey(0))
    kw = dict(max_steps=16, dry_run=True, seed=0, progress_bar=False)
    JaxTrainer(group="jax", **kw).fit(jmodule, jdemo.ChainLoader(
        batch=8, seq=32, vocab=32, seed=0))
    args = trainer_args(argv + ["--device", "cpu"])
    module = CarriedChainLM(args, params_from_flax(jax.device_get(params)))

    def fit(group, steps, **extra):
        t = Trainer(group=group, device="cpu", **dict(kw, max_steps=steps),
                    **extra)
        losses = t.fit(module, ChainLoader(batch=8, seq=32, vocab=32,
                                           seed=0))
        t.teardown()
        return losses

    assert set(fit("port", 16)) == {"lm"}
    want = metric_rows("runs/jax/metrics.jsonl")
    got = metric_rows("runs/port/metrics.jsonl")
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss/lm"], w["loss/lm"], rtol=2e-5)
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=5)
    fit("resumed", 10, **ck)
    fit("resumed", 16, resume=True, **ck)
    resumed = metric_rows("runs/resumed/metrics.jsonl")
    assert [r["loss/lm"] for r in resumed] == [r["loss/lm"] for r in got]
    with pytest.raises(ValueError, match="one optimizer"):
        class Dict(ChainLMModule):
            def configure_optimizers(self):
                return {"lm": super().configure_optimizers()}

        Trainer(device="cpu", **kw).fit(Dict(args), ChainLoader(
            batch=8, seq=32, vocab=32))
