"""The port's toy ``demo.py`` path (tpudist_torch: config, runtime, data,
models/toy_mlp, comm, train/step and loop, examples/demo) against the JAX
package.

The host logic copied across (the toy dataset, the sharded loader, the
launch contracts, the CLI) must agree exactly.  The model and the train
step are held against the JAX ones on the same weights (carried across by
``toy_params_from_flax``) and batches; tolerances:

- the forward: ``rtol 1e-6, atol 1e-6`` — f32 products summed in another
  order over at most 10 terms;
- 20 Adam steps against JAX ``make_multi_model_train_step`` on the 8-device
  CPU mesh: losses to ``rtol 2e-5``, parameters to ``atol 2e-6``.  The JAX
  step's gradient is a sum over 8 device shards, the port's over one
  batch; the orders differ, so each gradient differs by f32 rounding
  (~1e-7 relative), and Adam's normalized steps carry that into the
  parameters: 3.6e-7 at worst and the losses 1.7e-6 apart after 20 steps,
  where the parameters themselves travel up to 20·lr = 0.02;
- the scanned step against the per-step path, and the loss rows of the
  port's two metric fabrics: bit for bit and ``rtol 1e-6`` (the host
  fabric averages in float64, the device group in float32);
- 2 ranks over gloo against 1 rank at the same global batch: losses
  ``rtol 1e-6`` — the same samples, summed in another order (DDP averages
  two half-batch gradients where one rank takes one mean); 1.4e-7 at worst
  over 20 iterations.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpudist.config import get_args as jax_get_args
from tpudist.data.loader import ShardedLoader as JaxLoader
from tpudist.data.loader import shard_batch as jax_shard_batch
from tpudist.data.sharding import ShardPlan as JaxPlan
from tpudist.data.toy import make_toy_data as jax_toy_data
from tpudist.models.toy_mlp import create_toy_model as jax_toy_model
from tpudist.runtime.bootstrap import BootstrapError as JaxBootstrapError
from tpudist.runtime.bootstrap import \
    resolve_process_context as jax_resolve
from tpudist.train.loop import TrainLoopConfig as JaxLoopConfig
from tpudist.train.loop import run_training as jax_run_training
from tpudist.train.step import init_model_states as jax_init_states
from tpudist.train.step import make_multi_model_train_step as jax_step
from tpudist.train.step import make_scanned_train_step as jax_scanned
from tpudist.utils.metrics import init_metrics as jax_init_metrics
from torch_cases import settled_torch_cpu
from tpudist_torch.comm import (HostFabricTimeout, MetricBackend,
                                batch_weighted_loss_mean, host_allreduce_sum)
from tpudist_torch.comm.collectives import _with_deadline
from tpudist_torch.config import get_args
from tpudist_torch.data import (ShardedLoader, ShardPlan, make_loader,
                                make_toy_data, shard_batch)
from tpudist_torch.data.sharding import epoch_indices
from tpudist_torch.data.native_loader import PrefetchingLoader
from tpudist_torch.examples.demo import main as demo_main
from tpudist_torch.models import ToyMLP, create_toy_model, \
    toy_params_from_flax
from tpudist_torch.models.toy_mlp import lecun_normal_
from tpudist_torch.runtime import (BootstrapError, fold_in_process,
                                   initialize, per_process_seed,
                                   resolve_process_context,
                                   resolve_shared_seed, shutdown)
from tpudist_torch.train import (TrainLoopConfig, build_optimizer,
                                 build_optimizer_from_args,
                                 init_model_states,
                                 make_multi_model_train_step,
                                 make_scanned_train_step, run_training)
from tpudist_torch.utils import MetricsLogger, init_metrics

REPO = Path(__file__).resolve().parent.parent
NAMES = ("model_X", "model_Y")
LAUNCH_ENV = ("TPUDIST_NUM_PROCESSES", "TPUDIST_PROCESS_ID",
              "TPUDIST_COORDINATOR", "TPUDIST_LOCAL_RANK",
              "TPUDIST_LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "SLURM_PROCID", "SLURM_LOCALID", "SLURM_NTASKS",
              "SLURM_NTASKS_PER_NODE", "TASKS_PER_NODE", "NODE_RANK",
              "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
              "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE")


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


@pytest.fixture()
def no_launch_env(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# host logic copied across: data, loader, launch contracts, CLI


@pytest.mark.parametrize("n,seed", [(512, 0), (100, 7)])
def test_toy_data_equals_jax(n, seed):
    a, b = make_toy_data(n, seed), jax_toy_data(n, seed)
    assert a.x.dtype == b.x.dtype == np.float32
    assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)


@pytest.mark.parametrize("mode", ["distributed", "standard"])
@pytest.mark.parametrize("shards,batch", [(1, 256), (2, 256), (3, 100),
                                          (4, 48)])
def test_loader_batches_equal_jax(mode, shards, batch):
    """Every shard's batches over three epochs, the ragged last batch
    included, and ``iter_from``'s skip."""
    data = make_toy_data()
    for shard in range(shards):
        kw = dict(num_samples=len(data), num_shards=shards, shard_id=shard,
                  seed=3, mode=mode)
        ours = ShardedLoader(data, batch, ShardPlan(**kw))
        theirs = JaxLoader(jax_toy_data(), batch, JaxPlan(**kw))
        assert len(ours) == len(theirs)
        for epoch in range(3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            for skip in (0, 1):
                got = list(ours.iter_from(skip))
                want = list(theirs.iter_from(skip))
                assert len(got) == len(want)
                for (gx, gy), (wx, wy) in zip(got, want):
                    assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_shard_batch_and_loader_factory():
    x, y = make_toy_data(8).x, make_toy_data(8).y
    tx, ty = shard_batch((x, y), "cpu")
    assert torch.equal(tx, torch.from_numpy(x))
    assert torch.equal(ty, torch.from_numpy(y))
    plan = ShardPlan(num_samples=8, num_shards=1, shard_id=0)
    assert isinstance(make_loader(make_toy_data(8), 4, plan), ShardedLoader)
    # num_workers > 0: the native gather pool, the same batches
    pooled = make_loader(make_toy_data(8), 4, plan, num_workers=2)
    assert isinstance(pooled, PrefetchingLoader)
    for (gx, gy), (wx, wy) in zip(pooled, make_loader(make_toy_data(8), 4,
                                                      plan)):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    pooled.close()


CONTRACTS = {
    "single": ({}, {}),
    "explicit": ({"LOCAL_RANK": "1"},
                 dict(process_id=1, num_processes=2,
                      coordinator_address="h:1")),
    "explicit_no_pid": ({}, dict(num_processes=2)),
    "explicit_no_coord": ({}, dict(process_id=0, num_processes=2)),
    "tpudist": ({"TPUDIST_NUM_PROCESSES": "4", "TPUDIST_PROCESS_ID": "2",
                 "TPUDIST_COORDINATOR": "h:1234", "TPUDIST_LOCAL_RANK": "1",
                 "TPUDIST_LOCAL_WORLD_SIZE": "2"}, {}),
    "tpudist_no_pid": ({"TPUDIST_NUM_PROCESSES": "4"}, {}),
    "tpudist_no_coord": ({"TPUDIST_NUM_PROCESSES": "2",
                          "TPUDIST_PROCESS_ID": "0"}, {}),
    "torchrun": ({"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "h",
                  "MASTER_PORT": "29500", "LOCAL_RANK": "1",
                  "LOCAL_WORLD_SIZE": "2"}, {}),
    "torchrun_world1": ({"RANK": "0", "WORLD_SIZE": "1"}, {}),
    "torchrun_default_port": ({"RANK": "0", "WORLD_SIZE": "2",
                               "MASTER_ADDR": "h"}, {}),
    "torchrun_no_master": ({"RANK": "0", "WORLD_SIZE": "2"}, {}),
    "torchrun_bad_int": ({"RANK": "x", "WORLD_SIZE": "2"}, {}),
    "slurm": ({"SLURM_PROCID": "3", "WORLD_SIZE": "4", "SLURM_LOCALID": "1",
               "TASKS_PER_NODE": "2", "MASTER_ADDR": "h",
               "MASTER_PORT": "7"}, {}),
    "slurm_ntasks": ({"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
                      "SLURM_NTASKS_PER_NODE": "2", "MASTER_ADDR": "h"}, {}),
    "slurm_node_rank": ({"WORLD_SIZE": "4", "SLURM_LOCALID": "1",
                         "TASKS_PER_NODE": "2", "NODE_RANK": "1",
                         "SLURM_PROCID": "0", "MASTER_ADDR": "h"},
                        dict(use_node_rank=True)),
    "slurm_node_rank_missing": ({"WORLD_SIZE": "4", "SLURM_LOCALID": "1",
                                 "MASTER_ADDR": "h"},
                                dict(use_node_rank=True)),
    "slurm_no_procid": ({"WORLD_SIZE": "4", "SLURM_LOCALID": "1",
                         "MASTER_ADDR": "h"}, {}),
    "slurm_no_world": ({"SLURM_PROCID": "0"}, {}),
    "mpi": ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2",
             "OMPI_COMM_WORLD_LOCAL_RANK": "1", "MASTER_ADDR": "h",
             "MASTER_PORT": "5"}, {}),
    "mpi_no_master": ({"OMPI_COMM_WORLD_RANK": "1",
                       "OMPI_COMM_WORLD_SIZE": "2"}, {}),
    "mpi_world1": ({"OMPI_COMM_WORLD_RANK": "0",
                    "OMPI_COMM_WORLD_SIZE": "1"}, {}),
}


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_process_context_equals_jax(no_launch_env, name):
    """The same environment gives the same ``ProcessContext``, or both
    raise ``BootstrapError``."""
    env, kwargs = CONTRACTS[name]
    for k, v in env.items():
        no_launch_env.setenv(k, v)
    try:
        want = dataclasses.asdict(jax_resolve(**kwargs))
    except JaxBootstrapError:
        with pytest.raises(BootstrapError):
            resolve_process_context(**kwargs)
        return
    got = resolve_process_context(**kwargs)
    assert dataclasses.asdict(got) == want
    assert got.is_distributed == (want["num_processes"] > 1)


@pytest.mark.parametrize("argv", [
    [],
    ["--backend", "nccl", "--dry_run", "--seed", "3"],
    ["--backend", "gloo", "--dataloader", "standard", "--batch_size", "64"],
    ["--backend", "mpi", "--use_node_rank", "--torchrun"],
    ["--backend", "host", "--lr", "0.01", "--lr_schedule", "warmup_cosine",
     "--warmup_steps", "5", "--optimizer", "adamw", "--weight_decay", "0.1",
     "--grad_clip", "1.0", "--log_every", "10", "--group", "g",
     "--total_iterations", "50", "--num_workers", "0"],
    ["--checkpoint_dir", "c", "--checkpoint_every", "5", "--resume",
     "--profile_dir", "p", "--project", "q"],
])
def test_cli_equals_jax(argv):
    """The same argv parses to the same namespace (aliases normalized), plus
    the port's ``--device``."""
    ours = vars(get_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_get_args(argv))
    assert get_args(argv + ["--device", "cpu"]).device == "cpu"


def test_unported_flags_raise():
    """Nothing of the shared CLI is refused any more: adafactor and lion
    (6e) build their optimizers, ``--num_workers`` (6d) the native pool's
    loader, as checkpoints (A9) and ``--profile_dir`` (A7b) before them."""
    from tpudist_torch.train.optim import Adafactor, Lion

    for opt, cls in (("adafactor", Adafactor), ("lion", Lion)):
        built, _ = build_optimizer_from_args(
            get_args(["--optimizer", opt]),
            [torch.zeros(2, requires_grad=True)])
        assert isinstance(built, cls)
    args = get_args(["--num_workers", "2", "--batch_size", "4"])
    plan = ShardPlan(num_samples=8, num_shards=1, shard_id=0)
    loader = make_loader(make_toy_data(8), args.batch_size, plan,
                         num_workers=args.num_workers)
    assert isinstance(loader, PrefetchingLoader)
    loader.close()


def test_seeding(no_launch_env):
    """Without a process group: the given seed stands, ``base + rank``, and
    per-process generators distinct across processes and repeatable."""
    assert resolve_shared_seed(5) == 5
    assert 0 <= resolve_shared_seed(None) < 2 ** 32
    assert per_process_seed(10) == 10 and per_process_seed(10, 3) == 13
    a = torch.rand(4, generator=fold_in_process(7, 0))
    assert torch.equal(a, torch.rand(4, generator=fold_in_process(7, 0)))
    assert not torch.equal(a, torch.rand(4, generator=fold_in_process(7, 1)))
    assert initialize(device="cpu").launch_source == "single"
    shutdown()


# ---------------------------------------------------------------------------
# the model and the train step against JAX


def _flax_pair(seed=0):
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    return jax_toy_model(kx), jax_toy_model(ky)


def _port_model(params):
    model = ToyMLP()
    model.load_state_dict(toy_params_from_flax(jax.device_get(params)))
    return model


def test_toy_mlp_equals_flax_apply():
    (module, params), _ = _flax_pair(1)
    x = np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32)
    want = np.asarray(module.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_init_statistics_match_flax():
    """``lecun_normal_`` against flax's ``lecun_normal()`` on a [256, 4096]
    kernel: std 1/16 within 1%, mean within 4 standard errors, the
    truncation at 2 pre-scaling standard deviations, and the deciles within
    2% of the std; ToyMLP's shapes and zero biases are flax's."""
    fan_in = 256
    ours = lecun_normal_(torch.empty(fan_in, 4096),
                         torch.Generator().manual_seed(0)).numpy()
    theirs = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, 4096), jnp.float32))
    std = fan_in ** -0.5
    for a in (ours, theirs):
        assert abs(a.std() - std) < 0.01 * std
        assert abs(a.mean()) < 4 * std / np.sqrt(a.size)
        assert np.abs(a).max() <= 2 * std / 0.87962566103423978 + 1e-7
    q = np.linspace(0.1, 0.9, 9)
    np.testing.assert_allclose(np.quantile(ours, q), np.quantile(theirs, q),
                               atol=0.02 * std)
    (_, params), _ = _flax_pair()
    model = create_toy_model(0, device="cpu")
    flat = toy_params_from_flax(jax.device_get(params))
    for k, v in model.state_dict().items():
        assert v.shape == flat[k].shape
        if k.endswith("bias"):
            assert not v.any()


def _port_states(pairs):
    models = {n: _port_model(p) for n, (_, p) in zip(NAMES, pairs)}
    return init_model_states(models, lambda p: build_optimizer(p, 1e-3))


def _batches(n, batch=256, seed=0):
    data = make_toy_data(seed=seed)
    loader = ShardedLoader(data, batch, ShardPlan(len(data), 1, 0,
                                                  seed=seed))
    out, epoch = [], 0
    while len(out) < n:
        loader.set_epoch(epoch)
        out += list(loader)
        epoch += 1
    return out[:n]


def test_train_step_equals_jax(dp_mesh):
    """20 Adam steps of both models on the same weights and batches."""
    pairs = _flax_pair()
    tx = optax.adam(1e-3)
    jstates = jax_init_states(
        {n: (m.apply, p) for n, (m, p) in zip(NAMES, pairs)}, tx)
    jstep = jax_step({n: m.apply for n, (m, _) in zip(NAMES, pairs)}, tx,
                     dp_mesh, donate_state=False)
    states = _port_states(pairs)
    step = make_multi_model_train_step()
    sharding = NamedSharding(dp_mesh, P("data"))
    for x, y in _batches(20):
        jstates, jl = jstep(jstates, *jax_shard_batch((x, y), sharding))
        states, tl = step(states, *shard_batch((x, y), "cpu"))
        for n in NAMES:
            np.testing.assert_allclose(float(tl[n]), float(jl[n]), rtol=2e-5)
    for n in NAMES:
        want = toy_params_from_flax(jax.device_get(jstates[n].params))
        for k, v in states[n].model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=2e-6,
                                       rtol=0)


def test_scanned_step_equals_per_step_bit_for_bit():
    """Two windows (8 and 12 iterations) of the scanned step against 20
    per-step iterations on the same batches: losses and parameters equal
    bit for bit."""
    pairs = _flax_pair()
    data = make_toy_data()
    plan = ShardPlan(len(data), 1, 0, seed=0)
    rows = []
    for epoch in range(10):
        idx = epoch_indices(plan, epoch)
        rows += [idx[t * 256:(t + 1) * 256] for t in range(2)]
    rows = np.stack(rows[:20]).astype(np.int64)
    a, b = _port_states(pairs), _port_states(pairs)
    step, chunk = make_multi_model_train_step(), make_scanned_train_step()
    per_step = {n: [] for n in NAMES}
    for r in rows:
        a, losses = step(a, *shard_batch((data.x[r], data.y[r]), "cpu"))
        for n in NAMES:
            per_step[n].append(losses[n])
    x_all, y_all = torch.from_numpy(data.x), torch.from_numpy(data.y)
    scanned = {n: [] for n in NAMES}
    for lo, hi in ((0, 8), (8, 20)):
        b, losses = chunk(b, x_all, y_all, torch.from_numpy(rows[lo:hi]))
        for n in NAMES:
            assert losses[n].shape == (hi - lo,)
            scanned[n].append(losses[n])
    for n in NAMES:
        assert torch.equal(torch.stack(per_step[n]), torch.cat(scanned[n]))
        for (ka, va), (kb, vb) in zip(a[n].model.state_dict().items(),
                                      b[n].model.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)


def _rows(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


@pytest.mark.parametrize("log_every", [1, 3])
def test_run_training_dry_run_equals_jax(dp_mesh, tmp_path, monkeypatch,
                                         log_every):
    """Both loops on the device-cached path, 40 iterations in windows of
    16, ``--dry_run`` metrics: the same rows for the same iterations, the
    losses within the step test's tolerance."""
    monkeypatch.setenv("TPUDIST_TELEMETRY", "0")
    monkeypatch.setenv("WANDB_MODE", "dryrun")
    monkeypatch.chdir(tmp_path)
    pairs = _flax_pair()
    tx = optax.adam(1e-3)
    apply_fns = {n: m.apply for n, (m, _) in zip(NAMES, pairs)}
    data = jax_toy_data(seed=0)
    plan = dict(num_samples=len(data), num_shards=1, shard_id=0, seed=0)
    kw = dict(total_iterations=40, log_every=log_every, sync_every=16,
              progress_bar=False)
    jlogger = jax_init_metrics(group="jax", dry_run=True, log_dir="runs")
    jstates = jax_init_states(
        {n: (m.apply, p) for n, (m, p) in zip(NAMES, pairs)}, tx)
    _, jfinal = jax_run_training(
        jstates, jax_step(apply_fns, tx, dp_mesh, donate_state=False),
        JaxLoader(data, 256, JaxPlan(**plan)), dp_mesh, jlogger,
        JaxLoopConfig(**kw), chunk_step_fn=jax_scanned(
            apply_fns, tx, dp_mesh, donate_state=False))
    logger = init_metrics(group="port", dry_run=True, log_dir="runs")
    _, final = run_training(
        _port_states(pairs), make_multi_model_train_step(),
        ShardedLoader(make_toy_data(seed=0), 256, ShardPlan(**plan)), "cpu",
        logger, TrainLoopConfig(**kw),
        chunk_step_fn=make_scanned_train_step())
    want, got = _rows("runs/jax/metrics.jsonl"), _rows(
        "runs/port/metrics.jsonl")
    assert len(got) == len(want) == len(range(0, 40, log_every))
    for g, w in zip(got, want):
        assert g["_step"] == w["_step"]
        assert set(g) == set(w)
        for n in NAMES:
            np.testing.assert_allclose(g[f"loss/{n}"], w[f"loss/{n}"],
                                       rtol=2e-5)
    for n in NAMES:
        np.testing.assert_allclose(final[n], jfinal[n], rtol=2e-5)


def test_per_step_loop_equals_scanned_loop(tmp_path):
    """The loop's two paths log the same rows, bit for bit: the per-step
    path (no scanned step given) and the device-cached path."""
    pairs = _flax_pair()
    rows = {}
    for label, chunk in (("per_step", None),
                         ("scanned", make_scanned_train_step())):
        path = tmp_path / label / "metrics.jsonl"
        logger = MetricsLogger(jsonl_path=path)
        data = make_toy_data(seed=0)
        run_training(_port_states(pairs), make_multi_model_train_step(),
                     ShardedLoader(data, 256, ShardPlan(512, 1, 0, seed=0)),
                     "cpu", logger, TrainLoopConfig(
                         total_iterations=21, sync_every=8,
                         progress_bar=False), chunk_step_fn=chunk)
        rows[label] = [{k: v for k, v in r.items() if k != "_time"}
                       for r in _rows(path)]
    assert len(rows["per_step"]) == 21
    assert rows["per_step"] == rows["scanned"]


def test_metric_helpers_single_process(no_launch_env):
    assert batch_weighted_loss_mean({"a": torch.tensor(0.5)}, 8,
                                    MetricBackend.HOST) == {"a": 0.5}
    assert batch_weighted_loss_mean({"a": torch.tensor(0.25)}, 8,
                                    MetricBackend.ICI) == {"a": 0.25}
    out = host_allreduce_sum({"n": np.ones(3), "d": (2.0, [3])})
    assert np.array_equal(out["n"], np.ones(3))
    assert out["d"][0] == 2.0 and out["d"][1][0] == 3.0


def test_host_fabric_deadline():
    """A host-fabric op past its deadline raises ``HostFabricTimeout``; the
    next op runs on a fresh worker."""
    wedged = threading.Event()
    with pytest.raises(HostFabricTimeout, match="wedged"):
        _with_deadline(lambda: wedged.wait(30), 0.05, "wedged")
    wedged.set()
    assert _with_deadline(lambda: 3, 5.0, "ok") == 3


# ---------------------------------------------------------------------------
# the demo: one process in this one, two ranks over gloo as subprocesses


def _demo_rows(cwd):
    return _rows(Path(cwd) / "runs" / "demo_dp" / "metrics.jsonl")


def _demo_args(iterations, batch, backend):
    return ["--device", "cpu", "--dry_run", "--seed", "0",
            "--total_iterations", str(iterations), "--batch_size",
            str(batch), "--backend", backend]


def _free_port():
    from tpudist_torch.runtime.bootstrap import find_free_port

    return find_free_port()


def _two_ranks(cwd, args):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(PYTHONPATH=str(REPO), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpudist_torch.examples.demo", *args],
        cwd=cwd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_two_ranks_over_gloo_equal_one_rank(tmp_path, no_launch_env):
    """20 iterations: 2 ranks × 256 over gloo (DDP, the device-group loss
    all-reduce; then ``--backend host``, the second gloo group) log the
    losses of 1 rank × 512."""
    iters = 20
    no_launch_env.chdir(tmp_path)
    one = demo_main(_demo_args(iters, 512, "ici"))
    want = _demo_rows(tmp_path)
    assert len(want) == iters
    rows = {}
    for backend in ("ici", "host"):
        cwd = tmp_path / backend
        cwd.mkdir()
        outs = _two_ranks(cwd, _demo_args(iters, 256, backend))
        assert "launch=torchrun" in outs[0] and "world=2" in outs[0]
        assert "backend=gloo" in outs[0]
        rows[backend] = _demo_rows(cwd)
    for backend in ("ici", "host"):
        assert len(rows[backend]) == iters
        for g, w in zip(rows[backend], want):
            for n in NAMES:
                np.testing.assert_allclose(g[f"loss/{n}"], w[f"loss/{n}"],
                                           rtol=1e-6)
    for g, w in zip(rows["host"], rows["ici"]):
        for n in NAMES:
            np.testing.assert_allclose(g[f"loss/{n}"], w[f"loss/{n}"],
                                       rtol=1e-6)
    assert set(one) == set(NAMES)
