"""3-D parallelism in the port (``seq`` beside ``model``: the ring under
the Megatron block, ``tpudist_torch.examples.demo_3d_parallel``) and the
scanned LM step, against the JAX package on the CPU.

- ``make_mesh`` with ``seq`` and ``model`` both above 1: the axes in the
  JAX order ``(data, seq, model)``, the ring, the model devices; with
  ``stage`` beside them, ``(data, stage, seq, model)``.
- ``demo_3d_parallel --seq_shards 2 --model_shards 2`` in one process (a
  LocalRing of 2, the model axis folded onto the CPU) against the JAX demo
  in process on the suite's 8-device mesh (data 2 × seq 2 × model 2),
  from the JAX init's weights: the losses at ``rtol 1e-5`` (the JAX data
  axis splits the same global batch; the mean is the same); each head
  shard's ring attends over its own heads.
- The same entry point over gloo at world 2 (the ring of 2 over the
  ranks, a model axis of 2 folded onto each) against one process: ``rtol
  1e-6``, the same mean gradient summed in another order.
- ``make_scanned_lm_train_step`` (K 4): the losses and weights of 4 plain
  steps bit for bit (the plain step is the one held against JAX's), and
  ``chunk_token_sharding`` against JAX's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_long_context import _load_example, no_launch_env
from torch_cases import settled_torch_cpu
from torch_launch import launch_ranks, metric_rows, torchrun_envs
from tpudist.models.transformer import create_transformer as jax_create
from tpudist.train import chunk_token_sharding as jax_chunk_sharding
from tpudist_torch.examples import demo_3d_parallel as port_3d
from tpudist_torch.models import TransformerLM, params_from_flax
from tpudist_torch.models.transformer import RingCausal
from tpudist_torch.parallel import LocalRing
from tpudist_torch.runtime.mesh import MeshConfig, make_mesh
from tpudist_torch.train import (build_optimizer, chunk_token_sharding,
                                 make_lm_train_step,
                                 make_scanned_lm_train_step)

assert no_launch_env  # a fixture of this module too

ARGV = ["--dry_run", "--seed", "0", "--seq_len", "32", "--d_model", "32",
        "--n_layers", "1", "--vocab", "32", "--lr", "1e-3", "--batch_size",
        "8", "--total_iterations", "4", "--seq_shards", "2",
        "--model_shards", "2"]


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def test_mesh_with_seq_beside_model():
    m = make_mesh(MeshConfig(seq=4, model=2), device="cpu")
    assert m.axis_names == ("data", "seq", "model")
    assert m.shape == {"data": 1, "seq": 4, "model": 2}
    assert m.devices == (torch.device("cpu"),) * 2
    assert isinstance(m.ring, LocalRing) and m.ring.size == 4
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(MeshConfig(data=2, seq=4, model=2), device="cpu")
    # a stage axis beside them (A6c's last slice): the full JAX order
    m = make_mesh(MeshConfig(stage=2, seq=2, model=2), device="cpu")
    assert m.axis_names == ("data", "stage", "seq", "model")
    assert m.shape == {"data": 1, "stage": 2, "seq": 2, "model": 2}
    assert m.stages.size == 2 and m.ring.size == 2


def _carried(jax_params):
    """``create_transformer`` for the port demo: the JAX demo's weights."""
    sd = params_from_flax(jax.device_get(jax_params))

    def create(seed, *, device, trainable, dtype, param_dtype, **cfg):
        model = TransformerLM(dtype=dtype, param_dtype=param_dtype, **cfg)
        model.load_state_dict(sd)
        return model.to(device).requires_grad_(trainable)

    return create


def _port_rows(cwd, argv, monkeypatch, create=None):
    monkeypatch.chdir(cwd)
    if create is not None:
        monkeypatch.setattr(port_3d, "create_transformer", create)
    port_3d.main(argv + ["--device", "cpu"])
    return metric_rows(cwd / "runs" / "demo_3d_parallel" / "metrics.jsonl")


def test_demo_3d_equals_jax_demo(tmp_path, no_launch_env):
    import tpudist.runtime.bootstrap as bs

    heads = []
    real = RingCausal.attend

    def counting(self, layer, q, k, v, rotated=False):
        heads.append(q.shape[1])
        return real(self, layer, q, k, v, rotated)

    mod = _load_example("demo_3d_parallel")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    no_launch_env.chdir(tmp_path / "jax")
    no_launch_env.setattr("sys.argv", ["prog"] + ARGV)
    bs._INITIALIZED_CTX = None
    mod.main()
    want = metric_rows(tmp_path / "jax" / "runs" / "demo_3d_parallel" /
                       "metrics.jsonl")
    _, params = jax_create(jax.random.PRNGKey(0), seq_len=32, vocab=32,
                           d_model=32, n_layers=1, max_len=32)
    no_launch_env.setattr(RingCausal, "attend", counting)
    got = _port_rows(tmp_path / "port", ARGV, no_launch_env,
                     _carried(params))
    assert len(got) == len(want) == 4
    np.testing.assert_allclose([r["loss/lm"] for r in got],
                               [r["loss/lm"] for r in want], rtol=1e-5)
    # 4 heads over a model axis of 2: each shard's ring over its 2 heads,
    # per layer and step
    assert heads == [2] * (2 * 1 * 4)


def test_demo_3d_over_gloo_equals_one_process(tmp_path, no_launch_env):
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()
    want = _port_rows(tmp_path / "one", ARGV, no_launch_env)
    outs = launch_ranks("tpudist_torch.examples.demo_3d_parallel",
                        ARGV + ["--device", "cpu"], tmp_path / "two",
                        torchrun_envs(2))
    assert "mesh={'data': 1, 'seq': 2, 'model': 2}" in outs[0]
    got = metric_rows(tmp_path / "two" / "runs" / "demo_3d_parallel" /
                      "metrics.jsonl")
    np.testing.assert_allclose([r["loss/lm"] for r in got],
                               [r["loss/lm"] for r in want], rtol=1e-6)


def test_scanned_step_equals_plain_steps():
    """K steps a call: the losses and weights of K plain steps bit for
    bit; the window's spec is JAX's ``chunk_token_sharding``."""
    cfg = dict(vocab=32, d_model=32, n_layers=1, n_heads=2, d_ff=64,
               max_len=32)
    K = 4
    toks = np.random.default_rng(0).integers(0, 32, size=(K, 8, 32)).astype(
        np.int32)
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.1 for k, v in
          TransformerLM(**cfg).state_dict().items()}
    runs = []
    for scanned in (True, False):
        model = TransformerLM(param_dtype=torch.float32, **cfg)
        model.load_state_dict(sd)
        model.requires_grad_(True)
        opt, _ = build_optimizer(model.parameters(), 1e-3)
        t = torch.from_numpy(toks)
        if scanned:
            losses = make_scanned_lm_train_step(model, opt)(t)
            assert tuple(losses.shape) == (K,)
        else:
            step = make_lm_train_step(model, opt)
            losses = torch.stack([step(r) for r in t])
        runs.append((losses, model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    m = make_mesh(MeshConfig(seq=2), device="cpu")
    assert chunk_token_sharding(m) == tuple(jax_chunk_sharding(Mesh(
        np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "seq"))).spec)
