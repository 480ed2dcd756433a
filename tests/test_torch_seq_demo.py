"""The port's LM entry point at ``--seq_shards > 1`` (ring attention over
the ``seq`` axis) against the JAX package's, on the CPU at a small size (2
layers, d 64, seq 64, batch 8).

- ``tpudist_torch.examples.demo_long_context --seq_shards 4`` (one process:
  a LocalRing of 4 on the CPU, the plain carry body) against the JAX
  ``examples/demo_long_context.py --seq_shards 4`` in process on the
  suite's 8-device virtual mesh (data 2 × seq 4), from the JAX init's
  weights carried across: synthetic batches, ``--zigzag``,
  ``--sliding_window`` (the port also with ``--inner_block``, which the
  JAX demo cannot run beside a data axis), ``--rope`` with
  ``--n_kv_heads``, and a corpus with ``--eval_fraction``.  Bound: the
  losses at ``rtol 1e-5``, as ``tests/test_torch_long_context.py`` holds
  the unsharded entry point.
- The same entry point over gloo — world 2 (one ring of two ranks), world
  4 (one ring of four; data 2 × seq 2) — against world 1 (a LocalRing):
  every rank of a ring reads its data row's rows and holds its shard of
  each sequence.  Bound ``rtol 1e-6``: the same mean gradient summed in
  another order.
"""

import importlib

import jax
import pytest
import torch

from test_torch_long_context import (BASE, _corpus, _hold_rows,
                                     _jax_demo_rows, no_launch_env)
from tpudist.models.transformer import create_transformer as jax_create
from torch_cases import settled_torch_cpu
from torch_launch import launch_ranks, metric_rows, torchrun_envs
from tpudist_torch.examples import demo_long_context as port_demo
from tpudist_torch.models import TransformerLM, params_from_flax

assert no_launch_env  # a fixture of this module too


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def _carried_model(args, device):
    """The port's model of ``args`` (the demo's ``build_model``: no model
    window on the ring) holding the JAX demo's init weights."""
    _, params = jax_create(
        jax.random.PRNGKey(args.seed), seq_len=args.seq_len,
        vocab=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        max_len=args.seq_len, rope=args.rope, n_kv_heads=args.n_kv_heads)
    model = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, d_ff=args.d_ff, max_len=args.seq_len,
        rope=args.rope, n_kv_heads=args.n_kv_heads,
        sliding_window=(None if args.seq_shards > 1
                        else args.sliding_window),
        param_dtype=torch.float32)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model.to(device).requires_grad_(True)


def _port_rows(cwd, argv, monkeypatch, carried=False):
    monkeypatch.chdir(cwd)
    if carried:
        monkeypatch.setattr(port_demo, "build_model", _carried_model)
    port_demo.main(argv + ["--device", "cpu"])
    return metric_rows(cwd / "runs" / "demo_long_context" / "metrics.jsonl")


VARIANTS = {
    "synthetic": [],
    "zigzag": ["--zigzag"],
    "window, inner_block": ["--sliding_window", "12"],
    "rope, gqa": ["--rope", "--n_kv_heads", "2"],
    "corpus": None,  # --data_path with --eval_fraction
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_seq_shards_equal_jax_demo(tmp_path, no_launch_env, variant):
    extra = VARIANTS[variant]
    if extra is None:
        extra = _corpus(tmp_path / "c.npy")
    argv = BASE + ["--batch_size", "8", "--seq_shards", "4"] + extra
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _jax_demo_rows(tmp_path / "jax", argv, no_launch_env)
    if variant == "window, inner_block":
        # the JAX demo's own --inner_block fails its shard_map type check
        # under a data axis (the sub-block scan's carry varies over seq
        # only): its run without sub-blocks is the yardstick, the same sums
        # in another order
        argv = argv + ["--inner_block", "4"]
    got = _port_rows(tmp_path / "port", argv, no_launch_env, carried=True)
    _hold_rows(got, want, 1e-5)
    if variant == "corpus":
        assert sum("loss/eval" in r for r in got) == 3  # iterations 0, 3, 6


# (world, seq shards, flags): one ring of 2 or 4 ranks, or data 2 x seq 2
GLOO_CASES = {
    "world 2, zigzag": (2, 2, ["--zigzag"]),
    "world 2, corpus": (2, 2, None),
    "world 4, seq 4": (4, 4, ["--rope", "--n_kv_heads", "2"]),
    "world 4, data 2 x seq 2": (4, 2, ["--sliding_window", "12"]),
}


@pytest.mark.parametrize("case", list(GLOO_CASES))
def test_ring_over_gloo_equals_one_process(tmp_path, no_launch_env, case):
    """The ranks of a ring over gloo (ProcessGroupRings, DDP over every
    rank) against one process holding every shard (a LocalRing) on the
    same global batches: the synthetic batch split over the data rows, or
    the corpus read whole by every rank of the one ring."""
    world, seq, extra = GLOO_CASES[case]
    if extra is None:
        extra = _corpus(tmp_path / "c.npy")
    argv = BASE + ["--batch_size", "8", "--seq_shards", str(seq)] + extra
    (tmp_path / "one").mkdir()
    (tmp_path / "many").mkdir()
    want = _port_rows(tmp_path / "one", argv, no_launch_env)
    outs = launch_ranks("tpudist_torch.examples.demo_long_context",
                        argv + ["--device", "cpu"], tmp_path / "many",
                        torchrun_envs(world))
    assert f"mesh={{'data': {world // seq}, 'seq': {seq}}}" in outs[0]
    got = metric_rows(tmp_path / "many" / "runs" / "demo_long_context" /
                      "metrics.jsonl")
    _hold_rows(got, want, 1e-6)


def test_ring_trained_window_decodes_with_it(tmp_path, no_launch_env,
                                             capsys):
    """``--generate`` after a windowed ring run decodes through the model's
    own cache with the window the ring held (the JAX demo's clone)."""
    # the module (the package re-exports its function under the same name)
    gen_mod = importlib.import_module("tpudist_torch.models.generate")
    windows = []
    real = gen_mod.generate

    def generate(model, *args, **kwargs):
        windows.append(model.sliding_window)
        return real(model, *args, **kwargs)

    no_launch_env.chdir(tmp_path)
    no_launch_env.setattr(gen_mod, "generate", generate)
    port_demo.main(BASE + ["--batch_size", "8", "--seq_shards", "4",
                           "--sliding_window", "5", "--generate", "6",
                           "--total_iterations", "2", "--device", "cpu"])
    assert windows == [5]
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'seq': 4}" in out and "(block 16/chip)" in out
    tokens = out.split(" -> ")[-1].split("]")[0]
    assert len(tokens.strip("[").split(",")) == 6
