"""The port's data path behind ``--num_workers`` and the device prefetch
against the JAX package's, on the CPU.

- The native gather pool (``tpudist_torch/data/native/gather.cpp``, built
  with ``g++`` into ``build/tpudist_torch/``): :class:`PrefetchingTokenBatches`
  and :class:`PrefetchingLoader` batch for batch equal to the JAX classes
  across epochs, shards, start epochs and resume skips (exact).
- :func:`prefetch_to_device` on CPU tensors: order kept, the source drained
  once, a source's exception re-raised at its position after the batches
  before it, ``close()`` joining the drain thread, as the JAX
  ``prefetch_to_device`` behaves on the same sources.
"""

import threading

import numpy as np
import pytest
import torch

from tpudist.data.lm import PrefetchingTokenBatches as JaxTokenBatches
from tpudist.data.lm import TokenWindows as JaxWindows
from tpudist.data.native_loader import PrefetchingLoader as JaxLoader
from tpudist.data.prefetch import prefetch_to_device as jax_prefetch
from tpudist.data.sharding import ShardPlan as JaxPlan
from tpudist.data.toy import make_toy_data as jax_toy_data
from torch_cases import settled_torch_cpu
from tpudist_torch.data import (PrefetchingTokenBatches, PrefetchStats,
                                ShardedLoader, ShardPlan, TokenWindows,
                                make_loader, make_toy_data,
                                prefetch_to_device)
from tpudist_torch.data import native_loader
from tpudist_torch.ops._build import BUILD_DIR


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def test_library_builds_hash_named_under_build():
    assert native_loader.native_available()
    path = native_loader.library_path()
    assert path.parent == BUILD_DIR and path.is_file()
    assert path.name.startswith("libtpugather-") and path.suffix == ".so"
    pool = native_loader.GatherPool(2)
    src = np.arange(12, dtype=np.int32).reshape(6, 2)
    dst = np.empty((3, 2), np.int32)
    pool.wait(pool.submit(src, np.array([5, 0, 3], np.int64), dst))
    np.testing.assert_array_equal(dst, src[[5, 0, 3]])
    with pytest.raises(ValueError, match="int64"):
        pool.submit(src, np.array([1], np.int32), dst)
    pool.close()
    pool.wait(1)  # a no-op once closed
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(src, np.array([1], np.int64), dst)


@pytest.mark.parametrize("shards,shard,seed,start", [
    (1, 0, 0, 0), (2, 1, 7, 0), (3, 2, 3, 2)])
def test_token_batches_equal_jax(tmp_path, shards, shard, seed, start):
    tokens = np.random.default_rng(2).integers(0, 500, size=5000).astype(
        np.uint16)
    plan = dict(num_samples=150, num_shards=shards, shard_id=shard,
                seed=seed)
    ours = PrefetchingTokenBatches(
        TokenWindows(tokens, 32), ShardPlan(**plan), 4, num_workers=2,
        prefetch_depth=3, start_epoch=start)
    ref = JaxTokenBatches(JaxWindows(tokens, 32), JaxPlan(**plan), 4,
                          num_workers=2, prefetch_depth=3, start_epoch=start)
    for _ in range(90):  # several epochs of the shard
        got, want = next(ours), next(ref)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    ours.close()
    ref.close()
    with pytest.raises(ValueError, match="fewer than one batch"):
        PrefetchingTokenBatches(TokenWindows(tokens, 32),
                                ShardPlan(num_samples=3, num_shards=1,
                                          shard_id=0), 4)


@pytest.mark.parametrize("mode,drop_last", [("distributed", False),
                                            ("distributed", True),
                                            ("standard", False)])
def test_native_loader_equals_jax(mode, drop_last):
    plan = dict(num_samples=1000, num_shards=3, shard_id=1, seed=5,
                mode=mode, drop_last=drop_last)
    ours = make_loader(make_toy_data(1000), 96, ShardPlan(**plan),
                       num_workers=3, prefetch_depth=2)
    assert isinstance(ours, native_loader.PrefetchingLoader)
    ref = JaxLoader(jax_toy_data(1000), 96, JaxPlan(**plan), num_workers=3,
                    prefetch_depth=2)
    assert len(ours) == len(ref)
    for epoch in range(3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for skip in (0, 2):
            got, want = list(ours.iter_from(skip)), list(ref.iter_from(skip))
            assert len(got) == len(want) > 0
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, np.asarray(wx))
                np.testing.assert_array_equal(gy, np.asarray(wy))
    # abandoned mid-epoch: the in-flight jobs drain, the next pass is whole
    it = iter(ours)
    next(it)
    it.close()
    assert len(list(ours)) == len(ours)
    ours.close()
    ref.close()


def test_make_loader_falls_back_without_the_library(monkeypatch):
    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    plan = ShardPlan(num_samples=8, num_shards=1, shard_id=0)
    loader = make_loader(make_toy_data(8), 4, plan, num_workers=2)
    assert type(loader) is ShardedLoader


def _source(n, fail_at=None, drawn=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"batch {i}")
        if drawn is not None:
            drawn.append(i)
        yield (np.full((2, 3), i, np.int32), np.arange(i, i + 2))


@pytest.mark.parametrize("depth,host_buffer", [(1, 1), (2, 2), (4, 3)])
def test_prefetch_keeps_order_and_drains_once(depth, host_buffer):
    drawn = []
    stats = PrefetchStats()
    got = list(prefetch_to_device(_source(9, drawn=drawn), "cpu",
                                  depth=depth, host_buffer=host_buffer,
                                  stats=stats))
    want = list(jax_prefetch(_source(9), None, depth=depth,
                             host_buffer=host_buffer))
    assert drawn == list(range(9)) and stats.batches == 9
    assert len(got) == len(want) == 9
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def test_prefetch_reraises_at_the_position():
    for prefetch in (lambda s: prefetch_to_device(s, "cpu"),
                     lambda s: jax_prefetch(s, None)):
        seen = []
        with pytest.raises(KeyError, match="batch 5"):
            for x, _ in prefetch(_source(9, fail_at=5)):
                seen.append(int(x[0, 0]))
        assert seen == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        prefetch_to_device(_source(1), "cpu", depth=0)
    with pytest.raises(ValueError):
        prefetch_to_device(_source(1), "cpu", host_buffer=0)


def test_prefetch_close_joins_the_drain_thread():
    before = threading.active_count()
    it = prefetch_to_device(_source(10 ** 6), "cpu")
    first, _ = next(it)
    assert first.shape == (2, 3) and int(first[0, 0]) == 0
    it.close()
    assert not it._thread.is_alive()
    assert threading.active_count() == before
    with pytest.raises(StopIteration):
        next(it)
