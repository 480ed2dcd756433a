"""The port's named axes (``tpudist_torch.runtime.mesh``) against the JAX
package's ``tpudist.runtime.mesh``.

``MeshConfig`` is copied across and must agree exactly: the same resolved
sizes, or the same ``ValueError`` message, over a grid of axis sizes and
device counts.  Device resolution is the port's own: a local rank gets
``model_size`` distinct CUDA devices or a ``ValueError`` when the host has
fewer, never a device index taken modulo the count.
"""

import itertools

import pytest
import torch

from tpudist.runtime import mesh as jax_mesh
from tpudist_torch.runtime import mesh
from tpudist_torch.runtime.mesh import (MeshConfig, data_model_mesh,
                                        data_parallel_mesh, make_hybrid_mesh,
                                        make_mesh, replica_devices)

SIZES = (-1, 1, 2, 3, 4)


def _resolve(cls, sizes, n):
    try:
        return cls(*sizes).resolve(n).axis_sizes(), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_config_resolve_equals_jax(n):
    """Every (data, stage, seq, model) in SIZES^4 resolves to the same
    sizes as JAX's, or fails with the same message."""
    for sizes in itertools.product(SIZES, repeat=4):
        assert _resolve(MeshConfig, sizes, n) == \
            _resolve(jax_mesh.MeshConfig, sizes, n), sizes


def test_axis_names_and_defaults_equal_jax():
    assert mesh.ALL_AXES == jax_mesh.ALL_AXES
    assert (mesh.AXIS_DATA, mesh.AXIS_STAGE, mesh.AXIS_SEQ,
            mesh.AXIS_MODEL) == (jax_mesh.AXIS_DATA, jax_mesh.AXIS_STAGE,
                                 jax_mesh.AXIS_SEQ, jax_mesh.AXIS_MODEL)
    assert MeshConfig().axis_sizes() == jax_mesh.MeshConfig().axis_sizes()


@pytest.mark.parametrize("model_size,count", [(1, 1), (2, 2), (2, 8),
                                              (4, 8), (3, 7)])
def test_replica_devices_distinct_per_local_rank(model_size, count):
    """Every local rank that fits gets its own devices, none shared; the
    first that does not fit raises."""
    ranks = count // model_size
    seen = []
    for r in range(ranks):
        devs = replica_devices(r, model_size, count)
        assert len(devs) == model_size == len(set(devs))
        assert all(d.type == "cuda" for d in devs)
        assert [d.index for d in devs] == list(
            range(r * model_size, (r + 1) * model_size))
        seen += devs
    assert len(seen) == len(set(seen))
    with pytest.raises(ValueError, match="host has"):
        replica_devices(ranks, model_size, count)


def test_replica_devices_raise_when_short():
    """The reference's formula would wrap rank 1 of 2 GPUs per process on
    a 2-GPU host back onto devices 0 and 1; the port refuses."""
    with pytest.raises(ValueError, match="needs devices 2..3"):
        replica_devices(1, 2, 2)
    with pytest.raises(ValueError, match="host has 1"):
        replica_devices(0, 2, 1)
    with pytest.raises(ValueError, match="at least 1"):
        replica_devices(0, 0, 8)


def test_meshes_on_the_cpu():
    """Without a process group: world 1, rank 0; CPU stages repeat; an
    explicit device list is taken as given and must be one replica."""
    dp = data_parallel_mesh(device="cpu")
    assert dp.axis_names == ("data",) and dp.shape == {"data": 1}
    assert dp.coords == {"data": 0} and dp.devices == (torch.device("cpu"),)
    dm = data_model_mesh(2, device="cpu")
    assert dm.axis_names == ("data", "model")
    assert dm.shape == {"data": 1, "model": 2}
    assert dm.devices == (torch.device("cpu"),) * 2
    given = data_model_mesh(2, devices=["cuda:0", "cuda:0"])
    assert given.devices == (torch.device("cuda", 0),) * 2
    with pytest.raises(ValueError, match="3 devices given"):
        data_model_mesh(2, devices=["cpu"] * 3)
    assert make_mesh(MeshConfig(model=2), device="cpu") == dm
    assert make_mesh(device="cpu") == dp
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(MeshConfig(data=2), device="cpu")


@pytest.mark.parametrize("config", [MeshConfig(stage=2),
                                    MeshConfig(stage=2, seq=2),
                                    MeshConfig(stage=-1, data=1)])
def test_unported_axes_raise(config):
    """The ``stage`` axis is ported (A6c's last slice): in one process the
    stages fold onto the device (``stage=-1`` absorbs the one rank there);
    so is the hybrid mesh, which in a job of one node is
    ``make_mesh``'s."""
    m = make_mesh(config, device="cpu")
    stage = max(config.stage, 1)
    if stage > 1:
        assert m.axis_names[:2] == ("data", "stage")
        assert m.shape["stage"] == stage and m.stages.size == stage
        assert m.stages.processes == 1
        assert m.stages.devices == (torch.device("cpu"),) * stage
        if config.seq > 1:
            assert m.axis_names == ("data", "stage", "seq")
            assert m.ring.size == config.seq
    else:
        assert m == make_mesh(device="cpu")
    assert make_hybrid_mesh(config, device="cpu") == m


def test_seq_axis_folds_onto_one_process():
    """Without a process group the seq shards fold onto the rank's device:
    a ``LocalRing`` of the axis's size, data 1; a data axis the one process
    cannot cover raises as JAX's resolve does, and seq beside a model axis
    is the 3-D mesh, in the JAX axis order."""
    from tpudist_torch.parallel import LocalRing

    m = make_mesh(MeshConfig(seq=4), device="cpu")
    assert m.axis_names == ("data", "seq")
    assert m.shape == {"data": 1, "seq": 4} and m.coords == {"data": 0}
    assert m.devices == (torch.device("cpu"),)
    assert isinstance(m.ring, LocalRing) and m.ring.size == 4
    assert m.ring.indices == (0, 1, 2, 3) and m.ring.processes == 1
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(MeshConfig(data=2, seq=4), device="cpu")
    three = make_mesh(MeshConfig(seq=2, model=2), device="cpu")
    assert three.axis_names == ("data", "seq", "model")
    assert three.shape == {"data": 1, "seq": 2, "model": 2}
    assert isinstance(three.ring, LocalRing) and three.ring.size == 2
