"""The port's hybrid (DCN × ICI) mesh (``tpudist_torch.runtime.mesh.
make_hybrid_mesh``) against the JAX package's ``make_hybrid_mesh``.

A JAX process is a node of the port and a JAX device a rank.  At world 4
over gloo (``tests/torch_hybrid_worker.py``, one host):

- under ``force_granules=2`` (two blocks of two ranks stand in for nodes)
  each rank's ``(data, stage, seq)`` coordinates are the position of device
  ``rank`` in JAX's ``make_hybrid_mesh(..., force_granules=2)`` over 4 CPU
  devices, for data 4, data 2 × seq 2 and data 2 × stage 2, and data 1 ×
  seq 4 raises JAX's error, its text;
- with the launch contract claiming two nodes of two ranks and
  ``TPUDIST_NODE_NAME`` putting ranks 0, 2 on one and 1, 3 on the other
  (a launcher numbering ranks across nodes), every ``seq`` ring and
  ``stage`` chain lies on one node, ``data`` spans the two, and
  ``force_granules`` raises.

In one process the hybrid mesh is ``make_mesh``'s."""

import json

import jax
import numpy as np
import pytest

from tpudist.runtime import mesh as jax_mesh
from torch_hybrid_worker import CONFIGS
from torch_launch import REPO, launch_ranks, torchrun_envs
from tpudist_torch.runtime.mesh import MeshConfig, make_hybrid_mesh, make_mesh

AXES = ("data", "stage", "seq")


def _run(tmp_path, mode, envs):
    launch_ranks("torch_hybrid_worker", ["--out", str(tmp_path), "--mode",
                                         mode], REPO / "tests", envs)
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]


def _jax_positions(data, stage, seq):
    devs = jax.devices()[:4]
    try:
        m = jax_mesh.make_hybrid_mesh(
            jax_mesh.MeshConfig(data=data, stage=stage, seq=seq),
            force_granules=2, devices=devs)
    except ValueError as e:
        return None, str(e)
    pos = {}
    for r, d in enumerate(devs):
        idx = np.argwhere(m.devices == d)[0]
        pos[r] = dict(zip(m.axis_names, (int(i) for i in idx)))
    return pos, None


def test_force_granules_coordinates_equal_jax(tmp_path):
    envs = [dict(e, LOCAL_WORLD_SIZE="4") for e in torchrun_envs(4)]
    ranks = _run(tmp_path, "force", envs)
    for name, (data, stage, seq) in CONFIGS.items():
        want, err = _jax_positions(data, stage, seq)
        for r, res in enumerate(ranks):
            if err is not None:
                assert res[name] == {"error": err}, (name, r)
                continue
            got = res[name]["coords"]
            assert got == {a: want[r][a] for a in AXES if a in got}, (
                name, r)
            assert got["data"] == want[r]["data"]
            for a in ("stage", "seq"):
                assert got.get(a, 0) == want[r][a], (name, r, a)


def test_interleaved_nodes_keep_subgroups_on_one_node(tmp_path):
    envs = [dict(e, LOCAL_WORLD_SIZE="2",
                 TPUDIST_NODE_NAME="node-a" if r % 2 == 0 else "node-b")
            for r, e in enumerate(torchrun_envs(4))]
    ranks = _run(tmp_path, "nodes", envs)
    node = [res["node"] for res in ranks]
    assert node == ["node-a", "node-b", "node-a", "node-b"]
    for name, sub in (("data 2 x seq 2", "ring"),
                      ("data 2 x stage 2", "stages")):
        for r, res in enumerate(ranks):
            group = res[name][sub]
            assert r in group and len(group) == 2
            assert {node[g] for g in group} == {node[r]}, (name, r, group)
        # node-major order: node-a's ranks hold data row 0
        assert [ranks[r][name]["coords"]["data"] for r in range(4)] == \
            [0, 1, 0, 1]
    assert [res["data 4"]["coords"]["data"] for res in ranks] == [0, 2, 1, 3]
    _, err = _jax_positions(1, 1, 4)
    for res in ranks:
        assert res["data 1 x seq 4"]["error"] == err
        assert res["force across nodes"].startswith(
            "force_granules is the single-node validation path; this job "
            "spans 2 nodes")


@pytest.mark.parametrize("config", [None, MeshConfig(seq=2),
                                    MeshConfig(stage=2),
                                    MeshConfig(model=2)])
def test_one_process_falls_back_to_make_mesh(config):
    assert make_hybrid_mesh(config, device="cpu") == \
        make_mesh(config, device="cpu")
    with pytest.raises(ValueError, match="DCN granules"):
        make_hybrid_mesh(config, force_granules=2, device="cpu")
