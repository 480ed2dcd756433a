"""The MPI bootstrap (``tpudist_torch.runtime.mpi_bootstrap``,
``tpudist_torch.examples.demo_mpi_bootstrap``) against the JAX package's
``tpudist.runtime.mpi_bootstrap``.

``mpi4py`` is not installed here.  A stub ``mpi4py`` in ``sys.modules``
(a ``COMM_WORLD`` with ``Get_rank``/``Get_size``/``bcast``) stands in for
it, so both modules' broadcast path runs and must return the same values
and export the same environment; without it, both run the ``OMPI_*``
environment contract to the same context.  Each module's ``initialize`` is
replaced by one that returns the context it is given, so no process group
forms in this process.  Two ranks under the ``OMPI_*`` contract over gloo
print the final losses of one rank at the same global batch
(``rtol 1e-6``, as ``test_torch_toy.py`` holds the torchrun demo).
"""

import ast
import dataclasses
import os
import sys
import types

import pytest
import torch

import tpudist.runtime.mpi_bootstrap as jax_mpi
from torch_cases import settled_torch_cpu
from torch_launch import (LAUNCH_ENV, REPO, free_port, launch_ranks,
                          printed_losses)
from tpudist_torch.examples.demo_mpi_bootstrap import main as mpi_main
from tpudist_torch.runtime import mpi_bootstrap


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.fixture()
def no_launch_env(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


class _Comm:
    """``MPI.COMM_WORLD`` of rank ``rank`` in a world of ``size``, whose
    ``bcast`` hands out what rank 0 of the stub world sends."""

    def __init__(self, rank, size, root_values):
        self.rank, self.size = rank, size
        self._root = list(root_values)
        self.sent = []

    def Get_rank(self):
        return self.rank

    def Get_size(self):
        return self.size

    def bcast(self, value, root=0):
        assert root == 0
        self.sent.append(value)
        return value if self.rank == 0 else self._root.pop(0)


def _stub_mpi4py(monkeypatch, comm):
    mod = types.ModuleType("mpi4py")
    mod.MPI = types.SimpleNamespace(COMM_WORLD=comm)
    monkeypatch.setitem(sys.modules, "mpi4py", mod)


def _identity_initialize(monkeypatch):
    """Both modules' ``initialize``: record and return the context."""
    seen = []

    def init(ctx, **kwargs):
        seen.append((ctx, kwargs))
        return ctx

    monkeypatch.setattr(jax_mpi, "initialize", init)
    monkeypatch.setattr(mpi_bootstrap, "initialize", init)
    return seen


@pytest.mark.parametrize("rank,size,port", [(0, 1, 4321), (0, 4, 4321),
                                            (2, 4, None), (0, 2, None)])
def test_exchange_coordinator_equals_jax(no_launch_env, rank, size, port):
    """The same stub world gives the same ``(coordinator, size, rank)``
    and the same exported ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``;
    rank 0 picks a free port when none is given (pinned to one value for
    both modules)."""
    no_launch_env.setattr(jax_mpi, "find_free_port", lambda: 5555)
    no_launch_env.setattr(mpi_bootstrap, "find_free_port", lambda: 5555)
    results = []
    for mod in (jax_mpi, mpi_bootstrap):
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"):
            no_launch_env.delenv(k, raising=False)
        comm = _Comm(rank, size, ["host0", 6666])
        _stub_mpi4py(no_launch_env, comm)
        assert mod.have_mpi4py()
        out = mod.exchange_coordinator(port)
        env = {k: os.environ.get(k)
               for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE")}
        results.append((out, env, comm.sent))
    assert results[0] == results[1]
    (addr, n, r), env, _ = results[1]
    assert (n, r) == (size, rank)
    assert env["WORLD_SIZE"] == str(size)
    if rank != 0:
        assert addr == "host0:6666"


@pytest.mark.parametrize("with_mpi4py", [True, False])
@pytest.mark.parametrize("env", [
    {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "2",
     "MASTER_ADDR": "h", "MASTER_PORT": "7"},
    {"OMPI_COMM_WORLD_RANK": "0", "OMPI_COMM_WORLD_SIZE": "1"},
])
def test_initialize_from_mpi_context_equals_jax(no_launch_env, env,
                                                with_mpi4py):
    """``initialize_from_mpi`` hands ``initialize`` the same context as
    JAX's, through the stub's broadcast or the env contract."""
    for k, v in env.items():
        no_launch_env.setenv(k, v)
    seen = _identity_initialize(no_launch_env)
    size, rank = int(env["OMPI_COMM_WORLD_SIZE"]), int(
        env["OMPI_COMM_WORLD_RANK"])
    ctxs = []
    for mod in (jax_mpi, mpi_bootstrap):
        if with_mpi4py:
            _stub_mpi4py(no_launch_env, _Comm(rank, size, ["h", 7]))
        else:
            no_launch_env.setitem(sys.modules, "mpi4py", None)
            assert not mod.have_mpi4py()
        kwargs = {} if mod is jax_mpi else {"device": "cpu"}
        ctxs.append(dataclasses.asdict(mod.initialize_from_mpi(7, **kwargs)))
    assert ctxs[0] == ctxs[1]
    assert ctxs[1]["launch_source"] == "mpi"
    assert seen[1][1] == {"device": "cpu"}


def test_import_does_not_import_mpi4py():
    """The port module imports ``mpi4py`` only inside its functions."""
    path = REPO / "tpudist_torch" / "runtime" / "mpi_bootstrap.py"
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + [
        n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not any(name and name.startswith("mpi4py") for name in names)
    inner = [n for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom)) and n not in top]
    assert any((getattr(n, "module", None) or n.names[0].name) == "mpi4py"
               for n in inner)


def test_two_mpi_ranks_equal_one_rank(tmp_path, no_launch_env):
    """``demo_mpi_bootstrap`` for 20 iterations: two ranks under
    ``OMPI_COMM_WORLD_*`` + ``MASTER_ADDR`` over gloo, 256 each, print the
    final losses of one rank at 512 (no metrics file: stdout only)."""
    base = ["--device", "cpu", "--seed", "0", "--total_iterations", "20"]
    no_launch_env.chdir(tmp_path)
    no_launch_env.setenv("OMPI_COMM_WORLD_RANK", "0")
    no_launch_env.setenv("OMPI_COMM_WORLD_SIZE", "1")
    want = mpi_main(base + ["--batch_size", "512"])
    port = str(free_port())
    outs = launch_ranks(
        "tpudist_torch.examples.demo_mpi_bootstrap",
        base + ["--batch_size", "256"], tmp_path,
        [{"OMPI_COMM_WORLD_RANK": str(r), "OMPI_COMM_WORLD_SIZE": "2",
          "OMPI_COMM_WORLD_LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
          "MASTER_PORT": port} for r in range(2)])
    for r, out in enumerate(outs):
        assert "launch=mpi" in out and "world=2" in out
        assert f"[rank {r}/2] final losses:" in out
        got = printed_losses(out)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-6)
    # no metrics file: only the telemetry stream, armed by default
    runs = tmp_path / "runs"
    assert not runs.exists() or os.listdir(runs) == ["telemetry"]
