"""Launching the port's entry points as processes, for its tests: one
process a rank under a launch contract's environment, their outputs, the
metric rows and the printed final losses.  Imports no JAX."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

#: every variable a launch contract reads (tpudist_torch.runtime.bootstrap)
LAUNCH_ENV = ("TPUDIST_NUM_PROCESSES", "TPUDIST_PROCESS_ID",
              "TPUDIST_COORDINATOR", "TPUDIST_LOCAL_RANK",
              "TPUDIST_LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "SLURM_PROCID", "SLURM_LOCALID", "SLURM_NTASKS",
              "SLURM_NTASKS_PER_NODE", "TASKS_PER_NODE", "NODE_RANK",
              "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
              "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE")


def free_port() -> int:
    from tpudist_torch.runtime.bootstrap import find_free_port

    return find_free_port()


def launch_ranks(module, args, cwd, rank_envs, timeout=180):
    """Run ``python -m module *args`` in ``cwd`` once per entry of
    ``rank_envs`` (that rank's launch variables), all at once, with the
    repository on the path and one intra-op thread each; every process
    must exit 0.  Returns their combined outputs, in rank order."""
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    base.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", module, *args],
                              cwd=cwd, env=dict(base, **env),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for env in rank_envs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def torchrun_envs(world: int):
    """The torchrun contract's variables for ranks ``0 .. world-1`` of one
    host, rendezvous at a free local port."""
    common = dict(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                  MASTER_PORT=str(free_port()))
    return [dict(common, RANK=str(r), LOCAL_RANK=str(r))
            for r in range(world)]


def metric_rows(path):
    """The rows of a ``metrics.jsonl``."""
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def printed_losses(out: str) -> dict:
    """The dict of the last ``final losses: {...}`` line of an output."""
    found = re.findall(r"final losses: (\{.*\})", out)
    assert found, out[-2000:]
    return ast.literal_eval(found[-1])
