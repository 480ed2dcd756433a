"""Process bootstrap: the rank/world-size contract and distributed init —
the counterpart of :mod:`tpudist.runtime.bootstrap`.

:func:`resolve_process_context` is copied from the JAX package (pure
environment parsing).  Resolution priority (first match wins):

1. explicit arguments
2. tpudist launcher contract: ``TPUDIST_COORDINATOR`` /
   ``TPUDIST_NUM_PROCESSES`` / ``TPUDIST_PROCESS_ID``
3. torchrun contract: ``MASTER_ADDR``/``MASTER_PORT`` + ``RANK`` +
   ``WORLD_SIZE`` (and ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``)
4. SLURM contract: ``MASTER_ADDR``/``MASTER_PORT`` + ``WORLD_SIZE`` +
   (``NODE_RANK``×``TASKS_PER_NODE``+``SLURM_LOCALID`` when
   ``use_node_rank``, else ``SLURM_PROCID``)
5. OpenMPI contract: ``OMPI_COMM_WORLD_RANK``/``OMPI_COMM_WORLD_SIZE``
   (with ``MASTER_ADDR``/``MASTER_PORT`` for more than one process)
6. single-process default (no distributed init)

:func:`initialize` replaces ``jax.distributed.initialize`` with
``torch.distributed.init_process_group`` — NCCL for the card, gloo for the
CPU — plus a second gloo group on the host for the ``host`` metric fabric
(the reference's ``dist.new_group(backend="gloo")``, ``demo.py:84``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import random
import socket
import sys
import time
from typing import Callable, Optional

class BootstrapError(RuntimeError):
    """A launch contract was detected but is incomplete/inconsistent."""


@dataclasses.dataclass(frozen=True)
class ProcessContext:
    """Everything a rank needs to know about its place in the job."""

    process_id: int
    num_processes: int
    coordinator_address: Optional[str]  # "host:port" or None for single-process
    local_rank: int
    local_world_size: int
    launch_source: str  # explicit | tpudist | torchrun | slurm | mpi | single

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError as e:
        raise BootstrapError(f"env var {name}={v!r} is not an integer") from e


def _require(name: str) -> str:
    v = os.environ.get(name)
    if v is None or v == "":
        # Mirrors the reference's fail-fast env checks (demo.py:31-33,47-48).
        raise BootstrapError(
            f"required env var {name} is not set for this launch contract"
        )
    return v


def _coordinator_from_master_env(default_port: int = 2345) -> str:
    addr = _require("MASTER_ADDR")
    port = _env_int("MASTER_PORT", default_port)
    return f"{addr}:{port}"


def resolve_process_context(
    *,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    coordinator_address: Optional[str] = None,
    use_node_rank: bool = False,
) -> ProcessContext:
    """Resolve (process_id, num_processes, coordinator) from args or env.

    ``use_node_rank`` mirrors the reference's ``--use_node_rank`` flag
    (``argument_parser.py:16-19``, consumed at ``demo.py:38-41``).
    """
    if num_processes is not None:
        if process_id is None:
            raise BootstrapError("explicit num_processes requires explicit process_id")
        if num_processes > 1 and coordinator_address is None:
            raise BootstrapError(
                "explicit multi-process launch requires coordinator_address"
            )
        return ProcessContext(
            process_id=process_id,
            num_processes=num_processes,
            coordinator_address=coordinator_address,
            local_rank=_env_int("LOCAL_RANK", 0) or 0,
            local_world_size=_env_int("LOCAL_WORLD_SIZE", 1) or 1,
            launch_source="explicit",
        )

    env = os.environ
    # 2. tpudist launcher contract.
    if "TPUDIST_NUM_PROCESSES" in env:
        n = _env_int("TPUDIST_NUM_PROCESSES")
        pid = _env_int("TPUDIST_PROCESS_ID")
        if n is None:
            raise BootstrapError("TPUDIST_NUM_PROCESSES is set but empty")
        if pid is None:
            raise BootstrapError("TPUDIST_NUM_PROCESSES set but TPUDIST_PROCESS_ID missing")
        coord = env.get("TPUDIST_COORDINATOR")
        if n > 1 and not coord:
            raise BootstrapError("TPUDIST_COORDINATOR required for multi-process launch")
        return ProcessContext(
            process_id=pid,
            num_processes=n,
            coordinator_address=coord,
            local_rank=_env_int("TPUDIST_LOCAL_RANK", 0) or 0,
            local_world_size=_env_int("TPUDIST_LOCAL_WORLD_SIZE", 1) or 1,
            launch_source="tpudist",
        )

    # 3. torchrun-style contract (reference demo.py:25-34 reads WORLD_SIZE/
    #    LOCAL_WORLD_SIZE/LOCAL_RANK under --torchrun).
    if "RANK" in env and "WORLD_SIZE" in env:
        n = _env_int("WORLD_SIZE")
        pid = _env_int("RANK")
        if n is None or pid is None:
            raise BootstrapError("RANK/WORLD_SIZE are set but empty")
        coord = _coordinator_from_master_env() if n > 1 else None
        return ProcessContext(
            process_id=pid,
            num_processes=n,
            coordinator_address=coord,
            local_rank=_env_int("LOCAL_RANK", 0) or 0,
            local_world_size=_env_int("LOCAL_WORLD_SIZE", 1) or 1,
            launch_source="torchrun",
        )

    # 4. SLURM contract (reference demo.py:35-49).
    if "SLURM_PROCID" in env or ("WORLD_SIZE" in env and "SLURM_LOCALID" in env):
        n = _env_int("WORLD_SIZE", _env_int("SLURM_NTASKS"))
        if n is None:
            raise BootstrapError("SLURM launch detected but WORLD_SIZE/SLURM_NTASKS unset")
        local_rank = _env_int("SLURM_LOCALID", 0) or 0
        local_world = _env_int("TASKS_PER_NODE", _env_int("SLURM_NTASKS_PER_NODE", 1)) or 1
        if use_node_rank:
            # demo.py:38-39 — global = NODE_RANK * local_world + local_rank
            node_rank = _env_int("NODE_RANK")
            if node_rank is None:
                raise BootstrapError("--use_node_rank requires NODE_RANK")
            pid = node_rank * local_world + local_rank
        else:
            pid = _env_int("SLURM_PROCID")  # demo.py:41
            if pid is None:
                raise BootstrapError("SLURM launch without SLURM_PROCID")
        coord = _coordinator_from_master_env() if n > 1 else None
        return ProcessContext(
            process_id=pid,
            num_processes=n,
            coordinator_address=coord,
            local_rank=local_rank,
            local_world_size=local_world,
            launch_source="slurm",
        )

    # 5. OpenMPI contract (mpiexec-started; demo_assume_started_with_mpiexec.py).
    if "OMPI_COMM_WORLD_RANK" in env:
        n = _env_int("OMPI_COMM_WORLD_SIZE")
        pid = _env_int("OMPI_COMM_WORLD_RANK")
        if n is None or pid is None:
            raise BootstrapError("OMPI_COMM_WORLD_RANK/SIZE are set but empty")
        coord = None
        if n > 1:
            # The coordinator address must have been agreed on out-of-band:
            # by env here, or broadcast over MPI first
            # (runtime/mpi_bootstrap.py exports MASTER_ADDR/MASTER_PORT).
            if "MASTER_ADDR" in env:
                coord = _coordinator_from_master_env()
            else:
                raise BootstrapError(
                    "MPI launch detected; set MASTER_ADDR/MASTER_PORT"
                )
        return ProcessContext(
            process_id=pid,
            num_processes=n,
            coordinator_address=coord,
            local_rank=_env_int("OMPI_COMM_WORLD_LOCAL_RANK", 0) or 0,
            local_world_size=_env_int("OMPI_COMM_WORLD_LOCAL_SIZE", 1) or 1,
            launch_source="mpi",
        )

    # 6. single-process default.
    return ProcessContext(
        process_id=0,
        num_processes=1,
        coordinator_address=None,
        local_rank=0,
        local_world_size=1,
        launch_source="single",
    )


def find_free_port() -> int:
    """Pick a free TCP port (reference ``_find_free_port``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]


def _retry_with_backoff(
    fn: Callable[[int], "object"],
    *,
    retries: int,
    backoff_s: float,
    what: str,
    retry_on: tuple = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    rng: Callable[[], float] = random.random,
):
    """Run ``fn(attempt)`` with up to ``retries`` retries on ``retry_on``
    failures, sleeping a jittered exponential backoff between attempts:
    ``backoff_s * 2**attempt * (0.5 + rng())`` — the jitter (0.5x–1.5x)
    decorrelates a whole worker group hammering a recovering coordinator
    at the same instant.  KeyboardInterrupt/SystemExit (and anything not
    in ``retry_on``) pass through.  A copy of JAX's helper, with its
    ``retry`` event and stderr line."""
    attempt = 0
    while True:
        try:
            return fn(attempt)
        except (KeyboardInterrupt, SystemExit):
            raise
        except retry_on as e:  # noqa: BLE001 — bounded by `retries`
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt) * (0.5 + rng())
            from tpudist_torch import telemetry

            telemetry.event("retry", what=what, attempt=attempt,
                            error=type(e).__name__, backoff_s=round(delay, 3))
            print(
                f"[tpudist.retry] {what} failed "
                f"(attempt {attempt + 1}/{retries + 1}): "
                f"{type(e).__name__}: {e}; retrying in {delay:.1f}s",
                file=sys.stderr, flush=True,
            )
            sleep(delay)
            attempt += 1


# the process-wide runtime state, as torch.distributed's own default group:
# the context of the last initialize() and its host (gloo) group
_INITIALIZED_CTX: Optional[ProcessContext] = None
_HOST_GROUP = None


def initialize(ctx: Optional[ProcessContext] = None, *,
               use_node_rank: bool = False, device="cuda",
               initialization_timeout_s: int = 3600,
               init_retries: Optional[int] = None,
               init_backoff_s: Optional[float] = None) -> ProcessContext:
    """Bring up ``torch.distributed`` for this process.

    Replaces ``dist.init_process_group`` (``demo.py:27,49``) with the
    reference's 1-hour timeout.  A launch under any contract (``ctx`` not
    ``single``) joins the process group, even at world size 1, so the
    device group, DDP and the metric all-reduce run as they would across
    many processes: NCCL on a ``cuda`` device (which is set to the local
    rank), gloo on the CPU, rendezvous at ``tcp://`` the coordinator (for
    one process, ``MASTER_ADDR:MASTER_PORT`` when set, else a free local
    port).  A second gloo group serves the host fabric (:func:`host_group`).
    A single-process launch initializes nothing.  Idempotent: a second call
    returns the context of the first, and a process group the process
    already holds is joined as it is (never destroyed and rebuilt).

    As in JAX the fault grammar is armed and the telemetry session started
    here, and the group's rendezvous is retried with jittered exponential
    backoff on transient failures: ``init_retries`` retries (default
    ``TPUDIST_INIT_RETRIES`` or 3) from ``init_backoff_s`` (default
    ``TPUDIST_INIT_BACKOFF_S`` or 1.0 s), inside one ``init`` span."""
    global _INITIALIZED_CTX, _HOST_GROUP
    if _INITIALIZED_CTX is not None:
        return _INITIALIZED_CTX
    import torch
    import torch.distributed as dist

    if ctx is None:
        ctx = resolve_process_context(use_node_rank=use_node_rank)
    # the chaos grammar from the earliest runtime seam; the session starts
    # here so the init span lands where the training loop records
    from tpudist_torch import telemetry
    from tpudist_torch.runtime import faults

    faults.arm_from_env()
    telemetry.ensure_started()
    if dist.is_initialized():
        # a group this process already holds (a caller's own
        # init_process_group; a Trainer inside a serving process): join
        # it, never tear it down and build another
        _INITIALIZED_CTX = ctx
        return ctx
    if ctx.launch_source != "single":
        from tpudist_torch.utils.envutil import env_float

        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(ctx.local_rank)
        coord = ctx.coordinator_address
        if coord is None:
            coord = (_coordinator_from_master_env()
                     if os.environ.get("MASTER_ADDR")
                     else f"localhost:{find_free_port()}")
        if init_retries is None:
            init_retries = max(0, int(env_float("TPUDIST_INIT_RETRIES", 3)))
        if init_backoff_s is None:
            init_backoff_s = env_float("TPUDIST_INIT_BACKOFF_S", 1.0)

        def _attempt(attempt: int) -> None:
            faults.inject_init(attempt)
            if dist.is_initialized():  # a half-built group from a failure
                dist.destroy_process_group()
            dist.init_process_group(
                backend="nccl" if device.type == "cuda" else "gloo",
                init_method=f"tcp://{coord}", world_size=ctx.num_processes,
                rank=ctx.process_id,
                timeout=datetime.timedelta(seconds=initialization_timeout_s))

        with telemetry.span("init", world=ctx.num_processes,
                            source=ctx.launch_source):
            _retry_with_backoff(
                _attempt, retries=init_retries, backoff_s=init_backoff_s,
                what=f"torch.distributed.init_process_group({coord})")
        _HOST_GROUP = dist.new_group(backend="gloo")
    _INITIALIZED_CTX = ctx
    return ctx


def host_group():
    """The host (gloo) process group of :func:`initialize`, or ``None``
    when no process group is up."""
    return _HOST_GROUP


def local_rank() -> int:
    """This process's rank on its host: from the context of
    :func:`initialize`, else from the launch environment."""
    ctx = _INITIALIZED_CTX or resolve_process_context()
    return ctx.local_rank


def local_world_size() -> int:
    """The number of ranks on this process's host, as its launch contract
    states it: from the context of :func:`initialize`, else from the launch
    environment."""
    ctx = _INITIALIZED_CTX or resolve_process_context()
    return ctx.local_world_size


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The process group's world size (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Tear the process group down: a barrier, then
    ``destroy_process_group`` (``demo.py:177-178``)."""
    global _INITIALIZED_CTX, _HOST_GROUP
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier(group=_HOST_GROUP)
        dist.destroy_process_group()
    _INITIALIZED_CTX = None
    _HOST_GROUP = None
