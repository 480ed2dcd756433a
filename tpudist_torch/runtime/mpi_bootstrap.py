"""Bring the process group up from an MPI launch — the counterpart of
:mod:`tpudist.runtime.mpi_bootstrap`.

The reference pattern (``demo_assume_started_with_mpiexec.py:29-50``): use
one fabric (MPI) to bootstrap another — rank 0 picks a free port
(``:20-27``), broadcasts its hostname and the port over ``MPI.COMM_WORLD``
(``:43-45``), every rank exports ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE`` and then initializes the real backend (``:46-50``): here
``torch.distributed`` through :func:`tpudist_torch.runtime.initialize`
(NCCL on the card, gloo on the CPU).

``mpi4py`` is optional and imported only inside the functions that use it.
Without it the ``OMPI_*`` environment contract runs
(:func:`~tpudist_torch.runtime.bootstrap.resolve_process_context`), which
needs ``MASTER_ADDR`` (and optionally ``MASTER_PORT``) exported by the
launcher for more than one process.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

from tpudist_torch.runtime.bootstrap import (ProcessContext, find_free_port,
                                             initialize,
                                             resolve_process_context)


def have_mpi4py() -> bool:
    try:
        import mpi4py  # noqa: F401

        return True
    except ImportError:
        return False


def exchange_coordinator(port: Optional[int] = None) -> Tuple[str, int, int]:
    """Agree on ``(coordinator_address, num_processes, process_id)`` via MPI.

    Mirrors ``demo_assume_started_with_mpiexec.py:35-47``: rank, size from
    ``COMM_WORLD``; rank 0 picks the port; hostname+port broadcast to all.
    Exports MASTER_ADDR/MASTER_PORT so later env-contract resolution agrees.
    """
    from mpi4py import MPI  # deferred: optional dependency

    comm = MPI.COMM_WORLD
    rank = comm.Get_rank()
    size = comm.Get_size()
    if rank == 0:
        hostname = socket.gethostname()
        port = port or find_free_port()
    else:
        hostname, port = None, None
    hostname = comm.bcast(hostname, root=0)
    port = comm.bcast(port, root=0)
    os.environ["MASTER_ADDR"] = hostname
    os.environ["MASTER_PORT"] = str(port)
    os.environ.setdefault("WORLD_SIZE", str(size))
    return f"{hostname}:{port}", size, rank


def initialize_from_mpi(port: Optional[int] = None, *,
                        device="cuda") -> ProcessContext:
    """One-call MPI-launched bootstrap → the initialized process group on
    ``device``'s backend."""
    if have_mpi4py():
        coord, size, rank = exchange_coordinator(port)
        ctx = ProcessContext(
            process_id=rank,
            num_processes=size,
            coordinator_address=coord if size > 1 else None,
            local_rank=int(os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)),
            local_world_size=int(os.environ.get("OMPI_COMM_WORLD_LOCAL_SIZE", 1)),
            launch_source="mpi",
        )
        return initialize(ctx, device=device)
    # mpi4py-less fallback: pure env contract (OMPI_* + MASTER_ADDR).
    return initialize(resolve_process_context(), device=device)
