"""Training bootstrapped by an external MPI launcher — the counterpart of
``examples/demo_mpi_bootstrap.py`` (the reference's
``demo_assume_started_with_mpiexec.py``, SURVEY.md §3.3).

The job is started by ``mpiexec -np W``; rank and world size come from
``MPI.COMM_WORLD`` and rank 0's hostname and a free port are broadcast over
MPI to seed ``torch.distributed`` (``tpudist_torch.runtime.mpi_bootstrap``;
without ``mpi4py``, the ``OMPI_*`` environment plus ``MASTER_ADDR``).  As in
the reference this variant logs to stdout only: each rank prints the final
losses, global batch-weighted means as in ``demo.py``.

  mpiexec -np 4 python -m tpudist_torch.examples.demo_mpi_bootstrap
"""

from __future__ import annotations

from tpudist_torch.config import get_args
from tpudist_torch.examples.common import train_demo
from tpudist_torch.models.transformer import resolve_device
from tpudist_torch.runtime import (describe_runtime, per_process_seed,
                                   rank_print, resolve_shared_seed, shutdown)
from tpudist_torch.runtime.mesh import data_parallel_mesh
from tpudist_torch.runtime.mpi_bootstrap import initialize_from_mpi
from tpudist_torch.utils.record import record


@record
def main(argv=None) -> dict:
    args = get_args(argv)
    device = resolve_device(args.device)
    ctx = initialize_from_mpi(device=device)
    args.seed = resolve_shared_seed(args.seed)
    mesh = data_parallel_mesh(device=device)
    describe_runtime(ctx, per_process_seed(args.seed), mesh.devices[0])
    losses = train_demo(args, mesh, group=None)
    rank_print(f"final losses: {losses}")
    shutdown()
    return losses


if __name__ == "__main__":
    main()
