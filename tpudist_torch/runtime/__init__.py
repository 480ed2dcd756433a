"""The process contract of the port: rank/world-size resolution,
``torch.distributed`` bring-up and teardown, job-wide seeding,
rank-aware printing, the fault grammar and the hang watchdog (the
counterpart of :mod:`tpudist.runtime`)."""

from tpudist_torch.runtime import faults
from tpudist_torch.runtime.bootstrap import (BootstrapError, ProcessContext,
                                             host_group, initialize,
                                             process_count, process_index,
                                             resolve_process_context,
                                             shutdown)
from tpudist_torch.runtime.mesh import (MeshConfig, make_hybrid_mesh,
                                        make_mesh)
from tpudist_torch.runtime.rank_logging import describe_runtime, rank_print
from tpudist_torch.runtime.seeding import (fold_in_process, per_process_seed,
                                           resolve_shared_seed)
from tpudist_torch.runtime.watchdog import WATCHDOG_EXIT_CODE, Watchdog

__all__ = ["BootstrapError", "MeshConfig", "ProcessContext",
           "WATCHDOG_EXIT_CODE", "Watchdog", "describe_runtime", "faults",
           "fold_in_process", "host_group", "initialize",
           "make_hybrid_mesh", "make_mesh", "per_process_seed",
           "process_count", "process_index", "rank_print",
           "resolve_process_context", "resolve_shared_seed", "shutdown"]
