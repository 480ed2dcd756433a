"""Host-side helpers of the port: env knobs, FLOP counts, the metrics
logger, the profiler window and stage timer, and the crash record."""

from tpudist_torch.utils.metrics import MetricsLogger, init_metrics
from tpudist_torch.utils.profiling import StageTimer, trace
from tpudist_torch.utils.record import record, write_error_record

__all__ = ["MetricsLogger", "StageTimer", "init_metrics", "record", "trace",
           "write_error_record"]
