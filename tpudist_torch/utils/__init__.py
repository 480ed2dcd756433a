"""Host-side helpers of the port: env knobs, FLOP counts, the metrics
logger and the crash record."""

from tpudist_torch.utils.metrics import MetricsLogger, init_metrics
from tpudist_torch.utils.record import record, write_error_record

__all__ = ["MetricsLogger", "init_metrics", "record", "write_error_record"]
