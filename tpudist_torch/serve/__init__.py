"""Continuous-batching serving on the port: :class:`InferenceServer` over
:class:`SlotEngine` over the paged slot programs and their kernels."""

from tpudist_torch.serve.engine import SlotEngine
from tpudist_torch.serve.paged_alloc import BlockAllocator, hash_chain
from tpudist_torch.serve.scheduler import (FINISH_REASONS, AdmissionError,
                                           Request, RequestHandle, Scheduler)
from tpudist_torch.serve.server import InferenceServer, ServeConfig

__all__ = [
    "AdmissionError", "BlockAllocator", "FINISH_REASONS", "InferenceServer",
    "Request", "RequestHandle", "Scheduler", "ServeConfig", "SlotEngine",
    "hash_chain",
]
