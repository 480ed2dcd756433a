"""Continuous-batching serving on the port: :class:`InferenceServer` over
:class:`SlotEngine` over the paged slot programs and their kernels, on one
device or over a serving mesh (:class:`ServeMeshConfig`)."""

from tpudist_torch.serve.engine import SlotEngine
from tpudist_torch.serve.paged_alloc import BlockAllocator, hash_chain
from tpudist_torch.serve.scheduler import (FINISH_REASONS, AdmissionError,
                                           Request, RequestHandle, Scheduler)
from tpudist_torch.serve.server import InferenceServer, ServeConfig
from tpudist_torch.serve.spmd import ServeMeshConfig

__all__ = [
    "AdmissionError", "BlockAllocator", "FINISH_REASONS", "InferenceServer",
    "Request", "RequestHandle", "Scheduler", "ServeConfig",
    "ServeMeshConfig", "SlotEngine",
    "hash_chain",
]
