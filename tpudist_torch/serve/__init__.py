"""Continuous-batching serving on the port: :class:`InferenceServer` over
:class:`SlotEngine` over the paged slot programs and their kernels, on one
device or over a serving mesh (:class:`ServeMeshConfig`); graceful
degradation under overload (:class:`HostKVTier`,
:class:`OverloadController`) and the fleet router over replicas
(:class:`FleetRouter`)."""

from tpudist_torch.serve.disagg import (HANDOFF_SCHEMA_MIN,
                                        HANDOFF_SCHEMA_VERSION, HandoffError,
                                        deserialize_package,
                                        serialize_package)
from tpudist_torch.serve.engine import SlotEngine
from tpudist_torch.serve.host_tier import HostKVTier, HostTierError
from tpudist_torch.serve.overload import OverloadController
from tpudist_torch.serve.paged_alloc import BlockAllocator, hash_chain
from tpudist_torch.serve.router import FleetRouter, RouterConfig, RouterHandle
from tpudist_torch.serve.scheduler import (FINISH_REASONS, AdmissionError,
                                           Request, RequestHandle, Scheduler)
from tpudist_torch.serve.server import (InferenceServer, ReplicaKilled,
                                        ServeConfig)
from tpudist_torch.serve.spmd import ServeMeshConfig

__all__ = [
    "AdmissionError", "BlockAllocator", "FINISH_REASONS", "FleetRouter",
    "HANDOFF_SCHEMA_MIN", "HANDOFF_SCHEMA_VERSION", "HandoffError",
    "HostKVTier", "HostTierError", "InferenceServer", "OverloadController",
    "ReplicaKilled", "Request", "RequestHandle", "RouterConfig",
    "RouterHandle", "Scheduler", "ServeConfig", "ServeMeshConfig",
    "SlotEngine", "deserialize_package", "hash_chain", "serialize_package",
]
