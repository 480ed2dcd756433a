"""The port's two communication fabrics (the counterpart of
:mod:`tpudist.comm`)."""

from tpudist_torch.comm.collectives import (HostFabricTimeout, MetricBackend,
                                            barrier,
                                            batch_weighted_loss_mean,
                                            cross_process_mean_scalar,
                                            host_allreduce_sum, pmean_tree,
                                            psum_tree)

__all__ = ["HostFabricTimeout", "MetricBackend", "barrier",
           "batch_weighted_loss_mean", "cross_process_mean_scalar",
           "host_allreduce_sum", "pmean_tree", "psum_tree"]
