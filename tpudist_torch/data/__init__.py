"""The port's data path: deterministic per-epoch sharding, the tokenized
LM corpus loader and the toy dataset with its sharded loader (numpy host
logic copied from :mod:`tpudist.data`), the native C++ gather pool behind
``--num_workers`` and the device prefetch."""

from tpudist_torch.data.lm import (PrefetchingTokenBatches, TokenWindows,
                                   lm_batches, make_lm_loader,
                                   open_token_stream)
from tpudist_torch.data.loader import ShardedLoader, make_loader, shard_batch
from tpudist_torch.data.prefetch import (PrefetchStats, prefetch_to_device)
from tpudist_torch.data.sharding import ShardPlan, epoch_indices
from tpudist_torch.data.toy import ToyData, make_toy_data

__all__ = ["PrefetchStats", "PrefetchingTokenBatches", "ShardPlan",
           "ShardedLoader", "TokenWindows", "ToyData", "epoch_indices",
           "lm_batches", "make_lm_loader", "make_loader", "make_toy_data",
           "open_token_stream", "prefetch_to_device", "shard_batch"]
