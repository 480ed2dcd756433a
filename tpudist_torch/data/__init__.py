"""The port's data path: deterministic per-epoch sharding and the tokenized
LM corpus loader (numpy only, copied from :mod:`tpudist.data`)."""

from tpudist_torch.data.lm import (TokenWindows, lm_batches, make_lm_loader,
                                   open_token_stream)
from tpudist_torch.data.sharding import ShardPlan, epoch_indices

__all__ = ["ShardPlan", "TokenWindows", "epoch_indices", "lm_batches",
           "make_lm_loader", "open_token_stream"]
