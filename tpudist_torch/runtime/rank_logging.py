"""Rank-aware console output — the counterpart of
:mod:`tpudist.runtime.rank_logging`: rank-prefixed prints and the startup
banner (``demo.py:51-63``).
"""

from __future__ import annotations

import socket

from tpudist_torch.runtime.bootstrap import process_count, process_index


def rank_print(*args, **kwargs) -> None:
    """Print prefixed with ``[rank r/w]``."""
    prefix = f"[rank {process_index()}/{process_count()}]"
    print(prefix, *args, **kwargs, flush=True)


def describe_runtime(ctx=None, seed=None, device=None) -> None:
    """The ``demo.py:51-63`` startup banner: host, device, world, launch
    contract, seed."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device) if device is not None else None
    kind = (torch.cuda.get_device_name(dev) if dev is not None
            and dev.type == "cuda" else "cpu")
    rank_print(
        f"host={socket.gethostname()} device={kind} "
        f"world={process_count()} "
        f"backend={dist.get_backend() if dist.is_initialized() else None} "
        + (f"launch={ctx.launch_source} " if ctx is not None else "")
        + (f"seed={seed}" if seed is not None else ""))
