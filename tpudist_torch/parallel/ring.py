"""The ring's hop: how K/V blocks travel the ``seq`` mesh axis — the seam
that stands in for the JAX package's ``lax.ppermute`` inside
:mod:`tpudist.parallel.ring_attention`.

The ring bodies (:mod:`tpudist_torch.parallel.ring_attention`) hold this
process's shards of the sequence as lists, one tensor a shard, and call
``ring.hop(ks, vs)`` where the JAX bodies permute K and V one step to the
right: shard ``i``'s block goes to shard ``i + 1``.  Two rings implement it:

- :class:`ProcessGroupRing` — one shard a rank, the ``seq`` subgroup of
  one ``data`` row of the process group.  A hop sends K and V (packed into
  one buffer) to the next rank and receives the previous rank's through
  ``torch.distributed.batch_isend_irecv`` (NCCL on cards, gloo on the
  CPU).  It is an autograd function whose backward sends the cotangent the
  other way, which is what the transpose of ``ppermute`` does.
- :class:`LocalRing` — a job of one process: the ``N`` shards of the
  sequence sit on the rank's one device and a hop rotates the lists, so
  each shard runs the launches, in the order, that its rank would run.  It
  plays the part of the JAX package's one-process virtual mesh; its peak
  memory is that of the whole sequence, not of a shard.

The collective matmuls (:mod:`tpudist_torch.parallel.overlap`) move one
tensor a place by any offset: :meth:`LocalRing.shift` rotates the list
(onto each place's device, the ``model`` axis of a rank), and over a
:class:`ProcessGroupRing` a hop posts :func:`_post_exchange` to the rank
:meth:`ProcessGroupRing.rank_at` the offset and waits where it is used.

Every rank of a ring posts its send and receive on every hop, also where
its own compute on that hop is dead (a causal ring's early ranks): the
bodies call ``hop`` unconditionally.  In the backward every hop must run
on every rank as well, though a rank whose later hops are all dead has no
use for their outputs: :meth:`ProcessGroupRing.finish` ties the last hop's
K/V to the ring's output with a zero cotangent, so the chain of hop
backwards runs everywhere, in the same order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class LocalRing:
    """``size`` shards of the sequence on this process's one device;
    ``indices`` are their places on the ring (all of them), ``processes``
    the number of ranks the ring spans (one).  ``devices`` (one a place,
    repeats allowed), when given, are where :meth:`shift` delivers each
    place's tensor: the ``model`` axis's devices of a rank."""

    processes = 1

    def __init__(self, size: int, devices: Optional[Sequence] = None):
        if size < 1:
            raise ValueError(f"ring size must be at least 1, got {size}")
        if devices is not None and len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a ring of {size}")
        self.size = size
        self.indices = tuple(range(size))
        self.devices = None if devices is None else tuple(
            torch.device(d) for d in devices)

    def hop(self, ks: List[torch.Tensor], vs: List[torch.Tensor]):
        """Shard ``i`` receives shard ``i - 1``'s K and V."""
        return ks[-1:] + ks[:-1], vs[-1:] + vs[:-1]

    def shift(self, ts: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
        """Place ``i`` receives place ``i - shift``'s tensor (on its own
        device when the ring has devices)."""
        n = self.size
        out = [ts[(i - shift) % n] for i in range(n)]
        if self.devices is not None:
            out = [t.to(d) for t, d in zip(out, self.devices)]
        return out

    def finish(self, out: torch.Tensor, ks, vs) -> torch.Tensor:
        return out


def _post_exchange(t: Optional[torch.Tensor], send_to: Optional[int],
                   recv_from: Optional[int], group,
                   like: Optional[torch.Tensor] = None):
    """Post the send of ``t`` to global rank ``send_to`` and the receive
    from global rank ``recv_from`` in one ``batch_isend_irecv``; returns the
    receive buffer and the requests, which must be waited on before it is
    read (on NCCL the wait orders the current stream after the transfer).
    Either side may be ``None`` (a one-way hop: the pipeline's, whose
    chain has ends; ``like`` then gives the receive buffer's shape and
    dtype); the buffer is ``None`` without a receive."""
    import torch.distributed as dist

    ops, buf = [], None
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, t, send_to, group))
    if recv_from is not None:
        buf = torch.empty_like(t if like is None else like)
        ops.append(dist.P2POp(dist.irecv, buf, recv_from, group))
    return buf, (dist.batch_isend_irecv(ops) if ops else [])


def _exchange(t: torch.Tensor, send_to: int, recv_from: int, group):
    """Send ``t`` to global rank ``send_to`` and return what global rank
    ``recv_from`` sent (:func:`_post_exchange`, waited on)."""
    buf, reqs = _post_exchange(t, send_to, recv_from, group)
    for req in reqs:
        req.wait()
    return buf


class _Hop(torch.autograd.Function):
    """One hop of K and V to the next rank; the backward sends their
    cotangents back to the previous one (the transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, k, v, ring):
        ctx.ring = ring
        buf = _exchange(torch.stack([k, v]), ring.next_rank, ring.prev_rank,
                        ring.group)
        return buf[0], buf[1]

    @staticmethod
    def backward(ctx, g_k, g_v):
        ring = ctx.ring
        g = _exchange(torch.stack([g_k, g_v]), ring.prev_rank,
                      ring.next_rank, ring.group)
        return g[0], g[1], None


class _Sink(torch.autograd.Function):
    """``out`` unchanged, with the last hop's K/V as inputs whose
    cotangent is zero: their hop backwards then run on every rank."""

    @staticmethod
    def forward(ctx, out, k, v):
        ctx.kv = [(t.shape, t.dtype, t.device) for t in (k, v)]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        zeros = [torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.kv]
        return g, zeros[0], zeros[1]


class ProcessGroupRing:
    """One shard a rank: ``ranks`` are the global ranks of this ``data``
    row's ``seq`` subgroup ``group``, in seq order, and ``index`` is this
    rank's place among them."""

    def __init__(self, group, ranks: Sequence[int], index: int):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        if not 0 <= index < self.size:
            raise ValueError(f"seq index {index} outside a ring of "
                             f"{self.size}")
        self.index = index
        self.indices = (index,)
        self.processes = self.size
        self.next_rank = self.rank_at(1)
        self.prev_rank = self.rank_at(-1)

    def rank_at(self, offset: int) -> int:
        """The global rank ``offset`` places along the ring from this one."""
        return self.ranks[(self.index + offset) % self.size]

    def hop(self, ks, vs) -> Tuple[list, list]:
        k, v = _Hop.apply(ks[0].contiguous(), vs[0].contiguous(), self)
        return [k], [v]

    def finish(self, out: torch.Tensor, ks, vs) -> torch.Tensor:
        return _Sink.apply(out, ks[0], vs[0])
