"""Decomposed collective matmuls — the counterpart of
:mod:`tpudist.parallel.overlap`.

The JAX package decomposes an all-gather (or a reduce-scatter) into a chain
of ``lax.ppermute`` hops inside ``shard_map``, each hop moving one chunk
while the previous chunk's matmul runs.  Here an axis is a ring of
:mod:`tpudist_torch.parallel.ring` and the operands are lists, one tensor a
place of the axis this process holds (``ring.indices``):

- the ``model`` axis (:class:`~tpudist_torch.parallel.ring.LocalRing` over
  the devices of one rank, folded onto one card where they repeat): every
  place is in the process and a hop moves each place's chunk to the next
  place's device;
- an axis over the process group (``data``; :class:`~tpudist_torch.
  parallel.ring.ProcessGroupRing`): one place a rank, and a hop is a
  send/receive through ``torch.distributed.batch_isend_irecv`` inside an
  autograd function whose backward sends the cotangent the other way (the
  transpose of ``ppermute``).  Each hop ``s + 1`` is posted before the
  matmul of chunk ``s`` and waited on only where it is consumed, so on NCCL
  the transfer runs beside the matmul (the overlap XLA's scheduler gives
  the JAX chains).

At ring size 1 each function is the plain matmul, as the JAX ones
degenerate at ``n == 1``.  Every hop runs under ``torch.profiler.
record_function(OVERLAP_SCOPE)``, so traces tag the hops as the JAX HLO's
``op_name`` metadata does.

- :func:`ag_matmul` — an all-gather fused into a matmul: ``gather="lhs"``
  (``allgather(x) @ w``, x row-sharded), ``"rhs"`` (``x @ allgather(w)``,
  w column-sharded) and ``"contract"`` (w sharded along the contraction,
  one partial product a hop);
- :func:`matmul_rs` — a matmul feeding a pipelined reduce-scatter ring.

``lhs``/``rhs`` assemble disjoint output chunks: each element is the same
dot product as the monolithic matmul's.  ``contract`` and ``matmul_rs`` sum
one partial product a hop, which reassociates the contraction (the JAX
module's f32 bound, ``rtol <= 1e-5``).  ``mode="bidir"`` sends chunks both
ways round the ring at the same total bytes.

``OVERLAP_MODES`` and :func:`overlap_mode` (the ``TPUDIST_OVERLAP`` knob)
are copied from the JAX module; ``compat_shard_map``, ``compat_pcast`` and
``compat_axis_size`` are shims of JAX's API with no counterpart here.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from tpudist_torch.parallel.ring import (LocalRing, ProcessGroupRing,
                                         _exchange, _post_exchange)

__all__ = ["OVERLAP_MODES", "OVERLAP_SCOPE", "ag_matmul", "axis_ring",
           "matmul_rs", "overlap_mode"]

#: the profiler scope every hop runs under (the JAX ``named_scope``)
OVERLAP_SCOPE = "tpudist_overlap"

#: valid TPUDIST_OVERLAP values
OVERLAP_MODES = ("off", "ring", "bidir")


def overlap_mode(override: Optional[str] = None) -> str:
    """Resolve the collective-matmul overlap mode: ``override`` (a call-site
    argument) wins when given, else the ``TPUDIST_OVERLAP`` knob.  The value
    is stripped and lower-cased; unset, empty, ``0``/``off``/``false``/
    ``no`` and any unrecognised knob value mean ``"off"`` (a mistyped knob
    must not take a job down); an unrecognised explicit argument raises."""
    v = override if override is not None else os.environ.get(
        "TPUDIST_OVERLAP", "")
    v = v.strip().lower()
    if v in ("ring", "bidir"):
        return v
    if override is not None and v not in ("", "0", "off", "false", "no"):
        # explicit call-site arguments are code, not config: fail loud
        raise ValueError(
            f"overlap must be one of {OVERLAP_MODES}, got {override!r}")
    return "off"


def axis_ring(mesh, axis_name: str):
    """The ring of ``mesh``'s axis ``axis_name`` (the port's
    :class:`~tpudist_torch.runtime.mesh.Mesh`): ``model`` a
    :class:`LocalRing` over this rank's devices, ``seq`` the mesh's ring,
    ``data`` a :class:`ProcessGroupRing` over this rank's data group (a
    :class:`LocalRing` of 1 when the axis has one place)."""
    size = int(mesh.shape.get(axis_name, 1))
    if axis_name == "model":
        return LocalRing(size, devices=mesh.devices)
    if axis_name == "seq":
        return mesh.ring if mesh.ring is not None else LocalRing(1)
    if axis_name != "data":
        raise ValueError(f"no ring for a {axis_name!r} axis")
    if size == 1:
        return LocalRing(1)
    import torch.distributed as dist

    group = mesh.data_group
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    return ProcessGroupRing(group, ranks, mesh.coords["data"])


class _Shift(torch.autograd.Function):
    """One hop over a :class:`ProcessGroupRing`: this place's tensor to the
    place ``shift`` along, the one ``shift`` before it received.  The
    forward only posts the transfer (``pending`` keeps the requests and the
    sent tensor until :class:`_Arrive` waits); the backward sends the
    cotangent back the other way."""

    @staticmethod
    def forward(ctx, t, ring, shift, pending):
        ctx.ring, ctx.shift = ring, shift
        send = t.contiguous()
        buf, reqs = _post_exchange(send, ring.rank_at(shift),
                                   ring.rank_at(-shift), ring.group)
        pending.append((reqs, send))
        return buf

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        return (_exchange(g.contiguous(), ring.rank_at(-ctx.shift),
                          ring.rank_at(ctx.shift), ring.group),
                None, None, None)


class _Arrive(torch.autograd.Function):
    """Identity that first waits for the hop that filled ``t``."""

    @staticmethod
    def forward(ctx, t, pending):
        reqs, _ = pending.pop(0)
        for req in reqs:
            req.wait()
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _post(ring, ts: List[torch.Tensor], shift: int):
    """Post one hop of this process's places' tensors ``ts``."""
    with torch.profiler.record_function(OVERLAP_SCOPE):
        if isinstance(ring, ProcessGroupRing):
            pending: list = []
            return [_Shift.apply(ts[0], ring, shift, pending)], pending
        return ring.shift(ts, shift), None


def _arrive(posted) -> List[torch.Tensor]:
    ts, pending = posted
    if pending is None:
        return ts
    return [_Arrive.apply(ts[0], pending)]


def _chain(ring, start: List[torch.Tensor], shift: int, hops: int):
    """``start``, then the states after 1, 2, ..., ``hops`` hops by
    ``shift``.  Each hop is posted before the state it starts from is
    handed out, so the caller's work on that state runs beside it."""
    cur = start
    for s in range(hops + 1):
        nxt = _post(ring, cur, shift) if s < hops else None
        yield cur
        if nxt is not None:
            cur = _arrive(nxt)


def _check_mode(mode: str) -> str:
    if mode not in ("ring", "bidir"):
        raise ValueError(f"mode must be 'ring' or 'bidir', got {mode!r}")
    return mode


def _places(ring, x, w):
    """The operands as lists of this process's places (a tensor stands for
    the one place of a process-group ring), and whether to unwrap."""
    single = torch.is_tensor(x)
    xs = [x] if single else list(x)
    ws = [w] if torch.is_tensor(w) else list(w)
    want = len(ring.indices)
    if len(xs) != want or len(ws) != want:
        raise ValueError(f"this process holds {want} place(s) of the ring, "
                         f"got {len(xs)} x and {len(ws)} w operand(s)")
    return xs, ws, single


def ag_matmul(x, w, *, axis, mode: str = "ring", gather: str = "lhs"):
    """All-gather fused into a matmul over the ring ``axis``: ``x`` and
    ``w`` are this process's places' local operands (lists in
    ``axis.indices`` order, or one tensor each for a ring with one place a
    process), and so is the result.

    - ``"lhs"``: x ``[m, k]`` is a row shard of a ``[m·n, k]`` global;
      returns ``allgather(x) @ w: [m·n, f]``;
    - ``"rhs"``: w ``[k, f]`` is a column shard of ``[k, f·n]``; returns
      ``x @ allgather(w): [m, f·n]``;
    - ``"contract"``: w ``[k, f]`` is a contraction shard of ``[k·n, f]``
      and x holds the whole ``[m, k·n]``; returns ``x @ allgather(w)``,
      one partial product a hop.

    For ``rhs``/``contract`` x may carry leading dims (the decode step's
    ``[slots, 1, d]``), flattened into the rows and restored; ``lhs``
    stays 2-D (its rows are the sharded axis)."""
    _check_mode(mode)
    if gather not in ("lhs", "rhs", "contract"):
        raise ValueError(
            f"gather must be 'lhs', 'rhs' or 'contract', got {gather!r}")
    xs, ws, single = _places(axis, x, w)
    lead = xs[0].shape[:-2]
    if lead:
        if gather == "lhs":
            raise ValueError(
                "gather='lhs' requires 2-D x (the row axis is the sharded "
                f"global axis); got shape {tuple(xs[0].shape)} — flatten "
                "explicitly or use gather='rhs'/'contract'")
        xs = [t.reshape(-1, t.shape[-1]) for t in xs]
    n = axis.size
    if n == 1:
        outs = [a @ b for a, b in zip(xs, ws)]
    elif gather == "lhs":
        outs = _ag_lhs_rhs(xs, ws, axis, mode, lhs=True)
    elif gather == "rhs":
        outs = _ag_lhs_rhs(xs, ws, axis, mode, lhs=False)
    else:
        outs = _ag_contract(xs, ws, axis, mode)
    if lead:
        m = x.shape[-2] if single else x[0].shape[-2]
        outs = [o.reshape(*lead, m, o.shape[-1]) for o in outs]
    return outs[0] if single else outs


def _ag_lhs_rhs(xs, ws, ring, mode, *, lhs: bool):
    """The gathered operand (x for lhs, w for rhs) travels; each place
    computes one output chunk a state, assembled in source order."""
    n, places = ring.size, ring.indices
    moving = xs if lhs else ws
    chunks = [dict() for _ in places]

    def emit(state, offset):
        # after ``offset`` hops (+1 direction) place i holds place
        # (i - offset)'s operand
        for j, i in enumerate(places):
            prod = state[j] @ ws[j] if lhs else xs[j] @ state[j]
            chunks[j][(i - offset) % n] = prod

    if mode == "ring":
        for s, state in enumerate(_chain(ring, moving, +1, n - 1)):
            emit(state, s)
    else:
        # bidir: the forward buffer travels +1 (delivers i - s), the
        # backward one -1 (delivers i + s); floor((n-1)/2) full steps, plus
        # one forward half step when n is even
        steps = (n - 1) // 2
        fwd = _chain(ring, moving, +1, steps + (n % 2 == 0))
        bwd = _chain(ring, moving, -1, steps)
        own = next(fwd)
        next(bwd)
        emit(own, 0)
        for s in range(1, steps + 1):
            sf, sb = next(fwd), next(bwd)
            emit(sf, s)
            emit(sb, -s)
        if n % 2 == 0:
            emit(next(fwd), n // 2)
    dim = 0 if lhs else 1
    return [torch.cat([c[k] for k in range(n)], dim=dim) for c in chunks]


def _ag_contract(xs, ws, ring, mode):
    n, places = ring.size, ring.indices
    k = ws[0].shape[0]
    if xs[0].shape[1] != k * n:
        raise ValueError(
            f"gather='contract' needs x.shape[1] == {k * n} "
            f"(n={n} shards of k={k}), got {xs[0].shape[1]}")

    def part(j, src, wt):
        return xs[j][:, src * k:(src + 1) * k] @ wt

    if mode == "ring":
        accs = [None] * len(places)
        for s, state in enumerate(_chain(ring, ws, +1, n - 1)):
            for j, i in enumerate(places):
                p = part(j, (i - s) % n, state[j])
                accs[j] = p if s == 0 else accs[j] + p
        return accs
    # bidir: column halves of w travel opposite ways; each accumulator sees
    # every contraction shard once
    fh = ws[0].shape[1] // 2
    if fh == 0:
        raise ValueError("bidir contract-gather needs w.shape[1] >= 2")
    fwd = _chain(ring, [w[:, :fh] for w in ws], +1, n - 1)
    bwd = _chain(ring, [w[:, fh:] for w in ws], -1, n - 1)
    acc_f = [None] * len(places)
    acc_b = [None] * len(places)
    for s, (sf, sb) in enumerate(zip(fwd, bwd)):
        for j, i in enumerate(places):
            pf = part(j, (i - s) % n, sf[j])
            pb = part(j, (i + s) % n, sb[j])
            acc_f[j] = pf if s == 0 else acc_f[j] + pf
            acc_b[j] = pb if s == 0 else acc_b[j] + pb
    return [torch.cat([a, b], dim=1) for a, b in zip(acc_f, acc_b)]


def matmul_rs(x, w, *, axis, mode: str = "ring", pad_rows: bool = False):
    """Matmul feeding a pipelined reduce-scatter ring over ``axis``:
    ``psum_scatter(x @ w)`` over the rows.  ``x [m, k]`` (k this place's
    shard of the contraction) and ``w [k, f]`` are this process's places'
    operands (lists, or one tensor each, as :func:`ag_matmul`); each place
    returns its fully reduced ``[m/n, f]`` row chunk: each ring step
    computes one row chunk of the partial product and adds it to the
    accumulator arriving from the neighbour.  ``m`` must divide by the ring
    size unless ``pad_rows``, which zero-pads the rows to the next multiple
    (each place then returns its chunk of the padded result)."""
    _check_mode(mode)
    xs, ws, single = _places(axis, x, w)
    n, places = axis.size, axis.indices
    if n == 1:
        outs = [a @ b for a, b in zip(xs, ws)]
        return outs[0] if single else outs
    m = xs[0].shape[0]
    if m % n:
        if not pad_rows:
            raise ValueError(
                f"matmul_rs needs rows {m} divisible by ring {n} "
                "(pass pad_rows=True for the padded decode-shaped variant)")
        pad = n - m % n
        xs = [torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
              for t in xs]
        m += pad
    mloc = m // n

    def rows(j, c, wt):
        return xs[j][c * mloc:(c + 1) * mloc] @ wt

    if mode == "ring":
        # chunk c starts at place c + 1 and travels +1, landing summed on c;
        # the accumulator's hop runs beside the next chunk's matmul
        acc = [rows(j, (i - 1) % n, ws[j]) for j, i in enumerate(places)]
        for s in range(1, n):
            posted = _post(axis, acc, +1)
            parts = [rows(j, (i - 1 - s) % n, ws[j])
                     for j, i in enumerate(places)]
            acc = [a + p for a, p in zip(_arrive(posted), parts)]
        return acc[0] if single else acc
    fh = ws[0].shape[1] // 2
    if fh == 0:
        raise ValueError("bidir matmul_rs needs w.shape[1] >= 2")
    # both halves' hops are posted before either half's next chunk matmul
    wf = [t[:, :fh] for t in ws]
    wb = [t[:, fh:] for t in ws]
    acc_f = [rows(j, (i - 1) % n, wf[j]) for j, i in enumerate(places)]
    acc_b = [rows(j, (i + 1) % n, wb[j]) for j, i in enumerate(places)]
    for s in range(1, n):
        pf = _post(axis, acc_f, +1)
        pb = _post(axis, acc_b, -1)
        parts_f = [rows(j, (i - 1 - s) % n, wf[j])
                   for j, i in enumerate(places)]
        parts_b = [rows(j, (i + 1 + s) % n, wb[j])
                   for j, i in enumerate(places)]
        acc_f = [a + p for a, p in zip(_arrive(pf), parts_f)]
        acc_b = [a + p for a, p in zip(_arrive(pb), parts_b)]
    outs = [torch.cat([a, b], dim=1) for a, b in zip(acc_f, acc_b)]
    return outs[0] if single else outs
