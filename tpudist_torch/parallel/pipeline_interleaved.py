"""Interleaved (virtual-stage) 1F1B pipeline schedule — the counterpart of
:mod:`tpudist.parallel.pipeline_interleaved`.

:mod:`tpudist_torch.parallel.pipeline` gives GPipe (O(M) residuals) and
non-interleaved 1F1B (O(S) residuals); both pay the fill bubble of about
``2·(D−1)`` stage units a step on ``D`` devices.  Here each device holds
``V`` depth-strided chunks (device ``d`` owns global stages ``{c·D + d}``),
so a microbatch makes ``V`` laps around the device ring through chunks
``1/V`` the size (Narayanan et al. 2021, Megatron's interleaved schedule).

The schedule comes from the JAX module's framework-free discrete-event
simulator, copied here unchanged (numpy and ``heapq``; the tests hold its
tables equal to JAX's): warmup-capped 1F1B with one forward and one
backward unit a device a tick, baked into ``[T, D]`` integer tables, and
activation/cotangent banks whose slots an offline interval allocation
assigns.  :func:`pipeline_interleaved_shard` walks the tables tick by tick
over this process's devices of the ``stage`` axis: a dead unit computes and
launches nothing, and both sides of every hop read the same table rows
(``act_recv_valid``, ``cot_recv_valid``), so a send never lacks its
receive (:func:`~tpudist_torch.parallel.pipeline.hop`).  The hops use the
full ring, wrap included: leaving device ``D−1`` re-enters device 0 one
chunk deeper.  The backward recomputes each chunk's forward from its saved
input, as the non-interleaved schedule does.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from tpudist_torch.parallel.pipeline import (_add, _finish, _head, _leaves,
                                             _like, _data_mean, _vjp, hop)

__all__ = ["InterleavedSchedule", "deinterleave_block_params",
           "format_timeline", "interleave_block_params",
           "interleaved_schedule", "pipeline_interleaved_shard"]

_INF = 10**9


def _fwd_order(D: int, V: int, M: int):
    """Per-device forward unit order: groups of D microbatches, each
    group walked through the V local chunks (Megatron's grouping)."""
    return [(m, c)
            for g0 in range(0, M, D)
            for c in range(V)
            for m in range(g0, g0 + D)]


def _bwd_order(D: int, V: int, M: int):
    return [(m, c)
            for g0 in range(0, M, D)
            for c in range(V - 1, -1, -1)
            for m in range(g0, g0 + D)]


def _alloc_slots(intervals):
    """Offline interval register allocation.

    ``intervals``: ``[(write_tick, last_read_tick, key), ...]``.  Returns
    ``(assignment dict key->slot, depth)``.  A slot is reusable from its
    last read tick onward because the scan body performs ALL bank reads
    before any bank write within a tick."""
    assign = {}
    free: list = []  # heap of (available_from_tick, slot)
    next_slot = 0
    for w, r, key in sorted(intervals, key=lambda iv: (iv[0], iv[1])):
        if free and free[0][0] <= w:
            _, slot = heapq.heappop(free)
        else:
            slot, next_slot = next_slot, next_slot + 1
        assign[key] = slot
        heapq.heappush(free, (r, slot))
    return assign, max(next_slot, 1)


@dataclass(frozen=True)
class InterleavedSchedule:
    """Static schedule tables, all ``[total_ticks, n_dev]`` int32."""

    n_dev: int
    n_chunks: int
    n_micro: int
    total_ticks: int
    act_depth: int
    cot_depth: int
    tables: dict = field(repr=False)

    @property
    def bubble_ticks(self) -> int:
        """Ticks beyond the per-device useful work (M·V units)."""
        return self.total_ticks - self.n_micro * self.n_chunks


def interleaved_schedule(n_dev: int, n_chunks: int,
                         n_micro: int) -> InterleavedSchedule:
    """Simulate warmup-capped interleaved 1F1B and bake the tables.

    Raises if the microbatch count does not divide into device-sized
    groups (``M % D != 0``, the Megatron grouping constraint) or if the
    simulation fails to converge (a schedule bug, not a user error).
    """
    D, V, M = n_dev, n_chunks, n_micro
    if M % D:
        raise ValueError(f"num_microbatches {M} must be a multiple of the "
                         f"pipeline width {D} for the interleaved schedule")
    S = D * V
    fq = _fwd_order(D, V, M)
    bq = _bwd_order(D, V, M)
    n_units = M * V
    # Forward admission is bounded two ways (each tick runs one fwd AND
    # one bwd unit, the pair-tick convention of pipeline_1f1b_shard):
    # per chunk, in-flight <= residual lifetime 2(S-1-g)+1 — the same
    # bound the non-interleaved ring depth encodes, so V=1 reproduces its
    # no-stall timeline exactly; per device, total in-flight <=
    # (V-1)·D + 2(D-d) — the Megatron interleaved warmup depth, keeping
    # residual memory O(V·D), constant in M.  A too-small device cap
    # deadlocks the sim; retry with slack and fail loudly if it persists.
    for slack in range(0, 4):
        dev_cap = [(V - 1) * D + 2 * (D - d) + slack for d in range(D)]
        sim = _simulate(D, V, S, M, fq, bq, n_units, dev_cap)
        if sim is not None:
            break
    else:
        raise RuntimeError("interleaved schedule simulation did not "
                           f"converge for D={D} V={V} M={M}")
    fwd_done, bwd_done, fwd_events, bwd_events, T = sim

    # ---- offline slot allocation ----
    act_iv = {d: [] for d in range(D)}   # consumer-keyed activation slots
    cot_iv = {d: [] for d in range(D)}   # consumer-keyed cotangent slots
    for (t, d, m, c) in fwd_events:
        g = c * D + d
        if g < S - 1:
            rd, cc = (g + 1) % D, (g + 1) // D
            act_iv[rd].append((t, bwd_done[(rd, m, cc)], (m, cc)))
        else:
            # loss cotangent, produced on-device at the fwd tick
            cot_iv[d].append((t, bwd_done[(d, m, c)], (m, c)))
    for (t, d, m, c) in bwd_events:
        g = c * D + d
        if g > 0:
            pd, pc = (g - 1) % D, (g - 1) // D
            cot_iv[pd].append((t, bwd_done[(pd, m, pc)], (m, pc)))
    act_assign, cot_assign = {}, {}
    act_depth = cot_depth = 1
    for d in range(D):
        a, da = _alloc_slots(act_iv[d])
        k, dk = _alloc_slots(cot_iv[d])
        act_assign[d], cot_assign[d] = a, k
        act_depth, cot_depth = max(act_depth, da), max(cot_depth, dk)

    # ---- tables ----
    def tab():
        return np.zeros((T, D), np.int32)

    t_ = {name: tab() for name in (
        "fwd_valid", "fwd_m", "fwd_c", "fwd_from_x", "fwd_slot",
        "take_loss", "loss_cot_valid", "loss_cot_slot",
        "act_recv_valid", "act_recv_slot",
        "bwd_valid", "bwd_m", "bwd_c", "bwd_from_x", "bwd_act_slot",
        "bwd_cot_slot", "take_dx",
        "cot_recv_valid", "cot_recv_slot",
    )}
    for (t, d, m, c) in fwd_events:
        g = c * D + d
        t_["fwd_valid"][t, d] = 1
        t_["fwd_m"][t, d] = m
        t_["fwd_c"][t, d] = c
        if g == 0:
            t_["fwd_from_x"][t, d] = 1
        else:
            t_["fwd_slot"][t, d] = act_assign[d][(m, c)]
        if g == S - 1:
            t_["take_loss"][t, d] = 1
            t_["loss_cot_valid"][t, d] = 1
            t_["loss_cot_slot"][t, d] = cot_assign[d][(m, c)]
        else:
            rd, cc = (g + 1) % D, (g + 1) // D
            t_["act_recv_valid"][t, rd] = 1
            t_["act_recv_slot"][t, rd] = act_assign[rd][(m, cc)]
    for (t, d, m, c) in bwd_events:
        g = c * D + d
        t_["bwd_valid"][t, d] = 1
        t_["bwd_m"][t, d] = m
        t_["bwd_c"][t, d] = c
        t_["bwd_cot_slot"][t, d] = cot_assign[d][(m, c)]
        if g == 0:
            t_["bwd_from_x"][t, d] = 1
            t_["take_dx"][t, d] = 1
        else:
            t_["bwd_act_slot"][t, d] = act_assign[d][(m, c)]
        if g > 0:
            pd, pc = (g - 1) % D, (g - 1) // D
            t_["cot_recv_valid"][t, pd] = 1
            t_["cot_recv_slot"][t, pd] = cot_assign[pd][(m, pc)]
    return InterleavedSchedule(
        n_dev=D, n_chunks=V, n_micro=M, total_ticks=T,
        act_depth=act_depth, cot_depth=cot_depth, tables=t_)


def _simulate(D, V, S, M, fq, bq, n_units, dev_cap):
    """One capped-greedy pass; returns None on deadlock."""
    fwd_done, bwd_done = {}, {}
    fi, bi = [0] * D, [0] * D
    chunk_fly = {(d, c): 0 for d in range(D) for c in range(V)}
    fwd_events, bwd_events = [], []
    bound = 8 * S + 4 * n_units + 64
    t = 0
    while any(fi[d] < n_units or bi[d] < n_units for d in range(D)):
        if t > bound:
            return None
        progressed = False
        plan_f = []
        for d in range(D):
            if fi[d] >= n_units or (fi[d] - bi[d]) >= dev_cap[d]:
                continue
            m, c = fq[fi[d]]
            g = c * D + d
            # +2, not +1: the fwd plan runs before the same tick's bwd
            # plan, so the counter still includes a unit whose backward
            # retires THIS tick (the F half of an F+B pair-tick must not
            # be blocked by it).  True residual memory is measured by the
            # offline allocator from actual lifetimes, not this cap.
            if chunk_fly[(d, c)] >= 2 * (S - 1 - g) + 2:
                continue
            if g == 0:
                ready = True
            else:
                pd, pc = (g - 1) % D, (g - 1) // D
                ready = fwd_done.get((pd, m, pc), _INF) <= t - 1
            if ready:
                plan_f.append((d, m, c))
        for d, m, c in plan_f:
            fwd_done[(d, m, c)] = t
            fi[d] += 1
            chunk_fly[(d, c)] += 1
            fwd_events.append((t, d, m, c))
            progressed = True
        plan_b = []
        for d in range(D):
            if bi[d] >= n_units:
                continue
            m, c = bq[bi[d]]
            g = c * D + d
            if g == S - 1:
                ready = fwd_done.get((d, m, c), _INF) <= t - 1
            else:
                sd, sc = (g + 1) % D, (g + 1) // D
                ready = (bwd_done.get((sd, m, sc), _INF) <= t - 1
                         and fwd_done.get((d, m, c), _INF) <= t)
            if ready:
                plan_b.append((d, m, c))
        for d, m, c in plan_b:
            bwd_done[(d, m, c)] = t
            bi[d] += 1
            chunk_fly[(d, c)] -= 1
            bwd_events.append((t, d, m, c))
            progressed = True
        if not progressed:
            # The done-maps only grow when a unit commits, so a tick with
            # zero commits can never unblock a later tick: deadlock.
            return None
        t += 1
    return fwd_done, bwd_done, fwd_events, bwd_events, t


def _stage_perm(s_total: int, n_dev: int) -> torch.Tensor:
    v = s_total // n_dev
    return torch.tensor([(j % v) * n_dev + j // v for j in range(s_total)])


def _stack_size(stacked) -> int:
    return pytree.tree_leaves(stacked)[0].shape[0]


def interleave_block_params(stacked, n_dev: int):
    """Permute a ``[S_total, ...]`` stage stack (a pytree of tensors) into
    the device-major interleaved layout: position ``j = d·V + c`` holds
    global stage ``c·D + d``, so splitting the leading axis over ``D``
    devices hands device ``d`` its depth-strided chunks in local order."""
    s_total = _stack_size(stacked)
    if s_total % n_dev:
        raise ValueError(f"stage stack of {s_total} does not split over "
                         f"{n_dev} devices")
    perm = _stage_perm(s_total, n_dev)
    return pytree.tree_map(
        lambda a: a.index_select(0, perm.to(a.device)), stacked)


def deinterleave_block_params(stacked, n_dev: int):
    """Inverse of :func:`interleave_block_params` (checkpoint interop)."""
    s_total = _stack_size(stacked)
    inv = torch.argsort(_stage_perm(s_total, n_dev))
    return pytree.tree_map(
        lambda a: a.index_select(0, inv.to(a.device)), stacked)


def pipeline_interleaved_shard(
    stage_params: Sequence,
    out_params,
    x_microbatches: torch.Tensor,
    aux_microbatches,
    *,
    stage_fn,
    loss_fn,
    schedule: InterleavedSchedule,
    stages,
    data_group=None,
):
    """The interleaved 1F1B schedule over this process's places of
    ``stages`` (the mesh's stage chain, used as a ring).  Same contract as
    :func:`tpudist_torch.parallel.pipeline.pipeline_1f1b_shard` except that
    each place's entry of ``stage_params`` is the list of its ``V`` chunks'
    parameters, in local chunk order (the :func:`interleave_block_params`
    layout), and ``schedule`` carries the static tables.  Returns
    ``(loss_sum, chunk_grads, out_grads, dx_microbatches)``: ``chunk_grads``
    one list of ``V`` gradient trees a place; the rest as 1F1B's."""
    D, V = schedule.n_dev, schedule.n_chunks
    if stages.size != D:
        raise ValueError(f"schedule built for {D} devices, the stage axis "
                         f"has {stages.size}")
    num_micro = schedule.n_micro
    if x_microbatches.shape[0] != num_micro:
        raise ValueError(f"schedule built for {num_micro} microbatches, "
                         f"got {x_microbatches.shape[0]}")
    places = list(stages.indices)
    if len(stage_params) != len(places):
        raise ValueError(f"{len(stage_params)} stage params for the "
                         f"{len(places)} places of this process")
    for chunks in stage_params:
        if len(chunks) != V:
            raise ValueError(
                f"stage_params carry {len(chunks)} chunks per device but "
                f"the schedule was built for n_chunks={V} — stack with "
                f"stack_block_params_interleaved(params, n_dev, n_chunks)")
    params = dict(zip(places, stage_params))
    like = x_microbatches[0]
    dev = like.device
    tabs = schedule.tables
    act_bank: Dict[int, List[Optional[torch.Tensor]]] = {
        d: [None] * schedule.act_depth for d in places}
    cot_bank: Dict[int, List[Optional[torch.Tensor]]] = {
        d: [None] * schedule.cot_depth for d in places}
    dx = torch.zeros_like(x_microbatches) if 0 in places else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    og_acc = None
    cg = {d: [None] * V for d in places}
    for t in range(schedule.total_ticks):
        r = {k: v[t] for k, v in tabs.items()}
        asends, csends, loss_cots = {}, {}, {}
        for d in places:
            # ---- forward unit (reads the banks; no writes yet) ----
            if r["fwd_valid"][d]:
                fm, fc = int(r["fwd_m"][d]), int(r["fwd_c"][d])
                a_in = (x_microbatches[fm] if r["fwd_from_x"][d]
                        else act_bank[d][r["fwd_slot"][d]])
                with torch.no_grad():
                    a_out = stage_fn(params[d][fc], a_in)
                if r["take_loss"][d]:
                    loss, d_og, d_act = _head(loss_fn, out_params, a_out,
                                              aux_microbatches[fm])
                    loss_acc = loss_acc + loss.to(dev)
                    og_acc = d_og if og_acc is None else [
                        a + g for a, g in zip(og_acc, d_og)]
                    loss_cots[d] = d_act
                if tabs["act_recv_valid"][t, (d + 1) % D]:
                    asends[d] = a_out
            # ---- backward unit (reads the banks before any write) ----
            if r["bwd_valid"][d]:
                bm, bc = int(r["bwd_m"][d]), int(r["bwd_c"][d])
                a_res = (x_microbatches[bm] if r["bwd_from_x"][d]
                         else act_bank[d][r["bwd_act_slot"][d]])
                cot_in = cot_bank[d][r["bwd_cot_slot"][d]]
                dp, da = _vjp(stage_fn, params[d][bc], a_res, cot_in)
                cg[d][bc] = _add(cg[d][bc], dp, _leaves(params[d][bc]))
                if r["take_dx"][d]:
                    dx[bm] = da
                if tabs["cot_recv_valid"][t, (d - 1) % D]:
                    csends[d] = da
        # ---- hops + bank writes (after ALL reads) ----
        got = hop(stages, asends,
                  [d for d in places if r["act_recv_valid"][d]], 1, like)
        for d, msg in got.items():
            act_bank[d][r["act_recv_slot"][d]] = msg
        got = hop(stages, csends,
                  [d for d in places if r["cot_recv_valid"][d]], -1, like)
        for d, msg in got.items():
            cot_bank[d][r["cot_recv_slot"][d]] = msg
        for d, d_act in loss_cots.items():
            cot_bank[d][r["loss_cot_slot"][d]] = d_act
    loss_sum, og = _finish(loss_acc, og_acc, out_params, stages, data_group)
    grads = []
    for d in places:
        per = []
        for c in range(V):
            g = cg[d][c] if cg[d][c] is not None else [
                torch.zeros_like(p) for p in _leaves(params[d][c])]
            per.append(_like(params[d][c], _data_mean(g, data_group)))
        grads.append(per)
    return loss_sum, grads, og, dx


def format_timeline(schedule: InterleavedSchedule) -> str:
    """ASCII timeline of the schedule (one row per device, one column per
    tick, ``F<m>``/``B<m>``/``·``) — the at-a-glance view of warmup,
    steady 1F1B pairs, and drain.  ``python -m
    tpudist_torch.parallel.pipeline_interleaved D V M`` prints it."""
    t = schedule.tables
    rows = []
    for d in range(schedule.n_dev):
        cells = []
        for tick in range(schedule.total_ticks):
            f = (f"F{t['fwd_m'][tick, d]}.{t['fwd_c'][tick, d]}"
                 if t["fwd_valid"][tick, d] else "")
            b = (f"B{t['bwd_m'][tick, d]}.{t['bwd_c'][tick, d]}"
                 if t["bwd_valid"][tick, d] else "")
            cells.append(f"{f}{'+' if f and b else ''}{b}" or "·")
        rows.append(f"dev{d}: " + " ".join(c.ljust(9) for c in cells))
    head = (f"D={schedule.n_dev} V={schedule.n_chunks} M={schedule.n_micro}"
            f"  ticks={schedule.total_ticks}"
            f" (bubble {schedule.bubble_ticks})"
            f"  act_bank={schedule.act_depth} cot_bank={schedule.cot_depth}")
    return "\n".join([head] + rows)


if __name__ == "__main__":  # pragma: no cover - debug CLI
    import sys as _sys

    d_, v_, m_ = (int(x) for x in _sys.argv[1:4])
    print(format_timeline(interleaved_schedule(d_, v_, m_)))
