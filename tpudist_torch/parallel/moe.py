"""Expert parallelism: top-k routed MoE (k = 1 Switch, k > 1 Mixtral/GShard)
over the ``model`` axis — the counterpart of :mod:`tpudist.parallel.moe`.

The semantics are the JAX module's: routing probabilities in f32 whatever
the compute dtype, top-``k`` experts a token (ties to the lower expert
index, as ``lax.top_k``), the ``k > 1`` gates renormalised to sum 1,
capacity queues filled choice-major (every token's first choice before any
second choice), ``capacity = int(capacity_factor·k·tokens/n_experts + 0.5)``
over this data shard's tokens, an assignment past its expert's capacity
dropped (its output zero), and :class:`MoEStats` with the differentiable
Switch/GShard balance loss.

What differs is the form.  The JAX body builds dense one-hot
``[tokens, experts, capacity]`` dispatch and combine tensors and moves the
expert rows with one ``all_to_all`` each way.  At the LM's width (16,384
tokens, 8 experts, top-2, capacity 5120) those tensors are 2.7–5.4 GB a
layer in f32, more than the card holds once the backward keeps them for 8
layers.  Here the same values come from indices: each kept assignment
copies its token into its ``(expert, slot)`` row of an ``[experts·capacity,
d]`` buffer (a slot receives one token or none: the einsum's sum of ones
and zeros), and the combine gathers each assignment's expert row, weights
it by its gate (cast to the compute dtype, as the JAX combine tensor is)
and sums a token's ``k`` rows in f32.  Dropped assignments point at one
spare zero row.

The ``model`` axis is the devices of one rank (:mod:`tpudist_torch.runtime.
mesh`): expert ``e`` runs on ``devices[e]``, one expert a place, and its
rows travel there and back (the ``all_to_all`` inside a rank, a copy or
nothing when the places fold onto one card).  In JAX every model place
routes the same tokens, the batch being replicated over the axis; here a
rank routes its tokens once and computes each expert's rows once, which
gives the JAX values and gradients without ``n`` identical copies.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from tpudist_torch.runtime.mesh import AXIS_DATA, AXIS_MODEL

__all__ = ["ExpertFn", "MoEStats", "make_moe", "moe_shard"]

#: ``(expert_params, tokens [rows, d]) -> [rows, d]``
ExpertFn = Callable[[dict, torch.Tensor], torch.Tensor]


class MoEStats(NamedTuple):
    """Routing observability plus the differentiable balance loss.  At
    ``k > 1`` the fractions are over the ``k·tokens`` assignments."""

    dropped_fraction: torch.Tensor  # scalar: assignments past capacity
    expert_load: torch.Tensor  # [n_experts]: fraction of assignments
    balance_loss: torch.Tensor  # scalar: Switch/GShard aux (1.0 = uniform)


class Dispatch(NamedTuple):
    """Where each of the ``k·tokens`` assignments (choice-major: flat index
    ``c·tokens + t``) goes: its ``slot`` in the ``[experts·capacity + 1,
    d]`` buffer (the last row for a dropped one) and its ``weight`` (the
    gate, 0 when dropped)."""

    slot: torch.Tensor  # [k·t] int64
    weight: torch.Tensor  # [k·t] f32
    token: torch.Tensor  # [k·t] int64


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values and their
    indices, ties to the lower index (``argmax`` returns the first)."""
    left = probs.detach().clone()
    vals, idx = [], []
    for _ in range(k):
        i = left.argmax(dim=-1, keepdim=True)
        idx.append(i)
        vals.append(probs.gather(-1, i))
        left.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


def _topk_dispatch(router_logits: torch.Tensor, n_experts: int,
                   capacity: int, k: int = 1):
    """The :class:`Dispatch` of top-``k`` routing and its
    :class:`MoEStats` (the JAX ``_topk_dispatch``, in index form).  The
    balance loss is ``n_experts · Σ_e f_e · P_e`` with ``f_e`` the fraction
    of assignments to expert ``e`` and ``P_e`` its mean router probability,
    differentiable through ``P_e``."""
    t = router_logits.shape[0]
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)  # [t, k]
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    # choice-major: all first choices lead
    flat_idx = expert_idx.t().reshape(-1)
    one_hot = F.one_hot(flat_idx, n_experts).to(torch.int32)
    # each assignment's place in its expert's queue: a running count down
    # the expert's column, scanned along the contiguous axis (a scan down
    # dim 0 of k·t rows and 8 columns runs as 8 slow serial passes)
    pos = (one_hot.t().cumsum(1, dtype=torch.int32).t() * one_hot).sum(
        -1) - 1
    kept = pos < capacity
    spare = n_experts * capacity
    slot = torch.where(kept, flat_idx * capacity + pos,
                       torch.full_like(pos, spare))
    weight = gate_vals.t().reshape(-1) * kept
    token = torch.arange(k * t, device=flat_idx.device) % t
    load = one_hot.float().mean(0)
    stats = MoEStats(
        dropped_fraction=1.0 - kept.float().mean(),
        expert_load=load,
        balance_loss=n_experts * (load * probs.mean(0)).sum())
    return Dispatch(slot, weight, token), stats


def moe_shard(params: dict, x: torch.Tensor, *, expert_fn: ExpertFn,
              capacity_factor: float = 1.25,
              devices: Optional[Sequence] = None, k: int = 1):
    """The MoE layer over this rank's ``x [tokens, d]``: ``params =
    {'router': [d, E], 'experts': {leaves with a leading expert axis}}``
    (or a leaf as the list of its ``E`` experts' tensors, each where it
    lives: the tensor-parallel block's expert shards), expert ``e`` run on
    ``devices[e]`` (default: ``x``'s device).  Returns ``(y [tokens, d],
    MoEStats)``."""
    n_experts = params["router"].shape[1]
    devices = ([x.device] * n_experts if devices is None
               else [torch.device(d) for d in devices])
    if len(devices) != n_experts:
        raise ValueError(f"{n_experts} experts over a model axis of "
                         f"{len(devices)} (one expert a place)")
    tokens, d = x.shape
    capacity = int(capacity_factor * k * tokens / n_experts + 0.5)
    disp, stats = _topk_dispatch(x @ params["router"], n_experts, capacity,
                                 k=k)
    # each slot receives one token or none; the dropped ones land on the
    # spare last row, which is never read
    buf = x.new_zeros(n_experts * capacity + 1, d).index_copy(
        0, disp.slot, x.index_select(0, disp.token))
    # one unbind each: its backward stacks the experts' gradients once,
    # where indexing each expert would add a zero-filled gradient of the
    # whole stack per expert
    rows = buf[:n_experts * capacity].view(n_experts, capacity, d).unbind(0)
    stacks = {name: leaf.unbind(0) if torch.is_tensor(leaf) else leaf
              for name, leaf in params["experts"].items()}
    outs = []
    for e, dev in enumerate(devices):
        expert = {name: st[e].to(dev) for name, st in stacks.items()}
        outs.append(expert_fn(expert, rows[e].to(dev)).to(x.device))
    outs.append(x.new_zeros(1, d))
    expert_out = torch.cat(outs)
    # the JAX combine tensor is cast to the compute dtype before its
    # product; a token's k rows are summed in f32, rounded once
    w = disp.weight.to(x.dtype).float()
    picked = expert_out.index_select(0, disp.slot).float() * w[:, None]
    y = picked.view(k, tokens, d).sum(0).to(x.dtype)
    return y, stats


def _data_mean(stats: MoEStats, group, size: int) -> MoEStats:
    """Each statistic's mean over the ``data`` group (one all-reduce).  The
    balance loss keeps this rank's gradient under the mean's value: the
    data-parallel average of the ranks' gradients is then the gradient of
    the mean, as the JAX ``pmean`` gives."""
    import torch.distributed as dist

    bal = stats.balance_loss
    flat = torch.cat([stats.dropped_fraction.reshape(1),
                      stats.expert_load, bal.reshape(1)]).detach()
    dist.all_reduce(flat, group=group)
    flat = flat / size
    return MoEStats(flat[0], flat[1:-1], bal + (flat[-1] - bal).detach())


def make_moe(mesh, expert_fn: ExpertFn, *, axis_name: str = AXIS_MODEL,
             batch_axis: Optional[str] = None,
             capacity_factor: float = 1.25, k: int = 1):
    """The MoE layer over ``mesh`` (the port's mesh): ``moe(params, x) ->
    (y, MoEStats)`` with ``params['experts']`` stacked ``[n_experts,
    ...]``, one expert a place of the ``model`` axis (``n_experts`` must
    equal its size), ``x [tokens, d]`` this rank's tokens.  With
    ``batch_axis='data'`` the rank's tokens are its shard of the batch and
    the stats are averaged over the ``data`` group, as the JAX layer's
    ``pmean``; without it they are this rank's."""
    if axis_name != AXIS_MODEL:
        raise ValueError(f"experts run over the {AXIS_MODEL!r} axis (the "
                         f"devices of a rank), not {axis_name!r}")
    if batch_axis not in (None, AXIS_DATA):
        raise ValueError(f"batch_axis must be None or 'data', got "
                         f"{batch_axis!r}")
    n = int(mesh.shape.get(axis_name, 1))
    devices = tuple(mesh.devices)
    data = int(mesh.shape.get(AXIS_DATA, 1)) if batch_axis else 1
    group = getattr(mesh, "data_group", None)

    def moe(params: dict, x: torch.Tensor):
        if params["router"].shape[1] != n:
            raise ValueError(f"{params['router'].shape[1]} experts over a "
                             f"{axis_name} axis of {n}: one expert a place")
        y, stats = moe_shard(params, x, expert_fn=expert_fn,
                             capacity_factor=capacity_factor,
                             devices=devices, k=k)
        if data > 1:
            stats = _data_mean(stats, group, data)
        return y, stats

    return moe
