"""The gated hot-swap — the counterpart of :mod:`tpudist.distill.swap`:
score a distilled candidate on held-out capture, swap into the engine ONLY
on a measured win.

The gate's two invariants:

- **Measured, with hysteresis** — the candidate must beat the BETTER of
  (a) the serving draft re-scored on the SAME held-out slice and (b) the
  serving draft's live acceptance from ``spec_stats()``, by at least
  ``TPUDIST_DISTILL_SWAP_MARGIN``.  Scoring the serving weights on the
  holdout kills the distribution-shift false negative (live acceptance
  measured on OLD traffic), and the live floor kills the overfit false
  positive (a candidate that only wins on the tiny holdout); the margin
  keeps a coin-flip candidate from flapping the engine.
- **Quality-only blast radius** — a WRONG candidate (the
  ``draft_swap_corrupt`` chaos fault garbles one pre-gate) can only cost
  speed, never bytes: the target verifies every drafted token, so the gate
  rejecting it is an efficiency story — but the gate MUST reject it.

Scoring is one padded batched teacher-forced forward per weight set, under
``no_grad``, of a scratch copy of the draft (:func:`~tpudist_torch.distill.
train.draft_copy`: a tied draft's live modules are the target's, which the
engine thread may be running): next-token argmax agreement over the
EMITTED region, plus a windowed leading-prefix estimate of per-pass
acceptance for the engine's ``spec_k`` (greedy lanes make teacher-forced
agreement an exact oracle for that prefix).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from tpudist_torch.distill.train import draft_copy, pack_streams


def score_holdout(draft_model, draft_params, streams, *, spec_k: int = 4,
                  pad_to: Optional[int] = None) -> dict:
    """Teacher-forced draft quality on held-out streams: ``match`` =
    next-token argmax agreement over emitted positions, ``acceptance`` =
    the windowed leading-prefix estimate of the drafted-token accept rate
    at ``spec_k``, ``accepted_per_pass`` = its tokens-per-verify
    translation (leading prefix + the verify pass's bonus token)."""
    if not streams:
        return {"streams": 0, "positions": 0, "match": None,
                "acceptance": None, "accepted_per_pass": None}
    toks = pack_streams(streams, pad_to=pad_to)
    scorer = draft_copy(draft_model, draft_params)
    with torch.no_grad():
        t = torch.from_numpy(toks).to(scorer.tok_embed.device)
        ctx = scorer.train_context()
        ctx.moe_routed = False
        pred = scorer(t.clamp_min(0), ctx).argmax(-1).cpu().numpy()
    k = max(1, int(spec_k))
    npos = 0
    nmatch = 0
    windows = 0
    accepted = 0
    per_pass: List[float] = []
    for i, s in enumerate(streams):
        T = len(s)
        start = max(0, int(getattr(s, "prompt_len", 1)) - 1)
        # position j's prediction targets token j+1 — compare over the
        # emitted region only (prompt modeling is not what verify pays)
        tgt = toks[i, start + 1:T]
        got = pred[i, start:T - 1]
        ok = got == tgt
        npos += ok.size
        nmatch += int(ok.sum())
        for w in range(0, ok.size, k):
            win = ok[w:w + k]
            if win.size < k:
                break  # partial trailing window would inflate the rate
            lead = int(np.argmin(win)) if not win.all() else k
            windows += 1
            accepted += lead
            per_pass.append(float(lead + 1))
    return {
        "streams": len(streams),
        "positions": npos,
        "match": round(nmatch / npos, 4) if npos else None,
        "acceptance": round(accepted / (windows * k), 4) if windows
        else (round(nmatch / npos, 4) if npos else None),
        "accepted_per_pass": (round(float(np.mean(per_pass)), 3)
                              if per_pass else None),
    }


def gate_swap(candidate: dict, serving: dict,
              live_acceptance: Optional[float],
              margin: float = 0.02) -> dict:
    """The swap decision: candidate's holdout acceptance vs the
    baseline = max(serving-on-holdout, live gauge), with hysteresis.
    Returns ``{"swap": bool, "reason": str, ...}`` — every input the
    decision read is stamped on it (the ``distill_round`` event makes
    the gate auditable from the stream alone)."""
    cand = candidate.get("acceptance")
    base_hold = serving.get("acceptance")
    floors = [v for v in (base_hold, live_acceptance)
              if isinstance(v, (int, float))]
    baseline = max(floors) if floors else None
    out = {
        "candidate_acceptance": cand,
        "serving_holdout_acceptance": base_hold,
        "live_acceptance": live_acceptance,
        "baseline": baseline,
        "margin": float(margin),
    }
    if cand is None:
        return {**out, "swap": False, "reason": "no_holdout"}
    if baseline is None:
        # no measurement to beat (cold engine, no spec traffic yet):
        # the candidate still had to clear the holdout forward — admit
        return {**out, "swap": True, "reason": "no_baseline"}
    if cand >= baseline + float(margin):
        return {**out, "swap": True, "reason": "measured_win"}
    return {**out, "swap": False, "reason": "below_margin"}


def maybe_corrupt_candidate(candidate: dict, round_idx: int):
    """The ``draft_swap_corrupt`` chaos seam (:func:`tpudist_torch.runtime.
    faults.inject_draft_swap`): a due fault garbles the candidate PRE-GATE
    (every float tensor saturated at 1000.0 — garbage logits, unambiguous
    rejection), modeling a poisoned training round or a torn publish.  The
    held-out eval must then reject it and the serving draft stays
    untouched.  Returns ``(candidate, corrupted: bool)``."""
    from tpudist_torch.runtime import faults

    if not faults.inject_draft_swap(round_idx):
        return candidate, False
    return {name: (torch.full_like(t, 1000.0) if t.is_floating_point()
                   else t)
            for name, t in candidate.items()}, True
