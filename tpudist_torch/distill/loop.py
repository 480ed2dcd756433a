"""The background distillation lane — the counterpart of
:mod:`tpudist.distill.loop`: capture ring → the port's Trainer → gated
hot-swap, as a thread beside the serving loop.

One :meth:`DistillLoop.run_once` is the whole flywheel turn:

1. snapshot the capture ring (skip below ``TPUDIST_DISTILL_MIN_TOKENS``
   — a round on three streams would swap on noise);
2. split a held-out slice off the capture (interleaved — both slices
   see the CURRENT mix under distribution shift);
3. drive the port's own :class:`~tpudist_torch.trainer.Trainer` on
   the training slice, warm-started from the SERVING draft's current
   params (same geometry asserted, not assumed);
4. run the candidate through the ``draft_swap_corrupt`` chaos seam,
   then the measured gate (:func:`tpudist_torch.distill.swap.gate_swap`)
   against the serving draft's holdout re-score AND its live
   ``spec_stats()`` acceptance, with hysteresis;
5. on a win, hand the candidate to ``server.swap_draft`` — the server
   loop lands it BETWEEN decode blocks as a pure same-shape param
   update (no slot program rebuilt, lanes re-armed, the target verify
   the oracle of every emitted token).

Per-adapter binding: with ``per_adapter`` on, a round whose
heaviest captured adapter is RESIDENT in the engine's name→block
registry trains an adapter-biased candidate on that adapter's slice
and gates it against the adapter's OWN labeled acceptance
(``spec_stats()['by_adapter']``).  The swap stays whole-draft (the
slot programs run one draft), so the adapter round only
lands when it also clears the global holdout — biased toward the
heavy tenant, never regressing the rest.

Every round emits one ``distill_round`` event carrying the gate's full
input (and ``draft_swap`` fires from the server on an applied swap) —
the flywheel is auditable from the telemetry stream alone.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from tpudist_torch.distill.capture import CaptureBuffer
from tpudist_torch.distill.swap import (
    gate_swap,
    maybe_corrupt_candidate,
    score_holdout,
)
from tpudist_torch.distill.train import distill_streams


def _env_cfg() -> dict:
    from tpudist_torch.utils.envutil import (
        env_flag,
        env_float,
        env_int,
        env_positive_float,
    )

    return {
        "interval_s": env_positive_float("TPUDIST_DISTILL_INTERVAL_S", 30.0),
        "steps": env_int("TPUDIST_DISTILL_STEPS", 40),
        "min_tokens": env_int("TPUDIST_DISTILL_MIN_TOKENS", 256),
        "holdout": env_float("TPUDIST_DISTILL_HOLDOUT", 0.25),
        "margin": env_float("TPUDIST_DISTILL_SWAP_MARGIN", 0.02),
        "lr": env_float("TPUDIST_DISTILL_LR", 3e-3),
        "per_adapter": env_flag("TPUDIST_DISTILL_PER_ADAPTER", False),
    }


class DistillLoop:
    """Owns the flywheel thread.  ``server`` is either server flavor —
    the loop reads ``server.draft_ref()`` (serving draft module +
    its current state dict), ``server.stats()['spec']`` (live gauges),
    and calls ``server.swap_draft(state_dict)`` (the between-blocks
    landing).  A round trains and scores on the draft's device, beside
    the engine thread's launches.
    """

    def __init__(self, server, capture: CaptureBuffer, *,
                 interval_s: Optional[float] = None,
                 steps: Optional[int] = None,
                 min_tokens: Optional[int] = None,
                 holdout: Optional[float] = None,
                 margin: Optional[float] = None,
                 lr: Optional[float] = None,
                 per_adapter: Optional[bool] = None):
        cfg = _env_cfg()
        self.server = server
        self.capture = capture
        self.interval_s = float(interval_s if interval_s is not None
                                else cfg["interval_s"])
        self.steps = int(steps if steps is not None else cfg["steps"])
        self.min_tokens = int(min_tokens if min_tokens is not None
                              else cfg["min_tokens"])
        self.holdout = float(holdout if holdout is not None
                             else cfg["holdout"])
        self.margin = float(margin if margin is not None
                            else cfg["margin"])
        self.lr = float(lr if lr is not None else cfg["lr"])
        self.per_adapter = bool(per_adapter if per_adapter is not None
                                else cfg["per_adapter"])
        self.rounds = 0
        self.swaps = 0
        self.rejected = 0
        self.corrupt_rejected = 0
        self.last_round: Optional[dict] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- one flywheel turn ---------------------------------------------------

    def run_once(self) -> dict:
        """One distillation round (synchronous — tests and benches call
        this directly; the background thread calls it on a cadence).
        Returns the round record it also emits as ``distill_round``."""
        self.rounds += 1
        t0 = time.monotonic()
        info = {"round": self.rounds}
        cap = self.capture.stats()
        info["capture_tokens"] = cap["tokens"]
        info["capture_streams"] = cap["streams"]
        info["capture_evicted"] = cap["evicted"]
        ref = self.server.draft_ref()
        if ref is None:
            return self._done(info, swapped=False, reason="no_draft", t0=t0)
        if cap["tokens"] < self.min_tokens:
            return self._done(info, swapped=False, reason="min_tokens",
                              t0=t0)
        adapter = None
        if self.per_adapter:
            adapter = self.capture.heaviest_adapter()
            if adapter is not None and not self._adapter_bound(adapter):
                adapter = None  # not resident in the name→block registry
        streams = self.capture.snapshot()
        train, hold = CaptureBuffer.split_holdout(streams, self.holdout)
        if adapter is not None:
            biased = [s for s in train if s.adapter == adapter]
            if biased:
                # adapter-biased round: the heavy tenant's slice leads,
                # the rest stays in (a pure-slice round would forget
                # the base traffic the same draft still serves)
                train = biased + [s for s in train if s.adapter != adapter]
                info["adapter"] = adapter
        # greedy lanes are the exact oracle for leading-prefix accept;
        # score on them when available, whole holdout otherwise
        ghold = [s for s in hold if s.greedy] or hold
        draft_module, serving_params = ref
        candidate, loss = distill_streams(
            draft_module, serving_params, train,
            steps=self.steps, lr=self.lr)
        info["train_streams"] = len(train)
        info["holdout_streams"] = len(ghold)
        info["loss"] = None if loss is None else round(float(loss), 5)
        candidate, corrupted = maybe_corrupt_candidate(
            candidate, self.rounds)
        if corrupted:
            info["fault"] = "draft_swap_corrupt"
        spec_k = int((self._live_spec() or {}).get("spec_k") or 4)
        cscore = score_holdout(draft_module, candidate, ghold,
                               spec_k=spec_k)
        sscore = score_holdout(draft_module, serving_params, ghold,
                               spec_k=spec_k)
        live = (self._live_spec() or {}).get("acceptance_rate")
        gate = gate_swap(cscore, sscore, live, margin=self.margin)
        if adapter is not None and gate["swap"]:
            # the adapter slice must ALSO win on its own labeled lanes
            ahold = [s for s in ghold if s.adapter == adapter]
            if ahold:
                a_live = ((self._live_spec() or {}).get(
                    "by_adapter", {}).get(adapter, {})
                    .get("acceptance_rate"))
                agate = gate_swap(
                    score_holdout(draft_module, candidate, ahold,
                                  spec_k=spec_k),
                    score_holdout(draft_module, serving_params, ahold,
                                  spec_k=spec_k),
                    a_live, margin=self.margin)
                if not agate["swap"]:
                    gate = {**gate, "swap": False,
                            "reason": f"adapter_{agate['reason']}"}
        info.update(gate)
        if not gate["swap"]:
            self.rejected += 1
            if corrupted:
                self.corrupt_rejected += 1
            return self._done(info, swapped=False, reason=gate["reason"],
                              t0=t0)
        swap_info = self.server.swap_draft(candidate)
        self.swaps += 1
        info["swap_s"] = swap_info.get("swap_s")
        info["lanes_rearmed"] = swap_info.get("lanes_rearmed")
        return self._done(info, swapped=True, reason=gate["reason"], t0=t0)

    def _done(self, info: dict, *, swapped: bool, reason: str,
              t0: float) -> dict:
        from tpudist_torch import telemetry

        info["swapped"] = swapped
        info["reason"] = reason
        info["round_s"] = round(time.monotonic() - t0, 6)
        self.last_round = info
        telemetry.event("distill_round", **info)
        return info

    def _adapter_bound(self, name: str) -> bool:
        engines = self.server._adapter_engines()
        return bool(engines) and engines[0].has_adapter(name)

    def _live_spec(self) -> Optional[dict]:
        try:
            st = self.server.stats()
            # InferenceServer: top-level; DisaggServer: the decode pool
            # owns the draft, its aggregated gauges live under it
            return st.get("spec") or st.get("decode_pool", {}).get("spec")
        except Exception:
            return None

    # -- the thread ----------------------------------------------------------

    def start(self) -> "DistillLoop":
        if self._thread is not None:
            raise RuntimeError("distill loop already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="tpudist-distill", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> bool:
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        ok = not t.is_alive()
        if ok:
            self._thread = None
        return ok

    def _run(self) -> None:
        from tpudist_torch import telemetry

        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception as e:  # the lane must never take serving down
                telemetry.event("distill_round", round=self.rounds,
                                swapped=False, reason="error",
                                error=repr(e)[:200])

    def stats(self) -> dict:
        return {
            "rounds": self.rounds,
            "swaps": self.swaps,
            "rejected": self.rejected,
            "corrupt_rejected": self.corrupt_rejected,
            "interval_s": self.interval_s,
            "steps": self.steps,
            "min_tokens": self.min_tokens,
            "margin": self.margin,
            "per_adapter": self.per_adapter,
            **({"last_round": self.last_round}
               if self.last_round is not None else {}),
        }
