"""Live-traffic capture for the online draft-distillation flywheel — the
counterpart of :mod:`tpudist.distill.capture`, copied whole.

The serving loop's EXISTING ``request_finished`` seam is the tap: every
finished request offers its (prompt, emitted-token) stream to a bounded
ring here, greedy and sampled lanes alike, tagged per-tenant and
per-adapter so the distillation lane can bias rounds toward the
heaviest traffic.  The buffer is the training-set side of the flywheel
— acceptance is a property of (draft, workload), and this ring IS the
workload the serving process actually saw.

Discipline (the telemetry-drop rule): the ring is bounded in TOKENS
(``TPUDIST_DISTILL_BUFFER_TOKENS``), eviction is oldest-first, and
every stream that falls out — evicted, sampled past, or oversize — is
COUNTED, never silently gone (:meth:`CaptureBuffer.stats` and the
``/statusz`` ``distill`` block both read the counters).

Dependency-light on purpose: numpy + stdlib, importable without torch —
the capture tap sits on the serving hot path's finish seam and must
cost one attribute load + None check when disarmed.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CapturedStream:
    """One finished request's token stream: prompt + emitted, already
    concatenated — exactly the training sequence sequence-level
    distillation wants (the draft learns to continue the prompts the
    target actually continued)."""

    tokens: np.ndarray  # [prompt_len + emitted] int32
    prompt_len: int
    greedy: bool  # temperature == 0 (the byte-identity lane)
    tenant: Optional[str] = None
    adapter: Optional[str] = None

    def __len__(self) -> int:
        return int(self.tokens.shape[0])


class CaptureBuffer:
    """Bounded, sampled ring of :class:`CapturedStream`.

    ``budget_tokens`` bounds the SUM of stream lengths (a ring bounded
    in streams would let one long-prompt tenant squeeze everyone else
    out while looking half empty); ``sample_every`` keeps every Nth
    finished request (1 = all).  Thread-safe: the engine loop offers,
    the distillation thread snapshots.
    """

    def __init__(self, budget_tokens: int = 65536, sample_every: int = 1):
        if budget_tokens <= 0:
            raise ValueError("budget_tokens must be positive")
        self.budget_tokens = int(budget_tokens)
        self.sample_every = max(1, int(sample_every))
        self._dq: Deque[CapturedStream] = collections.deque()
        self._tokens = 0
        self._lock = threading.Lock()
        # the never-silent ledger
        self.seen = 0          # finished requests offered
        self.captured = 0      # streams that entered the ring
        self.sampled_out = 0   # skipped by the sampling knob
        self.dropped_empty = 0     # no emitted tokens (reject/shutdown)
        self.dropped_oversize = 0  # single stream exceeds the budget
        self.evicted = 0       # pushed out of the ring by newer streams

    @classmethod
    def from_env(cls) -> Optional["CaptureBuffer"]:
        """Build from the ``TPUDIST_DISTILL_*`` knobs; ``None`` unless
        ``TPUDIST_DISTILL_CAPTURE`` is on (the disarmed default — the
        tap then costs one None check per finished request)."""
        from tpudist_torch.utils.envutil import env_flag, env_int

        if not env_flag("TPUDIST_DISTILL_CAPTURE", False):
            return None
        return cls(
            budget_tokens=env_int("TPUDIST_DISTILL_BUFFER_TOKENS", 65536),
            sample_every=env_int("TPUDIST_DISTILL_SAMPLE", 1))

    # -- the tap -------------------------------------------------------------

    def offer(self, prompt, emitted, *, greedy: bool,
              tenant: Optional[str] = None,
              adapter: Optional[str] = None) -> bool:
        """Offer one finished stream; returns whether it was kept.
        Never raises into the serving loop (defensive coercion only at
        the boundary — a malformed stream is a counted drop)."""
        with self._lock:
            self.seen += 1
            if self.seen % self.sample_every != 0:
                self.sampled_out += 1
                return False
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            emitted = np.asarray(emitted, np.int32).reshape(-1)
            if emitted.size == 0:
                self.dropped_empty += 1
                return False
            toks = np.concatenate([prompt, emitted])
            if toks.size > self.budget_tokens:
                self.dropped_oversize += 1
                return False
            while self._tokens + toks.size > self.budget_tokens:
                old = self._dq.popleft()
                self._tokens -= len(old)
                self.evicted += 1
            self._dq.append(CapturedStream(
                tokens=toks, prompt_len=int(prompt.size),
                greedy=bool(greedy),
                tenant=None if tenant is None else str(tenant),
                adapter=None if adapter is None else str(adapter)))
            self._tokens += toks.size
            self.captured += 1
            return True

    def offer_handle(self, h) -> bool:
        """The serving-loop convenience: tap a finished
        :class:`~tpudist_torch.serve.scheduler.RequestHandle` (both server
        flavors call this from ``_note_finished``).  Streams that
        produced no tokens (rejects, shutdown aborts) are counted
        drops, not training data."""
        req = h.request
        return self.offer(req.prompt, h.tokens,
                          greedy=float(req.temperature) == 0.0,
                          tenant=req.tenant, adapter=req.adapter)

    # -- the training-set side ----------------------------------------------

    def snapshot(self, adapter: Optional[str] = None,
                 only_adapter: bool = False) -> List[CapturedStream]:
        """A stable copy of the ring (the distillation round trains on
        a snapshot while the loop keeps capturing).  ``only_adapter``
        restricts to streams tagged ``adapter`` — the per-adapter round
        of the per-adapter binding."""
        with self._lock:
            streams = list(self._dq)
        if only_adapter:
            streams = [s for s in streams if s.adapter == adapter]
        return streams

    @staticmethod
    def split_holdout(streams: List[CapturedStream],
                      holdout_frac: float = 0.25,
                      ) -> Tuple[List[CapturedStream],
                                 List[CapturedStream]]:
        """Deterministic train/held-out split via a fixed-seed
        permutation: both slices sample the WHOLE ring uniformly, so a
        traffic-mix shift mid-ring lands in both (a contiguous tail
        split would let the gate score yesterday's distribution), and
        the pick is decorrelated from any periodicity in the traffic —
        a strided every-k-th split aligned with a repeat-prompt pool's
        period would systematically exclude the held-out prompts from
        training, scoring generalization to unseen prompts instead of
        fit to the live workload (the gate's actual question).  At
        least one stream lands on each side when there are two or
        more; order within each slice stays arrival order."""
        if not streams:
            return [], []
        if len(streams) == 1:
            return list(streams), list(streams)
        frac = min(0.5, max(0.05, float(holdout_frac)))
        n = len(streams)
        n_hold = min(n - 1, max(1, int(round(frac * n))))
        perm = np.random.default_rng(0x5EED).permutation(n)
        hidx = set(int(i) for i in perm[:n_hold])
        hold = [s for i, s in enumerate(streams) if i in hidx]
        train = [s for i, s in enumerate(streams) if i not in hidx]
        return train, hold

    def heaviest_adapter(self, min_streams: int = 2) -> Optional[str]:
        """The adapter name carrying the most captured tokens (``None``
        when no adapter-tagged stream clears ``min_streams``) — the
        per-adapter round's target selection."""
        by: Dict[str, List[int]] = {}
        for s in self.snapshot():
            if s.adapter is not None:
                e = by.setdefault(s.adapter, [0, 0])
                e[0] += 1
                e[1] += len(s)
        best = None
        for name, (n, toks) in sorted(by.items()):
            if n >= min_streams and (best is None or toks > best[1]):
                best = (name, toks)
        return best[0] if best else None

    def stats(self) -> dict:
        """The never-silent ledger (rides into ``/statusz`` and the
        distillation-round telemetry events)."""
        with self._lock:
            by_adapter: Dict[str, int] = {}
            by_tenant: Dict[str, int] = {}
            greedy = 0
            for s in self._dq:
                if s.adapter is not None:
                    by_adapter[s.adapter] = by_adapter.get(s.adapter, 0) + 1
                key = s.tenant if s.tenant else "default"
                by_tenant[key] = by_tenant.get(key, 0) + 1
                greedy += int(s.greedy)
            return {
                "streams": len(self._dq),
                "tokens": self._tokens,
                "budget_tokens": self.budget_tokens,
                "sample_every": self.sample_every,
                "greedy_streams": greedy,
                "seen": self.seen,
                "captured": self.captured,
                "sampled_out": self.sampled_out,
                "dropped_empty": self.dropped_empty,
                "dropped_oversize": self.dropped_oversize,
                "evicted": self.evicted,
                **({"by_adapter": by_adapter} if by_adapter else {}),
                **({"by_tenant": by_tenant} if by_tenant else {}),
            }
