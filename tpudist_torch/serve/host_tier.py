"""Host-RAM KV session tier: the degraded-but-alive layer under the pool
— the port of ``tpudist/serve/host_tier.py``, whose ``put`` serializes
through the port's wire form (:func:`tpudist_torch.serve.disagg.
serialize_package`: torch tensors by dtype name, raw bytes, the same
schema and blake2b digest).

The device KV pool is the scarce resource serving fights over: a full
pool means "pool full → reject", an idle chat session holds device
blocks across minutes-long user gaps, and a preempted lane's KV would
otherwise be recompute.  This module is the tier BELOW the pool — a
byte-budgeted host-memory store of serialized KV packages (the
handoff wire format: ``serialize_package``'s schema-versioned,
blake2b-digested blob), keyed by session, so a lane can leave the
device and come back without recompute:

- **idle session park** — a finished turn's lane exports through the
  existing ``export_lane``/``serialize_package`` path and parks here
  keyed by ``(tenant, session)``; the session's NEXT turn re-imports it
  and teacher-forces only the new suffix (resume-TTFT ∝ the new turn,
  not the whole conversation);
- **preemption park** — a low-priority decode lane preempted by a
  high-priority arrival parks here mid-stream (keyed by request id,
  pinned) and resumes BYTE-IDENTICALLY later: decode is a pure function
  of the packaged ``(state, cache)`` plus the ``fold_in(key, count)``
  sampling stream, the same invariant lane recovery already rides;
- **LRU spill** — the store never exceeds its byte budget
  (``TPUDIST_HOST_TIER_BYTES``): least-recently-touched unpinned
  entries spill first (a spilled session's next turn re-prefills — the
  graceful degradation, not an error), pinned (preempted) entries spill
  only when nothing else is left (their resume falls back to a full
  re-prefill with duplicate-drop, still byte-identical);
- **integrity** — packages keep their serialize-time blake2b digest;
  re-import verifies it, and a corrupt parked blob degrades to a full
  re-prefill with a ``host_tier_corrupt`` event — never a crash, never
  wrong bytes (the ``TPUDIST_FAULT=host_tier_corrupt@nth:N`` chaos kind
  garbles the Nth parked package post-digest to prove exactly that).

Fleet re-homing (:mod:`tpudist_torch.serve.router`): a parked session is also the unit of
MIGRATION between replicas — :meth:`export_entry` hands out a copy of
the serialized entry (the same schema-versioned wire format), and
:meth:`adopt` installs one that was parked on ANOTHER replica's tier.
Integrity still travels with the blob: adopt stores the bytes verbatim,
and the adopting replica's resume path verifies the digest exactly as
if it had parked the package itself — a corrupt migrated blob degrades
to a full re-prefill there, never imports.

Thread contract: same as the engine — exactly one caller (the serving
loop's engine thread) for the put/get/match mutation paths; ``stats()``
reads are GIL-atomic counters.  :meth:`export_entry`,
:meth:`session_keys` and :meth:`adopt` are additionally safe to call
from a router thread: each is a single GIL-atomic dict operation (plus
reads of immutable entry fields), the same contract ``stats()`` rides.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


class HostTierError(RuntimeError):
    """A parked package the tier cannot hand back: ``reason`` is
    ``"missing"`` (never parked, spilled, or expired) or ``"corrupt"``
    (failed its integrity digest — the caller degrades to a full
    re-prefill, never imports the bytes)."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class _Entry:
    __slots__ = ("ser", "nbytes", "context", "pinned", "kind",
                 "t_parked", "t_touch")

    def __init__(self, ser: dict, nbytes: int, context, pinned: bool,
                 kind: str, now: float):
        self.ser = ser
        self.nbytes = nbytes
        self.context = context
        self.pinned = pinned
        self.kind = kind
        self.t_parked = now
        self.t_touch = now


class HostKVTier:
    """Byte-budgeted LRU store of serialized KV packages (module doc).

    Keys are tuples (``("sess", tenant, session)`` for idle session
    parks — tenant-scoped, so one tenant can never resume another's
    context — and ``("preempt", request_id)`` for preempted lanes), so
    caller-supplied session strings can never collide with internal
    keys.  ``context`` on a session entry is the full covered token
    stream (prompt + every delivered token): :meth:`match` resumes only
    when the next turn's prompt EXTENDS it exactly — a diverged context
    silently falls back to a fresh prefill."""

    def __init__(self, byte_budget: int, *, ttl_s: Optional[float] = None):
        if byte_budget < 1:
            raise ValueError(
                f"host-tier byte budget must be >= 1, got {byte_budget}")
        self.byte_budget = int(byte_budget)
        self.ttl_s = ttl_s
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.bytes_resident = 0
        # cumulative counters (stats() / /statusz / telemetry gauges)
        self.parks = 0
        self.resumes = 0
        self.spills = 0
        self.spilled_bytes = 0
        self.expired = 0
        self.rejected_oversize = 0

    # -- write side ---------------------------------------------------------

    def put(self, key: tuple, package: dict, *, context=None,
            pinned: bool = False, kind: str = "turn",
            now: Optional[float] = None) -> Optional[int]:
        """Serialize ``package`` (a raw :meth:`SlotEngine.export_slot`
        dict) and park it under ``key``, spilling LRU entries to stay
        under the byte budget.  Returns the stored byte count, or
        ``None`` — package dropped — when it alone exceeds the whole
        budget (the caller serves on without the tier, it does not
        crash).  Re-parking an existing key replaces the entry (a
        session's newest turn wins)."""
        from tpudist_torch.runtime import faults
        from tpudist_torch.serve.disagg import serialize_package

        now = time.monotonic() if now is None else now
        ser = serialize_package(package)
        # chaos harness: a due host_tier_corrupt fault garbles the blob
        # AFTER serialize stamped the digest — detectable corruption the
        # resume path must degrade on, not import
        faults.inject_host_tier(ser)
        nbytes = int(ser["bytes"])
        if context is not None:
            context = np.asarray(context, np.int32).reshape(-1)
            nbytes += context.nbytes
        return self._store(key, ser, nbytes, context, pinned, kind, now)

    def _store(self, key: tuple, ser: dict, nbytes: int, context,
               pinned: bool, kind: str, now: float) -> Optional[int]:
        """Budget-checked insert of an already-serialized entry — the
        shared tail of :meth:`put` (fresh park) and :meth:`adopt`
        (migrated park)."""
        if nbytes > self.byte_budget:
            self.rejected_oversize += 1
            return None
        self.discard(key)
        self._spill(nbytes)
        self._entries[key] = _Entry(ser, nbytes, context, pinned, kind, now)
        self.bytes_resident += nbytes
        self.parks += 1
        return nbytes

    def adopt(self, key: tuple, ser: dict, *, context=None,
              kind: str = "turn", now: Optional[float] = None
              ) -> Optional[int]:
        """Install a package serialized ELSEWHERE (another replica's
        tier, a router-side stash) under ``key`` — the migration half of
        :meth:`export_entry`.  The bytes are stored verbatim, digest and
        all: integrity is still checked by the resume path's
        deserialize, so a blob corrupted in transit degrades to a full
        re-prefill on THIS replica instead of importing.  Same budget
        rules as :meth:`put` (LRU spill, oversize → ``None``)."""
        now = time.monotonic() if now is None else now
        nbytes = int(ser["bytes"])
        if context is not None:
            context = np.asarray(context, np.int32).reshape(-1)
            nbytes += context.nbytes
        return self._store(key, ser, nbytes, context, False, kind, now)

    def export_entry(self, key: tuple) -> Optional[dict]:
        """A stashable copy of the entry under ``key`` WITHOUT popping
        it: the serialized package plus the covered context — everything
        :meth:`adopt` needs to re-home the session on another replica.
        ``None`` when not resident.  The package dict is returned as-is
        (entries are never mutated in place), so the copy is O(1)."""
        e = self._entries.get(key)
        if e is None:
            return None
        return {"ser": e.ser, "context": e.context, "kind": e.kind}

    def session_keys(self) -> List[tuple]:
        """Keys of every parked SESSION entry (``("sess", tenant,
        session)`` — preempted mid-stream lanes excluded: they belong to
        a live handle, not to the migratable idle-session set)."""
        return [k for k in list(self._entries)
                if isinstance(k, tuple) and k and k[0] == "sess"]

    def _spill(self, incoming: int) -> None:
        """Free room for ``incoming`` bytes: least-recently-touched
        UNPINNED entries first; pinned (preempted, mid-stream) entries
        only when nothing else remains — their resume degrades to a full
        re-prefill, a parked idle session is the cheaper loss."""
        for only_unpinned in (True, False):
            for key in list(self._entries):
                if self.bytes_resident + incoming <= self.byte_budget:
                    return
                if only_unpinned and self._entries[key].pinned:
                    continue
                e = self._entries.pop(key)
                self.bytes_resident -= e.nbytes
                self.spills += 1
                self.spilled_bytes += e.nbytes

    # -- read side ----------------------------------------------------------

    def match(self, key: tuple, prompt) -> Optional[int]:
        """Covered cursor position if a parked session entry under
        ``key`` can serve ``prompt`` without recompute — the prompt must
        extend the parked context token-for-token (``prompt[:len(ctx)]
        == ctx``; the resume then teacher-forces ``prompt[pos:]``, whose
        first token is the parked ``last_tok``).  ``None`` = no entry,
        or a diverged context (the caller re-prefills fresh; a stale
        diverged entry is discarded so it stops holding bytes)."""
        e = self._entries.get(key)
        if e is None or e.context is None:
            return None
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        ctx = e.context
        if len(prompt) < len(ctx):
            return None  # a different (shorter) turn — miss, keep entry
        if not np.array_equal(prompt[:len(ctx)], ctx):
            self.discard(key)
            return None
        e.t_touch = time.monotonic()
        self._entries.move_to_end(key)
        return int(e.ser["pos"])

    def get(self, key: tuple) -> dict:
        """Pop and return the serialized package under ``key``; raises
        :class:`HostTierError` (``"missing"``) when it is not resident
        (spilled/expired/never parked).  Integrity is the CALLER's
        deserialize step (``deserialize_package`` verifies the digest) —
        the tier hands back exactly the bytes it was given."""
        e = self._entries.pop(key, None)
        if e is None:
            raise HostTierError(
                f"no parked package under {key!r} (spilled, expired, or "
                "never parked) — resume falls back to a full re-prefill",
                reason="missing")
        self.bytes_resident -= e.nbytes
        self.resumes += 1
        return e.ser

    def peek(self, key: tuple) -> Optional[dict]:
        """The serialized package under ``key`` WITHOUT popping it —
        for capacity gates that read the envelope fields (``pos``/
        ``budget``) before committing to the resume."""
        e = self._entries.get(key)
        return None if e is None else e.ser

    def contains(self, key: tuple) -> bool:
        return key in self._entries

    def discard(self, key: tuple) -> bool:
        """Drop an entry (releases its bytes); True iff one existed."""
        e = self._entries.pop(key, None)
        if e is None:
            return False
        self.bytes_resident -= e.nbytes
        return True

    def sweep_expired(self, now: Optional[float] = None) -> List[tuple]:
        """Expire idle parked sessions past ``ttl_s`` (release their
        bytes NOW instead of leaking the entry until LRU pressure).
        Pinned (preempted mid-stream) entries are exempt — their
        lifetime is their request's deadline, enforced by the server's
        parked-deadline sweep.  Returns the expired keys."""
        if self.ttl_s is None:
            return []
        now = time.monotonic() if now is None else now
        out = []
        for key, e in list(self._entries.items()):
            if e.pinned:
                continue
            if now - e.t_touch > self.ttl_s:
                self._entries.pop(key)
                self.bytes_resident -= e.nbytes
                self.expired += 1
                out.append(key)
        return out

    # -- accounting ---------------------------------------------------------

    @property
    def entries(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, object]:
        """Occupancy + lifetime counters — the ``/statusz`` host-tier
        section and the serving report's ``kv.host_tier`` gauges."""
        return {
            "entries": len(self._entries),
            "pinned": sum(1 for e in self._entries.values() if e.pinned),
            "bytes": self.bytes_resident,
            "byte_budget": self.byte_budget,
            "parks": self.parks,
            "resumes": self.resumes,
            "spills": self.spills,
            "spilled_bytes": self.spilled_bytes,
            "expired": self.expired,
            "rejected_oversize": self.rejected_oversize,
            "ttl_s": self.ttl_s,
        }
