"""Host-side adapter accounting: the registry half of per-tenant LoRA.

The port's copy of ``tpudist/serve/adapters.py`` (no framework code, so it
is copied across and pinned equal by ``tests/test_torch_adapters.py``).

The device half (:mod:`tpudist_torch.models.lora`) is pure indirection — a
factor pool plus per-slot adapter ids that the LoRA kernel reads inside
each forward.  WHICH pool block holds which named adapter is decided here,
on the host, and shipped into the programs as data (``aids`` into
``insert_batch``, ``SlotState.adapter_id`` everywhere else) — never as
shapes.  This is :class:`tpudist_torch.serve.paged_alloc.
BlockAllocator`'s discipline applied to parameters:

- **whole-footprint admission**: one adapter = one block (its complete
  factor set across all layers/projections), reserved at
  :meth:`AdapterRegistry.load` — there is no partial residency;
- **refcounts**: a slot binding an adapter pins it
  (:meth:`acquire`/:meth:`release` — the engine calls these at
  admission/evict), so an in-use adapter's factors can never be
  evicted or overwritten mid-stream;
- **LRU eviction of cold adapters**: a load into a full pool evicts
  the least-recently-USED refcount-zero adapter (its block is zeroed
  on device by the engine — no cross-tenant weight leakage); if every
  block is hot the load fails loudly (:class:`AdapterPoolFull`);
- **deferred unload**: :meth:`unload` of an in-use adapter marks it —
  new requests reject ``adapter_missing`` immediately, the block frees
  (and zeroes) when the last bound lane evicts.

Thread contract: loads/unloads arrive from user threads while the
engine thread acquires/releases — one lock covers every mutation
(the registry is tiny; contention is nil next to a device dispatch).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


class AdapterPoolFull(RuntimeError):
    """A load found no free block and no cold (refcount-zero) adapter
    to evict — every resident adapter is bound to a live lane."""


class AdapterMissingError(RuntimeError):
    """A lane needs an adapter the pool does not hold (raced unload, or
    a handoff/resume re-bind onto a pool that never loaded the name).
    The serving loops finish the request with reason
    ``"adapter_missing"`` instead of decoding base-model output the
    tenant did not ask for."""

    def __init__(self, name: str):
        super().__init__(
            f"adapter {name!r} is not resident in this pool — finish the "
            "request with reason 'adapter_missing', never silently serve "
            "base-model output")
        self.adapter = name


class AdapterRegistry:
    """name → pool block id, refcounts, LRU (module doc)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._lock = threading.Lock()
        self._ids: Dict[str, int] = {}
        self._refs: Dict[str, int] = {}
        self._free: List[int] = list(range(num_blocks))
        #: cold adapters in last-use order (oldest first) — the LRU line
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._pending_unload: set = set()
        #: names loaded but whose FACTORS are not yet written into the
        #: device pool (two-phase load): ``has``/``acquire`` refuse them
        #: until :meth:`activate` — without this, the engine thread
        #: could bind a freshly-published name and gather a zeroed (or,
        #: after an LRU evict, the VICTIM's) block before the user
        #: thread's factor write lands
        self._pending_load: set = set()
        #: RETIRED generations: block id → lanes still bound to an OLD
        #: factor set whose name was reloaded (``load`` after a deferred
        #: ``unload``) — released by ``(name, bid)``, freed+zeroed when
        #: the last lane evicts
        self._retired: Dict[int, int] = {}
        # lifetime counters (adapter_stats / serving report)
        self.loads = 0
        self.evicts = 0
        self.unloads = 0

    # -- inspection ---------------------------------------------------------

    @property
    def resident(self) -> int:
        return len(self._ids)

    def resident_names(self) -> List[str]:
        with self._lock:
            return sorted(self._ids)

    def has(self, name: str) -> bool:
        """Is ``name`` bindable by a NEW request right now (resident,
        factors written, not marked for unload)?"""
        with self._lock:
            return (name in self._ids
                    and name not in self._pending_unload
                    and name not in self._pending_load)

    def block_of(self, name: str) -> Optional[int]:
        with self._lock:
            return self._ids.get(name)

    def refcount(self, name: str) -> int:
        with self._lock:
            return self._refs.get(name, 0)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "blocks_total": self.num_blocks,
                "resident": len(self._ids),
                "free_blocks": len(self._free),
                "in_use": sum(1 for r in self._refs.values() if r > 0),
                "pending_unload": len(self._pending_unload),
                "retired_blocks": len(self._retired),
                "loads": self.loads,
                "evicts": self.evicts,
                "unloads": self.unloads,
                "lanes_by_adapter": {n: r for n, r in self._refs.items()
                                     if r > 0},
            }

    # -- load / unload (user threads) ---------------------------------------

    def load(self, name: str) -> Tuple[int, Optional[Tuple[str, int]]]:
        """Reserve a block for ``name``: ``(block_id, evicted)`` where
        ``evicted`` is the ``(name, block_id)`` of the LRU cold adapter
        this load displaced (the caller zeroes that block on device
        BEFORE writing the new factors), or ``None``.  The name stays
        PENDING — invisible to ``has``/``acquire`` — until the caller
        writes the factors and calls :meth:`activate`, so a racing
        admission can never gather a half-loaded block.  A name whose
        unload is still deferred (lanes bound to the OLD factor set)
        reloads immediately: the old generation retires to block-id
        accounting and frees when its last lane evicts.  Raises
        :class:`AdapterPoolFull` when nothing can free and
        ``ValueError`` on a LIVE resident name (unload first — an
        in-place swap under bound lanes would change their streams
        mid-request)."""
        with self._lock:
            if name in self._ids:
                if name not in self._pending_unload:
                    raise ValueError(
                        f"adapter {name!r} is already loaded (unload it "
                        "first — swapping factors under bound lanes would "
                        "change their streams mid-request)")
                # deferred-unload reload: retire the old generation (its
                # lanes keep decoding the OLD block, released by id) and
                # load the new factor set fresh
                old_bid = self._ids.pop(name)
                self._retired[old_bid] = self._refs.pop(name, 0)
                self._lru.pop(name, None)
                self._pending_unload.discard(name)
            evicted = None
            if not self._free:
                if not self._lru:
                    raise AdapterPoolFull(
                        f"adapter pool full: all {self.num_blocks} blocks "
                        "bound to live lanes — nothing cold to evict")
                victim, _ = self._lru.popitem(last=False)
                bid = self._ids.pop(victim)
                self._refs.pop(victim, None)
                self._pending_unload.discard(victim)
                self._free.append(bid)
                self.evicts += 1
                evicted = (victim, bid)
            bid = self._free.pop(0)
            self._ids[name] = bid
            self._refs[name] = 0
            self._lru[name] = None  # cold until a lane binds it
            self._pending_load.add(name)
            self.loads += 1
            return bid, evicted

    def activate(self, name: str) -> None:
        """Publish a loaded name (its factors are now in the device
        pool) — the second half of the two-phase load."""
        with self._lock:
            self._pending_load.discard(name)

    def unload(self, name: str) -> Optional[Tuple[bool, int]]:
        """Drop ``name``: ``(freed_now, block_id)`` — ``freed_now``
        False means lanes still hold it (the block frees when the last
        one evicts; new requests already reject).  ``None`` when the
        name was never resident."""
        with self._lock:
            bid = self._ids.get(name)
            if bid is None:
                return None
            self.unloads += 1
            if self._refs.get(name, 0) > 0:
                self._pending_unload.add(name)
                self._lru.pop(name, None)
                return False, bid
            self._drop_locked(name)
            return True, bid

    def _drop_locked(self, name: str) -> None:
        bid = self._ids.pop(name)
        self._refs.pop(name, None)
        self._lru.pop(name, None)
        self._pending_unload.discard(name)
        self._pending_load.discard(name)
        self._free.append(bid)

    # -- bind / unbind (engine thread) --------------------------------------

    def acquire(self, name: str) -> Optional[int]:
        """Pin ``name`` for one lane: its block id, or ``None`` when it
        is not bindable (missing, factors still pending, or marked for
        unload) — the caller finishes the request ``adapter_missing``."""
        with self._lock:
            if name not in self._ids or name in self._pending_unload \
                    or name in self._pending_load:
                return None
            self._refs[name] = self._refs.get(name, 0) + 1
            self._lru.pop(name, None)  # hot while any lane holds it
            return self._ids[name]

    def release(self, name: str, bid: int) -> Optional[int]:
        """Unpin one lane's hold on ``(name, bid)`` — the bid
        disambiguates a RETIRED generation (the name was reloaded while
        this lane decoded the old factors) from the current one.
        Returns the block id to ZERO on device when this release freed
        the block (a deferred unload or retired generation completing),
        else ``None``."""
        with self._lock:
            if self._ids.get(name) != bid:
                # retired generation: id-keyed accounting
                refs = max(0, self._retired.get(bid, 0) - 1)
                if refs > 0:
                    self._retired[bid] = refs
                    return None
                self._retired.pop(bid, None)
                self._free.append(bid)
                return bid
            refs = max(0, self._refs.get(name, 0) - 1)
            self._refs[name] = refs
            if refs > 0:
                return None
            if name in self._pending_unload:
                self._drop_locked(name)
                return bid
            # cold: joins the LRU line (newest last)
            self._lru[name] = None
            self._lru.move_to_end(name)
            return None
