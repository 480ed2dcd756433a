"""Host-side block accounting for the paged KV cache — a copy of
``tpudist/serve/paged_alloc.py`` (pure numpy; the parity tests pin the two
equal).

The device half (:mod:`tpudist_torch.models.paged`) is pure indirection: a
block pool plus per-slot block tables, gathered and scattered inside the
compiled programs.  WHICH physical block backs which logical position is
decided here, on the host, and shipped into the programs as data
(``tables``/``poss`` into ``insert_batch``, ``free_ids`` into ``evict``)
— never as shapes, so allocation churn can't recompile anything.

Allocation policy (deliberately the simplest one that decouples slot
count from ``max_len``): a request reserves its WHOLE footprint
``ceil((prompt_len + max_new) / block_size)`` blocks at admission, minus
whatever prefix blocks it can reuse.  No mid-decode allocation means the
decode program never needs a table-update argument and an admitted
request can never be preempted by a later one's growth — admission is
the only gate.  The capacity win over the dense arena is that a request
holds blocks for its OWN budget, not for ``max_len``: mixed-length
traffic packs ``pool_blocks / mean_footprint`` concurrent sequences
where the dense cache pinned ``num_slots × max_len`` bytes regardless.

Shared-prefix reuse: prompts are hashed block by block into a chain
(``hash_chain``); a prefix cache maps chain hashes to resident pool
blocks, LRU-bounded.  A hit maps the block into the new request's table
row read-only (the compiled commit never writes below the request's
first private block), so a common system prompt is prefilled ONCE and
every later request that shares it skips those prefill steps AND those
blocks' bytes.  Refcounts here are tenant counts; a cache entry pins its
block independently, so a shared block outlives any one tenant and a
hot prefix survives idle gaps up to the cache bound.

Freed blocks returned by :meth:`release` are zeroed on device by the
``evict`` program (KV-hygiene, same as the dense engine).  Blocks freed
by prefix-cache LRU eviction skip the device zero: a recycled block's
stale bytes sit beyond every new tenant's cursor, where the decode
attention's hard mask (`models/paged.py` module doc) excludes them
bit-exactly — the oracle equivalence tests cover recycled-block reuse.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: hash-chain element: hex digest of (previous digest, block tokens)
PrefixHash = str


def hash_chain(prompt: np.ndarray, block_size: int) -> Tuple[PrefixHash, ...]:
    """One digest per FULL block of ``prompt``, each chained on the
    previous — equal chains mean equal token prefixes, so a chain hit is
    a safe block to share.  Computed once at submit (the scheduler
    stamps it on the request) so admission never re-hashes."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    out: List[PrefixHash] = []
    prev = b""
    for b in range(len(prompt) // block_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(prompt[b * block_size:(b + 1) * block_size].tobytes())
        prev = h.digest()
        out.append(h.hexdigest())
    return tuple(out)


class BlockAllocator:
    """Free list + tenant refcounts + LRU prefix cache over a pool of
    ``num_blocks`` physical blocks (ids ``0..num_blocks-1``; the device
    sentinel ``num_blocks`` marks unmapped table entries).

    Thread contract: same as the engine — exactly one caller.
    """

    def __init__(self, num_blocks: int, block_size: int, max_len: int,
                 prefix_cache_blocks: int = 0):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.blocks_per_slot = max_len // block_size
        self.prefix_cache_blocks = max(0, int(prefix_cache_blocks))
        self._free: List[int] = list(range(num_blocks))
        self._refs = np.zeros(num_blocks, np.int32)
        #: hash -> block id, oldest-first (LRU); every mapped block is
        #: pinned resident until the entry is evicted
        self._prefix: "OrderedDict[PrefixHash, int]" = OrderedDict()
        self._cached_id: Dict[int, PrefixHash] = {}
        # per-slot tenancy
        self._rows: Dict[int, List[int]] = {}
        self._hashes: Dict[int, Tuple[PrefixHash, ...]] = {}
        self._plen: Dict[int, int] = {}
        self._registered: Dict[int, int] = {}
        # reuse counters (served up through engine.kv_stats)
        self.prefix_hit_blocks = 0
        self.prefix_miss_blocks = 0
        self.prefix_hit_tokens = 0
        # lifetime admission/release churn (park/resume cycles through
        # the host tier release and re-reserve whole footprints — these
        # make that churn visible in kv_stats//statusz where a
        # point-in-time occupancy gauge cannot)
        self.blocks_admitted_total = 0
        self.blocks_released_total = 0

    # -- accounting ---------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        """Immediately free blocks (cache-pinned ones not counted)."""
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """Resident blocks: tenant-held or cache-pinned."""
        return self.num_blocks - len(self._free)

    @property
    def cached_blocks(self) -> int:
        return len(self._prefix)

    def _evictable(self, protect: Sequence[int] = ()) -> int:
        """Cache entries whose block no tenant holds — freeable on
        demand (``protect``: blocks a pending reuse is about to pin)."""
        ps = set(protect)
        return sum(1 for bid in self._prefix.values()
                   if self._refs[bid] == 0 and bid not in ps)

    # -- admission ----------------------------------------------------------

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Whole-footprint reservation (module doc: admission is the
        only allocation point)."""
        span = prompt_len + max_new
        return -(-span // self.block_size)

    def _reusable(self, hashes: Sequence[PrefixHash], prompt_len: int
                  ) -> List[int]:
        """Pool blocks backing the longest cached prefix chain — capped
        one position short of the full prompt, so at least one prompt
        token is always teacher-forced (the lane needs live last-token
        logits to sample from)."""
        cap = (prompt_len - 1) // self.block_size
        out: List[int] = []
        for h in hashes[:cap]:
            bid = self._prefix.get(h)
            if bid is None:
                break
            out.append(bid)
        return out

    def footprint(self, prompt_len: int, max_new: int,
                  hashes: Sequence[PrefixHash] = ()) -> int:
        """Fresh blocks an admission would actually take right now
        (whole footprint minus the currently-reusable prefix chain)."""
        return (self.blocks_needed(prompt_len, max_new)
                - len(self._reusable(hashes, prompt_len)))

    def probe(self, prompt_len: int, max_new: int,
              hashes: Sequence[PrefixHash] = (), *, reserve: int = 0,
              protect: Sequence[int] = ()
              ) -> Optional[Tuple[int, List[int]]]:
        """Admission peek (no state change): ``(fresh_blocks,
        reused_block_ids)`` if :meth:`admit` would succeed right now,
        else ``None``.  The two extra terms make a MULTI-take sound —
        without them a batch of gate checks each sees the same free
        list and collectively overdraws the pool:

        - ``reserve``: fresh blocks already promised to admissions
          taken earlier in the same batch;
        - ``protect``: cache-pinned blocks those admissions will REUSE —
          they count as evictable to a naive peek, but the moment the
          earlier tenant lands they are refcounted and cannot free.
        """
        reused = self._reusable(hashes, prompt_len)
        need = self.blocks_needed(prompt_len, max_new) - len(reused)
        ok = (need + reserve <= len(self._free)
              + self._evictable(protect=list(reused) + list(protect)))
        return (need, reused) if ok else None

    def can_admit(self, prompt_len: int, max_new: int,
                  hashes: Sequence[PrefixHash] = (), *,
                  reserve: int = 0,
                  protect: Sequence[int] = ()) -> bool:
        """Boolean form of :meth:`probe` (same contract)."""
        return self.probe(prompt_len, max_new, hashes, reserve=reserve,
                          protect=protect) is not None

    def reusable_blocks(self, prompt_len: int,
                        hashes: Sequence[PrefixHash] = ()) -> List[int]:
        """Pool blocks the longest cached prefix chain currently maps to
        — what an admission of this request would reuse.  The engine
        unions these over a whole admission batch into the ``protect``
        set, so an earlier admission's LRU eviction can't take a block a
        later gate-approved item was counting on."""
        return list(self._reusable(hashes, prompt_len))

    def admit(self, slot: int, prompt_len: int, max_new: int,
              hashes: Sequence[PrefixHash] = (), *,
              protect: Sequence[int] = ()) -> Tuple[List[int], int]:
        """Reserve ``slot``'s whole footprint: returns ``(row, reused_len)``
        — the block-table row (reused prefix blocks first, fresh blocks
        after) and the block-aligned position prefill starts at.
        ``protect``: cached blocks same-batch admissions will reuse —
        never evicted here (same contract as :meth:`probe`).  Raises
        ``RuntimeError`` when the pool can't cover it (callers gate on
        :meth:`can_admit` / ``check_budget`` first)."""
        if slot in self._rows:
            raise ValueError(f"slot {slot} already holds blocks")
        reused = self._reusable(hashes, prompt_len)
        guard = list(reused) + list(protect)
        need = self.blocks_needed(prompt_len, max_new) - len(reused)
        if need > len(self._free) + self._evictable(protect=guard):
            raise RuntimeError(
                f"kv pool exhausted: need {need} blocks, "
                f"{len(self._free)} free + "
                f"{self._evictable(protect=guard)} evictable")
        # pin the reused chain FIRST (a reused block must not be the LRU
        # victim of its own admission), then take free / evict LRU
        for bid in reused:
            self._refs[bid] += 1
            self._prefix.move_to_end(self._cached_id[bid])
        fresh: List[int] = []
        for _ in range(need):
            if not self._free:
                self._evict_lru_cached(protect=protect)
            fresh.append(self._free.pop(0))
        row = reused + fresh
        for bid in fresh:
            self._refs[bid] += 1
        self._rows[slot] = row
        self._hashes[slot] = tuple(hashes)
        self._plen[slot] = prompt_len
        self._registered[slot] = len(reused)
        n_prompt_blocks = prompt_len // self.block_size
        self.prefix_hit_blocks += len(reused)
        self.prefix_miss_blocks += max(0, n_prompt_blocks - len(reused))
        self.prefix_hit_tokens += len(reused) * self.block_size
        self.blocks_admitted_total += len(row)
        return row, len(reused) * self.block_size

    def _evict_lru_cached(self, protect: Sequence[int] = ()) -> None:
        """Free the oldest cache entry whose block no tenant holds and
        no pending same-batch reuse pins (``protect``).  Ineligible
        entries are SKIPPED, not popped — destroying a tenant-held entry
        frees nothing and silently loses the shared prefix for every
        future request that would have hit it."""
        ps = set(protect)
        for h, bid in list(self._prefix.items()):
            if self._refs[bid] == 0 and bid not in ps:
                del self._prefix[h]
                del self._cached_id[bid]
                self._free.append(bid)
                return
        raise RuntimeError("kv pool exhausted: no evictable cache entry")

    # -- prefix registration -------------------------------------------------

    def note_progress(self, slot: int, cursor: int) -> None:
        """Called after each prefill dispatch: prompt blocks now fully
        written (``(b+1)·bs <= cursor``, and fully inside the prompt —
        the block decode writes into is private forever) become
        shareable cache entries, LRU-bounded."""
        if self.prefix_cache_blocks <= 0 or slot not in self._rows:
            return
        hashes, row = self._hashes[slot], self._rows[slot]
        plen = self._plen[slot]
        b = self._registered[slot]
        while (b < len(hashes) and (b + 1) * self.block_size <= cursor
               and (b + 1) * self.block_size <= plen):
            h = hashes[b]
            bid = row[b]
            if h not in self._prefix and bid not in self._cached_id:
                while len(self._prefix) >= self.prefix_cache_blocks:
                    self._evict_any_lru()
                self._prefix[h] = bid
                self._cached_id[bid] = h
            b += 1
        self._registered[slot] = b

    def _evict_any_lru(self) -> None:
        """Capacity eviction: drop the oldest entry; its block frees
        only once no tenant holds it."""
        h, bid = self._prefix.popitem(last=False)
        del self._cached_id[bid]
        if self._refs[bid] == 0:
            self._free.append(bid)

    # -- release ------------------------------------------------------------

    def release(self, slot: int) -> List[int]:
        """Drop ``slot``'s tenancy.  Returns the block ids whose
        refcount hit zero AND that no cache entry pins — the ones the
        device ``evict`` program zeroes and the free list regains.
        Cache-pinned blocks stay resident (that is the prefix cache)."""
        row = self._rows.pop(slot, None)
        if row is None:
            return []
        self._hashes.pop(slot, None)
        self._plen.pop(slot, None)
        self._registered.pop(slot, None)
        freed: List[int] = []
        for bid in row:
            self._refs[bid] -= 1
            if self._refs[bid] == 0 and bid not in self._cached_id:
                self._free.append(bid)
                freed.append(bid)
        self.blocks_released_total += len(row)
        return freed

    def slot_row(self, slot: int) -> Optional[List[int]]:
        return self._rows.get(slot)
