"""Resident grammar-block registry.

The port's copy of ``tpudist/constrain/registry.py``.  The adapter-pool
discipline applied to grammars: the engine
owns a fixed device pool of ``num_blocks`` table blocks (plus the
sentinel identity block), and this registry decides which compiled
grammar occupies which block.  Binding is host-side bookkeeping only —
the caller performs the actual device write when a bind reports the
block is fresh — so the registry stays free of
framework code.

Blocks are pinned by per-slot refcounts while any lane decodes under
them; a bind for a new grammar evicts the least-recently-used
refcount-zero block.  A pool with every block pinned raises
:class:`GrammarPoolFull`, which admission turns into a deferral (the
request waits for a lane to finish) rather than an error.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from tpudist_torch.constrain.grammar import TokenGrammar

__all__ = ["GrammarPoolFull", "GrammarRegistry"]


class GrammarPoolFull(RuntimeError):
    """Every grammar block is pinned by an active lane."""


class _Block:
    __slots__ = ("key", "grammar", "refs", "stamp")

    def __init__(self) -> None:
        self.key: Optional[str] = None
        self.grammar: Optional[TokenGrammar] = None
        self.refs = 0
        self.stamp = 0


class GrammarRegistry:
    """Host-side occupancy map for the device grammar pool."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("grammar pool needs at least one block")
        self.num_blocks = int(num_blocks)
        self._blocks: List[_Block] = [_Block() for _ in range(num_blocks)]
        self._by_key: Dict[str, int] = {}
        self._clock = 0
        self._binds = 0
        self._evictions = 0
        self._lock = threading.Lock()

    # -- binding --------------------------------------------------------
    def bind(self, grammar: TokenGrammar) -> "tuple[int, bool]":
        """Pin ``grammar`` into a block; returns ``(block, fresh)``.

        ``fresh`` means the block's device tables must be (re)written
        by the caller before any lane decodes under it.  Raises
        :class:`GrammarPoolFull` when every block is pinned by another
        grammar.
        """
        with self._lock:
            self._clock += 1
            self._binds += 1
            idx = self._by_key.get(grammar.key)
            if idx is not None:
                b = self._blocks[idx]
                b.refs += 1
                b.stamp = self._clock
                return idx, False
            victim = None
            for i, b in enumerate(self._blocks):
                if b.refs == 0 and (
                        victim is None
                        or b.stamp < self._blocks[victim].stamp):
                    victim = i
            if victim is None:
                raise GrammarPoolFull(
                    "all %d grammar blocks are pinned" % self.num_blocks)
            b = self._blocks[victim]
            if b.key is not None:
                self._by_key.pop(b.key, None)
                self._evictions += 1
            b.key = grammar.key
            b.grammar = grammar
            b.refs = 1
            b.stamp = self._clock
            self._by_key[grammar.key] = victim
            return victim, True

    def release(self, block: int) -> None:
        with self._lock:
            b = self._blocks[block]
            if b.refs <= 0:
                raise RuntimeError("release of unpinned grammar block %d"
                                   % block)
            b.refs -= 1

    def grammar_at(self, block: int) -> Optional[TokenGrammar]:
        with self._lock:
            return self._blocks[block].grammar

    def lookup(self, key: str) -> Optional[int]:
        with self._lock:
            return self._by_key.get(key)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "blocks": self.num_blocks,
                "resident": sum(1 for b in self._blocks
                                if b.key is not None),
                "pinned": sum(1 for b in self._blocks if b.refs > 0),
                "binds": self._binds,
                "evictions": self._evictions,
            }
