"""Token-level grammar compilation and the host shadow automaton — the
port's copy of ``tpudist/constrain/grammar.py``.

:func:`compile_grammar` crosses a character DFA with the serving
vocabulary to produce the dense tables the slot programs consume:

- ``allowed[s, t]`` — may token ``t`` be emitted in automaton state
  ``s``?  Applied as a vocabulary-axis mask on the decode logits.
- ``next_state[s, t]`` — successor state after emitting ``t``
  (self-loop for disallowed tokens, so a defensive gather never
  escapes the table).

Two refinements make the tables safe to sample from:

1. **EOS placement** — the EOS token is allowed exactly in DFA accept
   states (``next = self``), so a constrained lane can only terminate
   on a complete sentence of the grammar.  A grammar therefore
   *requires* an EOS id; requests without one are rejected at submit.
2. **Token-level liveness trim** — a state is live iff it accepts
   (EOS allowed) or some allowed token leads to a live state, computed
   as a fixpoint over the *token* tables (a char-live state can still
   be a token dead end when no vocabulary entry spells a path out).
   Transitions into dead states are removed, so every reachable state
   keeps at least one allowed token and a masked logits row can never
   be all ``-inf``.  A dead start state means the grammar is
   unsatisfiable under this vocabulary and compilation fails.

Compilation is cached by grammar hash — (kind, source, vocabulary
fingerprint, eos id, state cap) — so grammar churn across requests
re-binds pool blocks without re-running the pipeline.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from tpudist_torch.constrain.regex_dfa import (ALPHABET, CharDfa, RegexError,
                                         compile_regex_dfa)
from tpudist_torch.constrain.schema import SchemaError, schema_to_regex

__all__ = ["ConstrainConfig", "GrammarError", "TokenGrammar",
           "compile_grammar", "default_vocab", "grammar_source_key"]


class GrammarError(ValueError):
    """An uncompilable grammar: bad syntax, state blowup, or a grammar
    unsatisfiable under the vocabulary.  Surfaces as a synchronous
    ``invalid_grammar`` admission rejection."""


def default_vocab(vocab_size: int, eos_id: Optional[int] = None
                  ) -> Tuple[str, ...]:
    """Synthetic vocabulary for the toy models: token ``i`` decodes to
    one printable character, cycling over the alphabet.  ``eos_id``
    (and token 0, the conventional pad) decode to the empty string."""
    out: List[str] = []
    for i in range(vocab_size):
        if i == 0 or (eos_id is not None and i == eos_id):
            out.append("")
        else:
            out.append(ALPHABET[i % len(ALPHABET)])
    return tuple(out)


@dataclass(frozen=True)
class ConstrainConfig:
    """Engine-facing configuration for the structured-output pool.

    ``vocab`` maps token id → decoded string (the bridge between the
    integer token space and the character grammars).  ``num_blocks``
    is the resident table-pool size G; block id G is the sentinel
    identity block unconstrained lanes index.  ``max_states`` caps the
    per-grammar automaton (S_max), which fixes the dense pool shape
    ``[G+1, S_max, V]``.
    """

    vocab: Tuple[str, ...]
    num_blocks: int = 4
    max_states: int = 64

    def __post_init__(self):
        if self.num_blocks < 1:
            raise ValueError("constrain pool needs at least one block")
        if self.max_states < 2:
            raise ValueError("max_states must be >= 2")

    def vocab_fingerprint(self) -> str:
        h = hashlib.blake2b(digest_size=8)
        for w in self.vocab:
            h.update(w.encode("utf-8"))
            h.update(b"\x00")
        return h.hexdigest()


def grammar_source_key(source: Mapping[str, Any]) -> str:
    """Stable hash of a grammar *source* spec ({"kind", "src", ...}) —
    the disagg wire format ships sources, and the importing side
    re-compiles and re-binds by this key."""
    return hashlib.blake2b(
        json.dumps(source, sort_keys=True).encode("utf-8"),
        digest_size=16).hexdigest()


@dataclass(frozen=True)
class TokenGrammar:
    """A compiled grammar: dense token tables plus the host-side
    shadow automaton the server uses to track delivered tokens."""

    key: str                      # cache/bind key (grammar hash)
    source: Dict[str, Any]        # serializable spec, rides the wire
    eos_id: int
    n_states: int
    allowed: np.ndarray = field(repr=False)      # [n_states, V] bool
    next_state: np.ndarray = field(repr=False)   # [n_states, V] int32
    accept: np.ndarray = field(repr=False)       # [n_states] bool

    # -- host shadow automaton ------------------------------------------
    def token_allowed(self, state: int, tok: int) -> bool:
        return bool(self.allowed[state, tok])

    def advance(self, state: int, tok: int) -> int:
        return int(self.next_state[state, tok])

    def is_accept(self, state: int) -> bool:
        return bool(self.accept[state])

    def walk(self, toks: Sequence[int], state: int = 0) -> Optional[int]:
        """Advance through ``toks``; None on the first violation."""
        for t in toks:
            if not self.allowed[state, t]:
                return None
            state = int(self.next_state[state, t])
        return state


# --------------------------------------------------------------------------
# Compilation
# --------------------------------------------------------------------------

_CACHE_CAP = 64
_cache: "Dict[Tuple, TokenGrammar]" = {}
_cache_order: List[Tuple] = []
_cache_lock = threading.Lock()
_cache_hits = 0
_cache_misses = 0


def compile_cache_stats() -> Dict[str, int]:
    with _cache_lock:
        return {"hits": _cache_hits, "misses": _cache_misses,
                "entries": len(_cache)}


def compile_grammar(*, regex: Optional[str] = None,
                    json_schema: Optional[Mapping[str, Any]] = None,
                    vocab: Sequence[str], eos_id: int,
                    max_states: int = 64) -> TokenGrammar:
    """Compile a regex or JSON schema into a :class:`TokenGrammar`.

    Exactly one of ``regex``/``json_schema`` must be given.  Raises
    :class:`GrammarError` on anything uncompilable — callers reject
    the request synchronously rather than admitting a lane that can
    only dead-end.
    """
    global _cache_hits, _cache_misses
    if (regex is None) == (json_schema is None):
        raise GrammarError("exactly one of regex/json_schema is required")
    if not 0 <= eos_id < len(vocab):
        raise GrammarError("grammar requires a valid eos_id inside the "
                           "vocabulary (got %r)" % (eos_id,))
    if json_schema is not None:
        source: Dict[str, Any] = {"kind": "json_schema", "src": json_schema}
    else:
        source = {"kind": "regex", "src": regex}

    vfp = hashlib.blake2b(
        ("\x00".join(vocab)).encode("utf-8"), digest_size=8).hexdigest()
    ckey = (grammar_source_key(source), vfp, int(eos_id), int(max_states))
    with _cache_lock:
        hit = _cache.get(ckey)
        if hit is not None:
            _cache_hits += 1
            return hit
        _cache_misses += 1

    if json_schema is not None:
        try:
            pattern = schema_to_regex(json_schema)
        except SchemaError as e:
            raise GrammarError("invalid json_schema: %s" % e)
    else:
        pattern = regex
    try:
        dfa = compile_regex_dfa(pattern, max_states=max_states)
    except RegexError as e:
        raise GrammarError("invalid grammar: %s" % e)

    tg = _tokenize(dfa, source, tuple(vocab), int(eos_id), int(max_states))
    with _cache_lock:
        if ckey not in _cache:
            _cache[ckey] = tg
            _cache_order.append(ckey)
            while len(_cache_order) > _CACHE_CAP:
                _cache.pop(_cache_order.pop(0), None)
    return tg


def _tokenize(dfa: CharDfa, source: Dict[str, Any], vocab: Tuple[str, ...],
              eos_id: int, max_states: int) -> TokenGrammar:
    n, vsz = dfa.n_states, len(vocab)
    if n > max_states:  # pragma: no cover - regex layer enforces its own cap
        raise GrammarError("grammar needs %d states, cap is %d"
                           % (n, max_states))
    cand = np.zeros((n, vsz), dtype=bool)
    nxt = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, vsz))

    # Walk every (state, token-string) pair through the char DFA.
    # Empty-string tokens (pad, eos) never advance text and are
    # disallowed, except the EOS column handled below.
    for t, word in enumerate(vocab):
        if t == eos_id or not word:
            continue
        for s in range(n):
            cur: Optional[int] = s
            for ch in word:
                cur = dfa.step(cur, ch)
                if cur is None:
                    break
            if cur is not None:
                cand[s, t] = True
                nxt[s, t] = cur

    accept = np.zeros(n, dtype=bool)
    for s in dfa.accepts:
        accept[s] = True
    cand[:, eos_id] = accept  # EOS exactly in accept states, self-loop

    # Token-level liveness fixpoint: live = accept ∪ {s | ∃t allowed,
    # next[s,t] live}.  Then prune transitions into dead states.
    live = accept.copy()
    while True:
        reach = (cand & live[nxt]).any(axis=1)
        new_live = live | reach
        if (new_live == live).all():
            break
        live = new_live
    if not live[0]:
        raise GrammarError(
            "unsatisfiable grammar: no vocabulary token sequence spells "
            "a complete match (start state is token-dead)")
    allowed = cand & live[nxt]
    allowed[:, eos_id] = accept
    nxt = np.where(allowed, nxt, np.arange(n, dtype=np.int32)[:, None])

    return TokenGrammar(
        key=grammar_source_key(source) + "-" + str(eos_id),
        source=source, eos_id=eos_id, n_states=n,
        allowed=allowed, next_state=nxt.astype(np.int32), accept=accept)
