"""Regex subset → character DFA, with zero dependencies.

The port's copy of ``tpudist/constrain/regex_dfa.py``.

The compiler is deliberately a from-scratch implementation of the
classic pipeline — parse → Thompson NFA → subset-construction DFA →
live-state trim — because the container bakes in no regex-automaton
library and the serving path only needs a pragmatic subset:

- literals and escapes (``\\d \\w \\s \\D \\W \\S \\n \\t \\r`` plus
  escaped punctuation),
- character classes ``[a-z0-9_]`` with ranges and ``[^...]`` negation,
- ``.`` (any alphabet character),
- quantifiers ``* + ?`` and bounded ``{m} {m,} {m,n}``,
- groups ``(...)`` / ``(?:...)`` and alternation ``|``.

Semantics are **fullmatch**: the DFA accepts exactly the strings the
pattern matches end-to-end, which is what constrained generation needs
(the emitted stream, decoded to text, must be a complete sentence of
the grammar when the lane finishes).

The alphabet is printable ASCII plus ``\\n``/``\\t`` — the same space
the synthetic serving vocabulary decodes into.  ``.`` and negated
classes range over this alphabet.

The DFA is returned trimmed to *useful* states: every kept state is
reachable from the start and can reach an accept state, so a masked
decode lane can never be steered into a character-level dead end.
Token-level liveness (a state may be char-live but unreachable with
the actual vocabulary) is handled one layer up, in
:mod:`tpudist_torch.constrain.grammar`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

__all__ = ["ALPHABET", "CharDfa", "RegexError", "compile_regex_dfa"]

# The character universe constrained generation ranges over.  `.` and
# negated classes are relative to this set, not all of Unicode.
ALPHABET: str = (
    " !\"#$%&'()*+,-./0123456789:;<=>?@"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_`"
    "abcdefghijklmnopqrstuvwxyz{|}~\n\t"
)
_ALPHASET: FrozenSet[str] = frozenset(ALPHABET)

# Bounded-repeat expansion cap: {m,n} unrolls the sub-pattern, so the
# bound keeps a hostile pattern from exploding the NFA host-side.
_MAX_REPEAT = 64


class RegexError(ValueError):
    """Raised for syntax outside the supported subset (or blowups)."""


# --------------------------------------------------------------------------
# Parse: pattern string → AST
# --------------------------------------------------------------------------
# Node shapes (plain tuples keep the walker trivial):
#   ("chars", frozenset)   one character drawn from the set
#   ("cat", [nodes])       concatenation
#   ("alt", [nodes])       alternation
#   ("rep", node, m, n)    m..n repeats; n=None means unbounded

_ESCAPES: Dict[str, FrozenSet[str]] = {
    "d": frozenset("0123456789"),
    "D": _ALPHASET - frozenset("0123456789"),
    "w": frozenset("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "W": _ALPHASET - frozenset("abcdefghijklmnopqrstuvwxyz"
                               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": frozenset(" \t\n"),
    "S": _ALPHASET - frozenset(" \t\n"),
    "n": frozenset("\n"),
    "t": frozenset("\t"),
    "r": frozenset("\r"),
}

_SPECIAL = set("\\^$.|?*+()[]{}")


class _Parser:
    def __init__(self, pat: str):
        self.pat = pat
        self.i = 0

    def error(self, msg: str) -> RegexError:
        return RegexError("%s at position %d in %r" % (msg, self.i, self.pat))

    def peek(self) -> Optional[str]:
        return self.pat[self.i] if self.i < len(self.pat) else None

    def take(self) -> str:
        ch = self.peek()
        if ch is None:
            raise self.error("unexpected end of pattern")
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.pat):
            raise self.error("unbalanced ')'")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self._cat())
        if len(branches) == 1:
            return branches[0]
        return ("alt", branches)

    def _cat(self):
        items: List = []
        while True:
            ch = self.peek()
            if ch is None or ch in "|)":
                break
            items.append(self._repeat())
        return ("cat", items)

    def _repeat(self):
        atom = self._atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                atom = ("rep", atom, 0, None)
            elif ch == "+":
                self.take()
                atom = ("rep", atom, 1, None)
            elif ch == "?":
                self.take()
                atom = ("rep", atom, 0, 1)
            elif ch == "{":
                atom = ("rep", atom, *self._bounds())
            else:
                return atom

    def _bounds(self) -> Tuple[int, Optional[int]]:
        assert self.take() == "{"
        lo = self._int()
        hi: Optional[int] = lo
        if self.peek() == ",":
            self.take()
            hi = None if self.peek() == "}" else self._int()
        if self.take() != "}":
            raise self.error("malformed {m,n} bound")
        if hi is not None and hi < lo:
            raise self.error("repeat bound {%d,%d} is inverted" % (lo, hi))
        if lo > _MAX_REPEAT or (hi is not None and hi > _MAX_REPEAT):
            raise self.error("repeat bound exceeds cap %d" % _MAX_REPEAT)
        return lo, hi

    def _int(self) -> int:
        start = self.i
        while self.peek() is not None and self.peek().isdigit():
            self.take()
        if self.i == start:
            raise self.error("expected integer in {m,n}")
        return int(self.pat[start:self.i])

    def _atom(self):
        ch = self.take()
        if ch == "(":
            if self.peek() == "?":
                self.take()
                if self.take() != ":":
                    raise self.error("only (?:...) groups are supported")
            node = self._alt()
            if self.peek() != ")":
                raise self.error("unbalanced '('")
            self.take()
            return node
        if ch == "[":
            return ("chars", self._char_class())
        if ch == ".":
            return ("chars", _ALPHASET)
        if ch == "\\":
            return ("chars", self._escape())
        if ch in "*+?{":
            raise self.error("quantifier %r has nothing to repeat" % ch)
        if ch in ")|":  # pragma: no cover - callers stop before these
            raise self.error("unexpected %r" % ch)
        if ch not in _ALPHASET:
            raise self.error("character %r outside the alphabet" % ch)
        return ("chars", frozenset(ch))

    def _escape(self) -> FrozenSet[str]:
        ch = self.take()
        if ch in _ESCAPES:
            return _ESCAPES[ch]
        if ch in _SPECIAL or ch in _ALPHASET:
            return frozenset(ch)
        raise self.error("unsupported escape \\%s" % ch)

    def _char_class(self) -> FrozenSet[str]:
        negate = False
        if self.peek() == "^":
            self.take()
            negate = True
        members: Set[str] = set()
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise self.error("unterminated character class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            ch = self.take()
            if ch == "\\":
                members |= self._escape()
                continue
            if self.peek() == "-" and self.i + 1 < len(self.pat) \
                    and self.pat[self.i + 1] != "]":
                self.take()  # '-'
                hi = self.take()
                if hi == "\\":
                    raise self.error("escape cannot end a range")
                if ord(hi) < ord(ch):
                    raise self.error("inverted range %s-%s" % (ch, hi))
                members |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
                continue
            members.add(ch)
        members &= _ALPHASET
        out = (_ALPHASET - members) if negate else frozenset(members)
        if not out:
            raise self.error("empty character class")
        return out


# --------------------------------------------------------------------------
# Thompson NFA
# --------------------------------------------------------------------------

class _Nfa:
    """States are ints; eps[s] is a list of targets, chars[s] a list of
    (charset, target) edges.  Single start, single accept."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.chars: List[List[Tuple[FrozenSet[str], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.chars.append([])
        return len(self.eps) - 1


def _build_nfa(node, nfa: _Nfa) -> Tuple[int, int]:
    kind = node[0]
    if kind == "chars":
        s, t = nfa.state(), nfa.state()
        nfa.chars[s].append((node[1], t))
        return s, t
    if kind == "cat":
        if not node[1]:
            s = nfa.state()
            return s, s
        start, end = _build_nfa(node[1][0], nfa)
        for sub in node[1][1:]:
            s2, e2 = _build_nfa(sub, nfa)
            nfa.eps[end].append(s2)
            end = e2
        return start, end
    if kind == "alt":
        s, t = nfa.state(), nfa.state()
        for sub in node[1]:
            bs, be = _build_nfa(sub, nfa)
            nfa.eps[s].append(bs)
            nfa.eps[be].append(t)
        return s, t
    if kind == "rep":
        _, sub, lo, hi = node
        s = nfa.state()
        end = s
        for _ in range(lo):
            bs, be = _build_nfa(sub, nfa)
            nfa.eps[end].append(bs)
            end = be
        if hi is None:  # Kleene tail: loop one more copy
            bs, be = _build_nfa(sub, nfa)
            t = nfa.state()
            nfa.eps[end].append(bs)
            nfa.eps[end].append(t)
            nfa.eps[be].append(bs)
            nfa.eps[be].append(t)
            return s, t
        t = nfa.state()
        nfa.eps[end].append(t)
        for _ in range(hi - lo):
            bs, be = _build_nfa(sub, nfa)
            nfa.eps[end].append(bs)
            end = be
            nfa.eps[end].append(t)
        return s, t
    raise AssertionError("unknown node %r" % (kind,))


def _eps_closure(nfa: _Nfa, states: FrozenSet[int]) -> FrozenSet[int]:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


# --------------------------------------------------------------------------
# DFA
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CharDfa:
    """Character-level DFA with fullmatch semantics.

    ``trans[s]`` maps a character to the successor state; characters
    absent from the map are rejected in state ``s``.  State 0 is the
    start.  Every state is reachable and can reach an accept state.
    """

    n_states: int
    trans: Tuple[Dict[str, int], ...]
    accepts: FrozenSet[int]

    def fullmatch(self, text: str) -> bool:
        s = 0
        for ch in text:
            nxt = self.trans[s].get(ch)
            if nxt is None:
                return False
            s = nxt
        return s in self.accepts

    def step(self, state: int, ch: str) -> Optional[int]:
        return self.trans[state].get(ch)


def compile_regex_dfa(pattern: str, *, max_states: int = 256) -> CharDfa:
    """Compile ``pattern`` (fullmatch semantics) to a trimmed DFA.

    Raises :class:`RegexError` for syntax outside the subset, for
    patterns whose DFA exceeds ``max_states``, and for patterns that
    match nothing at all (an unsatisfiable constraint is a caller bug
    better rejected synchronously than discovered as a dead-ended
    decode lane).
    """
    ast = _Parser(pattern).parse()
    nfa = _Nfa()
    start, accept = _build_nfa(ast, nfa)

    d0 = _eps_closure(nfa, frozenset([start]))
    index: Dict[FrozenSet[int], int] = {d0: 0}
    order: List[FrozenSet[int]] = [d0]
    trans: List[Dict[str, int]] = [{}]
    work = [d0]
    while work:
        cur = work.pop()
        ci = index[cur]
        # Group NFA char edges leaving this subset by character.
        by_char: Dict[str, Set[int]] = {}
        for s in cur:
            for charset, t in nfa.chars[s]:
                for ch in charset:
                    by_char.setdefault(ch, set()).add(t)
        for ch, targets in by_char.items():
            nxt = _eps_closure(nfa, frozenset(targets))
            ni = index.get(nxt)
            if ni is None:
                ni = len(order)
                if ni >= max_states:
                    raise RegexError(
                        "pattern %r exceeds the %d-state DFA cap"
                        % (pattern, max_states))
                index[nxt] = ni
                order.append(nxt)
                trans.append({})
                work.append(nxt)
            trans[ci][ch] = ni
    accepts = {i for i, subset in enumerate(order) if accept in subset}

    # Trim to states that can still reach an accept (all states are
    # reachable from the start by construction).
    rev: Dict[int, Set[int]] = {}
    for s, edges in enumerate(trans):
        for t in edges.values():
            rev.setdefault(t, set()).add(s)
    live: Set[int] = set(accepts)
    stack = list(accepts)
    while stack:
        s = stack.pop()
        for p in rev.get(s, ()):
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise RegexError("pattern %r matches no string" % pattern)
    remap = {old: new for new, old in
             enumerate(sorted(live, key=lambda s: (s != 0, s)))}
    new_trans: List[Dict[str, int]] = [{} for _ in remap]
    for old, edges in enumerate(trans):
        if old not in remap:
            continue
        new_trans[remap[old]] = {
            ch: remap[t] for ch, t in edges.items() if t in remap}
    new_accepts = frozenset(remap[s] for s in accepts if s in remap)
    return CharDfa(n_states=len(remap), trans=tuple(new_trans),
                   accepts=new_accepts)
