"""Structured output: grammar-constrained decoding for the slot engine.

The port's copy of ``tpudist/constrain/`` (numpy and pure Python, no
framework code, so it is copied across and pinned equal by
``tests/test_torch_constrain.py``).  A host-side grammar (a regex, or a
JSON schema lowered to one) becomes a token-level finite-state automaton
— regex → character DFA → vocabulary-indexed transition/mask tables —
and the serving stack applies it as DATA inside the slot programs:

- :mod:`tpudist_torch.constrain.regex_dfa` — the regex subset parser and
  the Thompson NFA → subset-construction DFA pipeline;
- :mod:`tpudist_torch.constrain.schema` — JSON schema → regex lowering
  (a schema constrains by becoming a regex over the canonical
  whitespace-free JSON serialization);
- :mod:`tpudist_torch.constrain.grammar` — the token-table compiler
  (:func:`compile_grammar`, cached by grammar hash) and the host-side
  shadow automaton (:class:`TokenGrammar`);
- :mod:`tpudist_torch.constrain.registry` — the resident-block registry
  the engine binds per-request grammars through (the adapter-pool
  discipline applied to grammars).

Per-slot automaton state lives in ``SlotState`` (``gidx``/``gstate``;
the pool's ``num_blocks`` sentinel = unconstrained); the dense tables
ride into the sampling kernel (``fused_sample_prep``'s grammar operands)
and the speculative verify as a read-only device pool, so mixed
constrained and unconstrained lanes share one batch.
"""

from tpudist_torch.constrain.grammar import (ConstrainConfig, GrammarError,
                                       TokenGrammar, compile_cache_stats,
                                       compile_grammar, default_vocab,
                                       grammar_source_key)
from tpudist_torch.constrain.regex_dfa import RegexError, compile_regex_dfa
from tpudist_torch.constrain.registry import GrammarPoolFull, GrammarRegistry
from tpudist_torch.constrain.schema import SchemaError, schema_to_regex

__all__ = [
    "ConstrainConfig",
    "GrammarError",
    "GrammarPoolFull",
    "GrammarRegistry",
    "RegexError",
    "SchemaError",
    "TokenGrammar",
    "compile_cache_stats",
    "compile_grammar",
    "compile_regex_dfa",
    "default_vocab",
    "grammar_source_key",
    "schema_to_regex",
]
