"""JSON schema → regex lowering.

The port's copy of ``tpudist/constrain/schema.py``.

A JSON schema constrains generation by being lowered to a regex over
the **canonical whitespace-free** JSON serialization (the style
``json.dumps(..., separators=(",", ":"))`` emits): object keys appear
in declaration order, no insignificant whitespace.  The resulting
regex then rides the ordinary :mod:`tpudist_torch.constrain.regex_dfa`
pipeline — schema mode adds zero machinery below this file.

Supported subset (uncompilable schemas are rejected synchronously at
``submit``):

- ``{"type": "object", "properties": {...}}`` — properties emitted in
  declaration order; properties listed in ``required`` (default: all)
  are mandatory, the rest are rejected (optional-key elision would
  need context-free power the DFA does not have, so the lowering
  requires ``required`` to cover every declared property);
- ``{"type": "string"}`` with optional ``enum`` / ``pattern`` (the
  pattern constrains the *content* between the quotes);
- ``{"type": "integer"}`` / ``{"type": "number"}`` with optional
  ``minDigits``/``maxDigits`` hints;
- ``{"type": "boolean"}``, ``{"type": "null"}``;
- ``{"type": "array", "items": ...}`` with ``minItems``/``maxItems``
  (unbounded tails use a Kleene loop, which is cheap in DFA states);
- ``{"enum": [...]}`` over JSON scalars;
- ``{"const": ...}`` for any JSON-serializable value.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

__all__ = ["SchemaError", "schema_to_regex"]

# Characters with meaning in the regex subset; everything literal in a
# lowered schema gets escaped through here.
_SPECIAL = set("\\^$.|?*+()[]{}")


class SchemaError(ValueError):
    """Raised when a schema falls outside the supported subset."""


def _lit(text: str) -> str:
    out = []
    for ch in text:
        out.append("\\" + ch if ch in _SPECIAL else ch)
    return "".join(out)


def _json_lit(value: Any) -> str:
    try:
        return _lit(json.dumps(value, separators=(",", ":"), sort_keys=False))
    except (TypeError, ValueError) as e:
        raise SchemaError("unserializable const/enum value %r: %s"
                          % (value, e))


# JSON string body: any non-quote/backslash printable, or a simple
# escape.  Kept deliberately small — the synthetic vocabulary decodes
# to printable ASCII, so \uXXXX escapes never help generation.
_STRING_BODY = '(?:[^"\\\\]|\\\\["\\\\/bfnrt])*'
_INTEGER = "-?(?:0|[1-9][0-9]*)"
_NUMBER = _INTEGER + "(?:\\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"


def schema_to_regex(schema: Mapping[str, Any]) -> str:
    """Lower ``schema`` to a fullmatch regex over canonical JSON."""
    if not isinstance(schema, Mapping):
        raise SchemaError("schema must be a mapping, got %r" % (schema,))
    return _node(schema, depth=0)


def _node(schema: Mapping[str, Any], depth: int) -> str:
    if depth > 8:
        raise SchemaError("schema nesting exceeds depth cap 8")
    if not isinstance(schema, Mapping):
        raise SchemaError("subschema must be a mapping, got %r" % (schema,))
    if "const" in schema:
        return _json_lit(schema["const"])
    if "enum" in schema:
        opts = schema["enum"]
        if not isinstance(opts, (list, tuple)) or not opts:
            raise SchemaError("enum must be a non-empty list")
        return "(?:%s)" % "|".join(_json_lit(v) for v in opts)
    t = schema.get("type")
    if t == "object":
        return _object(schema, depth)
    if t == "array":
        return _array(schema, depth)
    if t == "string":
        return _string(schema)
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return "(?:true|false)"
    if t == "null":
        return "null"
    raise SchemaError("unsupported schema node %r "
                      "(need type/enum/const)" % (schema,))


def _object(schema: Mapping[str, Any], depth: int) -> str:
    props = schema.get("properties", {})
    if not isinstance(props, Mapping):
        raise SchemaError("properties must be a mapping")
    required = schema.get("required")
    if required is not None and set(required) != set(props):
        raise SchemaError(
            "the lowering emits every declared property in order; "
            "'required' must cover all of %s" % sorted(props))
    parts = []
    for key, sub in props.items():
        parts.append('"%s":%s' % (_lit(str(key)), _node(sub, depth + 1)))
    if not parts:
        return "\\{\\}"
    return "\\{" + ",".join(parts) + "\\}"


def _array(schema: Mapping[str, Any], depth: int) -> str:
    item = _node(schema.get("items", {"type": "integer"}), depth + 1)
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    if lo < 0 or (hi is not None and int(hi) < lo):
        raise SchemaError("bad minItems/maxItems bounds")
    group = "(?:%s)" % item
    tail = "(?:,%s)" % item
    if hi is None:
        if lo == 0:
            body = "(?:%s%s*)?" % (group, tail)
        else:
            body = "%s%s{%d,}" % (group, tail, lo - 1)
    else:
        hi = int(hi)
        if hi == 0:
            body = ""
        elif lo == 0:
            body = "(?:%s%s{0,%d})?" % (group, tail, hi - 1)
        else:
            body = "%s%s{%d,%d}" % (group, tail, lo - 1, hi - 1)
    return "\\[" + body + "\\]"


def _string(schema: Mapping[str, Any]) -> str:
    pattern = schema.get("pattern")
    if pattern is not None:
        # The inner pattern constrains the unquoted content; it must
        # itself avoid raw quotes (they would break JSON framing).
        if '"' in pattern.replace('\\"', ""):
            raise SchemaError("string pattern must not contain raw '\"'")
        return '"(?:%s)"' % pattern
    return '"%s"' % _STRING_BODY
