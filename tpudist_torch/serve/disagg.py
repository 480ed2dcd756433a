"""The KV-handoff wire form — the port of the package half of
``tpudist/serve/disagg.py``: the schema version, the integrity digest and
the byte round trip of an exported lane (:meth:`tpudist_torch.serve.engine.
SlotEngine.export_slot`).  The host KV tier parks packages in this form and
the fleet router migrates them between replicas in it.

A package is ``{"paged", "pos", "counts", "budget", "trace_id", "adapter",
"grammar", "lane", "state"}``: the lane ``(k, v, cursor)`` and the slot's
:class:`~tpudist_torch.models.generate.SlotState` row are tensors, the rest
host values.  :func:`serialize_package` flattens the tensors to host bytes
(each leaf its raw bytes, its torch dtype NAME and its shape: ``bfloat16``
has no numpy dtype, so the bytes go through a ``uint8`` view and come back
through the named dtype — no ``ml_dtypes`` needed), stamps the blake2b
digest over them and keeps the structure beside them;
:func:`deserialize_package` checks the schema and the digest and rebuilds
CPU tensors, which the importing engine moves to its device.

``DisaggServer`` itself — the prefill and decode worker pools that hand
lanes over in this form — is not ported yet (ROADMAP.md queue A item 8).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

#: Wire-format version of a serialized KV-handoff package, the JAX
#: package's: v2 added the schema field and the blob digest, v3 the
#: ``trace_id``, v4 the ``adapter`` name, v5 the ``grammar`` envelope (each
#: additive and outside the digested blob, so older packages still
#: deserialize with the new fields read back as ``None``).
HANDOFF_SCHEMA_VERSION = 5

#: Oldest wire format :func:`deserialize_package` accepts.
HANDOFF_SCHEMA_MIN = 2


class HandoffError(RuntimeError):
    """A serialized package this engine must not import: a wrong or missing
    ``schema_version`` (``reason="schema"``) or a failed blob integrity
    check (``reason="corrupt"``)."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


def _blob_digest(blob) -> str:
    """blake2b-16 over every blob leaf's bytes (a flipped byte in a KV lane
    would otherwise deserialize silently into garbage attention)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for b, _, _ in blob:
        h.update(b)
    return h.hexdigest()


def _flatten(x, leaves: List[torch.Tensor]):
    """``x``'s tensor leaves appended to ``leaves`` in order, and its
    structure: None for a leaf, else ``(kind, type or keys, children)``
    (a NamedTuple keeps its class, as a JAX treedef does)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("named", type(x), [_flatten(c, leaves) for c in x])
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, None, [_flatten(c, leaves) for c in x])
    if isinstance(x, dict):
        keys = list(x)
        return ("dict", keys, [_flatten(x[k], leaves) for k in keys])
    leaves.append(torch.as_tensor(x))
    return None


def _unflatten(tree, leaves) -> Any:
    if tree is None:
        return next(leaves)
    kind, meta, children = tree
    vals = [_unflatten(c, leaves) for c in children]
    if kind == "named":
        return meta(*vals)
    if kind == "dict":
        return dict(zip(meta, vals))
    return tuple(vals) if kind == "tuple" else list(vals)


def _leaf_bytes(t: torch.Tensor) -> Tuple[bytes, str, tuple]:
    """One tensor as ``(raw bytes, dtype name, shape)``."""
    t = t.detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return raw, name, tuple(t.shape)


def _leaf_tensor(raw: bytes, name: str, shape) -> torch.Tensor:
    dtype = getattr(torch, name)
    if not raw:
        return torch.empty(tuple(shape), dtype=dtype)
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return flat.view(dtype).reshape(tuple(shape))


def serialize_package(pkg: dict) -> dict:
    """Flatten a lane package to host bytes — what would ride the wire
    between two engines.  Keeps the structure beside the blob (both ends
    share the engine geometry); byte-preserving for every lane dtype,
    bf16 and int8 included."""
    leaves: List[torch.Tensor] = []
    tree = _flatten((pkg["lane"], pkg["state"]), leaves)
    blob = [_leaf_bytes(t) for t in leaves]
    ser = {"schema_version": HANDOFF_SCHEMA_VERSION,
           "paged": pkg["paged"], "pos": pkg["pos"],
           "counts": pkg["counts"], "budget": pkg["budget"],
           "trace_id": pkg.get("trace_id"),
           "adapter": pkg.get("adapter"),
           "grammar": pkg.get("grammar"),
           "blob": blob, "tree": tree,
           "digest": _blob_digest(blob),
           "bytes": sum(len(b) for b, _, _ in blob)}
    # chaos harness: a due handoff_corrupt fault garbles the package after
    # the digest is stamped (detectable wire corruption); one None check
    # when disarmed
    from tpudist_torch.runtime import faults

    faults.inject_handoff(ser)
    return ser


def check_package_schema(ser: dict) -> None:
    """Raise :class:`HandoffError` unless ``ser`` carries a supported
    ``schema_version`` (``HANDOFF_SCHEMA_MIN`` .. current) — the cheap
    envelope check, no blob work."""
    ver = ser.get("schema_version")
    if (not isinstance(ver, int)
            or not HANDOFF_SCHEMA_MIN <= ver <= HANDOFF_SCHEMA_VERSION):
        raise HandoffError(
            f"handoff package schema_version {ver!r} not in supported "
            f"range [{HANDOFF_SCHEMA_MIN}, {HANDOFF_SCHEMA_VERSION}] "
            "(missing = pre-versioning sender; out of range = mixed "
            "versions across engines) — rejected instead of "
            "shape-crashing mid-import",
            reason="schema")


def deserialize_package(ser: dict) -> dict:
    """Inverse of :func:`serialize_package` (byte-preserving, CPU
    tensors).  Rejects a missing or unsupported ``schema_version`` and a
    blob whose digest no longer matches (:class:`HandoffError`)."""
    check_package_schema(ser)
    digest = ser.get("digest")
    if digest is not None and _blob_digest(ser["blob"]) != digest:
        raise HandoffError(
            "handoff package failed its integrity check (blob digest "
            "mismatch) — corrupted in transit; the request is finished "
            "with a reason instead of decoding garbage KV",
            reason="corrupt")
    flat = iter([_leaf_tensor(b, d, s) for b, d, s in ser["blob"]])
    lane, state = _unflatten(ser["tree"], flat)
    return {"paged": ser["paged"], "pos": ser["pos"],
            "counts": ser["counts"], "budget": ser["budget"],
            "trace_id": ser.get("trace_id"),
            "adapter": ser.get("adapter"),
            "grammar": ser.get("grammar"),
            "lane": lane, "state": state}
