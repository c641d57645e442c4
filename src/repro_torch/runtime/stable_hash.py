"""Process-stable hashing of query signatures and cache keys.

A byte-for-byte copy of ``repro/runtime/stable_hash.py``: the engine folds
``stable_hash32(q.signature())`` into its seed key, so the port draws the
same selection randomness as the reference only if both hash alike.

``hash()`` is salted per process and ``repr()`` is only accidentally
stable (numpy scalar reprs changed across major versions, set order follows
the salted string hash).  ``canonical_repr`` equals ``repr`` for the plain
python values signatures are built from (str, int, float, bool, None,
tuples) while normalizing numpy scalars, sets and dicts, and rejecting
unknown objects instead of embedding an ``id()``.
"""
from __future__ import annotations

import zlib
from typing import Any


def canonical_repr(obj: Any) -> str:
    """Deterministic, process-stable repr for signature-shaped values.

    Supported: None, bool, int, float, str, bytes, tuple/list, dict,
    set/frozenset, and numpy scalars (normalized to their python value so
    ``Having(">", np.float64(4.0))`` and ``Having(">", 4.0)`` hash alike).
    Anything else raises ``TypeError``.
    """
    if obj is None or obj is True or obj is False:
        return repr(obj)
    # numpy scalars (np.float64, np.int32, ...) before the exact-type
    # checks: bool/int/float subclasses with version-dependent reprs.
    item = getattr(obj, "item", None)
    if item is not None and getattr(obj, "shape", None) == ():
        return canonical_repr(obj.item())
    t = type(obj)
    if t is int or t is float or t is str or t is bytes:
        return repr(obj)
    if t is tuple:
        inner = ", ".join(canonical_repr(x) for x in obj)
        return f"({inner},)" if len(obj) == 1 else f"({inner})"
    if t is list:
        return "[" + ", ".join(canonical_repr(x) for x in obj) + "]"
    if t is dict:
        items = sorted((canonical_repr(k), canonical_repr(v)) for k, v in obj.items())
        return "{" + ", ".join(f"{k}: {v}" for k, v in items) + "}"
    if t is set or t is frozenset:
        tag = "set" if t is set else "frozenset"
        return tag + "{" + ", ".join(sorted(canonical_repr(x) for x in obj)) + "}"
    raise TypeError(
        f"canonical_repr: unsupported type {t.__name__!r} — extend the "
        f"canonical encoding rather than falling back to repr()")


def stable_hash32(obj: Any) -> int:
    """31-bit non-negative content hash, identical in every process:
    crc32 over :func:`canonical_repr`."""
    return zlib.crc32(canonical_repr(obj).encode()) & 0x7FFFFFFF
