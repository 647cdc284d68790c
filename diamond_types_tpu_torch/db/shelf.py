"""Shelf: a tiny state-based last-writer-wins JSON CRDT.

Capability mirror of the reference's `shelf` crate (reference:
crates/shelf/src/lib.rs:1-30): each value carries a version counter; merge
takes the higher version, recursing into dicts; ties resolve by comparing the
JSON encoding (deterministic on every peer).
"""

from __future__ import annotations

import json
from typing import Any, Tuple

Shelf = Tuple[Any, int]  # (value, version)


def new_shelf(value: Any = None) -> Shelf:
    return (value, 0)


def set_value(shelf: Shelf, value: Any) -> Shelf:
    return (value, shelf[1] + 1)


def set_key(shelf: Shelf, key: str, value: Any) -> Shelf:
    d, ver = shelf
    assert isinstance(d, dict)
    child = d.get(key, new_shelf())
    d = dict(d)
    d[key] = set_value(child, value)
    return (d, ver)


def merge(a: Shelf, b: Shelf) -> Shelf:
    av, an = a
    bv, bn = b
    if isinstance(av, dict) and isinstance(bv, dict) and an == bn:
        out = dict(av)
        for k, sub in bv.items():
            out[k] = merge(out[k], sub) if k in out else sub
        return (out, an)
    if an != bn:
        return a if an > bn else b
    # Same version, non-mergeable values: deterministic JSON tie-break.
    return a if json.dumps(av, sort_keys=True) >= json.dumps(bv, sort_keys=True) else b


def get(shelf: Shelf) -> Any:
    v = shelf[0]
    if isinstance(v, dict):
        return {k: get(sub) for k, sub in v.items()}
    return v
