"""Frontiers: a sorted list of LVs naming a version (the heads of the DAG).

The reference wraps this in a smallvec newtype with advance/retreat methods
(reference: src/frontier.rs:23). Here a frontier is a plain sorted `list[int]`
(always deduplicated, never containing ROOT). Graph-dependent movement
(advance/retreat) lives in `causalgraph.graph` to keep this module pure.
"""

from __future__ import annotations

from bisect import insort
from typing import Iterable, List, Sequence

Frontier = List[int]


def frontier_root() -> Frontier:
    return []


def frontier_from(vals: Iterable[int]) -> Frontier:
    return sorted(set(vals))


def frontier_eq(a: Sequence[int], b: Sequence[int]) -> bool:
    return list(a) == list(b)


def frontier_is_sorted(f: Sequence[int]) -> bool:
    return all(f[i] < f[i + 1] for i in range(len(f) - 1))


def insert_nonoverlapping(f: Frontier, v: int) -> None:
    """Insert `v` keeping the frontier sorted (reference: src/frontier.rs:343)."""
    assert v not in f
    insort(f, v)


def replace_with_1(f: Frontier, v: int) -> None:
    f.clear()
    f.append(v)
