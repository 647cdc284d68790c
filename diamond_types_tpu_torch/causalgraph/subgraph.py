"""Subgraph projection: restrict the time DAG to a filtered set of LVs.

Capability mirror of the reference's subgraph tools (reference:
src/causalgraph/graph/subgraph.rs:39-242 — `subgraph`, `project_onto_subgraph`):
build a mini-DAG containing only the ops touching one CRDT/item, remapping
frontiers into it. Key for multi-CRDT documents and for bounding merge work.

Different construction from the reference (which interleaves a reverse filter
iterator with the priority-queue walk): here projection collects "maximal
filtered ancestor" candidates with a run-granular walk and finishes with an
exact find_dominators pass; the subgraph builder then projects each filtered
piece's parents independently. Simpler, and verified against a brute-force
ancestor-closure oracle on random DAGs.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Sequence, Tuple

import heapq

from ..core.span import Span
from .graph import Graph, ROOT


def _clip_filter(filter_spans: Sequence[Span], cap: int) -> List[Span]:
    """Ascending filter spans clipped to LVs < cap."""
    out = []
    for (a, b) in filter_spans:
        if a >= cap:
            break
        out.append((a, min(b, cap)))
    return out


def _max_filtered_le(filter_spans: Sequence[Span], lo: int, hi: int) -> int:
    """Highest filtered LV in [lo, hi], or ROOT."""
    i = bisect_right(filter_spans, hi, key=lambda s: s[0]) - 1
    while i >= 0:
        a, b = filter_spans[i]
        if b <= lo:
            return ROOT
        v = min(hi, b - 1)
        if v >= max(lo, a):
            return v
        i -= 1
    return ROOT


def project_onto_subgraph(graph: Graph, filter_spans: Sequence[Span],
                          frontier: Sequence[int]) -> List[int]:
    """Map `frontier` to its image in the filtered subgraph: the dominator set
    of the newest filtered LVs in its history (reference: subgraph.rs:236-242).
    `filter_spans` must be ascending and disjoint."""
    if not frontier:
        return []
    filter_spans = list(filter_spans)
    if not filter_spans:
        return []
    fmin = filter_spans[0][0]
    heap = [-v for v in frontier]
    heapq.heapify(heap)
    candidates = set()
    while heap:
        v = -heapq.heappop(heap)
        if v < fmin:
            continue
        i = graph.find_idx(v)
        start = graph.starts[i]
        # Skip same-run queue entries (their histories are covered).
        while heap and -heap[0] >= start:
            heapq.heappop(heap)
        f = _max_filtered_le(filter_spans, start, v)
        if f != ROOT:
            candidates.add(f)
        else:
            for p in graph.parents[i]:
                heapq.heappush(heap, -p)
    return graph.find_dominators(sorted(candidates))


def subgraph(graph: Graph, filter_spans: Sequence[Span],
             parents: Sequence[int]) -> Tuple[Graph, List[int]]:
    """Build the filtered mini-DAG (original LV numbering preserved) plus the
    projection of `parents` into it (reference: subgraph.rs:39-236).

    The result graph contains exactly the LVs of `filter_spans` (clipped to
    the history of `parents`); each piece's parents are the projections of
    its original parents onto the earlier filtered set.
    """
    filter_spans = list(filter_spans)
    out = Graph()

    # Restrict the filter to the history of `parents`.
    kept: List[Span] = []
    for (a, b) in filter_spans:
        pos = a
        while pos < b:
            i = graph.find_idx(pos)
            hi = min(b, graph.ends[i])
            # Run pieces outside parents' history get dropped.
            last = hi - 1
            if graph.frontier_contains_version(parents, last):
                kept.append((pos, hi))
            else:
                # The prefix of the piece may still be contained.
                lo_ok = pos - 1
                lo, hi2 = pos, last
                while lo <= hi2:
                    mid = (lo + hi2) // 2
                    if graph.frontier_contains_version(parents, mid):
                        lo_ok = mid
                        lo = mid + 1
                    else:
                        hi2 = mid - 1
                if lo_ok >= pos:
                    kept.append((pos, lo_ok + 1))
            pos = hi

    for (a, b) in kept:
        pos = a
        while pos < b:
            i = graph.find_idx(pos)
            hi = min(b, graph.ends[i])
            orig_parents = graph.parents_at(pos)
            proj = project_onto_subgraph(
                graph, _clip_filter(kept, pos), orig_parents)
            out.push(proj, pos, hi)
            pos = hi

    return out, project_onto_subgraph(graph, kept, parents)
