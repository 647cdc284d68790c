"""Spanning-tree traversal of the conflict DAG.

Capability mirror of the reference SpanningTreeWalker (reference:
src/listmerge/txn_trace.rs:75-332): visit every span of a set of (reverse
ordered) LV spans exactly once, in causal order, emitting for each visit the
frontier retreat/advance schedule that moves the tracker to the span's parent
version with minimal churn.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..causalgraph.graph import Graph
from ..core.span import Span


class _VisitEntry:
    __slots__ = ("span", "parents", "parent_idxs", "child_idxs", "visited")

    def __init__(self, span: Span, parents: Tuple[int, ...]) -> None:
        self.span = span
        self.parents = parents
        self.parent_idxs: List[int] = []
        self.child_idxs: List[int] = []
        self.visited = False


class WalkItem:
    __slots__ = ("retreat", "advance_rev", "parents", "consume")

    def __init__(self, retreat, advance_rev, parents, consume) -> None:
        self.retreat: List[Span] = retreat        # descending order
        self.advance_rev: List[Span] = advance_rev  # descending order
        self.parents = parents
        self.consume: Span = consume


class SpanningTreeWalker:
    def __init__(self, graph: Graph, rev_spans: Sequence[Span],
                 start_at: List[int], track_frontier: bool = True) -> None:
        """With track_frontier=False the walker yields the same traversal
        order and parents but skips the per-step frontier diff (the
        retreat/advance lists come back empty) — for consumers like the
        encoder that only need (consume, parents), this removes the
        dominant graph-query cost."""
        self.graph = graph
        self.track_frontier = track_frontier
        # NOTE: with track_frontier=False, `frontier` is intentionally NOT
        # maintained; reading it raises (see frontier property) so callers
        # that copy the plan.py chaining pattern fail loudly.
        self._frontier: List[int] = list(start_at)
        self.input: List[_VisitEntry] = []
        self.to_process: List[int] = []

        def find_entry_idx(t: int) -> Optional[int]:
            # binary search entries by span containment
            lo, hi = 0, len(self.input)
            while lo < hi:
                mid = (lo + hi) // 2
                s = self.input[mid].span
                if t < s[0]:
                    hi = mid
                elif t >= s[1]:
                    lo = mid + 1
                else:
                    return mid
            return None

        for span in reversed(rev_spans):  # ascending order
            start, end = span
            i = graph.find_idx(start)
            while start < end:
                t_end = min(graph.ends[i], end)
                parents = graph.parents_at(start)
                e = _VisitEntry((start, t_end), parents)
                e.parent_idxs = [pi for pi in
                                 (find_entry_idx(p) for p in parents)
                                 if pi is not None]
                if not e.parent_idxs:
                    self.to_process.append(len(self.input))
                self.input.append(e)
                start = t_end
                i += 1

        for i, e in enumerate(self.input):
            for p in e.parent_idxs:
                self.input[p].child_idxs.append(i)

        self.to_process.reverse()
        assert not rev_spans or self.to_process

    def __iter__(self):
        return self

    def __next__(self) -> WalkItem:
        # Preferentially expand non-merge entries (reference: txn_trace.rs:243-265).
        if not self.to_process:
            raise StopIteration
        idx = self.to_process[-1]
        if len(self.input[idx].parents) >= 2:
            found = None
            for ii in range(len(self.to_process) - 1, -1, -1):
                if len(self.input[self.to_process[ii]].parents) < 2:
                    found = ii
                    break
            if found is not None:
                idx = self.to_process[found]
                # swap_remove
                self.to_process[found] = self.to_process[-1]
                self.to_process.pop()
            else:
                self.to_process.pop()
        else:
            self.to_process.pop()

        e = self.input[idx]
        e.visited = True
        parents = e.parents
        span = e.span

        if self.track_frontier:
            only_branch, only_txn = self.graph.diff_rev(self._frontier,
                                                        list(parents))
            for rng in only_branch:
                self.graph.retreat_frontier(self._frontier, rng)
            for rng in reversed(only_txn):
                self.graph.advance_frontier(self._frontier, rng)
            self.graph._advance_known_run(self._frontier, parents, span)
        else:
            only_branch, only_txn = [], []

        for c in e.child_idxs:
            ce = self.input[c]
            if ce.visited:
                continue
            if all(self.input[p].visited for p in ce.parent_idxs):
                self.to_process.append(c)

        return WalkItem(only_branch, only_txn, parents, span)

    @property
    def frontier(self) -> List[int]:
        if not self.track_frontier:
            raise RuntimeError(
                "walker built with track_frontier=False does not maintain "
                "a frontier; construct with track_frontier=True to chain "
                "walks from walker.frontier")
        return self._frontier
