"""Transformed-operation stream: the top of the merge pipeline.

Capability mirror of the reference TransformedOpsIter (reference:
src/listmerge/merge.rs:585-941): given a causal graph, op table and two
frontiers (`from`, `merge`), yield every op in merge's history that `from`
hasn't seen, with positions transformed onto `from`'s document frame.

Pipeline (reference strategy, re-expressed):
  1. find_conflicting splits the zone into `new_ops` (only-B) and
     `conflict_ops` (shared / only-A).
  2. Fast-forward: while the next new span's parents == our frontier, ops
     stream through untransformed (linear history; reference merge.rs:792-859).
  3. Otherwise build a Tracker over the conflict set, then walk the new spans
     in causal order, advancing/retreating the tracker between spans and
     transforming each op run.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from ..causalgraph.agent import AgentAssignment
from ..causalgraph.graph import DiffFlag, Graph
from ..core.span import Span, push_reversed_rle
from ..text.op import DEL, INS, OpRun, OpStore
from .tracker import Tracker
from .walker import SpanningTreeWalker

# xf results: ("ok", pos) == BaseMoved; ("gone", None) == DeleteAlreadyHappened
XfOp = Tuple[int, OpRun, Optional[int]]


class TransformedOps:
    """Iterate (lv, op_piece, xf_pos | None) triples; after exhaustion,
    `final_frontier` holds the merged version."""

    def __init__(self, graph: Graph, aa: AgentAssignment, ops: OpStore,
                 from_frontier: List[int], merge_frontier: List[int]) -> None:
        self.graph = graph
        self.aa = aa
        self.ops = ops
        self.merge_frontier = list(merge_frontier)
        self.next_frontier = list(from_frontier)
        self.tracker: Optional[Tracker] = None

        self.new_ops: List[Span] = []
        self.conflict_ops: List[Span] = []

        def visit(span: Span, flag: DiffFlag) -> None:
            target = self.new_ops if flag == DiffFlag.ONLY_B else self.conflict_ops
            push_reversed_rle(target, span)

        self.common_ancestor = graph.find_conflicting(
            from_frontier, merge_frontier, visit)

    def __iter__(self) -> Iterator[XfOp]:
        return self._gen()

    @property
    def collisions(self) -> int:
        """Colliding concurrent inserts seen while transforming (valid
        after the iterator is exhausted; reference: merge_conflict_checks
        flag, listmerge/mod.rs:50-51)."""
        return self.tracker.collisions if self.tracker is not None else 0

    def _gen(self) -> Iterator[XfOp]:
        graph, aa, ops = self.graph, self.aa, self.ops

        # --- Phase 1: fast-forward over linear history -------------------
        did_ff = False
        while self.new_ops:
            span = self.new_ops[-1]
            i = graph.find_idx(span[0])
            parents = graph.parents_at(span[0])
            if list(parents) != self.next_frontier:
                break
            self.new_ops.pop()
            take_end = min(graph.ends[i], span[1])
            if take_end < span[1]:
                self.new_ops.append((take_end, span[1]))
            self.next_frontier = [take_end - 1]
            did_ff = True
            for piece in ops.iter_range((span[0], take_end)):
                yield (piece.lv, piece, piece.start)

        if not self.new_ops:
            return

        if did_ff:
            # Re-scan the (smaller) conflict zone from the new frontier.
            self.conflict_ops = []

            def visit(span: Span, flag: DiffFlag) -> None:
                if flag != DiffFlag.ONLY_B:
                    push_reversed_rle(self.conflict_ops, span)

            self.common_ancestor = graph.find_conflicting(
                self.next_frontier, self.merge_frontier, visit)

        # --- Phase 2: tracked merge --------------------------------------
        tracker = Tracker()
        self.tracker = tracker
        frontier = self._walk_populate(tracker)

        walker = SpanningTreeWalker(graph, self.new_ops, frontier)
        for walk in walker:
            for rng in walk.retreat:
                tracker.retreat_by_range(rng)
            for rng in reversed(walk.advance_rev):
                tracker.advance_by_range(rng)
            graph.advance_frontier(self.next_frontier, walk.consume)

            for piece in ops.iter_range(walk.consume):
                pair = piece
                while True:
                    _agent, _seq, agent_len = aa.local_span_to_agent_span(
                        pair.lv, len(pair))
                    consumed, xf = tracker.apply(aa, _agent, pair, agent_len)
                    if consumed == len(pair):
                        yield (pair.lv, pair, xf)
                        break
                    head = ops._slice_run(pair, 0, consumed)
                    pair = ops._slice_run(pair, consumed, len(pair))
                    yield (head.lv, head, xf)

    def _walk_populate(self, tracker: Tracker) -> List[int]:
        """Build the tracker over the conflict set ("hot"), returning the
        walker's final frontier (reference: merge.rs:560-581 M2Tracker::walk)."""
        walker = SpanningTreeWalker(self.graph, self.conflict_ops,
                                    list(self.common_ancestor))
        for walk in walker:
            for rng in walk.retreat:
                tracker.retreat_by_range(rng)
            for rng in reversed(walk.advance_rev):
                tracker.advance_by_range(rng)
            for piece in self.ops.iter_range(walk.consume):
                pair = piece
                while True:
                    agent, _seq, agent_len = self.aa.local_span_to_agent_span(
                        pair.lv, len(pair))
                    consumed, _xf = tracker.apply(self.aa, agent, pair, agent_len)
                    if consumed == len(pair):
                        break
                    pair = self.ops._slice_run(pair, consumed, len(pair))
        return walker.frontier
