"""Plan-then-execute merging: static merge schedules.

Capability mirror of the reference's experimental listmerge2 engine
(reference: src/listmerge2/ — ConflictSubgraph mod.rs:20-33, MergePlan
action_plan.rs:11-37): instead of interleaving DAG queries (diff,
find_conflicting, frontier movement) with tracker mutation the way the M1
engine does, *compile* the whole traversal into a linear `MergePlan` first —
a flat list of steps, each a (retreat spans, advance spans, consume span,
emit?) tuple — then execute it with zero graph queries.

Why this shape matters for the TPU tier: execution becomes pure data
movement over dense span tables with a statically known schedule — exactly
what a device kernel can consume (the compile step stays on host; the
execute step is the part that lowers to JAX/Pallas; the reference's
index_gap_buffer dense state matrix is the round-2 executor design).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from ..causalgraph.agent import AgentAssignment
from ..causalgraph.graph import DiffFlag, Graph
from ..core.span import Span, push_reversed_rle
from ..text.op import OpStore
from .tracker import Tracker
from .walker import SpanningTreeWalker


@dataclass
class PlanStep:
    retreat: List[Span]        # descending order
    advance: List[Span]        # ascending order
    consume: Span
    emit: bool                 # False while building the tracker "hot"


@dataclass
class MergePlan:
    steps: List[PlanStep] = field(default_factory=list)
    ff_spans: List[Span] = field(default_factory=list)  # ascending, untransformed
    final_frontier: List[int] = field(default_factory=list)

    def num_ops(self) -> int:
        n = sum(b - a for (a, b) in self.ff_spans)
        n += sum(s.consume[1] - s.consume[0] for s in self.steps if s.emit)
        return n


def compile_plan(graph: Graph, from_frontier: List[int],
                 merge_frontier: List[int]) -> MergePlan:
    """All control flow happens here: conflict analysis, fast-forward
    extraction, spanning-tree traversal order, frontier diffs."""
    plan = MergePlan()
    new_ops: List[Span] = []
    conflict_ops: List[Span] = []

    def visit(span: Span, flag: DiffFlag) -> None:
        target = new_ops if flag == DiffFlag.ONLY_B else conflict_ops
        push_reversed_rle(target, span)

    common = graph.find_conflicting(from_frontier, merge_frontier, visit)
    next_frontier = list(from_frontier)

    # Fast-forward prefix.
    did_ff = False
    while new_ops:
        span = new_ops[-1]
        i = graph.find_idx(span[0])
        if list(graph.parents_at(span[0])) != next_frontier:
            break
        new_ops.pop()
        take_end = min(graph.ends[i], span[1])
        if take_end < span[1]:
            new_ops.append((take_end, span[1]))
        plan.ff_spans.append((span[0], take_end))
        next_frontier = [take_end - 1]
        did_ff = True

    if new_ops:
        if did_ff:
            conflict_ops = []

            def visit2(span: Span, flag: DiffFlag) -> None:
                if flag != DiffFlag.ONLY_B:
                    push_reversed_rle(conflict_ops, span)

            common = graph.find_conflicting(next_frontier, merge_frontier,
                                            visit2)

        walker = SpanningTreeWalker(graph, conflict_ops, list(common))
        for walk in walker:
            plan.steps.append(PlanStep(
                walk.retreat, list(reversed(walk.advance_rev)),
                walk.consume, emit=False))
        walker2 = SpanningTreeWalker(graph, new_ops, walker.frontier)
        for walk in walker2:
            graph.advance_frontier(next_frontier, walk.consume)
            plan.steps.append(PlanStep(
                walk.retreat, list(reversed(walk.advance_rev)),
                walk.consume, emit=True))

    plan.final_frontier = next_frontier
    return plan


def execute_plan(plan: MergePlan, aa: AgentAssignment, ops: OpStore
                 ) -> Iterator[Tuple[int, object, Optional[int]]]:
    """Pure data movement: no graph queries, no frontier logic — just the
    schedule. Yields the same (lv, op_piece, xf_pos|None) stream as
    TransformedOps."""
    for span in plan.ff_spans:
        for piece in ops.iter_range(span):
            yield (piece.lv, piece, piece.start)

    if not plan.steps:
        return

    tracker = Tracker()
    for step in plan.steps:
        for rng in step.retreat:
            tracker.retreat_by_range(rng)
        for rng in step.advance:
            tracker.advance_by_range(rng)
        for piece in ops.iter_range(step.consume):
            pair = piece
            while True:
                agent, _seq, alen = aa.local_span_to_agent_span(
                    pair.lv, len(pair))
                consumed, xf = tracker.apply(aa, agent, pair, alen)
                head = pair if consumed == len(pair) else \
                    ops._slice_run(pair, 0, consumed)
                if step.emit:
                    yield (head.lv, head, xf)
                if consumed == len(pair):
                    break
                pair = ops._slice_run(pair, consumed, len(pair))


def merge_via_plan(oplog, from_frontier, merge_frontier):
    """Convenience: compile + execute, returning (xf list, final frontier)."""
    plan = compile_plan(oplog.cg.graph, list(from_frontier),
                        list(merge_frontier))
    out = list(execute_plan(plan, oplog.cg.agent_assignment, oplog.ops))
    return out, plan.final_frontier
