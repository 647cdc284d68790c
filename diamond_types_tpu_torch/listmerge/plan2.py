"""Fork/join merge plans over numbered state indexes.

Capability mirror of the reference's listmerge2 action plans (reference:
src/listmerge2/action_plan.rs:11-37 `MergePlanAction` —
Apply/ForkIndex/DropIndex/MaxIndex over numbered indexes; conflict subgraph
in src/listmerge2/mod.rs:20-33, conflict_subgraph.rs): instead of moving ONE
tracker state back and forth along the conflict DAG with advance/retreat the
way the M1 engine does, keep SEVERAL numbered tracker states ("indexes")
alive at once:

  * every conflict-subgraph entry (a run of ops with one parents set) is
    applied exactly once, to exactly one index;
  * branches fork an index (copy its state row);
  * merge points join indexes with an elementwise state MAX — valid because
    listmerge2's span states are the 3-point lattice NotInsertedYet(0) <
    Inserted(1) < Deleted(2) (reference: listmerge2/yjsspan.rs SpanState)
    where delete *counts* are unnecessary: counts only exist in M1 so that
    retreat can undo one delete at a time, and this engine never retreats.

The compile step is pure control flow (host); execution is pure data
movement over a flat span table with a dense [n_spans, n_indexes] state
matrix (see dense.py) — the representation that lowers to the device tier
(reference: listmerge2/index_gap_buffer.rs:20-31 dense state matrix).

Unlike the reference's DFS planner (action_plan.rs plan_first_pass /
make_plan, which discovers fork/join structure by walking up and down the
subgraph), this compiler exploits a property the reference's own data
guarantees but its planner doesn't use: ascending-LV order over subgraph
entries IS a topological order (parents always have lower LVs). One linear
pass with refcounted index allocation emits the same action algebra with a
free-list bound on peak indexes.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import List, Tuple

from ..causalgraph.graph import DiffFlag, Graph
from ..core.span import Span, push_reversed_rle

# Action opcodes (plan actions are plain tuples so the schedule can be
# packed into arrays for the device tier).
BEGIN = 0   # (BEGIN, idx)             row <- base state (fresh index)
FORK = 1    # (FORK, src, dest)        row[dest] <- row[src]
MAX = 2     # (MAX, dest, src)         row[dest] <- max(row[dest], row[src])
DROP = 3    # (DROP, idx)              free the index
APPLY = 4   # (APPLY, entry_i, idx)    apply entry's op span at row[idx]


@dataclass
class SubgraphEntry:
    """One run of ops in the conflict zone with a single parents set
    (reference: listmerge2/mod.rs ConflictGraphEntry)."""
    span: Span
    parents: Tuple[int, ...]   # indexes of in-zone parent ENTRIES (topo order)
    emit: bool                 # True for only-B ops (new to `from`)
    num_children: int = 0


@dataclass
class MergePlan2:
    entries: List[SubgraphEntry] = field(default_factory=list)
    actions: List[tuple] = field(default_factory=list)
    indexes_used: int = 0
    ff_spans: List[Span] = field(default_factory=list)
    final_frontier: List[int] = field(default_factory=list)
    common: List[int] = field(default_factory=list)  # zone common ancestor
    # pin_lvs support: lv -> index holding that version's state row at
    # plan end (the row is never dropped; device sessions resume from it)
    pinned_rows: dict = field(default_factory=dict)

    def num_ops(self) -> int:
        n = sum(b - a for (a, b) in self.ff_spans)
        n += sum(e.span[1] - e.span[0] for e in self.entries if e.emit)
        return n


def _build_subgraph(graph: Graph, zone_spans: List[Tuple[Span, bool]]
                    ) -> List[SubgraphEntry]:
    """Split zone spans into entries (one parents set each), resolving parent
    LVs to entry indexes. `zone_spans` is ascending and disjoint."""
    # Pass 1: split at graph-run boundaries so each piece lives in one run.
    pieces: List[Tuple[int, int, bool]] = []
    for (s, e), emit in zone_spans:
        v = s
        while v < e:
            i = graph.find_idx(v)
            take = min(e, graph.ends[i])
            pieces.append((v, take, emit))
            v = take

    # Pass 2: cut after every LV that some zone piece names as a parent, so
    # parent LVs always sit at the END of the entry containing them.
    in_zone_starts = [p[0] for p in pieces]

    def in_zone(lv: int) -> bool:
        j = bisect_right(in_zone_starts, lv) - 1
        return j >= 0 and lv < pieces[j][1]

    cuts = set()
    for (s, _e, _emit) in pieces:
        i = graph.find_idx(s)
        if s == graph.starts[i]:
            for p in graph.parents[i]:
                if in_zone(p):
                    cuts.add(p + 1)

    entries: List[SubgraphEntry] = []
    sorted_cuts = sorted(cuts)
    for (s, e, emit) in pieces:
        v = s
        while v < e:
            j = bisect_right(sorted_cuts, v)
            nxt = sorted_cuts[j] if j < len(sorted_cuts) and \
                sorted_cuts[j] < e else e
            entries.append(SubgraphEntry((v, nxt), (), emit))
            v = nxt

    # Pass 3: resolve parents to entry indexes (ascending order = topo order).
    starts = [en.span[0] for en in entries]

    def entry_of(lv: int) -> int:
        j = bisect_right(starts, lv) - 1
        assert j >= 0 and lv < entries[j].span[1], "parent not in zone"
        assert lv == entries[j].span[1] - 1, "parent must end its entry"
        return j

    for k, en in enumerate(entries):
        s = en.span[0]
        i = graph.find_idx(s)
        if s == graph.starts[i]:
            plist = [entry_of(p) for p in graph.parents[i] if in_zone(p)]
        else:
            # Implicit mid-run parent: the previous piece of the same run
            # (unless the zone boundary cuts through the run right here —
            # then the parent is part of the base state).
            plist = [entry_of(s - 1)] if in_zone(s - 1) else []
        en.parents = tuple(plist)
        for p in plist:
            entries[p].num_children += 1
    return entries


def _alloc_actions(entries: List[SubgraphEntry],
                   pinned: Tuple[int, ...] = ()
                   ) -> Tuple[List[tuple], int, dict]:
    """Refcounted index allocation over the topo order. `pinned` entries
    keep their row alive past plan end (an extra phantom use); the
    returned dict maps pinned entry index -> row."""
    actions: List[tuple] = []
    free: List[int] = []
    next_idx = 0
    peak = 0
    row = [-1] * len(entries)
    uses = [en.num_children for en in entries]
    for k in pinned:
        uses[k] += 1

    def alloc() -> int:
        nonlocal next_idx, peak
        if free:
            i = free.pop()
        else:
            i = next_idx
            next_idx += 1
        peak = max(peak, next_idx - len(free))
        return i

    for k, en in enumerate(entries):
        if not en.parents:
            idx = alloc()
            actions.append((BEGIN, idx))
        else:
            p0 = en.parents[0]
            if uses[p0] == 1:
                idx = row[p0]          # consume the parent's row in place
            else:
                idx = alloc()
                actions.append((FORK, row[p0], idx))
            uses[p0] -= 1
            for pk in en.parents[1:]:
                actions.append((MAX, idx, row[pk]))
                uses[pk] -= 1
                if uses[pk] == 0:
                    actions.append((DROP, row[pk]))
                    free.append(row[pk])
        actions.append((APPLY, k, idx))
        row[k] = idx
        if uses[k] == 0:
            actions.append((DROP, idx))
            free.append(idx)
    return actions, peak, {k: row[k] for k in pinned}


def compile_plan2(graph: Graph, from_frontier: List[int],
                  merge_frontier: List[int],
                  pin_lvs: Tuple[int, ...] = ()) -> MergePlan2:
    """Conflict analysis + fast-forward extraction + fork/join schedule.
    Mirrors the control-flow split of plan.compile_plan; the emitted schedule
    is the listmerge2 action algebra instead of a retreat/advance tape."""
    plan = MergePlan2()
    new_ops: List[Span] = []
    conflict_ops: List[Span] = []

    def visit(span: Span, flag: DiffFlag) -> None:
        target = new_ops if flag == DiffFlag.ONLY_B else conflict_ops
        push_reversed_rle(target, span)

    common = graph.find_conflicting(from_frontier, merge_frontier, visit)
    next_frontier = list(from_frontier)

    # Fast-forward prefix (linear history streams through untransformed).
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

        plan.common = list(common)
        zone = sorted([(tuple(s), False) for s in conflict_ops] +
                      [(tuple(s), True) for s in new_ops])
        entries = _build_subgraph(graph, zone)
        # Apply the whole conflict set before the first emitted entry, the
        # way M1 builds the tracker "hot" first (merge.rs:869-887): emitted
        # upstream positions must see the full `from` document. This stays a
        # topological order because an only-B op is never an ancestor of an
        # only-A/shared op (ancestors of hist(from) lie in hist(from)).
        perm = [k for k, en in enumerate(entries) if not en.emit] + \
               [k for k, en in enumerate(entries) if en.emit]
        inv = [0] * len(perm)
        for new_k, old_k in enumerate(perm):
            inv[old_k] = new_k
        plan.entries = [entries[old_k] for old_k in perm]
        for en in plan.entries:
            en.parents = tuple(inv[p] for p in en.parents)
        # pin: entries whose LAST lv is a requested pin point keep their
        # state row alive for session resumption (zone_session.py)
        pins = []
        pin_entry = {}
        for lv in pin_lvs:
            for k, en in enumerate(plan.entries):
                if en.span[1] - 1 == lv:
                    pins.append(k)
                    pin_entry[k] = lv
                    break
        plan.actions, plan.indexes_used, rowmap = _alloc_actions(
            plan.entries, tuple(pins))
        plan.pinned_rows = {pin_entry[k]: r for k, r in rowmap.items()}
        for en in plan.entries:
            if en.emit:
                graph.advance_frontier(next_frontier, en.span)

    plan.final_frontier = next_frontier
    return plan


def validate_plan2(plan: MergePlan2) -> None:
    """Independent correctness check: simulate each index as the SET of
    entries whose effects its row contains; every Apply must see exactly its
    entry's in-zone ancestor set (the reference validates plans similarly by
    simulating index frontiers — action_plan.rs MergePlan::simulate_plan)."""
    anc: List[frozenset] = []
    for en in plan.entries:
        s = set()
        for p in en.parents:
            s |= anc[p] | {p}
        anc.append(frozenset(s))

    sim = {}
    applied = [False] * len(plan.entries)
    live_peak = 0
    for act in plan.actions:
        op = act[0]
        if op == BEGIN:
            assert act[1] not in sim, "BEGIN on live index"
            sim[act[1]] = frozenset()
        elif op == FORK:
            assert act[2] not in sim, "FORK onto live index"
            sim[act[2]] = sim[act[1]]
        elif op == MAX:
            sim[act[1]] = sim[act[1]] | sim[act[2]]
        elif op == DROP:
            del sim[act[1]]
        elif op == APPLY:
            k, idx = act[1], act[2]
            assert not applied[k], "entry applied twice"
            assert sim[idx] == anc[k], \
                f"apply {k}: row holds {sorted(sim[idx])}, " \
                f"needs {sorted(anc[k])}"
            applied[k] = True
            sim[idx] = sim[idx] | {k}
        live_peak = max(live_peak, len(sim))
    assert all(applied), "some entries never applied"
    assert set(sim.keys()) <= set(plan.pinned_rows.values()), \
        "indexes leaked at end of plan (beyond the pinned rows)"
    assert live_peak <= plan.indexes_used
