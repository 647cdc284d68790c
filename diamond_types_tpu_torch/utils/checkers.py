"""Deep invariant checkers.

Capability mirror of the reference's dbg_check family (reference:
src/causalgraph/check.rs, src/causalgraph/graph/check.rs, src/check.rs;
SURVEY.md §4.5): structural validation compiled into tests and callable on
demand when debugging.
"""

from __future__ import annotations

from ..causalgraph.causal_graph import CausalGraph
from ..causalgraph.graph import Graph
from ..text.oplog import OpLog


def check_graph(g: Graph, deep: bool = False) -> None:
    n = len(g)
    prev_end = 0
    for i in range(n):
        assert g.starts[i] == prev_end, "graph runs must be dense"
        assert g.ends[i] > g.starts[i]
        prev_end = g.ends[i]
        ps = g.parents[i]
        assert list(ps) == sorted(set(ps)), "parents sorted and unique"
        for p in ps:
            assert 0 <= p < g.starts[i], "parents strictly earlier"
        # Shadow: every LV in [shadow, start) must be an ancestor of start.
        assert g.shadows[i] <= g.starts[i]
        if deep and g.starts[i] > 0:
            for v in range(g.shadows[i], g.starts[i]):
                assert g.frontier_contains_version([g.starts[i]], v), \
                    f"shadow {g.shadows[i]} of run {i} is wrong at {v}"
        # child indexes consistent
        for c in g.child_idxs[i]:
            assert g.starts[i] in [p if p >= 0 else -1
                                   for p in g.parents[c]] or \
                any(g.starts[i] <= p < g.ends[i] for p in g.parents[c])
    for r in g.root_child_idxs:
        assert g.parents[r] == ()


def check_cg(cg: CausalGraph, deep: bool = False) -> None:
    check_graph(cg.graph, deep)
    aa = cg.agent_assignment
    # Global runs dense over the LV space.
    prev = 0
    for (lv0, lv1, agent, seq0) in aa.global_runs:
        assert lv0 == prev and lv1 > lv0
        assert 0 <= agent < len(aa.agent_names)
        prev = lv1
    assert prev == cg.graph.next_lv(), "assignment and graph lengths differ"
    # Per-client runs sorted, disjoint, and consistent with the global map.
    for agent, runs in enumerate(aa.client_runs):
        prev_seq = -1
        for (s0, s1, lv0) in runs:
            assert s0 > prev_seq and s1 > s0
            prev_seq = s1 - 1
            if deep:
                for off in (0, s1 - s0 - 1):
                    a2, seq2 = aa.local_to_agent_version(lv0 + off)
                    assert (a2, seq2) == (agent, s0 + off)
    # The version must be a valid dominator set.
    f = list(cg.version)
    assert f == sorted(set(f))
    if deep and len(f) > 1:
        assert cg.graph.find_dominators(f) == f, "version isn't a frontier"


def check_oplog(ol: OpLog, deep: bool = False) -> None:
    check_cg(ol.cg, deep)
    assert ol.ops.end_lv() == len(ol), "op table and causal graph differ"
    prev_end = 0
    for run in ol.ops.runs:
        assert run.lv == prev_end
        assert run.end > run.start
        prev_end = run.lv + len(run)
        if run.content_pos is not None:
            assert run.content_pos[1] - run.content_pos[0] == len(run)
