"""CausalGraph facade: agent assignment + parents graph + current version.

Capability mirror of the reference CausalGraph (reference:
src/causalgraph/mod.rs:21-34, causalgraph.rs:65-201), including the 3-case
partial-overlap dedup in `merge_and_assign` that makes patch ingestion
idempotent and order-tolerant.
"""

from __future__ import annotations

from bisect import bisect_right, insort
from typing import List, Optional, Sequence, Tuple

from ..core.frontier import Frontier, replace_with_1
from ..core.span import Span
from .agent import AgentAssignment, AgentId
from .graph import Graph, ROOT


class CausalGraph:
    __slots__ = ("agent_assignment", "graph", "version")

    def __init__(self) -> None:
        self.agent_assignment = AgentAssignment()
        self.graph = Graph()
        self.version: Frontier = []

    def __len__(self) -> int:
        return self.graph.next_lv()

    def get_or_create_agent(self, name: str) -> AgentId:
        return self.agent_assignment.get_or_create_agent(name)

    # --- local append path ------------------------------------------------

    def assign_local_op(self, agent: AgentId, num: int) -> Span:
        """Append `num` new LVs by `agent` with the current version as parent
        (reference: causalgraph.rs:82-93)."""
        return self.assign_local_op_with_parents(list(self.version), agent, num)

    def assign_local_op_with_parents(self, parents: Sequence[int], agent: AgentId,
                                     num: int) -> Span:
        start = len(self)
        seq = self.agent_assignment.next_seq_for(agent)
        self.agent_assignment.assign_span(agent, seq, start, num)
        self.graph.push(parents, start, start + num)
        self.graph._advance_known_run(self.version, parents, (start, start + num))
        return (start, start + num)

    # --- remote merge path --------------------------------------------------

    def merge_and_assign(self, parents: Sequence[int], agent: AgentId,
                         seq_start: int, n: int) -> Span:
        """Merge a remote run (agent, seq_start..+n) whose first op has
        `parents`. Returns the *newly added* LV span, which is empty/truncated
        when ops are already known (reference: causalgraph.rs:132-201).
        """
        time_start = len(self)
        aa = self.agent_assignment
        runs = aa.client_runs[agent]
        seq_last = seq_start + n - 1

        # Case 1: last seq already known => whole span already known.
        i = bisect_right(runs, seq_last, key=lambda r: r[0]) - 1
        if i >= 0 and seq_last < runs[i][1]:
            return (time_start, time_start)

        # idx = insertion point for this new run in the per-client RLE list.
        idx = bisect_right(runs, seq_start, key=lambda r: r[0])
        if idx >= 1:
            ps0, ps1, plv = runs[idx - 1]
            if ps1 >= seq_start:
                # Case 3: overlap at the head. Trim to the unknown tail.
                actual_len = (seq_start + n) - ps1
                time_span = (time_start, time_start + actual_len)
                if ps1 > seq_start:
                    # Overlapping head: the tail's parent is the last known LV
                    # of the previous run.
                    eff_parents: Sequence[int] = [plv + (ps1 - ps0) - 1]
                else:
                    eff_parents = parents
                self.graph.push(eff_parents, *time_span)
                self.graph._advance_known_run(self.version, eff_parents, time_span)
                # Extend the client run & global column.
                if plv + (ps1 - ps0) == time_start:
                    runs[idx - 1] = (ps0, seq_start + n, plv)
                else:
                    insort(runs, (ps1, seq_start + n, time_start))
                aa.global_runs.append((time_start, time_start + actual_len, agent, ps1))
                return time_span

        # Case 2: fully new.
        time_span = (time_start, time_start + n)
        insort(runs, (seq_start, seq_start + n, time_start))
        g = aa.global_runs
        if (g and g[-1][1] == time_start and g[-1][2] == agent
                and g[-1][3] + (g[-1][1] - g[-1][0]) == seq_start):
            g[-1] = (g[-1][0], time_start + n, agent, g[-1][3])
        else:
            g.append((time_start, time_start + n, agent, seq_start))
        self.graph.push(parents, *time_span)
        self.graph._advance_known_run(self.version, parents, time_span)
        return time_span

    # --- wire-safe version naming ------------------------------------------

    def local_to_remote_frontier(self, f: Sequence[int]) -> List[Tuple[str, int]]:
        """Frontier as [(agent_name, seq)] (reference: remote_ids.rs:17-207)."""
        out = []
        for lv in f:
            agent, seq = self.agent_assignment.local_to_agent_version(lv)
            out.append((self.agent_assignment.get_agent_name(agent), seq))
        return out

    def remote_to_local_frontier(self, rf: Sequence[Tuple[str, int]]) -> Frontier:
        out = []
        for name, seq in rf:
            agent = self.agent_assignment.try_get_agent(name)
            if agent is None:
                raise KeyError(f"unknown agent {name!r}")
            out.append(self.agent_assignment.agent_version_to_lv(agent, seq))
        return sorted(out)

    # --- iteration -----------------------------------------------------------

    def iter_entries(self):
        """Yield (lv_start, lv_end, parents, agent, seq_start) runs, splitting
        on both graph-run and agent-run boundaries (reference:
        causalgraph.rs:208-222 rle_zip)."""
        g = self.graph
        for gi in range(len(g)):
            lo, hi = g.starts[gi], g.ends[gi]
            pos = lo
            while pos < hi:
                agent, seq, n = self.agent_assignment.local_span_to_agent_span(
                    pos, hi - pos)
                parents = g.parents[gi] if pos == lo else (pos - 1,)
                yield (pos, pos + n, parents, agent, seq)
                pos += n
