"""Bidirectional (agent, seq) <-> LV mapping.

Redesign of the reference's AgentAssignment (reference:
src/causalgraph/agent_assignment/mod.rs:10-45): per-agent RLE runs of seqs
mapped to LV spans, plus a global LV-ordered column of (agent, seq_start)
runs. Both sides are append-mostly sorted RLE vectors searched by bisect.
"""

from __future__ import annotations

from bisect import bisect_right, insort
from typing import Dict, List, Optional, Tuple

AgentId = int
AgentVersion = Tuple[AgentId, int]  # (agent, seq)


class AgentAssignment:
    __slots__ = ("agent_names", "_name_to_id", "client_runs", "global_runs")

    def __init__(self) -> None:
        self.agent_names: List[str] = []
        self._name_to_id: Dict[str, AgentId] = {}
        # Per agent: sorted list of (seq_start, seq_end, lv_start). May be
        # inserted into out-of-order (remote peers can deliver seq runs in any
        # order), hence insort rather than append-only.
        self.client_runs: List[List[Tuple[int, int, int]]] = []
        # Global, LV-ordered, packed: (lv_start, lv_end, agent, seq_start).
        self.global_runs: List[Tuple[int, int, int, int]] = []

    # --- agents ----------------------------------------------------------

    def get_or_create_agent(self, name: str) -> AgentId:
        aid = self._name_to_id.get(name)
        if aid is None:
            aid = len(self.agent_names)
            self.agent_names.append(name)
            self._name_to_id[name] = aid
            self.client_runs.append([])
        return aid

    def try_get_agent(self, name: str) -> Optional[AgentId]:
        return self._name_to_id.get(name)

    def get_agent_name(self, agent: AgentId) -> str:
        return self.agent_names[agent]

    def next_seq_for(self, agent: AgentId) -> int:
        runs = self.client_runs[agent]
        return runs[-1][1] if runs else 0

    def len_lv(self) -> int:
        return self.global_runs[-1][1] if self.global_runs else 0

    # --- assignment -------------------------------------------------------

    def assign_span(self, agent: AgentId, seq_start: int, lv_start: int, n: int) -> None:
        """Record that LVs [lv_start, lv_start+n) are (agent, seq_start..+n)."""
        assert n > 0
        runs = self.client_runs[agent]
        if (runs and runs[-1][1] == seq_start
                and runs[-1][2] + (runs[-1][1] - runs[-1][0]) == lv_start):
            runs[-1] = (runs[-1][0], seq_start + n, runs[-1][2])
        elif runs and seq_start < runs[-1][1]:
            # Out-of-order seq delivery: keep the per-client list sorted.
            insort(runs, (seq_start, seq_start + n, lv_start))
        else:
            runs.append((seq_start, seq_start + n, lv_start))

        g = self.global_runs
        if (g and g[-1][1] == lv_start and g[-1][2] == agent
                and g[-1][3] + (g[-1][1] - g[-1][0]) == seq_start):
            g[-1] = (g[-1][0], lv_start + n, agent, g[-1][3])
        else:
            assert not g or lv_start == g[-1][1], "LVs must be assigned densely"
            g.append((lv_start, lv_start + n, agent, seq_start))

    # --- queries ----------------------------------------------------------

    def local_to_agent_version(self, lv: int) -> AgentVersion:
        lo, hi, agent, seq0 = self._find_global(lv)
        return (agent, seq0 + (lv - lo))

    def local_span_to_agent_span(self, lv: int, max_len: int) -> Tuple[AgentId, int, int]:
        """Returns (agent, seq_start, run_len<=max_len) for the run at `lv`."""
        lo, hi, agent, seq0 = self._find_global(lv)
        n = min(hi - lv, max_len)
        return agent, seq0 + (lv - lo), n

    def _find_global(self, lv: int) -> Tuple[int, int, int, int]:
        i = bisect_right(self.global_runs, lv, key=lambda r: r[0]) - 1
        if i < 0 or lv >= self.global_runs[i][1]:
            raise KeyError(f"LV {lv} unassigned")
        return self.global_runs[i]

    def try_agent_version_to_lv(self, agent: AgentId, seq: int) -> Optional[int]:
        if agent >= len(self.client_runs):
            return None
        runs = self.client_runs[agent]
        i = bisect_right(runs, seq, key=lambda r: r[0]) - 1
        if i < 0 or seq >= runs[i][1]:
            return None
        s0, _s1, lv0 = runs[i]
        return lv0 + (seq - s0)

    def agent_version_to_lv(self, agent: AgentId, seq: int) -> int:
        lv = self.try_agent_version_to_lv(agent, seq)
        if lv is None:
            raise KeyError(f"(agent {agent}, seq {seq}) unknown")
        return lv

    def seq_run_known_len(self, agent: AgentId, seq: int) -> int:
        """How many seqs from `seq` onward map to contiguous LVs."""
        runs = self.client_runs[agent]
        i = bisect_right(runs, seq, key=lambda r: r[0]) - 1
        assert i >= 0 and seq < runs[i][1]
        return runs[i][1] - seq

    def tie_break_agent_versions(self, a: AgentVersion, b: AgentVersion) -> int:
        """Deterministic ordering for fully concurrent versions: by agent name,
        then seq (reference: agent_assignment/mod.rs:163)."""
        if a == b:
            return 0
        na, nb = self.agent_names[a[0]], self.agent_names[b[0]]
        k = (na, a[1])
        j = (nb, b[1])
        return -1 if k < j else 1
