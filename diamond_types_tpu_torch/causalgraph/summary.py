"""Peer-sync handshake: version summaries.

Capability mirror of the reference's summary.rs (reference:
src/causalgraph/summary.rs:13-29, 119-234): a VersionSummary names, per agent,
the seq ranges a peer knows. Intersecting a remote summary with the local
causal graph yields (a) the common version frontier — the point to encode a
patch from — and (b) a remainder summary of ops the remote has that we lack.

Wire shape is plain JSON: {"agent": [[s0, e0], [s1, e1], ...], ...} (matching
the reference's serde encoding), so any transport works.

The JAX package's `causalgraph/summary.py`, copied: the storage layer's
patch encodes intersect with it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.span import merge_spans
from .causal_graph import CausalGraph

VersionSummary = Dict[str, List[List[int]]]
VersionSummaryFlat = Dict[str, int]


def summarize_versions(cg: CausalGraph) -> VersionSummary:
    """reference: summary.rs:119-132."""
    out: VersionSummary = {}
    aa = cg.agent_assignment
    for agent, runs in enumerate(aa.client_runs):
        if not runs:
            continue
        spans = merge_spans((s0, s1) for (s0, s1, _lv) in runs)
        out[aa.get_agent_name(agent)] = [[a, b] for (a, b) in spans]
    return out


def summarize_versions_flat(cg: CausalGraph) -> VersionSummaryFlat:
    """reference: summary.rs:134-139."""
    out: VersionSummaryFlat = {}
    aa = cg.agent_assignment
    for agent, runs in enumerate(aa.client_runs):
        if runs:
            out[aa.get_agent_name(agent)] = runs[-1][1]
    return out


def intersect_with_summary(cg: CausalGraph, summary: VersionSummary,
                           frontier: Sequence[int] = ()
                           ) -> Tuple[List[int], Optional[VersionSummary]]:
    """Returns (common_frontier, remainder_summary|None)
    (reference: summary.rs:234 intersect_with_summary)."""
    aa = cg.agent_assignment
    versions: List[int] = list(frontier)
    remainder: VersionSummary = {}

    for name, seq_ranges in summary.items():
        agent = aa.try_get_agent(name)
        if agent is None:
            remainder[name] = [list(r) for r in seq_ranges]
            continue
        runs = aa.client_runs[agent]
        for (want0, want1) in seq_ranges:
            expect_next = want0
            for (s0, s1, lv0) in runs:
                lo, hi = max(s0, want0), min(s1, want1)
                if hi <= lo:
                    continue
                if lo > expect_next:
                    remainder.setdefault(name, []).append([expect_next, lo])
                expect_next = hi
                # The covered LV span may cross graph-run boundaries (an
                # agent's contiguous seqs can land on different branches);
                # push the last LV of each graph-run piece so dominators are
                # exact. (The reference pushes one version per client run —
                # summary.rs:199 — a safe approximation that can over-send.)
                lv_lo = lv0 + (lo - s0)
                lv_hi = lv0 + (hi - s0)
                while lv_lo < lv_hi:
                    gi = cg.graph.find_idx(lv_lo)
                    piece_end = min(cg.graph.ends[gi], lv_hi)
                    versions.append(piece_end - 1)
                    lv_lo = piece_end
            if expect_next < want1:
                remainder.setdefault(name, []).append([expect_next, want1])

    return (cg.graph.find_dominators(versions),
            remainder if remainder else None)


def intersect_with_flat_summary(cg: CausalGraph, summary: VersionSummaryFlat,
                                frontier: Sequence[int] = ()
                                ) -> Tuple[List[int], Optional[VersionSummaryFlat]]:
    """reference: summary.rs:186-206."""
    full = {name: [[0, next_seq]] for name, next_seq in summary.items()}
    common, rem = intersect_with_summary(cg, full, frontier)
    flat_rem: Optional[VersionSummaryFlat] = None
    if rem:
        flat_rem = {name: max(r[1] for r in ranges)
                    for name, ranges in rem.items()}
    return common, flat_rem
