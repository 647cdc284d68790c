"""Observability: structured counters + stats dumps.

Capability mirror of the reference's tracing facilities (SURVEY.md §5):
print_stats RLE-compaction dumps (reference: src/list/oplog.rs:353-405),
the thread-local op counters sketched in the merge hot loops (reference:
src/listmerge/merge.rs:311-314, advance_retreat.rs:73-76), and the counting
allocator used for peak-memory probes (reference: crates/trace-alloc).
"""

from __future__ import annotations

import time
from collections import Counter
from contextlib import contextmanager
from typing import Dict


class MergeCounters:
    """Structured counters around the merge kernel."""

    def __init__(self) -> None:
        self.counts: Counter = Counter()
        self.timings: Dict[str, float] = {}

    def bump(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    @contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + \
                (time.perf_counter() - t0)

    def snapshot(self) -> Dict:
        return {"counts": dict(self.counts), "timings": dict(self.timings)}


GLOBAL_COUNTERS = MergeCounters()


def oplog_stats(oplog, include_encoded_sizes: bool = False) -> Dict:
    """RLE compaction ratios & per-structure byte breakdown (reference:
    src/list/oplog.rs:353-405 print_stats — entry counts, packed bytes,
    and the ratio vs one record per op).

    Byte figures are the packed columnar widths: op runs are 6 i64
    columns, graph runs 3 i64 columns + one i64 per parent edge, agent
    runs 4 i64 columns; arenas are UTF-32 chars x 4 (the device-uniform
    char space). `include_encoded_sizes` adds the actual wire sizes
    (full snapshot + patch header cost), which is what the reference's
    281 KB / 23 KB automerge figures measure."""
    from ..text.op import DEL, INS
    n_lv = len(oplog)
    runs = len(oplog.ops.runs)
    graph = oplog.cg.graph
    n_parents = sum(len(p) for p in graph.parents)
    n_agent_runs = len(oplog.cg.agent_assignment.global_runs)
    rec_op = 6 * 8
    out = {
        "num_ops": n_lv,
        "op_runs": runs,
        "ops_per_run": round(n_lv / runs, 2) if runs else 0.0,
        "op_runs_bytes": runs * rec_op,
        "op_uncompacted_bytes": n_lv * rec_op,
        "op_compaction_ratio": round(n_lv / runs, 2) if runs else 0.0,
        "graph_runs": len(graph),
        "graph_runs_bytes": len(graph) * 3 * 8 + n_parents * 8,
        "graph_parent_edges": n_parents,
        "agent_runs": n_agent_runs,
        "agent_runs_bytes": n_agent_runs * 4 * 8,
        "agents": len(oplog.cg.agent_assignment.agent_names),
        "ins_arena_chars": oplog.ops.arena_len(INS),
        "ins_arena_bytes": oplog.ops.arena_len(INS) * 4,
        "del_arena_chars": oplog.ops.arena_len(DEL),
        "del_arena_bytes": oplog.ops.arena_len(DEL) * 4,
        "frontier_len": len(oplog.cg.version),
    }
    if include_encoded_sizes:
        from ..encoding.encode import (ENCODE_FULL, ENCODE_PATCH,
                                       encode_oplog)
        out["encoded_full_bytes"] = len(encode_oplog(oplog, ENCODE_FULL))
        out["encoded_patch_from_tip_bytes"] = len(
            encode_oplog(oplog, ENCODE_PATCH, from_version=oplog.version))
    return out


def print_stats(oplog) -> None:
    for k, v in oplog_stats(oplog).items():
        print(f"{k}: {v}")


def peak_memory_probe(fn, *args, **kwargs):
    """Run fn while tracking peak Python allocation (reference: trace-alloc
    counting allocator behind the memusage feature)."""
    import tracemalloc
    tracemalloc.start()
    try:
        result = fn(*args, **kwargs)
        _current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return result, peak
