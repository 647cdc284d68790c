"""Cross-host trace assembly: clock alignment, span-tree merge,
stage waterfall, and critical-path analysis.

Span `t0` timestamps are per-host `time.monotonic()` readings — two
hosts' spans live on unrelated clocks and cannot be interleaved
directly. The assembler aligns them with ping-RTT offset estimation:
each `GET /debug/trace/<id>` fetch records the caller's send/receive
monotonic times around the request, and the response carries the
server's own `now`. Under the symmetric-RTT assumption the server
sampled `now` at the RTT midpoint, so

    offset = remote_now - (t_send + t_recv) / 2

maps every remote timestamp into the caller's clock (`local = remote
- offset`). The estimate is wrong by at most half the RTT asymmetry
plus jitter — small against cross-host replication lags, but not
zero, so after alignment a *monotonic repair* clamps every child's
start to be >= its parent's start: residual skew must never make an
effect precede its cause. Durations are host-local and never
adjusted.

The critical path walks the merged tree from the root, at each span
descending into the child whose interval ends last. Each span on the
path *owns* its duration minus its chosen child's — the telescoping
sum makes the owned segments add up to exactly the root's wall time,
so "which stage owns the edit-to-visibility wall clock" is an exact
decomposition, not a heuristic. A negative owned segment flags a
child that (after alignment) outlives its parent — residual clock
noise worth seeing, not hiding.

`replicate/faults.py`'s clock-skew bookkeeping (`set_clock_skew` /
`now(host)`) is the test seam: tests generate span sets on skewed
clocks and assert the assembly still orders stages monotonically.
"""

from __future__ import annotations

from typing import List, Optional


def estimate_offset(t_send: float, t_recv: float,
                    remote_now: float) -> float:
    """Offset of the remote monotonic clock relative to the caller's,
    assuming `remote_now` was sampled at the RTT midpoint."""
    return remote_now - 0.5 * (t_send + t_recv)


def align(fetches: List[dict]) -> List[dict]:
    """Flatten per-host span fetches onto one clock.

    Each fetch is `{"host", "spans", "now", "t_send", "t_recv"}` (or
    carries a precomputed `"offset_s"`). Returns copies of the spans
    with `host` and `_t0` (aligned start) added."""
    out = []
    for f in fetches:
        off = f.get("offset_s")
        if off is None:
            off = estimate_offset(f["t_send"], f["t_recv"], f["now"])
        for s in f.get("spans") or []:
            rec = dict(s)
            rec["host"] = f.get("host", "?")
            rec["_t0"] = s["t0"] - off
            out.append(rec)
    return out


def build_tree(spans: List[dict]):
    """Index the merged span set into (root, children, orphans) and
    apply the monotonic repair along parent->child edges."""
    by_id = {s["span"]: s for s in spans}
    children: dict = {}
    roots = []
    for s in spans:
        p = s.get("parent")
        if p and p in by_id:
            children.setdefault(p, []).append(s)
        else:
            roots.append(s)
    if not roots:
        return None, children, []
    roots.sort(key=lambda s: s["_t0"])
    root = roots[0]
    # monotonic repair: residual offset error must never order a child
    # before its parent (cause before effect). The `seen` guard keeps
    # a parent cycle (span-id collisions in a hand-fed or adversarial
    # fetch) from hanging the walk — the cycle degrades to a truncated
    # subtree instead.
    seen = {r["span"] for r in roots}
    for r in roots:
        stack = [r]
        while stack:
            node = stack.pop()
            kids = children.get(node["span"])
            if not kids:
                continue
            for k in kids:
                if k["_t0"] < node["_t0"]:
                    k["_t0"] = node["_t0"]
            kids.sort(key=lambda s: s["_t0"])
            fresh = [k for k in kids if k["span"] not in seen]
            seen.update(k["span"] for k in fresh)
            stack.extend(fresh)
    return root, children, roots[1:]


def critical_path(root: dict, children: dict) -> List[dict]:
    """Root-to-leaf chain through the latest-ending child at every
    step, with exact owned-time decomposition (sums to root wall)."""
    path = []
    seen = set()
    node = root
    while node is not None and node["span"] not in seen:
        seen.add(node["span"])
        path.append(node)
        kids = children.get(node["span"]) or []
        node = max(kids, key=lambda s: s["_t0"] + s["dur_s"]) \
            if kids else None
    segs = []
    for i, s in enumerate(path):
        nxt = path[i + 1] if i + 1 < len(path) else None
        owned = s["dur_s"] - (nxt["dur_s"] if nxt is not None else 0.0)
        segs.append({"name": s["name"], "host": s["host"],
                     "span": s["span"],
                     "t0_rel_s": round(s["_t0"] - root["_t0"], 6),
                     "dur_s": s["dur_s"],
                     "owned_s": round(owned, 6)})
    return segs


def _depths(root: dict, children: dict) -> dict:
    depth = {root["span"]: 0}
    stack = [root]
    while stack:
        node = stack.pop()
        for k in children.get(node["span"]) or []:
            if k["span"] in depth:
                continue        # cycle / duplicate id: keep first
            depth[k["span"]] = depth[node["span"]] + 1
            stack.append(k)
    return depth


def assemble_trace(trace_id: str, fetches: List[dict]) -> dict:
    """Merge per-host span fetches for one trace id into a single
    aligned tree with waterfall + critical path."""
    spans = [s for s in align(fetches) if s.get("trace") == trace_id]
    if not spans:
        return {"trace": trace_id, "spans": 0, "hosts": [],
                "waterfall": [], "critical_path": [], "wall_s": 0.0,
                "critical_path_s": 0.0, "root": None, "orphans": 0}
    root, children, orphans = build_tree(spans)
    depth = _depths(root, children)
    water = sorted(
        ({"name": s["name"], "host": s["host"], "span": s["span"],
          "parent": s.get("parent"),
          "depth": depth.get(s["span"], 0),
          "t0_rel_s": round(s["_t0"] - root["_t0"], 6),
          "dur_s": s["dur_s"],
          "attrs": s.get("attrs") or {}}
         for s in spans),
        key=lambda r: (r["t0_rel_s"], r["depth"]))
    cp = critical_path(root, children)
    return {"trace": trace_id,
            "root": {"name": root["name"], "host": root["host"]},
            "hosts": sorted({s["host"] for s in spans}),
            "spans": len(spans),
            "orphans": len(orphans),
            "wall_s": root["dur_s"],
            "waterfall": water,
            "critical_path": cp,
            "critical_path_s": round(sum(r["owned_s"] for r in cp), 6)}


def aggregate(reports: List[dict]) -> dict:
    """Aggregate critical-path ownership across traces: which
    (span name, host) owns the mesh's wall time overall."""
    owners: dict = {}
    total = 0.0
    for rep in reports:
        for seg in rep.get("critical_path") or []:
            key = (seg["name"], seg["host"])
            agg = owners.setdefault(key, {"owned_s": 0.0, "count": 0})
            agg["owned_s"] += seg["owned_s"]
            agg["count"] += 1
            total += seg["owned_s"]
    rows = [{"name": name, "host": host,
             "owned_s": round(agg["owned_s"], 6),
             "count": agg["count"],
             "share": round(agg["owned_s"] / total, 4)
             if total > 0 else 0.0}
            for (name, host), agg in owners.items()]
    rows.sort(key=lambda r: -r["owned_s"])
    return {"traces": len(reports), "total_owned_s": round(total, 6),
            "owners": rows}


def render_human(rep: dict, agg: Optional[dict] = None) -> str:
    """Human waterfall + critical path for `cli dt-trace`."""
    lines = []
    if rep["spans"] == 0:
        return f"trace {rep['trace']}: no spans found"
    lines.append(
        f"== trace {rep['trace']} ({rep['spans']} spans, "
        f"{len(rep['hosts'])} hosts, wall "
        f"{rep['wall_s'] * 1e3:.3f}ms"
        + (f", {rep['orphans']} orphans" if rep["orphans"] else "")
        + ") ==")
    for row in rep["waterfall"]:
        pad = "  " * row["depth"]
        lines.append(
            f"  {row['t0_rel_s'] * 1e3:9.3f}ms {pad}"
            f"{row['name']} @{row['host']} "
            f"{row['dur_s'] * 1e3:.3f}ms")
    lines.append(f"== critical path ({rep['critical_path_s'] * 1e3:.3f}"
                 f"ms of {rep['wall_s'] * 1e3:.3f}ms) ==")
    wall = max(rep["wall_s"], 1e-12)
    for seg in rep["critical_path"]:
        lines.append(
            f"  {seg['name']} @{seg['host']} owns "
            f"{seg['owned_s'] * 1e3:.3f}ms "
            f"({100.0 * seg['owned_s'] / wall:.1f}%)")
    if agg is not None:
        lines.append(f"== aggregated ownership "
                     f"({agg['traces']} traces) ==")
        for row in agg["owners"]:
            lines.append(
                f"  {row['name']} @{row['host']} owns "
                f"{row['owned_s'] * 1e3:.3f}ms "
                f"({100.0 * row['share']:.1f}% of "
                f"{agg['total_owned_s'] * 1e3:.3f}ms, "
                f"{row['count']} segments)")
    return "\n".join(lines)
