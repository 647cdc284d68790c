"""The flush's phases, read from inside the program: the readers' arithmetic
over the scheduler's `flush_phases` block and its new histograms, and a
traced run with every flush's phase spans laid against the device trace.

    python3 -m dtbench.phases --workload fused-concurrent --seed <n> \\
        --seconds 40 [--spans 0|1]

The run is the benchmark's own traced run (`--trace 1`: set-up, window,
drain, check), with the end-to-end `merged_ops_per_s` reported beside the
per-layer metrics. With `--spans 1` (the default) the tier is the merge
tier with `MergeScheduler.trace_flushes` on and its tracer's ring sized for
the window (`tiers/traced_merge_tier.py`), and the window's `bank.*` spans
are reduced against the device's idle time (`phase_idle`); the result's
`notes.phases` holds:

  idle_by_phase        device-idle seconds inside each phase, as the union
                       over shards (phases of different shards overlap, so
                       these may sum to more than the idle time)
  no_flush_idle_s      seconds with the device idle and no flush open
  idle_no_flush_pct    the same over the window's seconds
  idle_gaps_by_phase   for each of the breakdown's idle gaps, in its order:
                       [gap seconds, [[phase, overlap seconds], ...]], where
                       "no_flush" is the part with no flush open and
                       "no_phase" the part inside a flush in no phase (the
                       oplog or device lock's wait, the flush's own
                       bookkeeping)
  window               the window's phase seconds, oplog wait and holds,
                       `latencies.flush` sum, and `coverage`: the phases and
                       the oplog wait over that sum
  stalled_seconds      for each second of the window in which no sync
                       committed: [second, [[phase, seconds open], ...]]

It prints each gap's phases on standard error. `--spans 0` runs the plain
traced run (no flush spans), so the two can be compared for the spans'
cost. The benchmark's own runs (`python3 -m dtbench`) never open a flush
span.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]

# the bank's phase spans (serve/metrics.py FLUSH_PHASES, as `bank.<phase>`)
# and the spans a flush opens around them, on either flush path
PHASE_PREFIX = "bank."
FLUSH_SPANS = ("serve.flush", "serve.mesh_window")
# the tracer's ring for a traced window: about 15 spans a flush and at most
# 100 flushes a second a shard
SPANS_PER_S = 6000
# the tiers that `traced_merge_tier` built in this process, newest last
TIERS: list = []


# ---- the readers' arithmetic ------------------------------------------------

def window_phase_s(ctx, phase: str) -> Optional[float]:
    """Seconds the window added to `flush_phases.seconds[phase]`; None when
    the program keeps no such counter."""
    a = ctx["sched_after"].get("flush_phases")
    b = ctx["sched_before"].get("flush_phases")
    if a is None or b is None:
        return None
    return a["seconds"][phase] - b["seconds"][phase]


def phase_us_per_op(ctx, phase: str) -> Optional[float]:
    """A phase's microseconds per op committed in the window: the window's
    delta of the phase's seconds over the ops of every sync committed in
    it (the base `k1_us_per_op` divides by)."""
    from dtbench.metrics import committed_in_window
    s = window_phase_s(ctx, phase)
    ops = sum(x.n_ops for x in committed_in_window(ctx))
    if s is None or ops == 0:
        return None
    return 1e6 * s / ops


def window_quantile_ms(ctx, family: str, q: float) -> Optional[float]:
    """The q-quantile in ms of what the window added to
    `latencies.<family>`; None when the program keeps no such histogram or
    the window recorded nothing."""
    from dtbench.metrics import hist_quantile, hist_window
    if family not in ctx["sched_after"].get("latencies", {}) \
            or family not in ctx["sched_before"].get("latencies", {}):
        return None
    v = hist_quantile(hist_window(ctx["sched_before"], ctx["sched_after"],
                                  family), q)
    return None if v is None else 1e3 * v


# ---- intervals --------------------------------------------------------------

def clip(intervals: Sequence[Interval], t0: int, t1: int) -> List[Interval]:
    """The parts of `intervals` inside [t0, t1], merged and sorted."""
    from dtbench.trace import union
    return union(sorted((max(s, t0), min(t, t1)) for s, t in intervals
                        if min(t, t1) > max(s, t0)))


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if t > s:
            out.append((s, t))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """`a` less `b`, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for s, t in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < t:
            out.append((cur, t))
    return out


def measure(intervals: Sequence[Interval]) -> float:
    """Total seconds of disjoint ns intervals."""
    return sum(t - s for s, t in intervals) / 1e9


def phase_idle(idle: Sequence[Interval], spans: Sequence[dict], t0: int,
               t1: int, gaps: Sequence[Interval]) -> dict:
    """The device's idle time by flush phase. `idle` is the window's idle
    intervals (ns, sorted, disjoint), `spans` the tracer's finished
    records (`t0_ns`, `t1_ns`), `gaps` the breakdown's idle gaps in its
    order. Spans are clipped to the window [t0, t1]; each phase is the
    union of its spans over every shard."""
    by_phase: Dict[str, List[Interval]] = {}
    flush: List[Interval] = []
    for sp in spans:
        iv = (sp["t0_ns"], sp["t1_ns"])
        if sp["name"].startswith(PHASE_PREFIX):
            by_phase.setdefault(sp["name"][len(PHASE_PREFIX):],
                                []).append(iv)
        elif sp["name"] in FLUSH_SPANS:
            flush.append(iv)
    phases = {p: clip(ivs, t0, t1) for p, ivs in sorted(by_phase.items())}
    flush = clip(flush, t0, t1)
    any_phase = clip([iv for ivs in phases.values() for iv in ivs], t0, t1)
    idle = clip(idle, t0, t1)
    out = {"idle_by_phase": {p: measure(intersect(idle, ivs))
                             for p, ivs in phases.items()},
           "no_flush_idle_s": measure(subtract(idle, flush)),
           "idle_gaps_by_phase": []}
    for s, t in gaps:
        g = clip([(s, t)], t0, t1)
        parts = [[p, measure(intersect(g, ivs))]
                 for p, ivs in phases.items()]
        parts = sorted((x for x in parts if x[1] > 0), key=lambda x: -x[1])
        for name, part in (
                ("no_phase", intersect(subtract(g, any_phase), flush)),
                ("no_flush", subtract(g, flush))):
            if measure(part) > 0:
                parts.append([name, measure(part)])
        out["idle_gaps_by_phase"].append([(t - s) / 1e9, parts])
    return out


# ---- the traced run ---------------------------------------------------------

def _trace_class():
    from dtbench.trace import DeviceTrace, idle_gaps, union

    class PhaseTrace(DeviceTrace):
        """The benchmark's device trace, with the window's scheduler
        snapshots and its flush spans reduced by phase (`phase_notes`)."""

        last: Optional["PhaseTrace"] = None

        def __enter__(self):
            PhaseTrace.last = self
            super().__enter__()
            self.before = TIERS[-1].sched.metrics_json()
            return self

        def __exit__(self, *exc):
            self.after = TIERS[-1].sched.metrics_json()
            super().__exit__(*exc)

        def reduce(self, top: int = 10) -> dict:
            red = super().reduce(top)
            tier = TIERS[-1]
            busy = union(sorted((s, t) for _n, s, t
                                in self.device_events()))
            idle = idle_gaps(busy, self.t0_ns, self.t1_ns)
            gaps = sorted(idle, key=lambda g: g[0] - g[1])[:top]
            notes = {"window": window_totals(self.before, self.after)}
            self.spans = []
            tracer = getattr(getattr(tier, "obs", None), "tracer", None)
            if tracer is not None and tier.trace_spans:
                spans = self.spans = [sp for sp in tracer.spans()
                                      if "t0_ns" in sp]
                notes.update(phase_idle(idle, spans, self.t0_ns,
                                        self.t1_ns, gaps))
                notes["idle_no_flush_pct"] = \
                    100.0 * notes["no_flush_idle_s"] / red["window_s"]
                st = tracer.stats()
                notes["spans"] = {"buffered": st["buffered"],
                                  "finished": st["finished"]}
            self.phase_notes = notes
            return red

    return PhaseTrace


def window_totals(before: dict, after: dict) -> dict:
    """The window's phase seconds, oplog wait and holds, and
    `latencies.flush` sum, with the share of that sum the phases and the
    oplog wait cover; empty when the program keeps no phases."""
    if "flush_phases" not in after:
        return {}
    a, b = after["flush_phases"], before["flush_phases"]
    phases = {p: a["seconds"][p] - b["seconds"][p] for p in a["seconds"]}
    wait = a["oplog_wait_s"] - b["oplog_wait_s"]
    flush = after["latencies"]["flush"]["sum"] \
        - before["latencies"]["flush"]["sum"]
    return {"phase_s": phases, "oplog_wait_s": wait,
            "oplog_hold_s": a["oplog_hold_s"] - b["oplog_hold_s"],
            "oplog_holds": a["oplog_holds"] - b["oplog_holds"],
            "flush_sum_s": flush,
            "coverage": (sum(phases.values()) + wait) / flush
            if flush > 0 else None}


def main(argv=None) -> int:
    from dtbench import trace as trace_mod
    from dtbench.run import (build_program, cell_metrics, load_cell,
                             print_result, run_cell)
    ap = argparse.ArgumentParser(prog="python3 -m dtbench.phases",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    manifest, cell, config, mix = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("dtbench.phases: needs a CUDA card", file=sys.stderr)
        return 2
    config = dict(config, tier="traced_merge_tier", trace_spans=args.spans,
                  span_ring=int(SPANS_PER_S * args.seconds) + 10000)
    specs = [m for m in manifest["end_to_end"]
             if m["name"] == "merged_ops_per_s"] \
        + cell_metrics(manifest, cell["name"], True)
    build_program(torch.device("cuda"))
    TIERS.clear()
    real = trace_mod.DeviceTrace
    trace_mod.DeviceTrace = _trace_class()     # run_cell's traced window
    try:
        result = run_cell(cell, config, mix, specs, args.seed, args.seconds,
                          True, "cuda")
        traced = trace_mod.DeviceTrace.last
    finally:
        trace_mod.DeviceTrace = real
    notes = traced.phase_notes
    stalled = [k for k, n in enumerate(result["notes"]["commits_by_s"])
               if n == 0]
    if stalled and traced.spans:
        # each second of the window in which nothing committed, with the
        # phases open in it (its seconds counted from the trace's start)
        secs = [(traced.t0_ns + k * 10**9, traced.t0_ns + (k + 1) * 10**9)
                for k in stalled]
        by = phase_idle(secs, traced.spans, traced.t0_ns, traced.t1_ns,
                        secs)
        notes["stalled_seconds"] = [[k, parts] for k, (_g, parts)
                                    in zip(stalled,
                                           by["idle_gaps_by_phase"])]
    result["notes"]["phases"] = notes
    for (label, dur), (_s, parts) in zip(
            result["breakdown"]["idle_gaps"],
            notes.get("idle_gaps_by_phase", [])):
        named = ", ".join(f"{p} {s:.4f}" for p, s in parts) or "-"
        print(f"gap {dur:.4f} s (sampler: {label}): {named}",
              file=sys.stderr)
    print_result(result)
    return 0


if __name__ == "__main__":
    # run as the module `dtbench.phases`, whose TIERS the traced tier fills
    from dtbench.phases import main as module_main
    sys.exit(module_main())
