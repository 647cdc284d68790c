"""Metric readers: one file per metric, `dtbench/metrics/<name>.py`, found
by the metric's name in `BENCHMARK.json` (`load`).

A reader defines `read(ctx) -> float | None`. It returns None when the run
gave it nothing to read, and the harness then leaves the metric out of the
result line. `ctx` holds what one run saw:

  "window_s"       the measured window's length on the host clock
  "setup_s"        seconds from the process's start to the window's
  "syncs"          every sync sent in the window (`clients.Sync`: doc,
                   due, n_ops, committed: None if it never committed)
  "t0", "t_end"    the window's bounds on the clock the syncs use
  "sched_before"   the scheduler's `metrics_json()` as the window opened
  "sched_after"    the same as it closed (before the drain)
  "trace"          with --trace 1, `trace.DeviceTrace.reduce()`: busy_s,
                   window_s, kernels (device seconds by kernel name) and
                   breakdown; else None

The helpers below are shared arithmetic; a reader imports them from here.
"""

from __future__ import annotations

import math
import statistics
from pathlib import Path
from typing import List, Optional

from dtbench import plugins

HERE = Path(__file__).resolve().parent


def load(name: str):
    """The reader of metric `name`: its file's `read`. A name with a
    variant after its last dot (`visible_p95_ms.typing`, the same quantity
    under another name, as an end-to-end tail reported per layer) is read
    by the file of the name before the dot unless it has a file of its
    own."""
    if not (HERE / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return plugins.load("metrics", name).read


# ---- end-to-end arithmetic ----------------------------------------------------

def committed_in_window(ctx) -> list:
    return [s for s in ctx["syncs"]
            if s.committed is not None and s.committed <= ctx["t_end"]]


def latencies_ms(ctx) -> List[float]:
    """Due-to-commit latency of every sync sent in the window that
    committed (one that never did is a failure, counted apart)."""
    return [1e3 * (s.committed - s.due) for s in ctx["syncs"]
            if s.committed is not None]


def quantile(values: List[float], q: float) -> Optional[float]:
    """The q-quantile over all samples (linear between order statistics,
    Python's `statistics.quantiles(..., method="inclusive")`)."""
    if len(values) < 2:
        return values[0] if values else None
    if q == 0.5:
        return statistics.median(values)
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return cuts[round(100 * q) - 1]


# ---- the scheduler's histograms (serve/metrics.py, obs/hist.py) ---------------

# obs/hist.py's buckets, copied: 28 log2 buckets from 1 us
FIRST_BOUND_S = 1e-6
N_BUCKETS = 28
BOUNDS = tuple(FIRST_BOUND_S * (2.0 ** i) for i in range(N_BUCKETS))


def _counts(snap: dict) -> List[int]:
    """Per-bucket counts (overflow last) from a histogram snapshot's
    cumulative [[le, cum], ..., ["+Inf", count]]."""
    out = [0] * (N_BUCKETS + 1)
    prev = 0
    for le, cum in snap["buckets"]:
        i = N_BUCKETS if le == "+Inf" else \
            int(round(math.log2(le / FIRST_BOUND_S)))
        out[i] += cum - prev
        prev = cum
    return out


def hist_window(before: dict, after: dict, family: str) -> List[int]:
    """Bucket counts the window added to `latencies.<family>`."""
    a = _counts(after["latencies"][family])
    b = _counts(before["latencies"][family])
    return [x - y for x, y in zip(a, b)]


def hist_quantile(counts: List[int], q: float) -> Optional[float]:
    """obs/hist.py's interpolated quantile over bucket counts, in seconds
    (None for an empty window or a quantile in the overflow bucket)."""
    total = sum(counts)
    if total == 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts[:N_BUCKETS]):
        if c == 0:
            continue
        if cum + c >= target:
            lo = BOUNDS[i - 1] if i else 0.0
            return lo + (BOUNDS[i] - lo) * ((target - cum) / c)
        cum += c
    return None


def totals_delta(ctx, key: str) -> int:
    return ctx["sched_after"]["totals"][key] \
        - ctx["sched_before"]["totals"][key]


def transform_delta(ctx, key: str) -> int:
    return ctx["sched_after"]["transform"][key] \
        - ctx["sched_before"]["transform"][key]


# ---- the trace ------------------------------------------------------------------

def kernel_s(ctx, marker: str) -> Optional[float]:
    """Device seconds of the kernels whose name contains `marker`; None
    without a trace or when no such kernel ran."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    s = [v for k, v in tr["kernels"].items() if marker in k]
    return sum(s) if s else None


def us_per_merged_op(ctx, marker: str) -> Optional[float]:
    """A kernel's device microseconds per op merged in the window."""
    s = kernel_s(ctx, marker)
    ops = sum(x.n_ops for x in committed_in_window(ctx))
    if s is None or ops == 0:
        return None
    return 1e6 * s / ops


def idle_pct(ctx) -> Optional[float]:
    from dtbench.trace import idle_share
    tr = ctx.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return idle_share(tr["busy_s"], tr["window_s"])
