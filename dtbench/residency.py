"""The residency tier's readers' arithmetic (`tiers/tiered_tier.py`'s cell):
window deltas of the scheduler's `residency` block, its `hydration`
counters and its `build` and `gate` flush phases. Each returns None from a
program that keeps no such counter (the parent of the tiered cell), so a
reader falls silent there rather than raise."""

from __future__ import annotations

from typing import Optional


def window_delta(ctx, block: str, key: str) -> Optional[float]:
    """What the window added to `metrics_json()[block][key]`; None when
    the program has no such key."""
    a = ctx["sched_after"].get(block)
    b = ctx["sched_before"].get(block)
    if a is None or b is None or key not in a or key not in b:
        return None
    return a[key] - b[key]


def per_op(ctx, seconds: Optional[float]) -> Optional[float]:
    """`seconds` in microseconds per op committed in the window."""
    from dtbench.metrics import committed_in_window
    ops = sum(x.n_ops for x in committed_in_window(ctx))
    if seconds is None or ops == 0:
        return None
    return 1e6 * seconds / ops


def phase_us_per_op(ctx, phase: str) -> Optional[float]:
    """A flush phase's microseconds per op committed in the window; None
    when the program keeps no such phase."""
    a = ctx["sched_after"].get("flush_phases")
    b = ctx["sched_before"].get("flush_phases")
    if a is None or b is None or phase not in a["seconds"]:
        return None
    return per_op(ctx, a["seconds"][phase] - b["seconds"][phase])


def share_of_syncs(ctx, block: str, key: str) -> Optional[float]:
    """`metrics_json()[block][key]`'s window delta over the window's
    `totals.syncs`, in %."""
    n = window_delta(ctx, block, key)
    syncs = window_delta(ctx, "totals", "syncs")
    if n is None or not syncs:
        return None
    return 100.0 * n / syncs
