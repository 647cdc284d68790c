"""X8's byte count for its roofline share, and the window's zone counters,
kept with the benchmark so that a
change to the program cannot move it. The formula is the port's
`chip_smoke.py` `zone_bounds`, applied to the launch shapes the zone
sessions count (`metrics_json()["zone"]`, summed over a window's launches)
instead of one tape.

What X8 must move at least, its inputs read once and its outputs written
once: an APPLY step with m ranks placed before it, n new chars and
m' = m + n after reads the order over [0, m) (4m bytes) and the snapshot
states of those ranks (m), writes the rank and the order of all m' (8m')
and the new chars' keys, origins and state (17n), and on an entry's first
sub-step copies the row into the snapshot (2W); a BEGIN step moves W bytes,
a FORK 2W and a MAX 3W; and the tape is read once.
"""

from __future__ import annotations

from typing import Mapping, Optional

from dtbench.roofline import HBM_BYTES_PER_S

__all__ = ["HBM_BYTES_PER_S", "zone_delta", "zone_bytes_from_counts"]


def zone_delta(ctx) -> Optional[dict]:
    """The window's difference of the scheduler's `zone` counters, or None
    from a program that keeps none."""
    a = ctx["sched_after"].get("zone")
    b = ctx["sched_before"].get("zone")
    if a is None or b is None:
        return None
    return {k: a[k] - b[k] for k in a}


def zone_bytes_from_counts(z: Mapping[str, int]) -> int:
    """X8's minimum bytes over the launches the counts `z` cover (the
    program's zone counters, or their difference over a window)."""
    m, n = z["ranks_before"], z["chars"]
    return (5 * m + 8 * (m + n) + 17 * n + 2 * z["snap_slots"]
            + z["begin_slots"] + 2 * z["fork_slots"] + 3 * z["max_slots"]
            + z["tape_bytes"])
