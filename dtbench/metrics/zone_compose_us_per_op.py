"""Zone session: the zone sync's `zone_compose` phase (the new entries
split, composed, packed and filled into the micro-tape), in microseconds
per op committed in the window: the window's difference of the scheduler's
`flush_phases.seconds.zone_compose`, wall time on the flushing threads
summed over shards, over the ops of every sync committed in it. None from
a program that keeps no such phase."""

from dtbench.phases import phase_us_per_op


def read(ctx):
    for side in ("sched_before", "sched_after"):
        if "zone_compose" not in ctx[side].get("flush_phases", {}) \
                .get("seconds", {}):
            return None
    return phase_us_per_op(ctx, "zone_compose")
