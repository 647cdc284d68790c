"""Zone session: the share of the window's zone syncs that rebuilt the
session's carry instead of continuing it, in % (the scheduler's `zone`
counters: resynced over syncs). None from a program that keeps no such
counters, or with no zone sync in the window."""

from dtbench.roofline_zone import zone_delta


def read(ctx):
    z = zone_delta(ctx)
    if z is None or z["syncs"] == 0:
        return None
    return 100.0 * z["resynced"] / z["syncs"]
