"""Residency tier: cold opens as a share of the window's syncs, in % (the
scheduler's `hydration.hydrations`, loads of a home into the warm tier,
async and inline, over `totals.syncs`, window deltas). None from a program
without a residency tier's counters, or with no sync in the window."""

from dtbench.residency import share_of_syncs


def read(ctx):
    return share_of_syncs(ctx, "hydration", "hydrations")
