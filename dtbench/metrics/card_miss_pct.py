"""Bank residency: the share of the window's syncs that found no session on
the card and built one, in % (the scheduler's `totals.builds` over
`totals.syncs`, window deltas; a rebuild against a reloaded op log counts
as a build). None with no sync in the window."""

from dtbench.residency import share_of_syncs


def read(ctx):
    return share_of_syncs(ctx, "totals", "builds")
