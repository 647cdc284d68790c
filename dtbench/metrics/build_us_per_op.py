"""Bank residency: the flush phase `build` (a session built inside a bank
flush on a miss: the evictions that make room and the build), in
microseconds per op committed in the window: the window's delta of
`flush_phases.seconds.build` over the ops of every sync committed in it,
wall on the flushing threads summed over shards. None from a program whose
flush keeps no such phase."""

from dtbench.residency import phase_us_per_op


def read(ctx):
    return phase_us_per_op(ctx, "build")
