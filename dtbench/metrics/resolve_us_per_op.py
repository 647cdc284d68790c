"""Device plan: the `resolve` phase (linearisation and K2, their launches
included), in microseconds per op committed in the window. It is the window's
delta of the scheduler's `flush_phases.seconds.resolve` over the ops of
every sync committed in it: wall time on the flushing threads, summed over
shards. None from a program that keeps no phases."""

from dtbench.phases import phase_us_per_op


def read(ctx):
    return phase_us_per_op(ctx, "resolve")
