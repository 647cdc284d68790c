"""Residency tier: the flush phase `gate` (the hydration gate each taken
bucket crosses, its inline hydrations of documents still cold on their
second visit included), in microseconds per op committed in the window:
the window's delta of `flush_phases.seconds.gate` over the ops of every
sync committed in it. None from a program whose flush keeps no such
phase."""

from dtbench.residency import phase_us_per_op


def read(ctx):
    return phase_us_per_op(ctx, "gate")
