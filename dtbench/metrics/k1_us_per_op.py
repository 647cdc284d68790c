"""Replay: K1's device time (csrc/apply_ops.cu, by kernel name in the
trace) per op merged in the traced window."""

from dtbench.metrics import us_per_merged_op


def read(ctx):
    return us_per_merged_op(ctx, "apply_ops_window_kernel")
