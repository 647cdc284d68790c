"""Residency tier: the oplog lock held inside saves (`TieredStore.save`
encodes a document's unsaved suffix into its home under the serve tier's
one oplog lock, the lock every flush and every client append takes), in
microseconds per op committed in the window: the window's delta of
`residency.save_hold_s` over the ops of every sync committed in it. None
from a program without the residency block."""

from dtbench.residency import per_op, window_delta


def read(ctx):
    return per_op(ctx, window_delta(ctx, "residency", "save_hold_s"))
