"""Byte counts for kernels' roofline shares, kept with the benchmark so
that a change to the program cannot move them. Copied from the port's
`chip_smoke.py` (each function's note names its original); no metric of
this benchmark reads them yet: the program's kernel wrappers record no
launch shapes (PERF.md, Open questions).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet


def window_bytes(b: int, n: int, cap: int, mi: int) -> int:
    """Bytes K1 must move at minimum: every input read once (docs, lens,
    the op tape), every output written once (docs, lens).
    (chip_smoke.py `window_bytes`)"""
    return 4 * (2 * b * cap + 2 * b + b * n * (3 + mi))


def zone_bytes(ts) -> int:
    """Bytes of a list of tensors (X8's carry planes, its tape).
    (chip_smoke.py `zone_bytes`)"""
    return sum(t.numel() * t.element_size() for t in ts)


def k3_bound_ms(vis, cap: int) -> float:
    """K3's HBM bound: the run tables read once, the visible text read
    once, the text and the totals written once. (chip_smoke.py
    `k3_bound_ms`)"""
    b, n = vis.shape
    totals = vis.long().sum(dim=1).clamp(max=cap)
    nbytes = 4 * (3 * b * n + int(totals.sum()) + b * cap + b)
    return 1e3 * nbytes / HBM_BYTES_PER_S
