"""Follower reads. Only `metrics` (`READ_KEYS`, `ReadMetrics`, the
ServeMetrics `read` block's counters) is ported so far: the Prometheus
renderer, `obs/prom.py`, reads its keys. The cache, the follower index
and the read path wait for the read layer."""

from .metrics import READ_KEYS, ReadMetrics

__all__ = ["READ_KEYS", "ReadMetrics"]
