"""Trace exemplars: last sampled trace ID per histogram bucket.

A p99 outlier in `dt_flush_latency_seconds` is a number; the question
is always "show me THAT flush". Each latency family keeps, per log2
bucket (same ladder as hist.py / timeseries.py), the most recent
sampled trace that landed there — so the prom exporter can emit
OpenMetrics exemplars on the `_bucket` lines and a dashboard click
resolves straight to the flight-recorder / span view of that exact
operation.

Only sampled traces are noted (callers pass the trace id of an
already-sampled span), so the overhead rides the existing head-
sampling budget; disabled => one branch, zero allocations.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from ..analysis.witness import make_lock
from .hist import _N_BUCKETS, BOUNDS
from .timeseries import bucket_index


class ExemplarStore:
    """(family, bucket) -> (trace_id, value, unix_ts). Cardinality is
    bounded by families x 29 buckets; families are endpoint/flush
    names, never doc ids."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.noted = 0
        self._ts_lock = make_lock("obs.exemplars", "leaf")
        self._ex: Dict[Tuple[str, int], Tuple[str, float, float]] = {}

    def note(self, family: str, seconds: float,
             trace_id: Optional[str]) -> None:
        if not self.enabled or not trace_id:
            return
        idx = min(bucket_index(seconds), _N_BUCKETS)   # 28 == +Inf
        with self._ts_lock:
            self._ex[(family, idx)] = (trace_id, seconds, time.time())
            self.noted += 1

    def get(self, family: str, idx: int):
        with self._ts_lock:
            return self._ex.get((family, idx))

    def for_family(self, family: str) -> Dict[float, dict]:
        """le-keyed exemplars for one family (le math mirrors the
        trimmed-bucket rendering in prom.py: idx 28 is +Inf)."""
        out: Dict[float, dict] = {}
        with self._ts_lock:
            items = [(k, v) for k, v in self._ex.items()
                     if k[0] == family]
        for (_, idx), (tid, val, ts) in items:
            le = BOUNDS[idx] if idx < _N_BUCKETS else float("inf")
            out[le] = {"trace": tid, "value": val, "ts": ts}
        return out

    def snapshot(self) -> dict:
        with self._ts_lock:
            items = sorted(self._ex.items())
        fams: Dict[str, list] = {}
        for (fam, idx), (tid, val, ts) in items:
            le = BOUNDS[idx] if idx < _N_BUCKETS else "+Inf"
            fams.setdefault(fam, []).append(
                {"le": le, "trace": tid, "value": round(val, 6),
                 "ts": round(ts, 3)})
        return {"version": 1, "enabled": self.enabled,
                "noted": self.noted, "families": fams}
