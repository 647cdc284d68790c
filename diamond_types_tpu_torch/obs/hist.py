"""Log-bucketed latency histograms with cheap quantile snapshots.

One `Histogram` is a fixed ladder of powers-of-two buckets starting at
1µs (bucket i covers (2**(i-1), 2**i] µs), so recording is one log2 and
one list index — no allocation, no sorting, safe to call on every HTTP
request, flush, and probe. Quantiles are estimated by walking the
cumulative counts and interpolating inside the winning bucket, which
bounds the error to the bucket width (a factor of 2 worst case — good
enough to tell a 2ms flush from a 200ms one, which is all the serve
and replication dashboards need).

`snapshot()` includes the raw cumulative buckets so obs/prom.py can
render a Prometheus histogram (`*_bucket{le=...}` / `_sum` / `_count`)
straight from the JSON document without touching live objects.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

_FIRST_BOUND_S = 1e-6
_N_BUCKETS = 28          # 1µs .. ~134s; slower than that is overflow

BOUNDS: Tuple[float, ...] = tuple(
    _FIRST_BOUND_S * (2.0 ** i) for i in range(_N_BUCKETS))


class Histogram:
    """Thread-safe log2-bucketed histogram of durations in seconds."""

    __slots__ = ("_lock", "counts", "overflow", "count", "sum", "max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counts: List[int] = [0] * _N_BUCKETS
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        s = seconds if seconds > 0.0 else 0.0
        if s <= _FIRST_BOUND_S:
            idx = 0
        else:
            # first bound >= s; exact powers land in their own bucket
            # (upper-inclusive, matching Prometheus `le` semantics)
            idx = int(math.ceil(math.log2(s / _FIRST_BOUND_S)))
        with self._lock:
            self.count += 1
            self.sum += s
            if s > self.max:
                self.max = s
            if idx >= _N_BUCKETS:
                self.overflow += 1
            else:
                self.counts[idx] += 1

    # ---- quantiles --------------------------------------------------------

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = max(min(q, 1.0), 0.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = BOUNDS[i - 1] if i else 0.0
                hi = BOUNDS[i]
                return lo + (hi - lo) * ((target - cum) / c)
            cum += c
        return self.max        # target fell in the overflow bucket

    # ---- snapshots --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "sum": round(self.sum, 6),
                "max": round(self.max, 6),
                "p50": round(self._quantile_locked(0.50), 6),
                "p90": round(self._quantile_locked(0.90), 6),
                "p99": round(self._quantile_locked(0.99), 6),
                "buckets": self._buckets_locked(),
            }

    def _buckets_locked(self) -> list:
        # [[le_seconds, cumulative_count], ...] trimmed to the last
        # non-empty bucket, always terminated by ["+Inf", count]
        out: list = []
        last = -1
        for i, c in enumerate(self.counts):
            if c:
                last = i
        cum = 0
        for i in range(last + 1):
            cum += self.counts[i]
            out.append([BOUNDS[i], cum])
        out.append(["+Inf", self.count])
        return out


class HistogramSet:
    """A family of histograms keyed by (name, labels) — e.g. one
    `http_request` histogram per endpoint. Label cardinality must be
    bounded by the caller (endpoint/action names, never doc ids)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._h: Dict[Tuple[str, tuple], Histogram] = {}

    def observe(self, name: str, seconds: float, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        h = self._h.get(key)
        if h is None:
            with self._lock:
                h = self._h.setdefault(key, Histogram())
        h.record(seconds)

    def get(self, name: str, **labels) -> Optional[Histogram]:
        return self._h.get((name, tuple(sorted(labels.items()))))

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._h.items())
        out: Dict[str, list] = {}
        for (name, labels), h in sorted(
                items, key=lambda kv: (kv[0][0], kv[0][1])):
            entry = {"labels": dict(labels)}
            entry.update(h.snapshot())
            out.setdefault(name, []).append(entry)
        return out
