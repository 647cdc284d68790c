"""Windowed time-series: live rates and quantiles over a ring of
fixed-width windows.

The cumulative `Histogram`s in hist.py answer "what has flush p99 been
since boot" — useless for "what is it *right now*". `TimeSeries` keeps
a ring of `n_windows` fixed-width windows (default 10 s x 360 = one
hour of history); each window holds per-name counter deltas and per-
name log2 bucket counts (same bucket ladder as hist.py, so the bucket
index math and le semantics line up exactly). Recording is one lock,
one dict lookup, one list index; querying merges the windows that
overlap the requested horizon.

This is the signal source for obs/slo.py's multi-window burn rates and
the `rate()` feed ROADMAP item 2's adaptive admission will consume.

Contracts:

  * disabled => allocation-free no-op (one branch; pinned by the
    tracemalloc test in tests/test_telemetry.py)
  * the clock is injectable (fake-clock rollover tests)
  * `_ts_lock` is a leaf in the canonical lock order — record calls
    happen under shard/oplog/device locks all over the serve tier, so
    this lock may never wrap anything that blocks (dt-lint classifies
    `_ts_lock` as leaf and the witness enforces it at runtime)
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.witness import make_lock
from .hist import _FIRST_BOUND_S, _N_BUCKETS, BOUNDS


def bucket_index(seconds: float) -> int:
    """hist.py's bucket math, shared so exemplars key the same le."""
    s = seconds if seconds > 0.0 else 0.0
    if s <= _FIRST_BOUND_S:
        return 0
    return int(math.ceil(math.log2(s / _FIRST_BOUND_S)))


class _WindowHist:
    """Per-window latency buckets — a bare Histogram without its own
    lock (the owning TimeSeries' `_ts_lock` guards it)."""

    __slots__ = ("counts", "overflow", "count", "sum")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * _N_BUCKETS
        self.overflow = 0
        self.count = 0
        self.sum = 0.0

    def record(self, seconds: float, idx: int) -> None:
        self.count += 1
        self.sum += seconds
        if idx >= _N_BUCKETS:
            self.overflow += 1
        else:
            self.counts[idx] += 1


class _Window:
    __slots__ = ("idx", "counters", "hists")

    def __init__(self) -> None:
        self.idx = -1                       # absolute window index
        self.counters: Dict[str, float] = {}
        self.hists: Dict[str, _WindowHist] = {}

    def reset(self, idx: int) -> None:
        self.idx = idx
        self.counters.clear()
        self.hists.clear()


class TimeSeries:
    """Ring of fixed-width time windows holding counter deltas and
    log2 latency buckets, with windowed rate / quantile / count_over
    queries. One instance per Observability bundle."""

    def __init__(self, window_s: float = 10.0, n_windows: int = 360,
                 enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if window_s <= 0 or n_windows < 2:
            raise ValueError("need window_s > 0 and n_windows >= 2")
        self.enabled = enabled
        self.window_s = float(window_s)
        self.n_windows = int(n_windows)
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self._ring = [_Window() for _ in range(self.n_windows)]
        self._ts_lock = make_lock("obs.timeseries", "leaf")
        self.recorded = 0

    # ---- recording --------------------------------------------------------

    def _slot_locked(self) -> _Window:
        idx = int((self._clock() - self._t0) / self.window_s)
        w = self._ring[idx % self.n_windows]
        if w.idx != idx:
            w.reset(idx)
        return w

    def inc(self, name: str, n: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._ts_lock:
            w = self._slot_locked()
            w.counters[name] = w.counters.get(name, 0.0) + n
            self.recorded += 1

    def observe(self, name: str, seconds: float) -> None:
        if not self.enabled:
            return
        s = seconds if seconds > 0.0 else 0.0
        idx = bucket_index(s)
        with self._ts_lock:
            w = self._slot_locked()
            h = w.hists.get(name)
            if h is None:
                h = w.hists[name] = _WindowHist()
            h.record(s, idx)
            self.recorded += 1

    # ---- queries ----------------------------------------------------------

    def _live_locked(self, window_s: float) -> Tuple[List[_Window], int]:
        """Windows overlapping [now - window_s, now], plus the window
        count the horizon spans (for rate denominators)."""
        n_back = max(1, int(math.ceil(window_s / self.window_s)))
        n_back = min(n_back, self.n_windows)
        cur = int((self._clock() - self._t0) / self.window_s)
        lo = cur - n_back
        return [w for w in self._ring if lo < w.idx <= cur], n_back

    def rate(self, name: str, window_s: float = 60.0) -> float:
        """Events/sec over the trailing horizon. Counter names sum
        their deltas; latency names count their observations."""
        with self._ts_lock:
            live, n_back = self._live_locked(window_s)
            total = 0.0
            for w in live:
                total += w.counters.get(name, 0.0)
                h = w.hists.get(name)
                if h is not None:
                    total += h.count
        return total / (n_back * self.window_s)

    def quantile(self, name: str, q: float,
                 window_s: float = 300.0) -> float:
        """Merged-bucket quantile over the trailing horizon; same
        interpolation (and factor-of-2 error bound) as hist.py."""
        merged = [0] * _N_BUCKETS
        count = 0
        mx = 0.0
        with self._ts_lock:
            live, _ = self._live_locked(window_s)
            for w in live:
                h = w.hists.get(name)
                if h is None:
                    continue
                count += h.count
                for i, c in enumerate(h.counts):
                    merged[i] += c
                if h.overflow:
                    mx = BOUNDS[-1] * 2
        if count == 0:
            return 0.0
        target = max(min(q, 1.0), 0.0) * count
        cum = 0
        for i, c in enumerate(merged):
            if c == 0:
                continue
            if cum + c >= target:
                lo = BOUNDS[i - 1] if i else 0.0
                return lo + (BOUNDS[i] - lo) * ((target - cum) / c)
            cum += c
        return mx or BOUNDS[-1]

    def count_over(self, name: str, threshold_s: float,
                   window_s: float = 300.0) -> Tuple[float, float]:
        """(events slower than threshold, total events) over the
        horizon — the bad/total pair burn rates are built from. A
        threshold exactly on a bucket bound counts that bucket as
        good (le is upper-inclusive)."""
        thr = bucket_index(threshold_s)
        bad = 0.0
        total = 0.0
        with self._ts_lock:
            live, _ = self._live_locked(window_s)
            for w in live:
                h = w.hists.get(name)
                if h is None:
                    continue
                total += h.count
                bad += h.overflow
                for i in range(min(thr + 1, _N_BUCKETS), _N_BUCKETS):
                    bad += h.counts[i]
        return bad, total

    def sum_over(self, name: str, window_s: float = 300.0) -> float:
        """Summed counter deltas (or latency sums) over the horizon."""
        total = 0.0
        with self._ts_lock:
            live, _ = self._live_locked(window_s)
            for w in live:
                total += w.counters.get(name, 0.0)
                h = w.hists.get(name)
                if h is not None:
                    total += h.sum
        return total

    def names(self) -> List[str]:
        out = set()
        with self._ts_lock:
            for w in self._ring:
                if w.idx >= 0:
                    out.update(w.counters)
                    out.update(w.hists)
        return sorted(out)

    # ---- snapshot ---------------------------------------------------------

    def snapshot(self, windows: Tuple[float, ...] = (60.0, 300.0)) -> dict:
        """JSON-able live view for /metrics: per-name rates over each
        requested horizon, plus p50/p99 for latency families."""
        out: dict = {"version": 1, "enabled": self.enabled,
                     "window_s": self.window_s,
                     "n_windows": self.n_windows,
                     "recorded": self.recorded,
                     "series": {}}
        if not self.enabled:
            return out
        for name in self.names():
            row: dict = {}
            for win in windows:
                key = f"{int(win)}s"
                row[f"rate_{key}"] = round(self.rate(name, win), 6)
            row["p50_300s"] = round(self.quantile(name, 0.5, 300.0), 6)
            row["p99_300s"] = round(self.quantile(name, 0.99, 300.0), 6)
            out["series"][name] = row
        return out
