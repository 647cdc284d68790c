"""QoS metrics: per-class admission counters + controller decisions.

Same contract as ServeMetrics (serve/metrics.py): a declared key
surface fixed at module scope, double-written into the live TimeSeries
when one is attached, rendered by obs/prom.py as zero-filled
`dt_qos_*{class}` families, and stamped into scenario scorecards as
the `qos` block. The metrics-schema-drift lint rule imports these
tuples directly, so a key bumped here that is not declared below is a
lint error, not a silently-unexported counter.

Schema versions:
  v1  per-class admitted/shed/deferred counters + deadline_s gauge;
      controller decision counters (steps/stretched/shrunk/held/
      floors/ceilings).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

from .classes import QOS_CLASSES

# per-class admission counters (prom: dt_qos_<key>_total{class})
QOS_CLASS_KEYS = ("admitted", "shed", "deferred")

# controller decision counters (prom: dt_qos_controller_total{decision})
QOS_CTL_KEYS = ("steps", "stretched", "shrunk", "held", "floors",
                "ceilings")


class QosMetrics:
    SCHEMA_VERSION = 1

    def __init__(self, classes: Iterable[str] = QOS_CLASSES) -> None:
        self._lock = threading.Lock()
        self._classes = tuple(classes)
        self._counts: Dict[str, Dict[str, int]] = {
            c: {k: 0 for k in QOS_CLASS_KEYS} for c in self._classes}
        self._deadline_s: Dict[str, float] = {c: 0.0
                                              for c in self._classes}
        self._ctl: Dict[str, int] = {k: 0 for k in QOS_CTL_KEYS}
        # live-telemetry double-write target (obs.TimeSeries); set by
        # QosController.attach_obs. Series: qos.<key>.<class> — the
        # controller's arrival-rate estimator reads qos.admitted.<cls>
        # back out of this same table, closing the loop.
        self.ts = None

    def bump_class(self, cls: str, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[cls][key] += n
        ts = self.ts
        if ts is not None:
            ts.inc(f"qos.{key}.{cls}", n)

    def bump_ctl(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._ctl[key] += n
        ts = self.ts
        if ts is not None:
            ts.inc(f"qos.ctl.{key}", n)

    def set_deadline(self, cls: str, seconds: float) -> None:
        with self._lock:
            self._deadline_s[cls] = float(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "schema_version": self.SCHEMA_VERSION,
                "classes": {
                    c: {**self._counts[c],
                        "deadline_s": round(self._deadline_s[c], 6)}
                    for c in self._classes},
                "controller": dict(self._ctl),
            }


def merge_snapshots(snaps: Iterable[Optional[dict]]) -> Optional[dict]:
    """Sum per-class counters across servers (scorecard aggregation);
    deadline gauges take the max (the most-stretched server is the one
    the gate cares about). None snaps (qos-disabled servers) are
    skipped; all-None yields None so the scorecard block is omitted
    rather than fabricated."""
    out: Optional[dict] = None
    for snap in snaps:
        if not snap:
            continue
        if out is None:
            out = {"schema_version": snap.get("schema_version", 1),
                   "classes": {}, "controller": {}}
        for c, row in (snap.get("classes") or {}).items():
            dst = out["classes"].setdefault(
                c, {**{k: 0 for k in QOS_CLASS_KEYS}, "deadline_s": 0.0})
            for k in QOS_CLASS_KEYS:
                dst[k] += int(row.get(k, 0))
            dst["deadline_s"] = max(dst["deadline_s"],
                                    float(row.get("deadline_s", 0.0)))
        for k, v in (snap.get("controller") or {}).items():
            out["controller"][k] = out["controller"].get(k, 0) + int(v)
    return out
