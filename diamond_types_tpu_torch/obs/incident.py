"""Incident engine: online anomaly detection + auto-captured evidence.

The scenario harness can tell you a soak *failed*; by the time a human
looks, the flight recorder has wrapped and the "why" is gone. This
module is the flight-data-recorder analog of a training stack's
NaN-watchdog: `AnomalyDetector` watches the live TimeSeries ring for
deviations and, the moment one trips, `IncidentStore` freezes the
evidence that explains it — recorder tail, SLO burn rates, hot-doc
attribution, QoS controller state, per-peer convergence lag, open
journey stages, witness edge count, last sampled trace ids — into a
JSON bundle served at `GET /debug/incidents[/<id>]` and persisted
under the run's data dir.

Detector kinds (the declared schema surface — `INCIDENT_KINDS` is what
prom.py zero-fills `dt_incident_opened_total{kind}` from and what the
metrics-schema-drift lint rule checks literal kinds against):

  rate_stall   a series that was flowing (warmed past `warmup_polls`)
               goes silent for >= `stall_after_s` — e.g. `serve.flush`
               on a wedged scheduler, `convergence_lag.<peer>` behind
               a partition. Quiet-from-birth series never alarm; a
               fired stall re-arms only after the series flows again.
  rate_spike   current rate exceeds `spike_factor` x the trailing EWMA
               of an established series (warm-up gates the classic
               new-series false positive).
  p99_step     the short-window p99 of a latency family jumps past
               `p99_factor` x its trailing EWMA.
  slo_burn     an SLO objective transitioned to `burning` (the PR 10
               `slo_transition` flight-recorder events, tailed by
               cursor — no SloEngine coupling).

Detection is pull-driven like the SLO engine: `poll()` is invoked by
Observability.snapshot() (every /metrics scrape) and once per runner
tick — no threads, no timers. Dedup is by (kind, series) under a
`cooldown_s` window; a suppressed firing bumps `suppressed` instead of
opening a duplicate bundle.

Contracts shared with the rest of obs/:

  * disabled => allocation-free no-op (`poll()` is one branch; pinned
    by the tracemalloc test in tests/test_incident.py)
  * the clock is injectable (fake-clock detector matrix tests)
  * `_incident_lock` is a leaf in the canonical lock order: all
    TimeSeries / recorder / bundle-assembly reads happen OUTSIDE it —
    the lock only guards the detector's own state tables and the
    store's index (dt-lint classifies `_incident_lock` as leaf and the
    witness enforces it at runtime)
"""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.witness import make_lock

# the declared incident-kind surface (prom zero-fill + lint drift rule)
INCIDENT_KINDS = ("rate_stall", "rate_spike", "p99_step", "slo_burn")

_EMPTY: tuple = ()


class AnomalyDetector:
    """Watches a TimeSeries ring for stalls / spikes / p99 steps and
    the flight recorder for SLO burn transitions. One per bundle."""

    def __init__(self, ts, recorder=None, store=None,
                 enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 cooldown_s: float = 60.0,
                 rate_window_s: float = 30.0,
                 stall_after_s: float = 30.0,
                 spike_factor: float = 8.0,
                 p99_factor: float = 4.0,
                 ewma_alpha: float = 0.3,
                 warmup_polls: int = 3,
                 min_rate: float = 0.5,
                 min_p99_s: float = 0.001) -> None:
        self.enabled = enabled
        self.ts = ts
        self.recorder = recorder
        self.store = store
        self._clock = clock or time.monotonic
        self.cooldown_s = float(cooldown_s)
        self.rate_window_s = float(rate_window_s)
        self.stall_after_s = float(stall_after_s)
        self.spike_factor = float(spike_factor)
        self.p99_factor = float(p99_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.warmup_polls = int(warmup_polls)
        self.min_rate = float(min_rate)
        self.min_p99_s = float(min_p99_s)
        self._incident_lock = make_lock("obs.incident", "leaf")
        self._flow: Dict[str, dict] = {}     # series -> rate state
        self._p99: Dict[str, dict] = {}      # series -> p99 state
        self._last: Dict[Tuple[str, str], float] = {}   # cooldown table
        self._rec_cursor = 0
        self.polls = 0
        self.suppressed = 0

    # ---- firing (cooldown dedup) ------------------------------------------

    def _open_locked(self, kind: str, series: str, now: float,
                     detail: dict, fired: List[tuple]) -> None:
        """Record one detection under the lock: dedup by (kind, series)
        inside the cooldown window, else queue it for capture. The
        `kind` literal at every call site is checked against
        INCIDENT_KINDS by the metrics-schema-drift lint rule."""
        key = (kind, series)
        last = self._last.get(key)
        if last is not None and now - last < self.cooldown_s:
            self.suppressed += 1
            return
        self._last[key] = now
        fired.append((kind, series, detail))

    # ---- the poll ---------------------------------------------------------

    def poll(self) -> tuple:
        """Re-evaluate every watched series; returns the (kind, series,
        detail) tuples that fired this poll (after cooldown dedup).
        Bundle capture happens here too, strictly outside the lock."""
        if not self.enabled:
            return _EMPTY
        now = self._clock()
        ts = self.ts
        # all ring reads happen BEFORE the incident lock: _ts_lock is
        # itself a leaf and may not nest under another leaf
        names = ts.names()
        rates = [(n, ts.rate(n, self.rate_window_s)) for n in names]
        p99s = [(n, ts.quantile(n, 0.99, self.rate_window_s))
                for n in names]
        transitions: List[dict] = []
        rec = self.recorder
        if rec is not None:
            evs = rec.dump_since(self._rec_cursor)
            if evs:
                self._rec_cursor = evs[-1]["seq"]
                transitions = [ev for ev in evs
                               if ev.get("kind") == "slo_transition"
                               and ev.get("to") == "burning"]
        fired: List[tuple] = []
        with self._incident_lock:
            self.polls += 1
            for name, rate in rates:
                st = self._flow.get(name)
                if st is None:
                    st = self._flow[name] = {
                        "ewma": 0.0, "warm": 0,
                        "last_flow": now, "flowing": False}
                if rate > 0.0:
                    if (st["warm"] >= self.warmup_polls
                            and st["ewma"] > 0.0
                            and rate >= self.min_rate
                            and rate > self.spike_factor * st["ewma"]):
                        self._open_locked(
                            "rate_spike", name, now,
                            {"rate": round(rate, 6),
                             "ewma": round(st["ewma"], 6),
                             "factor": self.spike_factor}, fired)
                    st["ewma"] = rate if st["ewma"] == 0.0 else (
                        self.ewma_alpha * rate
                        + (1.0 - self.ewma_alpha) * st["ewma"])
                    st["warm"] += 1
                    st["last_flow"] = now
                    st["flowing"] = True
                elif (st["flowing"] and st["warm"] >= self.warmup_polls
                        and st["ewma"] >= self.min_rate
                        and now - st["last_flow"] >= self.stall_after_s):
                    self._open_locked(
                        "rate_stall", name, now,
                        {"silent_s": round(now - st["last_flow"], 3),
                         "ewma": round(st["ewma"], 6)}, fired)
                    st["flowing"] = False   # re-arm only on new flow
            for name, p99 in p99s:
                if p99 <= 0.0:
                    continue
                st = self._p99.get(name)
                if st is None:
                    st = self._p99[name] = {"ewma": 0.0, "warm": 0}
                if (st["warm"] >= self.warmup_polls
                        and st["ewma"] > 0.0
                        and p99 >= self.min_p99_s
                        and p99 > self.p99_factor * st["ewma"]):
                    self._open_locked(
                        "p99_step", name, now,
                        {"p99_s": round(p99, 6),
                         "ewma_s": round(st["ewma"], 6),
                         "factor": self.p99_factor}, fired)
                st["ewma"] = p99 if st["ewma"] == 0.0 else (
                    self.ewma_alpha * p99
                    + (1.0 - self.ewma_alpha) * st["ewma"])
                st["warm"] += 1
            for ev in transitions:
                self._open_locked(
                    "slo_burn", str(ev.get("objective", "?")), now,
                    {"series": ev.get("series"),
                     "frm": ev.get("frm"), "to": ev.get("to"),
                     "fast_burn": ev.get("fast_burn"),
                     "slow_burn": ev.get("slow_burn")}, fired)
        store = self.store
        if store is not None:
            for kind, series, detail in fired:
                store.open_incident(kind, series, detail)
        return tuple(fired)

    def snapshot(self) -> dict:
        with self._incident_lock:
            return {"enabled": self.enabled, "polls": self.polls,
                    "suppressed": self.suppressed,
                    "watched": len(self._flow)}


class IncidentStore:
    """Bounded in-memory index of incident bundles + JSON persistence.

    A bundle freezes everything a postmortem needs at detection time.
    Assembly reads the other obs structures through their own (leaf)
    locks, strictly OUTSIDE `_incident_lock`; only the index mutation
    runs under it. `kind` is validated against INCIDENT_KINDS — an
    undeclared kind raises, the ReadMetrics contract."""

    def __init__(self, data_dir: Optional[str] = None,
                 capacity: int = 64, prefix: str = "",
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.data_dir = data_dir
        self.capacity = max(int(capacity), 1)
        self.prefix = prefix
        self._clock = clock or time.monotonic
        self._incident_lock = make_lock("obs.incident_store", "leaf")
        self._bundles: "OrderedDict[str, dict]" = OrderedDict()
        self._seq = 0
        self._acked: set = set()
        self.persisted = 0
        self.obs = None              # back-ref, set by attach()
        self.qos_provider = None     # () -> qos export dict or None
        self.context_provider = None  # () -> extra capture context
        self._by_kind: Dict[str, int] = dict.fromkeys(INCIDENT_KINDS, 0)

    def attach(self, obs) -> None:
        self.obs = obs

    # ---- capture ----------------------------------------------------------

    def _capture(self) -> dict:
        """Assemble the evidence snapshot (no incident lock held)."""
        obs = self.obs
        cap: dict = {}
        if obs is None:
            return cap
        cap["recorder_tail"] = obs.recorder.tail(100)
        slo_rows = obs.slo.evaluate()
        cap["slo"] = [{"name": r["name"], "state": r["state"],
                       "fast_burn": r["fast"]["burn"],
                       "slow_burn": r["slow"]["burn"]}
                      for r in slo_rows]
        cap["hot"] = obs.attrib.snapshot(top=5)
        cap["convergence_lag"] = obs.journey.lag_summary()
        jo = obs.journey.snapshot()
        cap["journey_stages"] = jo.get("stages")
        cap["journeys_tracked"] = jo.get("tracked")
        from ..analysis import witness_snapshot
        wit = witness_snapshot()
        cap["witness_edges"] = len(wit.get("edges") or {})
        cap["traces"] = [row.get("trace")
                         for row in obs.tracer.index(limit=5)]
        qp = self.qos_provider
        if qp is not None:
            try:
                cap["qos"] = qp()
            except Exception:
                cap["qos"] = None
        ctx = self.context_provider
        if ctx is not None:
            try:
                cap["context"] = ctx()
            except Exception:
                cap["context"] = None
        return cap

    def open_incident(self, kind: str, series: str,
                      detail: Optional[dict] = None) -> dict:
        if kind not in INCIDENT_KINDS:
            raise ValueError(f"undeclared incident kind {kind!r} "
                             f"(INCIDENT_KINDS={INCIDENT_KINDS})")
        cap = self._capture()
        now = self._clock()
        with self._incident_lock:
            self._seq += 1
            iid = f"inc-{self.prefix}{self._seq:04d}"
            bundle = {"version": 1, "id": iid, "t": round(now, 6),
                      "kind": kind, "series": series,
                      "detail": dict(detail or {}), **cap}
            self._bundles[iid] = bundle
            self._by_kind[kind] += 1
            while len(self._bundles) > self.capacity:
                old, _ = self._bundles.popitem(last=False)
                self._acked.discard(old)
        self._persist(iid, bundle)
        obs = self.obs
        if obs is not None:
            obs.recorder.record("incident_opened", id=iid,
                                incident_kind=kind, series=series)
        return bundle

    def _persist(self, iid: str, bundle: dict) -> None:
        if self.data_dir is None:
            return
        try:
            root = os.path.join(self.data_dir, "incidents")
            os.makedirs(root, exist_ok=True)
            path = os.path.join(root, f"{iid}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf8") as f:
                f.write(json.dumps(bundle, default=str) + "\n")
            os.replace(tmp, path)
            self.persisted += 1
        except OSError:
            pass    # persistence is best-effort evidence, never fatal

    # ---- views ------------------------------------------------------------

    def ack(self, iid: str) -> bool:
        with self._incident_lock:
            if iid not in self._bundles:
                return False
            self._acked.add(iid)
            return True

    def get(self, iid: str) -> Optional[dict]:
        with self._incident_lock:
            b = self._bundles.get(iid)
            return dict(b) if b is not None else None

    def index_json(self) -> dict:
        with self._incident_lock:
            rows = [{"id": b["id"], "t": b["t"], "kind": b["kind"],
                     "series": b["series"], "detail": b["detail"],
                     "acknowledged": b["id"] in self._acked}
                    for b in self._bundles.values()]
            rows.reverse()          # newest first
            last_id = next(reversed(self._bundles)) \
                if self._bundles else None
            return {"version": 1, "total": self._seq,
                    "open": sum(1 for r in rows
                                if not r["acknowledged"]),
                    "by_kind": dict(self._by_kind),
                    "last_id": last_id,
                    "incidents": rows}

    def snapshot(self) -> dict:
        with self._incident_lock:
            last_id = next(reversed(self._bundles)) \
                if self._bundles else None
            return {"total": self._seq,
                    "open": sum(1 for i in self._bundles
                                if i not in self._acked),
                    "by_kind": dict(self._by_kind),
                    "last_id": last_id,
                    "persisted": self.persisted}
