"""Edit-to-visibility journey tracking (the convergence waterfall).

The per-stage dashboards (flush p99, queue wait, AE round time, read
staleness) each measure one machine; the product metric of a CRDT mesh
is *edit-to-visibility* — how long until an accepted edit is durable,
replicated, and servable from every follower. `OpJourney` stamps each
sampled edit as it crosses the pipeline stages:

  admitted        HTTP ingress accepted the edit (agent/seq known)
  queued          admission queue took the merge intent
  planned         flush planning produced an op schedule (host or
                  device rung — the rung shows on the trace spans)
  device_replayed the fused/mesh/pallas device phase replayed the tail
                  (host-engine flushes skip this stamp by design)
  adopted         the merge result was adopted into the session/oplog
  wal_durable     DocStore persisted the doc (atomic tmp+rename)
  ae_shipped      anti-entropy pushed the patch at a peer
  applied_at_peer the peer acknowledged applying the pushed patch
  advert_usable   the peer's frontier advert came back dominating the
                  edit — a follower read can now be served from it

Journeys are keyed by the edit's `X-DT-Trace` id when the ingress span
was sampled (falling back to `agent:seq`), carry the `(agent, seq)`
identity and doc id, and live in a bounded FIFO table. Only the
*owner* stamps: peer-side facts (shipped/applied/advert) are stamped
when the owner observes them, so the whole journey assembles on one
host without a cross-host table. Stage counters are zero-filled over
`STAGES` — prom and the dataflow lint key off the same tuple.

On `advert_usable` the per-peer convergence lag (stamp time minus
`admitted`) is double-written into the live TimeSeries as
`convergence_lag.{peer}` and the aggregate `journey.visibility` — the
family the `visibility_p99` SLO objective burns on.

Disabled journeys are a hard no-op: every public method checks one
flag and returns without allocating (tracemalloc-pinned, same contract
as the disabled tracer/TimeSeries). The internal lock is a leaf —
stamps arrive under shard/oplog/io locks and must never wrap blocking
work; TimeSeries writes happen after the lock is released.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional

STAGES = ("admitted", "queued", "planned", "device_replayed", "adopted",
          "wal_durable", "ae_shipped", "applied_at_peer",
          "advert_usable")

# stages observed about a specific peer (stamped with peer=...)
PEER_STAGES = ("ae_shipped", "applied_at_peer", "advert_usable")

# TimeSeries families the journey double-writes (the SLO objective and
# prom exemplar join read these names)
VISIBILITY_SERIES = "journey.visibility"
CONVERGENCE_PREFIX = "convergence_lag"


class OpJourney:
    """Bounded edit-journey table + per-peer convergence-lag rollup."""

    def __init__(self, capacity: int = 512, ts=None,
                 enabled: bool = True, clock=None) -> None:
        self.enabled = enabled
        self.capacity = max(int(capacity), 1)
        self.ts = ts
        self._clock = time.monotonic if clock is None else clock
        from ..analysis.witness import make_lock
        self._lock = make_lock("obs.journey", "leaf")
        self._journeys: OrderedDict = OrderedDict()  # key -> entry
        self._by_doc: dict = {}                      # doc -> set(keys)
        self._stage_counts = dict.fromkeys(STAGES, 0)
        self._peer_lags: dict = {}   # peer -> {"n","sum","max"}
        self.stamped = 0
        self.dropped = 0

    # ---- stamping ---------------------------------------------------------

    def begin(self, agent, seq, doc=None, trace=None,
              t: Optional[float] = None) -> Optional[str]:
        """Open a journey at the `admitted` stage. Returns the journey
        key (the trace id when the ingress span was sampled, else
        `agent:seq`). First begin wins: a later begin for the same key
        (the scheduler re-announcing an ingress-admitted edit) is a
        no-op, so the HTTP handler's (agent, seq) identity sticks."""
        if not self.enabled:
            return None
        key = trace if trace else f"{agent}:{seq}"
        now = self._clock() if t is None else t
        with self._lock:
            if key in self._journeys:
                return key
            entry = {"trace": trace, "agent": agent, "seq": seq,
                     "doc": doc, "t_admitted": now,
                     "stages": {"admitted": now}, "peers": {}}
            self._journeys[key] = entry
            if doc is not None:
                self._by_doc.setdefault(doc, set()).add(key)
            while len(self._journeys) > self.capacity:
                old_key, old = self._journeys.popitem(last=False)
                self.dropped += 1
                keys = self._by_doc.get(old.get("doc"))
                if keys is not None:
                    keys.discard(old_key)
                    if not keys:
                        self._by_doc.pop(old.get("doc"), None)
            self._stage_counts["admitted"] += 1
            self.stamped += 1
        return key

    def stamp(self, key, stage: str, peer: Optional[str] = None,
              t: Optional[float] = None) -> None:
        """Stamp one journey by key (trace id or `agent:seq`)."""
        if not self.enabled:
            return
        self._record((key,), stage, peer, t)

    def stamp_doc(self, doc, stage: str, peer: Optional[str] = None,
                  t: Optional[float] = None) -> None:
        """Stamp every in-flight journey of `doc` — the WAL flush, AE
        ship/apply and advert paths know the doc, not the trace."""
        if not self.enabled:
            return
        with self._lock:
            keys = tuple(self._by_doc.get(doc, ()))
        if keys:
            self._record(keys, stage, peer, t)

    def _record(self, keys, stage, peer, t) -> None:
        now = self._clock() if t is None else t
        observations = []   # (peer, lag) flushed to ts OUTSIDE the lock
        with self._lock:
            for key in keys:
                entry = self._journeys.get(key)
                if entry is None:
                    continue
                if peer is not None:
                    slots = entry["peers"].setdefault(peer, {})
                else:
                    slots = entry["stages"]
                if stage in slots:
                    continue            # first stamp wins
                if (stage == "advert_usable" and peer is not None
                        and "applied_at_peer" not in slots):
                    # an advert that predates the peer applying this
                    # edit proves nothing about ITS visibility — skip
                    # until the AE push acked (first-wins then takes
                    # the first post-apply advert)
                    continue
                slots[stage] = now
                self._stage_counts[stage] = \
                    self._stage_counts.get(stage, 0) + 1
                self.stamped += 1
                if stage == "advert_usable" and peer is not None:
                    lag = max(now - entry["t_admitted"], 0.0)
                    agg = self._peer_lags.setdefault(
                        peer, {"n": 0, "sum": 0.0, "max": 0.0})
                    agg["n"] += 1
                    agg["sum"] += lag
                    agg["max"] = max(agg["max"], lag)
                    observations.append((peer, lag))
        ts = self.ts
        if ts is not None:
            for peer_id, lag in observations:
                ts.observe(f"{CONVERGENCE_PREFIX}.{peer_id}", lag)
                ts.observe(VISIBILITY_SERIES, lag)

    # ---- views ------------------------------------------------------------

    def journey(self, key) -> Optional[dict]:
        """Deep-enough copy of one journey (stage map + per-peer map)."""
        with self._lock:
            entry = self._journeys.get(key)
            if entry is None:
                return None
            return {"trace": entry["trace"], "agent": entry["agent"],
                    "seq": entry["seq"], "doc": entry["doc"],
                    "stages": dict(entry["stages"]),
                    "peers": {p: dict(s)
                              for p, s in entry["peers"].items()}}

    def waterfall(self, key) -> list:
        """Ordered [(stage, offset_s, peer)] rows for one journey —
        offsets are relative to `admitted`."""
        j = self.journey(key)
        if j is None:
            return []
        t0 = j["stages"].get("admitted", 0.0)
        rows = [(stage, round(t - t0, 6), None)
                for stage, t in j["stages"].items()]
        for peer_id, slots in j["peers"].items():
            rows.extend((stage, round(t - t0, 6), peer_id)
                        for stage, t in slots.items())
        rows.sort(key=lambda r: (r[1], STAGES.index(r[0])))
        return rows

    def lag_summary(self) -> dict:
        """Per-peer convergence-lag rollup — the soak-verdict column."""
        with self._lock:
            return {peer: {"n": agg["n"],
                           "mean_s": round(agg["sum"] / agg["n"], 6)
                           if agg["n"] else 0.0,
                           "max_s": round(agg["max"], 6)}
                    for peer, agg in sorted(self._peer_lags.items())}

    def snapshot(self) -> dict:
        with self._lock:
            stages = {s: self._stage_counts.get(s, 0) for s in STAGES}
            convergence = {
                peer: {"n": agg["n"],
                       "mean_s": round(agg["sum"] / agg["n"], 6)
                       if agg["n"] else 0.0,
                       "max_s": round(agg["max"], 6)}
                for peer, agg in sorted(self._peer_lags.items())}
            return {"version": 1,
                    "enabled": self.enabled,
                    "tracked": len(self._journeys),
                    "stamped": self.stamped,
                    "dropped": self.dropped,
                    "stages": stages,
                    "convergence": convergence}
