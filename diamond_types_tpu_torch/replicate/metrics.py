"""Replication counters, merged into the sync server's `GET /metrics`.

Same philosophy as serve/metrics.py: plain host-side ints behind one
small lock, recording never touches the network or the device. The
snapshot carries a `version` field so soak/bench scrapers can detect
counter-set changes across PRs.

Changelog:
  v8  writer groups: new `writergroup` group — hot-doc write splitting
      (`promotions`, `demotions`, `demote_aborts`, `member_grants`,
      `member_admits`, `renewals`, `renewal_denials`, `self_fenced`,
      `stale_installs_rejected`, plus `active_groups` /
      `member_entries` injected by the node at snapshot time).
      Exported as `dt_repl_writergroup_*` prom families like every
      other group.
  v7  wire tier: new `wire` group — per-channel transport accounting
      (`{channel}_{bytes_sent,bytes_saved,frames,snapshot_ships}` for
      the antientropy / proxy / hydrate / gossip channels, exported as
      dedicated `dt_wire_*` prom families). Counts every send, framed
      or JSON fallback, so before/after scorecards stay comparable.
      Also `antientropy.docs_skipped` — per-doc handshakes elided by
      the frontier short-circuit (equal advertised frontier).
  v6  `ae_ship` latency histogram — per-peer anti-entropy push round
      trip (encode→200), the owner-side half of the edit-to-visibility
      journey (obs/journey.py stamps ae_shipped/applied_at_peer off
      the same call).
  v5  elastic-mesh rebalancer: new `rebalance` group (overrides
      set/cleared/merged, migrations started/completed/aborted, and
      `override_table_size` injected by the node at snapshot time),
      `antientropy.adverts_relayed` (follower→follower frontier advert
      relay), and a seeded `rebalance_drain` latency histogram (the
      drain phase of a live migration).
  v4  `antientropy.frontier_adverts` — owner frontier advertisements
      folded into the follower-read tier's FollowerIndex (from ping
      gossip and `/replicate/docs` piggybacks; read/follower.py).
  v3  latency observations moved onto obs.hist log-bucketed
      histograms. `handoffs.latency_s_total/latency_s_max` are now
      DERIVED from the handoff histogram (kept so schema-v2 scrapers
      keep working); the new `latencies` group carries full histogram
      snapshots (count/sum/max/p50/p90/p99/buckets) for `handoff`,
      `quorum_round`, `probe`, and `antientropy_round`.
  v2  quorum / fencing / membership groups, `leases.tie_breaks`,
      `proxy.fenced_relays`, membership_view + quorum_view objects
      (the partition-safety PR).

Schema (snapshot()):

  {"version": 5, "self": "host:port",
   "leases": {"held", "acquires", "renewals", "takeovers", "releases",
              "tie_breaks",        # equal-epoch conflicts arbitrated
              "churn"},            # churn = acquires+takeovers+releases
   "handoffs": {"started", "completed", "failed",
                "latency_s_total", "latency_s_max"},
   "antientropy": {"rounds", "docs_checked", "docs_skipped",
                   "docs_pulled", "docs_pushed", "bytes_pulled",
                   "bytes_pushed", "errors", "frontier_adverts",
                   "adverts_relayed"},
   "rebalance": {"overrides_set", "overrides_cleared",
                 "override_merges", "migrations_started",
                 "migrations_completed", "migrations_aborted",
                 "override_table_size"},  # size injected at snapshot
   "proxy": {"proxied", "fallback_local", "loops_refused",
             "fenced_relays"},     # 409-fenced proxies retried locally
   "merge_gate": {"admits", "denials"},
   "probes": {"ok", "failed", "circuit_opens", "circuit_closes"},
   "quorum": {"proposals", "acks", "denials", "rounds_won",
              "rounds_lost", "promise_conflicts",
              "rejoins_completed"},
   "fencing": {"rejected_writes",       # proxied writes 409'd as stale
               "stale_lease_revoked",   # own ACTIVE lease below floor
               "rejoin_denials"},       # merges denied while rejoining
   "membership": {"joins", "leaves", "suspicions", "refutations",
                  "deaths"},
   "wire": {f"{channel}_{key}"      # channel x key, flat
            for channel in ("antientropy", "proxy", "hydrate", "gossip")
            for key in ("bytes_sent", "bytes_saved", "frames",
                        "snapshot_ships")},
   "latencies": {"handoff": hist, "quorum_round": hist,
                 "probe": hist, "antientropy_round": hist,
                 "rebalance_drain": hist, "ae_ship": hist},
   "per_peer": {peer_id: {"consecutive_failures", "circuit_open",
                          "backoff_s", "last_ok_age_s"}},
   "membership_view": {"view_version", "members": {...}} | null,
   "quorum_view": {"voters", "quorum", "rejoining"} | null,
   "faults": injector counters | null}
"""

from __future__ import annotations

import threading
from typing import Dict

from ..obs.hist import Histogram
from ..wire.frames import WIRE_CHANNELS, WIRE_KEYS

_LATENCY_NAMES = ("handoff", "quorum_round", "probe",
                  "antientropy_round", "rebalance_drain", "ae_ship")

_GROUPS = {
    "leases": ("acquires", "renewals", "takeovers", "releases",
               "tie_breaks"),
    "handoffs": ("started", "completed", "failed"),
    "antientropy": ("rounds", "docs_checked", "docs_skipped",
                    "docs_pulled", "docs_pushed", "bytes_pulled",
                    "bytes_pushed", "errors", "frontier_adverts",
                    "adverts_relayed"),
    "rebalance": ("overrides_set", "overrides_cleared",
                  "override_merges", "migrations_started",
                  "migrations_completed", "migrations_aborted"),
    "proxy": ("proxied", "fallback_local", "loops_refused",
              "fenced_relays"),
    "merge_gate": ("admits", "denials"),
    "probes": ("ok", "failed", "circuit_opens", "circuit_closes"),
    "quorum": ("proposals", "acks", "denials", "rounds_won",
               "rounds_lost", "promise_conflicts",
               "rejoins_completed"),
    "fencing": ("rejected_writes", "stale_lease_revoked",
                "rejoin_denials"),
    "membership": ("joins", "leaves", "suspicions", "refutations",
                   "deaths"),
    "wire": tuple(f"{c}_{k}" for c in WIRE_CHANNELS for k in WIRE_KEYS),
    "writergroup": ("promotions", "demotions", "demote_aborts",
                    "member_grants", "member_admits", "renewals",
                    "renewal_denials", "self_fenced",
                    "stale_installs_rejected"),
}


class ReplicationMetrics:
    # v7 -> v8: writer-group hot-doc split counters (see changelog)
    SCHEMA_VERSION = 8

    def __init__(self, self_id: str = "") -> None:
        self.self_id = self_id
        self._lock = threading.Lock()
        self._c: Dict[str, Dict[str, int]] = {
            g: {k: 0 for k in keys} for g, keys in _GROUPS.items()}
        self.hist: Dict[str, Histogram] = {
            n: Histogram() for n in _LATENCY_NAMES}
        # live-telemetry double-write target (obs TimeSeries), wired by
        # attach_replication when the server carries an obs bundle
        self.ts = None

    def bump(self, group: str, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[group][key] += n
        if self.ts is not None:
            self.ts.inc(f"repl.{group}.{key}", n)

    def get(self, group: str, key: str) -> int:
        with self._lock:
            return self._c[group][key]

    def observe_latency(self, name: str, seconds: float) -> None:
        h = self.hist.get(name)
        if h is None:
            with self._lock:
                h = self.hist.setdefault(name, Histogram())
        h.record(seconds)
        if self.ts is not None:
            self.ts.observe(f"repl.{name}", seconds)

    def observe_handoff_latency(self, seconds: float) -> None:
        self.observe_latency("handoff", seconds)

    def bump_wire(self, channel: str, key: str, n: int = 1) -> None:
        """One wire-tier count: ``channel`` in WIRE_CHANNELS, ``key``
        in WIRE_KEYS — flattened into the ``wire`` group."""
        self.bump("wire", f"{channel}_{key}", n)

    def wire_counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c["wire"])

    def snapshot(self, leases_held: int = 0, per_peer: dict = None,
                 faults: dict = None, membership_view: dict = None,
                 quorum_view: dict = None,
                 override_table_size: int = 0,
                 writergroup_sizes: dict = None) -> dict:
        # histograms carry their own locks; snapshot before taking ours
        latencies = {n: h.snapshot() for n, h in
                     sorted(self.hist.items())}
        handoff = latencies["handoff"]
        with self._lock:
            leases = dict(self._c["leases"])
            leases["held"] = leases_held
            leases["churn"] = (leases["acquires"] + leases["takeovers"]
                               + leases["releases"])
            handoffs = dict(self._c["handoffs"])
            # v2-compat keys, now derived from the histogram
            handoffs["latency_s_total"] = handoff["sum"]
            handoffs["latency_s_max"] = handoff["max"]
            rebalance = dict(self._c["rebalance"])
            rebalance["override_table_size"] = int(override_table_size)
            writergroup = dict(self._c["writergroup"])
            for k, v in (writergroup_sizes or {}).items():
                writergroup[k] = int(v)
            return {
                "version": self.SCHEMA_VERSION,
                "self": self.self_id,
                "leases": leases,
                "handoffs": handoffs,
                "antientropy": dict(self._c["antientropy"]),
                "rebalance": rebalance,
                "proxy": dict(self._c["proxy"]),
                "merge_gate": dict(self._c["merge_gate"]),
                "probes": dict(self._c["probes"]),
                "quorum": dict(self._c["quorum"]),
                "fencing": dict(self._c["fencing"]),
                "membership": dict(self._c["membership"]),
                "wire": dict(self._c["wire"]),
                "writergroup": writergroup,
                "latencies": latencies,
                "per_peer": per_peer or {},
                "membership_view": membership_view,
                "quorum_view": quorum_view,
                "faults": faults,
            }
