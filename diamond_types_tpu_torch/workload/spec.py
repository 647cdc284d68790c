"""The declarative `Scenario` spec + the registry the CLI lists.

A scenario is pure data (dataclass of plain dicts/numbers — JSON
round-trippable, stamped verbatim into the scorecard) describing:

  arrivals     interactive-write arrival process (arrivals.py spec)
  popularity   which doc each write touches (popularity.py spec)
  reads_per_write   the read:write mix (realistic default ~100:1;
                    smoke overrides it down to stay seconds-long)
  tenants / docs_per_tenant   multi-tenant namespaces — doc ids are
                    "t{tenant}-doc{i:03d}" (the id grammar forbids /)
  sessions_per_tenant / session_churn_every_s   editing sessions per
                    tenant; churn retires agent names on a virtual
                    cadence and mints fresh ones
  bulk         optional bulk-import lane (its own arrival spec +
                    payload size) running BEHIND interactive traffic
  bank         optional bank-churn lane: docs churning through an
                    undersized warm tier (TieredStore + Hydrator) with
                    device-tier spill accounting — the tiered-
                    residency scale run rides this
  chaos        optional fault tape (replicate/faults.py): one
                    asymmetric partition plus one crash-restart at
                    fixed virtual times; arms persistent journals so
                    the crashed server reboots on its own state

Virtual time: `duration_s` of traffic is scheduled up front on the
scenario's injectable clock and executed in `tick_s` steps; nothing
sleeps to simulate load, so wall time is bounded by real work only.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional


@dataclass
class Scenario:
    name: str
    description: str = ""
    seed: int = 0
    servers: int = 2
    serve_shards: int = 1
    tenants: int = 1
    docs_per_tenant: int = 4
    duration_s: float = 4.0          # virtual seconds of traffic
    tick_s: float = 0.5              # control-plane step cadence
    arrivals: Dict = field(
        default_factory=lambda: {"kind": "poisson", "rate_per_s": 20.0})
    popularity: Dict = field(
        default_factory=lambda: {"kind": "zipf", "s": 1.1})
    reads_per_write: float = 100.0
    sessions_per_tenant: int = 2
    session_churn_every_s: float = 0.0   # 0 = sessions never churn
    bulk: Optional[Dict] = None
    bank: Optional[Dict] = None
    chaos: Optional[Dict] = None
    reconcile_rounds: int = 12
    slow: bool = False               # excluded from tier-1 by marker

    def doc_ids(self) -> List[str]:
        return [f"t{t}-doc{i:03d}" for t in range(self.tenants)
                for i in range(self.docs_per_tenant)]

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Scenario":
        return cls(**d)


SCENARIOS: Dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        known = ", ".join(sorted(SCENARIOS))
        raise ValueError(
            f"unknown scenario {name!r} (known: {known})") from None


# ---- registry ------------------------------------------------------------

# Tier-1 smoke: every harness feature exercised (two tenants, session
# churn, a bulk lane, a bank-churn lane small enough to finish in
# seconds) with the read mix cut far below the realistic 100:1 so the
# gate stays fast; the scorecard must still come out complete.
register(Scenario(
    name="smoke",
    description="tier-1 gate: small, seconds-long, deterministic; "
                "complete scorecard with every column populated",
    seed=7, servers=2, serve_shards=1, tenants=2, docs_per_tenant=3,
    duration_s=3.0, tick_s=0.5,
    arrivals={"kind": "poisson", "rate_per_s": 14.0},
    popularity={"kind": "zipf", "s": 1.1},
    reads_per_write=3.0,
    sessions_per_tenant=2, session_churn_every_s=1.0,
    bulk={"arrivals": {"kind": "ramp", "start_per_s": 0.0,
                       "end_per_s": 4.0, "ramp_s": 3.0},
          "bytes_per_op": 256},
    bank={"docs": 48, "warm_slots": 8, "rounds": 2,
          "edits_per_round": 32},
))

# Mesh-transport stressor: a 3-server mesh with aggressive session
# churn and a modest doc set, so anti-entropy re-walks the same docs
# round after round and most edits land on non-owners (proxied). This
# is the wire tier's before/after scenario — run once with
# DT_WIRE_DISABLED=1 (JSON protocol, no frontier short-circuit) and
# once framed, then scorecard-diff the wire.* bytes_per_op columns.
register(Scenario(
    name="churn",
    description="session-churn mesh traffic: the wire-tier transport "
                "baseline (antientropy + proxy bytes_per_op)",
    seed=17, servers=3, serve_shards=1, tenants=2, docs_per_tenant=8,
    duration_s=8.0, tick_s=0.25,
    arrivals={"kind": "poisson", "rate_per_s": 10.0},
    popularity={"kind": "zipf", "s": 1.3},
    reads_per_write=6.0,
    sessions_per_tenant=3, session_churn_every_s=1.5,
))

register(Scenario(
    name="flash-crowd",
    description="bursty arrivals on a rotating hot set: the admission/"
                "QoS stressor (ROADMAP item 1's scenario matrix)",
    seed=11, servers=3, serve_shards=2, tenants=2, docs_per_tenant=8,
    duration_s=20.0, tick_s=0.5,
    arrivals={"kind": "bursty", "base_per_s": 12.0, "burst_x": 8.0,
              "every_s": 6.0, "burst_len_s": 1.5},
    popularity={"kind": "hotset", "hot_k": 2, "hot_weight": 0.85,
                "rotate_every_s": 5.0},
    reads_per_write=20.0,
    sessions_per_tenant=3, session_churn_every_s=4.0,
    slow=True,
))

register(Scenario(
    name="ramp-bulk",
    description="bulk import ramping up behind steady interactive "
                "traffic at the realistic ~100:1 read mix",
    seed=13, servers=2, serve_shards=2, tenants=4, docs_per_tenant=6,
    duration_s=15.0, tick_s=0.5,
    arrivals={"kind": "poisson", "rate_per_s": 8.0},
    popularity={"kind": "zipf", "s": 1.2},
    reads_per_write=100.0,
    sessions_per_tenant=2, session_churn_every_s=5.0,
    bulk={"arrivals": {"kind": "ramp", "start_per_s": 0.0,
                       "end_per_s": 30.0, "ramp_s": 10.0},
          "bytes_per_op": 2048},
    slow=True,
))

# The churn tape under injected faults: one asymmetric mid-run
# partition (server 1 cannot reach server 0, the reverse path stays
# up) and a crash-restart of server 2 on persistent journals.
# Client-visible errors and SLO burn are EXPECTED while the mesh
# degrades — the gate is the safety property: every server
# byte-identical after the heal and reboot.
register(Scenario(
    name="chaos-churn",
    description="churn traffic under faults: one asymmetric partition "
                "+ one crash-restart; availability degrades honestly, "
                "the gate is post-heal byte-identical convergence",
    seed=17, servers=3, serve_shards=1, tenants=2, docs_per_tenant=8,
    duration_s=8.0, tick_s=0.25,
    arrivals={"kind": "poisson", "rate_per_s": 10.0},
    popularity={"kind": "zipf", "s": 1.3},
    reads_per_write=6.0,
    sessions_per_tenant=3, session_churn_every_s=1.5,
    chaos={"partition": {"a": 1, "b": 0, "at_s": 2.0, "heal_s": 4.0,
                         "oneway": True},
           "crash": {"server": 2, "at_s": 4.5, "restart_s": 6.0}},
    reconcile_rounds=24,
    slow=True,
))

# The tiered-residency scale run (PR 8 residual): 1M docs churning
# through a 10k-slot bank, gated on spill accounting + cold-start p99.
# Docs materialize on first touch (TieredStore.load treats a missing
# home as a fresh doc), so the run's cost is the churn, not a seeding
# pass over the full population.
register(Scenario(
    name="bank-churn-1m",
    description="1M docs through a 10k-slot bank with device-tier "
                "spill accounting (the honest tiered-residency scale "
                "run; hours, not seconds)",
    seed=8, servers=1, serve_shards=2, tenants=1, docs_per_tenant=4,
    duration_s=30.0, tick_s=1.0,
    arrivals={"kind": "poisson", "rate_per_s": 4.0},
    popularity={"kind": "zipf", "s": 1.1},
    reads_per_write=10.0,
    bank={"docs": 1_000_000, "warm_slots": 10_000, "rounds": 50,
          "edits_per_round": 20_000},
    slow=True,
))
