"""Actions and scenarios: the explored state machine's alphabet.

An action is one ATOMIC step of the virtual scheduler — a protocol
step on one node (acquire/renew, probe+maintain, anti-entropy round),
an environment event (clock tick, link cut/heal, crash/restart), or an
adversarial delivery (duplicate of the last lease message). Atomicity
is the model's core approximation: the real system interleaves at
instruction granularity under locks, the model at action granularity
(CHECKING.md discusses what that excludes and why the lock witness +
dt-lint carry the intra-action burden).

`acquire` calls `LeaseManager.ensure_local(doc, True)` directly — the
node acts as if placement selected it. That models divergent
rendezvous views (the adversarial case) without enumerating membership
states; with the quorum hook attached, safety must hold anyway.

Scenarios bound each action's occurrence count per trace. The bounds
are part of the model (the state space is finite because of them) and
are reported with every verdict — a clean verdict means "no violation
within these bounds", nothing stronger.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ...replicate.ownership import ACTIVE
from .world import SimWorld

# footprint token meaning "conflicts with everything"
ALL = "*"


class Action:
    __slots__ = ("op", "node", "peer", "doc")

    def __init__(self, op: str, node: Optional[str] = None,
                 peer: Optional[str] = None,
                 doc: Optional[str] = None) -> None:
        self.op = op
        self.node = node
        self.peer = peer
        self.doc = doc

    @property
    def label(self) -> str:
        if self.op == "tick":
            return "tick"
        if self.op in ("cut", "heal"):
            return f"{self.op}({self.node},{self.peer})"
        if self.op in ("edit", "qedit", "gedit", "acquire", "demote"):
            return f"{self.op}({self.node},{self.doc})"
        if self.op in ("migrate", "promote"):
            return f"{self.op}({self.node},{self.peer},{self.doc})"
        return f"{self.op}({self.node})"

    def __repr__(self) -> str:
        return self.label

    def as_json(self) -> dict:
        out = {"op": self.op}
        for k in ("node", "peer", "doc"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "Action":
        return cls(doc["op"], node=doc.get("node"),
                   peer=doc.get("peer"), doc=doc.get("doc"))

    # ---- scheduler interface ----
    def enabled(self, world: SimWorld) -> bool:
        op = self.op
        if op == "tick":
            return True
        if op == "cut":
            return not world.is_cut(self.node, self.peer)
        if op == "heal":
            return world.is_cut(self.node, self.peer)
        if op == "crash":
            return self.node not in world.crashed
        if op == "restart":
            return self.node in world.crashed
        if self.node in world.crashed:
            return False
        if op == "dup":
            return self.node in world.last_lease_msg
        if op in ("qedit", "migrate"):
            # only the current ACTIVE holder acks queued writes or
            # initiates a migration (the rebalancer runs on the owner);
            # the TARGET may be crashed/cut — that is the abort path
            l = world.nodes[self.node].leases.get(self.doc)
            return l is not None and l.holder == self.node \
                and l.state == ACTIVE
        if op == "promote":
            # the ACTIVE holder splits its own doc — once per trace is
            # enough; re-promotion of a live group is refused anyway
            node = world.nodes[self.node]
            l = node.leases.get(self.doc)
            return l is not None and l.holder == self.node \
                and l.state == ACTIVE \
                and node.writergroups.get(self.doc) is None
        if op == "demote":
            return world.nodes[self.node].can_demote(self.doc)
        if op == "gedit":
            # a member write is only offered where the member-side
            # admission gate (incl. the self-fence) would admit it
            return world.nodes[self.node].group_accepts(self.doc)
        if op == "flush":
            return bool(world.stores[self.node].pending)
        return True

    def apply(self, world: SimWorld) -> None:
        op = self.op
        if op == "edit":
            world.edit(self.node, self.doc)
        elif op == "qedit":
            world.qedit(self.node, self.doc)
        elif op == "flush":
            world.stores[self.node].scheduler.drain()
        elif op == "gedit":
            world.qedit(self.node, self.doc)
        elif op == "migrate":
            world.migrate(self.node, self.peer, self.doc)
        elif op == "promote":
            world.nodes[self.node].promote_writer_group(
                self.doc, [self.peer])
        elif op == "demote":
            world.nodes[self.node].demote_writer_group(self.doc)
        elif op == "acquire":
            world.nodes[self.node].leases.ensure_local(self.doc, True)
        elif op == "step":
            node = world.nodes[self.node]
            node.table.probe_once()
            node.maintain()
        elif op == "ae":
            world.nodes[self.node].antientropy.run_round()
        elif op == "tick":
            world.now += world.tick_s
        elif op == "cut":
            world.cut(self.node, self.peer)
        elif op == "heal":
            world.heal(self.node, self.peer)
        elif op == "crash":
            world.crash(self.node)
        elif op == "restart":
            world.restart(self.node)
        elif op == "dup":
            world.redeliver_last_lease_msg(self.node)
        else:
            raise ValueError(f"unknown action op {op!r}")

    def footprint(self) -> frozenset:
        """Aspects this action reads or writes, for the independence
        relation (disjoint footprints commute). Environment actions and
        anything that can touch every node are ALL — conservative is
        sound; it only costs reduction."""
        if self.op in ("edit", "qedit", "gedit", "flush"):
            return frozenset({f"{self.node}:oplog"})
        return frozenset({ALL})


def independent(a: Action, b: Action) -> bool:
    fa, fb = a.footprint(), b.footprint()
    if ALL in fa or ALL in fb:
        return False
    return not (fa & fb)


class Scenario:
    """A bounded model: node set, doc set, action pool with per-label
    occurrence bounds, and the invariant names checked over it."""

    def __init__(self, name: str, node_ids: Tuple[str, ...],
                 docs: Tuple[str, ...], quorum: bool,
                 actions: Tuple[Action, ...], bounds: Dict[str, int],
                 invariants: Tuple[str, ...], ttl_s: float = 2.0,
                 tick_s: float = 1.1,
                 setup: Tuple[Action, ...] = (),
                 description: str = "") -> None:
        self.name = name
        self.node_ids = node_ids
        self.docs = docs
        self.quorum = quorum
        self.actions = actions
        self.bounds = bounds
        self.invariants = invariants
        self.ttl_s = ttl_s
        self.tick_s = tick_s
        # deterministic pre-state applied at build time (seeded edits,
        # typically) — part of the model, not of the explored choices
        self.setup = setup
        self.description = description

    def build(self, mutation=None) -> SimWorld:
        world = SimWorld(self.node_ids, docs=self.docs,
                         ttl_s=self.ttl_s, quorum=self.quorum,
                         mutation=mutation)
        world.tick_s = self.tick_s
        for a in self.setup:
            a.apply(world)
        return world

    def enabled_actions(self, world: SimWorld,
                        counts: Dict[str, int]):
        out = []
        for a in self.actions:
            if counts.get(a.op, 0) >= self.bounds.get(a.op, 2):
                continue
            if a.enabled(world):
                out.append(a)
        return out


def _acts(*specs) -> Tuple[Action, ...]:
    return tuple(Action(*s) for s in specs)


# Node/doc ids are chosen so rendezvous placement makes the model
# interesting: owner_of("d0", [n1,n2,n3]) == n1, and n2 succeeds n1
# when n1 leaves the universe — so takeover and handoff-back paths are
# reachable within the bounds.
SCENARIOS: Dict[str, Scenario] = {}


def _register(s: Scenario) -> None:
    SCENARIOS[s.name] = s


_register(Scenario(
    "handoff", ("n1", "n2", "n3"), ("d0",), quorum=True,
    setup=_acts(("edit", "n1", None, "d0")),
    actions=_acts(
        ("acquire", "n1", None, "d0"), ("acquire", "n2", None, "d0"),
        ("step", "n1"), ("step", "n2"),
        ("ae", "n1"), ("ae", "n2"),
        ("edit", "n1", None, "d0"), ("edit", "n2", None, "d0"),
        ("tick",),
        ("cut", "n1", "n2"), ("heal", "n1", "n2"),
        ("crash", "n2"), ("restart", "n2"),
        ("dup", "n2"),
    ),
    bounds={"acquire": 3, "step": 2, "ae": 2, "edit": 2, "tick": 3,
            "cut": 1, "heal": 1, "crash": 1, "restart": 1, "dup": 1},
    invariants=("single-active", "promise-exclusivity",
                "floor-monotonic", "floor-coverage",
                "own-lease-stability", "tie-break-direction",
                "convergence"),
    description="3-voter mesh, one doc: competing acquires, partition, "
                "crash/restart, duplicate delivery, anti-entropy."))

_register(Scenario(
    "crash-recovery", ("n1", "n2", "n3"), ("d0",), quorum=True,
    actions=_acts(
        ("acquire", "n1", None, "d0"), ("acquire", "n3", None, "d0"),
        ("crash", "n2"), ("restart", "n2"),
        ("step", "n2"), ("tick",),
    ),
    bounds={"acquire": 2, "crash": 1, "restart": 1, "step": 2,
            "tick": 2},
    invariants=("single-active", "promise-exclusivity",
                "floor-monotonic", "floor-coverage"),
    description="voter crash between two competing acquisitions: the "
                "promise table must survive the restart."))

_register(Scenario(
    "renewal", ("n1", "n2"), ("d0",), quorum=True,
    setup=_acts(("edit", "n1", None, "d0")),
    actions=_acts(
        ("acquire", "n1", None, "d0"),
        ("ae", "n1"), ("ae", "n2"), ("tick",),
    ),
    bounds={"acquire": 2, "ae": 2, "tick": 2},
    invariants=("single-active", "promise-exclusivity",
                "floor-monotonic", "floor-coverage",
                "own-lease-stability", "convergence"),
    description="renewals under anti-entropy echo: a peer's stale "
                "view of our own lease must never shorten it."))

_register(Scenario(
    "tiebreak", ("n1", "n2"), ("d0",), quorum=False,
    setup=_acts(("edit", "n1", None, "d0"),
                ("edit", "n2", None, "d0")),
    actions=_acts(
        ("acquire", "n1", None, "d0"), ("acquire", "n2", None, "d0"),
        ("ae", "n1"), ("ae", "n2"), ("tick",),
    ),
    bounds={"acquire": 2, "ae": 2, "tick": 2},
    invariants=("floor-monotonic", "floor-coverage",
                "own-lease-stability", "tie-break-direction",
                "convergence"),
    description="PR 2 no-quorum mode, where equal-epoch conflicts ARE "
                "reachable: arbitration must be deterministic "
                "(lexically smaller holder wins) on every host. "
                "single-active is deliberately not checked here."))

_register(Scenario(
    "migration", ("n1", "n2", "n3"), ("d0",), quorum=True,
    # pre-state: n1 owns d0 with one acked-but-queued write sitting in
    # its admission queue — the op the drain barrier must not lose
    setup=_acts(("acquire", "n1", None, "d0"),
                ("qedit", "n1", None, "d0")),
    actions=_acts(
        ("qedit", "n1", None, "d0"),
        ("flush", "n1"),
        ("migrate", "n1", "n2", "d0"),
        ("step", "n1"), ("step", "n2"),
        ("ae", "n1"), ("ae", "n2"),
        ("tick",),
        ("cut", "n1", "n2"), ("heal", "n1", "n2"),
        ("crash", "n2"), ("restart", "n2"),
        ("dup", "n2"),
    ),
    bounds={"qedit": 1, "flush": 1, "migrate": 2, "step": 1, "ae": 1,
            "tick": 2, "cut": 1, "heal": 1, "crash": 1, "restart": 1,
            "dup": 1},
    invariants=("single-active", "promise-exclusivity",
                "floor-monotonic", "floor-coverage",
                "no-acked-loss", "convergence"),
    description="elastic-mesh live migration (override + grant -> "
                "drain -> transfer -> activate) under crash, "
                "partition and duplicate delivery: no interleaving "
                "may lose an acknowledged op or activate two owners; "
                "aborts must leave the doc owned at the source."))

_register(Scenario(
    "writer-group", ("n1", "n2", "n3"), ("d0",), quorum=True,
    # tick_s > ttl_s: one tick expires leases, two expire the group
    # registration TTL (2 * ttl_s) — so every TTL-gated path (member
    # self-fence on expiry, demotion past a silent member) is
    # reachable within the tick bound
    ttl_s=2.0, tick_s=2.2,
    # pre-state: n1 owns d0 with one acked-but-queued write — the op
    # neither promotion nor demotion may lose
    setup=_acts(("acquire", "n1", None, "d0"),
                ("qedit", "n1", None, "d0")),
    actions=_acts(
        ("promote", "n1", "n2", "d0"),
        ("demote", "n1", None, "d0"),
        ("qedit", "n1", None, "d0"),
        ("gedit", "n2", None, "d0"),
        ("flush", "n2"),
        ("step", "n1"), ("step", "n2"),
        ("ae", "n1"), ("ae", "n2"),
        ("tick",),
        ("cut", "n1", "n2"), ("heal", "n1", "n2"),
        ("crash", "n2"), ("restart", "n2"),
        ("dup", "n2"),
    ),
    bounds={"promote": 1, "demote": 2, "qedit": 1, "gedit": 2,
            "flush": 1, "step": 1, "ae": 1, "tick": 2, "cut": 1,
            "heal": 1, "crash": 1, "restart": 1, "dup": 1},
    invariants=("single-active", "promise-exclusivity",
                "floor-monotonic", "floor-coverage",
                "group-epoch-exclusivity", "no-acked-loss",
                "convergence"),
    description="hot-doc write splitting: promote n1's lease to a "
                "{n1,n2} writer group, member writes on n2, fenced "
                "demotion back to one writer — under member crash, "
                "partition, duplicate grant/demote delivery and TTL "
                "expiry. No interleaving may admit a write under a "
                "superseded group epoch or lose an acked member "
                "write across the demotion drain."))
