"""Writer groups: hot-doc write splitting over the lease protocol.

A doc whose write SLO keeps burning is capped by its single ACTIVE
lease holder — migration (replicate/rebalance.py) moves whole docs, so
one viral doc still funnels through one host. The CRDT itself is
multi-writer by construction (OpLog merge is deterministic from any
interleaving), so the wall is pure policy: the lease system made docs
single-writer for device efficiency, not correctness.

A *writer group* splits the write path for one doc:

  * **Promotion** (leader = the current ACTIVE holder) runs a quorum
    round at a bumped epoch — `max(lease.epoch, floor) + 1`, the same
    planning rule every acquisition uses — then re-keys its own ACTIVE
    lease to that epoch (`LeaseManager.promote_epoch`) and records the
    member set at it, journaled like any lease state. Members receive a
    directed group grant over `/replicate/lease`; installing it folds
    the leader's lease claim (raising the member's fencing floor to the
    group epoch) and registers a TTL-bounded entry.

  * **Member writes** are admitted locally (`ReplicaNode.owns` /
    `group_accepts`) and stamped with the group epoch — fenced exactly
    like `X-DT-Lease-Epoch` proxied writes: a floor that passes the
    group epoch invalidates the registration. Convergence rides the
    existing anti-entropy + merge path; nothing new is needed there
    because merge order never mattered.

  * **Demotion is the robustness centerpiece.** The group drains back
    to one writer by bumping the epoch once more: the leader runs a
    quorum round at `group_epoch + 1`, fences every member (reachable
    members drain their pending admissions into the oplog, drop the
    registration and evict their admission queue; an unreachable
    member must first be provably past its registration TTL — the
    demotion epoch is never committed while a silent member could
    still be accepting), then re-keys its lease. Replayed grants from
    the superseded group are refused at install time (`epoch < floor`).

  * **Self-fencing**: a member that cannot reach the leader plus a
    majority of the group, or whose registration expired un-renewed,
    stops accepting writes immediately (proxy-only) rather than
    accumulating acked edits the group may already have fenced away.
    Registrations are renewed through the leader on the maintain loop.

Epochs are shared with the lease space on purpose: every existing
fencing mechanism (floors, 409s on stale claims, journal restore,
rejoining fences) applies to group state with no parallel machinery.
The model checker covers the protocol first — see
analysis/explore/model.py's `writer-group` scenario, the
`group-epoch-exclusivity` invariant, and the `demote-without-drain` /
`promote-floor-drop` seeded mutations.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple


class WriterGroup:
    __slots__ = ("doc_id", "epoch", "members", "leader", "expires_at")

    def __init__(self, doc_id: str, epoch: int,
                 members: Sequence[str], leader: str,
                 expires_at: float) -> None:
        self.doc_id = doc_id
        self.epoch = epoch
        self.members = tuple(sorted(members))
        self.leader = leader
        self.expires_at = expires_at

    def quorum_size(self) -> int:
        return len(self.members) // 2 + 1

    def as_json(self, now: float) -> dict:
        return {"epoch": self.epoch, "members": list(self.members),
                "leader": self.leader,
                "ttl_s": round(max(self.expires_at - now, 0.0), 3)}


class WriterGroupTable:
    """Per-host writer-group registrations (one entry per doc this host
    is a member or leader of), journaled alongside the lease table.

    Lock discipline: the table lock is a *late* rung — it is taken
    while holding the lease lock (the floor-raise hook fences entries
    atomically with the floor) and never the other way around, and no
    method calls into the lease manager, peer table, or network while
    holding it. Every method is a pure dict operation plus at most a
    journal append (the journal lock is a leaf).
    """

    def __init__(self, self_id: str, ttl_s: float = 4.0,
                 metrics=None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        import time
        self.self_id = self_id
        self.ttl_s = ttl_s
        self.metrics = metrics
        self.clock: Callable[[], float] = \
            time.monotonic if clock is None else clock
        self.journal = None
        self.groups: Dict[str, WriterGroup] = {}
        from ..analysis.witness import make_lock
        self.lock = make_lock("repl.writergroup", "repl.writergroup")

    def _bump(self, key: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.bump("writergroup", key, n)

    # ---- crash-restart restore -------------------------------------------

    def restore(self, journal,
                floor_of: Callable[[str], int]) -> int:
        """Adopt journaled group registrations at boot. Entries are
        restored EXPIRED (accepting again requires a fresh renewal
        through the leader — the rejoining fence denies admits anyway)
        and entries below the restored fencing floor are not restored
        at all: the group they belonged to has been superseded."""
        n = 0
        now = self.clock()
        with self.lock:
            for doc, info in journal.restored_groups().items():
                if int(info.get("epoch", 0)) < floor_of(doc):
                    continue
                self.groups[doc] = WriterGroup(
                    doc, int(info["epoch"]),
                    [str(m) for m in info.get("members", [])],
                    str(info.get("leader", "")), now)
                n += 1
        self.journal = journal
        return n

    # ---- views ------------------------------------------------------------

    def get(self, doc_id: str) -> Optional[WriterGroup]:
        with self.lock:
            return self.groups.get(doc_id)

    def entries(self) -> List[Tuple[str, WriterGroup]]:
        with self.lock:
            return sorted(self.groups.items())

    def peer_set(self) -> frozenset:
        """Every OTHER host that co-writes some doc with us — the
        anti-entropy loop reconciles these peers first so in-group
        visibility stays tight."""
        with self.lock:
            return frozenset(
                m for g in self.groups.values() for m in g.members
                if m != self.self_id)

    def sizes(self) -> Dict[str, int]:
        """Snapshot-time gauges injected into the metrics block."""
        with self.lock:
            led = sum(1 for g in self.groups.values()
                      if g.leader == self.self_id)
            return {"active_groups": led,
                    "member_entries": len(self.groups) - led}

    def fingerprint(self) -> dict:
        """Deterministic state digest for the model checker."""
        with self.lock:
            return {d: [g.epoch, list(g.members), g.leader,
                        round(g.expires_at, 6)]
                    for d, g in sorted(self.groups.items())}

    def as_json(self) -> dict:
        now = self.clock()
        with self.lock:
            return {d: g.as_json(now)
                    for d, g in sorted(self.groups.items())}

    # ---- mutation ----------------------------------------------------------

    def install(self, doc_id: str, epoch: int,
                members: Sequence[str], leader: str,
                floor: int) -> bool:
        """Record a group registration. Refuses epochs below the
        caller-supplied fencing floor — a replayed grant from a
        superseded group must not resurrect it. Idempotent re-installs
        at the current epoch refresh the TTL (renewal propagation)."""
        if epoch < floor:
            return False
        now = self.clock()
        with self.lock:
            cur = self.groups.get(doc_id)
            if cur is not None and cur.epoch > epoch:
                return False
            self.groups[doc_id] = WriterGroup(
                doc_id, epoch, members, leader, now + self.ttl_s)
        if self.journal is not None:
            self.journal.note_group(doc_id, epoch,
                                    sorted(members), leader)
        return True

    def refresh(self, doc_id: str, epoch: int) -> bool:
        """Extend the registration TTL (a successful renewal round
        trip, or the leader folding a member's renewal)."""
        now = self.clock()
        with self.lock:
            g = self.groups.get(doc_id)
            if g is None or g.epoch != epoch:
                return False
            g.expires_at = now + self.ttl_s
            return True

    def drop(self, doc_id: str,
             at_or_below: Optional[int] = None) -> bool:
        """Remove a registration. `at_or_below` guards replayed
        demotions: a demote for epoch E must not fence a NEWER group
        registered after it."""
        with self.lock:
            g = self.groups.get(doc_id)
            if g is None:
                return False
            if at_or_below is not None and g.epoch > at_or_below:
                return False
            del self.groups[doc_id]
        if self.journal is not None:
            self.journal.drop_group(doc_id)
        return True

    def fence_below(self, doc_id: str, floor: int) -> None:
        """Floor-raise hook (wired to LeaseManager.on_floor_raise,
        called UNDER the lease lock): a fencing floor that passes a
        registration's epoch supersedes the group — drop the entry in
        the same critical section so no admit can slip between the
        floor raise and the fence. Pending admissions are NOT touched
        here; they flush into the oplog on the next drain (acked work
        survives — only the right to accept new work is revoked)."""
        with self.lock:
            g = self.groups.get(doc_id)
            if g is None or g.epoch >= floor:
                return
            del self.groups[doc_id]
        if self.journal is not None:
            self.journal.drop_group(doc_id)
        self._bump("self_fenced")
