"""Dynamic mesh membership: join/leave/suspect/dead with incarnations.

PR 2's mesh was a static `--peers host:port,...` list — a restarted or
added host silently fell out of the rendezvous universe. This module
replaces that with an explicit membership view driven by two evidence
sources:

  * local health — the PeerTable probe loop's `down_duration` maps to
    ALIVE (reachable), SUSPECT (down, but for less than the takeover
    delay) and DEAD (down past it). SUSPECT members stay in the
    rendezvous universe, so a short partition never collapses each
    side's host set to itself — exactly the semantics the old
    `ownership_ids()` delay encoded, now as named states;
  * gossip — ping responses piggyback the responder's member table.
    Entries with a HIGHER incarnation always win; at equal incarnation
    local probe evidence wins (a node I can reach is not dead no matter
    who says so). A node that hears itself called SUSPECT/DEAD at its
    own incarnation refutes by bumping its incarnation (SWIM's
    refutation rule), and the bumped number spreads the same way.

Incarnations are persisted (quorum.ReplicaJournal) and bumped on every
restart, so a recovered node's refutation is never mistaken for a stale
echo of its previous life.

Two derived sets drive everything else:

  * `universe()` — ALIVE + SUSPECT (+ always self): the host set
    `owner_of` rendezvous-hashes over. Deterministic lease migration on
    view changes falls out of rendezvous placement being a pure
    function of this set.
  * `voters()` — every member not LEFT (DEAD included): the quorum
    denominator. Counting DEAD members keeps the denominator from
    shrinking under partition — a minority side can never reach
    majority by declaring the other side dead. Shrinking the voter set
    requires an explicit, operator-driven `leave`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .metrics import ReplicationMetrics

JOINING = "joining"   # announced via /replicate/join, not yet probed ok
ALIVE = "alive"
SUSPECT = "suspect"   # unreachable for < dead_after_s; still in universe
DEAD = "dead"         # unreachable past dead_after_s; out of universe
LEFT = "left"         # explicit leave; out of universe AND voters

_UNIVERSE_STATES = (JOINING, ALIVE, SUSPECT)


class Member:
    __slots__ = ("member_id", "state", "incarnation", "since")

    def __init__(self, member_id: str, state: str,
                 incarnation: int = 0) -> None:
        self.member_id = member_id
        self.state = state
        self.incarnation = incarnation
        self.since = time.monotonic()

    def as_json(self) -> dict:
        return {"state": self.state, "incarnation": self.incarnation,
                "since_s": round(time.monotonic() - self.since, 3)}


class MembershipView:
    """Thread-safe membership table. `view_version` bumps on every
    state transition so scrapers (and tests) can detect view churn."""

    def __init__(self, self_id: str, incarnation: int = 1,
                 metrics: Optional[ReplicationMetrics] = None) -> None:
        self.self_id = self_id
        self.metrics = metrics
        from ..analysis.witness import make_lock
        self._lock = make_lock("repl.membership", "repl.membership")
        self.members: Dict[str, Member] = {
            self_id: Member(self_id, ALIVE, incarnation)}
        self.view_version = 1

    def _bump(self, key: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.bump("membership", key, n)

    def _set_state(self, m: Member, state: str) -> bool:
        if m.state == state:
            return False
        m.state = state
        m.since = time.monotonic()
        self.view_version += 1
        return True

    # ---- views -----------------------------------------------------------

    @property
    def self_incarnation(self) -> int:
        with self._lock:
            return self.members[self.self_id].incarnation

    def state_of(self, member_id: str) -> Optional[str]:
        with self._lock:
            m = self.members.get(member_id)
            return m.state if m is not None else None

    def universe(self) -> List[str]:
        """Host ids rendezvous ownership is computed over. Self is
        always included (a node always owns the docs that hash to it,
        regardless of what gossip claims about it)."""
        with self._lock:
            ids = {m.member_id for m in self.members.values()
                   if m.state in _UNIVERSE_STATES}
            ids.add(self.self_id)
            return sorted(ids)

    def voters(self) -> List[str]:
        """The quorum denominator: every member that has not
        explicitly LEFT (DEAD members still count — see module doc)."""
        with self._lock:
            return sorted(m.member_id for m in self.members.values()
                          if m.state != LEFT)

    def quorum_size(self) -> int:
        return len(self.voters()) // 2 + 1

    # ---- explicit membership changes -------------------------------------

    def add(self, member_id: str, state: str = JOINING,
            incarnation: int = 0) -> bool:
        """Register a member (join announcement or bootstrap peer).
        Re-adding a LEFT/DEAD member with a newer incarnation revives
        it (a restarted host re-joins under a bumped incarnation)."""
        with self._lock:
            m = self.members.get(member_id)
            if m is None:
                self.members[member_id] = Member(member_id, state,
                                                 incarnation)
                self.view_version += 1
                self._bump("joins")
                return True
            if incarnation > m.incarnation:
                m.incarnation = incarnation
                changed = self._set_state(m, state)
                if changed:
                    self._bump("joins")
                return changed
            return False

    def leave(self, member_id: str) -> bool:
        """Explicit leave: out of the universe AND the voter set."""
        with self._lock:
            m = self.members.get(member_id)
            if m is None or m.state == LEFT:
                return False
            self._set_state(m, LEFT)
            self._bump("leaves")
            return True

    # ---- local health evidence -------------------------------------------

    def note_health(self, member_id: str, down_s: Optional[float],
                    dead_after_s: float) -> bool:
        """Fold one probe-loop observation: `down_s` is
        PeerTable.down_duration (None = reachable). Local evidence
        moves state without touching the incarnation — incarnations
        arbitrate GOSSIP, not direct observation."""
        with self._lock:
            m = self.members.get(member_id)
            if m is None or m.state == LEFT:
                return False
            if down_s is None:
                return self._set_state(m, ALIVE)
            if down_s >= dead_after_s:
                changed = self._set_state(m, DEAD)
                if changed:
                    self._bump("deaths")
                return changed
            changed = self._set_state(m, SUSPECT)
            if changed:
                self._bump("suspicions")
            return changed

    # ---- gossip ----------------------------------------------------------

    def merge_remote(self, entries: Dict[str, dict]) -> bool:
        """Fold a peer's member table (ping piggyback). Returns True
        when the view changed. Rules: higher incarnation wins; at equal
        incarnation local state stands (probe evidence beats hearsay);
        unknown ids are added (this is how a join spreads without a
        broadcast). Hearing ourselves called SUSPECT/DEAD at our own
        incarnation (or newer) is refuted by bumping our incarnation."""
        changed = False
        with self._lock:
            for mid, info in entries.items():
                try:
                    state = str(info["state"])
                    inc = int(info["incarnation"])
                except (KeyError, TypeError, ValueError):
                    continue
                if state not in (JOINING, ALIVE, SUSPECT, DEAD, LEFT):
                    continue
                if mid == self.self_id:
                    me = self.members[self.self_id]
                    if state in (SUSPECT, DEAD) \
                            and inc >= me.incarnation:
                        me.incarnation = inc + 1
                        self.view_version += 1
                        self._bump("refutations")
                        changed = True
                    continue
                m = self.members.get(mid)
                if m is None:
                    self.members[mid] = Member(mid, state, inc)
                    self.view_version += 1
                    self._bump("joins")
                    changed = True
                    continue
                if inc > m.incarnation:
                    m.incarnation = inc
                    changed |= self._set_state(m, state)
                elif inc == m.incarnation and state == LEFT \
                        and m.state != LEFT:
                    # LEFT is operator-driven and terminal at its
                    # incarnation: it must spread even without an
                    # incarnation bump
                    self._set_state(m, LEFT)
                    self._bump("leaves")
                    changed = True
        return changed

    # ---- export ----------------------------------------------------------

    def as_json(self) -> dict:
        with self._lock:
            return {"view_version": self.view_version,
                    "members": {mid: m.as_json()
                                for mid, m in
                                sorted(self.members.items())}}

    def gossip_payload(self) -> Dict[str, dict]:
        """The compact member table piggybacked on ping responses."""
        with self._lock:
            return {mid: {"state": m.state,
                          "incarnation": m.incarnation}
                    for mid, m in self.members.items()}
