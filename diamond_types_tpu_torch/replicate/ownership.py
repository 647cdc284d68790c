"""Doc-ownership leases on rendezvous placement extended to hosts.

Placement reuses the exact scheme serve/router.py proved out for chips
— blake2b rendezvous (highest-random-weight) over the candidate set —
but the candidates are *host ids* (`host:port`) and the set is the
membership universe (membership.MembershipView.universe: ALIVE +
SUSPECT members). Every host computes the same owner for a doc given
the same view; transient view disagreements are resolved by the lease
epoch, and convergence never depends on ownership anyway (anti-entropy
replicates to non-owners).

A lease is a host-local assertion "I run doc X's device merges until
`expires_at`". Exactly-one-merger comes from the combination:

  * a host only admits scheduler work for docs whose ACTIVE lease it
    holds (`LeaseManager.ensure_local` — consulted by the scheduler's
    admit gate);
  * becoming ACTIVE at epoch E requires a MAJORITY of the voter set to
    promise (doc, E) to this holder (quorum.QuorumCoordinator). A
    voter promises an epoch to at most one holder, so two majorities
    for one (doc, E) cannot both exist: at most one ACTIVE lease per
    (doc, epoch), under any partition/crash/churn combination. With no
    quorum hook attached (standalone use, tests) acquisition is
    immediate — PR 2's TTL-delayed behavior;
  * epochs are FENCING tokens: every promise or observation of epoch E
    raises this host's per-doc floor `max_epoch[doc]`; an ACTIVE lease
    below the floor has been superseded and is revoked on its next
    admit check, and proxied writes claiming a below-floor epoch are
    rejected (HTTP 409), not merged;
  * moving ownership while both hosts are alive goes through the
    explicit handoff state machine (driven by node.ReplicaNode):

        ACTIVE --grant sent--> GRANTING --scheduler drained-->
        DRAINING --final patch pushed--> TRANSFER --activate acked-->
        RELEASED (local) / ACTIVE (remote, epoch+1)

    A failure at any step rolls the local lease back to ACTIVE (same
    epoch); the remote side's granted-but-never-activated lease simply
    expires. The doc keeps exactly one active merger throughout. The
    receiver's GRANTED→ACTIVE flip is the step that runs the quorum
    round (one round per handoff covers the new epoch).

Equal-epoch arbitration (`observe_remote`): two differing holders at
one epoch can only reach us through pre-quorum history or observation
races — the quorum protocol itself cannot mint them. The rule is
deterministic and symmetric on every host regardless of arrival order:
the lexically SMALLER holder id wins (the same tie-break rendezvous
uses for score ties), and each arbitration is counted
(`leases.tie_breaks`).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import ReplicationMetrics

# lease states
ACTIVE = "active"        # we merge this doc
GRANTING = "granting"    # handoff: grant offered to the new owner
DRAINING = "draining"    # handoff: draining our pending merges
TRANSFER = "transfer"    # handoff: pushing the final patch
GRANTED = "granted"      # remote offered US the lease; not active yet
RELEASED = "released"    # terminal; kept briefly for observability

_HANDOFF_STATES = (GRANTING, DRAINING, TRANSFER)

# cap on the activation history kept for split-brain auditing
_ACTIVATION_LOG_MAX = 4096


def _score(doc_id: str, host_id: str, salt: bytes) -> int:
    h = hashlib.blake2b(digest_size=8, salt=salt[:16])
    h.update(doc_id.encode("utf8"))
    h.update(host_id.encode("utf8"))
    return int.from_bytes(h.digest(), "little")


def owner_of(doc_id: str, host_ids: Sequence[str],
             salt: str = "dt-replicate") -> str:
    """Rendezvous owner of `doc_id` among `host_ids` — pure function of
    its arguments, so every process that sees the same healthy set
    picks the same owner (ties broken by the lexically smaller id)."""
    if not host_ids:
        raise ValueError("empty host set")
    salt_b = salt.encode("utf8")
    best, best_score = None, -1
    for hid in sorted(host_ids):
        sc = _score(doc_id, hid, salt_b)
        if sc > best_score:
            best, best_score = hid, sc
    return best


class Lease:
    __slots__ = ("doc_id", "holder", "epoch", "state", "expires_at",
                 "granted_at")

    def __init__(self, doc_id: str, holder: str, epoch: int,
                 state: str, expires_at: float,
                 now: Optional[float] = None) -> None:
        self.doc_id = doc_id
        self.holder = holder
        self.epoch = epoch
        self.state = state
        self.expires_at = expires_at     # monotonic, local clock
        self.granted_at = time.monotonic() if now is None else now

    def expired(self, now: Optional[float] = None) -> bool:
        return (time.monotonic() if now is None else now) \
            >= self.expires_at

    def as_json(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        # TTL remaining, not absolute time: peer clocks are not synced
        return {"holder": self.holder, "epoch": self.epoch,
                "state": self.state,
                "ttl_s": round(max(self.expires_at - now, 0.0), 3)}


class LeaseManager:
    """Host-local lease records for every doc this host has an opinion
    about (its own leases + leases observed from peers via grant
    messages and /replicate/docs piggyback), plus the voter-side quorum
    state: the promise table and the per-doc fencing floors."""

    def __init__(self, self_id: str, ttl_s: float = 2.0,
                 metrics: Optional[ReplicationMetrics] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.self_id = self_id
        self.ttl_s = ttl_s
        self.metrics = metrics
        # time source for every lease decision; the model checker
        # (analysis/explore) injects a virtual clock here
        self.clock: Callable[[], float] = \
            time.monotonic if clock is None else clock
        self.leases: Dict[str, Lease] = {}
        # per-doc fencing floor: highest epoch ever promised/observed
        self.max_epoch: Dict[str, int] = {}
        # voter promise table: doc -> (epoch, holder); an epoch is
        # promised to AT MOST one holder (the quorum safety core)
        self.promised: Dict[str, Tuple[int, str]] = {}
        # every local transition to ACTIVE, for split-brain audits
        self.activation_log: List[dict] = []
        # hooks wired by node.ReplicaNode: quorum(doc, epoch, takeover)
        # runs the majority round (called with NO locks held); journal
        # persists floors/promises/held leases across restarts
        self.quorum: Optional[Callable[[str, int, bool], bool]] = None
        self.journal = None
        # floor-raise hook (wired by node.ReplicaNode to
        # WriterGroupTable.fence_below): called UNDER self.lock every
        # time a doc's fencing floor rises, so group registrations the
        # new floor supersedes are fenced in the same critical section
        self.on_floor_raise: Optional[Callable[[str, int], None]] = None
        # obs.recorder.FlightRecorder (wired by node.ReplicaNode);
        # every lease transition is rare enough to record
        self.recorder = None
        from ..analysis.witness import make_lock
        self.lock = make_lock("repl.leases", "repl.leases",
                              reentrant=True)

    def _bump(self, key: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.bump("leases", key, n)

    def _bump_group(self, group: str, key: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.bump(group, key, n)

    def _event(self, kind: str, doc_id: str, epoch: int,
               **fields) -> None:
        r = self.recorder
        if r is not None:
            r.record(kind, doc=doc_id, epoch=epoch, **fields)

    # ---- fencing floor / journal (callers hold self.lock) ----------------

    def _note_epoch_locked(self, doc_id: str, epoch: int) -> None:
        if epoch > self.max_epoch.get(doc_id, 0):
            self.max_epoch[doc_id] = epoch
            if self.journal is not None:
                self.journal.note_epoch(doc_id, epoch)
            if self.on_floor_raise is not None:
                self.on_floor_raise(doc_id, epoch)

    def _log_activation_locked(self, doc_id: str, epoch: int) -> None:
        self.activation_log.append(
            {"doc": doc_id, "epoch": epoch, "holder": self.self_id,
             "t": self.clock()})
        if len(self.activation_log) > _ACTIVATION_LOG_MAX:
            del self.activation_log[:_ACTIVATION_LOG_MAX // 4]

    def max_epoch_of(self, doc_id: str) -> int:
        with self.lock:
            return self.max_epoch.get(doc_id, 0)

    def activation_history(self) -> List[dict]:
        with self.lock:
            return list(self.activation_log)

    # ---- crash-restart restore -------------------------------------------

    def restore(self, journal) -> int:
        """Adopt journal state at boot. Fencing floors and the promise
        table are restored verbatim (the safety payload: a recovered
        voter must never re-promise a taken epoch, and a recovered
        holder must never re-issue a stale one). Leases this host HELD
        are restored as RELEASED — their epoch feeds the next
        acquisition plan (`max(epoch, floor) + 1`), but serving them
        again requires a fresh quorum round."""
        n = 0
        with self.lock:
            for doc, e in journal.restored_max_epochs().items():
                if e > self.max_epoch.get(doc, 0):
                    self.max_epoch[doc] = e
                    n += 1
            for doc, p in journal.restored_promises().items():
                cur = self.promised.get(doc)
                if cur is None or p["epoch"] > cur[0]:
                    self.promised[doc] = (int(p["epoch"]),
                                          str(p["holder"]))
            now = self.clock()
            for doc, info in journal.restored_leases().items():
                if doc in self.leases:
                    continue
                holder = str(info["holder"])
                state = RELEASED if holder == self.self_id \
                    else str(info.get("state", ACTIVE))
                # expires_at = now: an expired hint, never admissible
                self.leases[doc] = Lease(doc, holder,
                                         int(info["epoch"]), state, now,
                                         now=now)
        self.journal = journal
        return n

    # ---- views -----------------------------------------------------------

    def get(self, doc_id: str) -> Optional[Lease]:
        with self.lock:
            return self.leases.get(doc_id)

    def held_ids(self) -> List[str]:
        with self.lock:
            return sorted(d for d, l in self.leases.items()
                          if l.holder == self.self_id
                          and l.state in (ACTIVE,) + _HANDOFF_STATES)

    def held_count(self) -> int:
        return len(self.held_ids())

    def holder_of(self, doc_id: str,
                  now: Optional[float] = None) -> Optional[str]:
        """Current unexpired lease holder, if any is known."""
        with self.lock:
            lease = self.leases.get(doc_id)
            if lease is None or lease.state == RELEASED \
                    or lease.expired(self.clock() if now is None
                                     else now):
                return None
            return lease.holder

    def active_epoch(self, doc_id: str) -> int:
        """Epoch of the ACTIVE lease THIS host holds for the doc, or 0.
        The scheduler's flush-time fencing recheck keys on this."""
        with self.lock:
            lease = self.leases.get(doc_id)
            if lease is None or lease.holder != self.self_id \
                    or lease.state != ACTIVE:
                return 0
            return lease.epoch

    # ---- acquisition -----------------------------------------------------

    def ensure_local(self, doc_id: str, is_desired_owner: bool,
                     now: Optional[float] = None) -> bool:
        """The merge-admission question: may THIS host run doc X's
        merges right now? Renewal of a held ACTIVE lease is local; a
        NEW acquisition (first grant or takeover) is planned under the
        lock, put through the quorum hook with the lock RELEASED (the
        round is network I/O), and committed under the lock with
        re-validation. Returns False while another host's unexpired
        lease stands, during our own outbound handoff, while a quorum
        round is lost, or when our lease has been fenced off."""
        now = self.clock() if now is None else now
        plan = self._admit_or_plan(doc_id, is_desired_owner, now)
        if plan is True or plan is False:
            return plan
        epoch, takeover = plan
        if self.quorum is not None \
                and not self.quorum(doc_id, epoch, takeover):
            return False
        return self._commit_acquire(doc_id, epoch, takeover, now)

    def _admit_or_plan(self, doc_id: str, is_desired_owner: bool,
                       now: float):
        """Under the lock: admit (True), deny (False), or return the
        (epoch, takeover) plan a quorum round must ratify."""
        with self.lock:
            lease = self.leases.get(doc_id)
            floor = self.max_epoch.get(doc_id, 0)
            if lease is not None and lease.holder == self.self_id:
                if lease.state == ACTIVE:
                    if lease.epoch < floor:
                        # superseded: a higher epoch was promised or
                        # observed — the fencing token revokes us
                        del self.leases[doc_id]
                        self._bump_group("fencing",
                                         "stale_lease_revoked")
                        self._event("lease_fenced", doc_id,
                                    lease.epoch, floor=floor)
                        if self.journal is not None:
                            self.journal.drop_lease(doc_id)
                        return False
                    if not is_desired_owner:
                        # placement moved away; keep serving until the
                        # handoff runs (node drives it) — merges must
                        # not stall in the gap
                        pass
                    lease.expires_at = now + self.ttl_s
                    self._bump("renewals")
                    return True
                if lease.state in _HANDOFF_STATES:
                    return False     # outbound handoff in progress
                if lease.state == GRANTED:
                    # we were offered the lease but activation hasn't
                    # arrived; the grantor is still draining/merging
                    return False
            if not is_desired_owner:
                return False
            if lease is not None and lease.holder != self.self_id \
                    and not lease.expired(now):
                return False         # live remote lease wins
            # free (no lease, expired, or released): plan the acquire
            epoch = max(lease.epoch if lease is not None else 0,
                        floor) + 1
            takeover = (lease is not None
                        and lease.holder != self.self_id
                        and lease.state != RELEASED)
            return (epoch, takeover)

    def _commit_acquire(self, doc_id: str, epoch: int, takeover: bool,
                        now: float) -> bool:
        """Re-validate and activate after the (lock-free) quorum round:
        the plan is void if a live conflicting lease or a higher
        promise appeared meanwhile."""
        with self.lock:
            lease = self.leases.get(doc_id)
            if lease is not None and lease.holder != self.self_id \
                    and not lease.expired(now) and lease.epoch >= epoch:
                return False
            floor = self.max_epoch.get(doc_id, 0)
            if floor > epoch or (
                    floor == epoch and self.promised.get(doc_id)
                    not in (None, (epoch, self.self_id))):
                return False
            self.leases[doc_id] = Lease(doc_id, self.self_id, epoch,
                                        ACTIVE, now + self.ttl_s,
                                        now=now)
            self._note_epoch_locked(doc_id, epoch)
            self._log_activation_locked(doc_id, epoch)
            self._bump("takeovers" if takeover else "acquires")
            self._event("lease_acquired", doc_id, epoch,
                        takeover=takeover)
            if self.journal is not None:
                self.journal.note_lease(doc_id, self.self_id, epoch,
                                        ACTIVE)
            return True

    def promote_epoch(self, doc_id: str, epoch: int) -> bool:
        """Writer-group rekey: move our own ACTIVE lease to `epoch` — a
        strictly higher, quorum-ratified bump — without ever leaving
        ACTIVE. Promotion registers the member set at the new epoch;
        demotion bumps once more so every member grant below it is
        fenced by the ordinary floor machinery. The caller MUST have
        won the quorum round for `epoch` first (node-level), exactly
        like a handoff activation."""
        now = self.clock()
        with self.lock:
            lease = self.leases.get(doc_id)
            if lease is None or lease.holder != self.self_id \
                    or lease.state != ACTIVE or epoch <= lease.epoch:
                return False
            lease.epoch = epoch
            lease.expires_at = now + self.ttl_s
            self._note_epoch_locked(doc_id, epoch)
            self._log_activation_locked(doc_id, epoch)
            self._event("lease_rekeyed", doc_id, epoch)
            if self.journal is not None:
                self.journal.note_lease(doc_id, self.self_id, epoch,
                                        ACTIVE)
            return True

    # ---- voter side of the quorum round ----------------------------------

    def promise(self, doc_id: str, epoch: int, holder: str,
                now: Optional[float] = None) -> Tuple[bool, str]:
        """May `holder` become ACTIVE for (doc_id, epoch)? The promise
        is binding and exclusive: once granted, no OTHER holder can be
        promised the same (doc, epoch) by this voter — ever (the table
        survives restarts via the journal). Granting also raises the
        fencing floor, so a superseded local lease self-revokes.
        Returns (ok, reason)."""
        now = self.clock() if now is None else now
        with self.lock:
            if epoch < self.max_epoch.get(doc_id, 0):
                return False, "stale_epoch"
            p = self.promised.get(doc_id)
            if p is not None:
                p_epoch, p_holder = p
                if epoch < p_epoch:
                    return False, "promised_higher"
                if epoch == p_epoch and holder != p_holder:
                    self._bump_group("quorum", "promise_conflicts")
                    self._event("promise_conflict", doc_id, epoch,
                                holder=holder, promised_to=p_holder)
                    return False, "promise_conflict"
            cur = self.leases.get(doc_id)
            if cur is not None and cur.holder != holder \
                    and cur.state != RELEASED \
                    and not cur.expired(now) and cur.epoch >= epoch:
                return False, "live_lease"
            if p != (epoch, holder):
                self.promised[doc_id] = (epoch, holder)
                if self.journal is not None:
                    self.journal.note_promise(doc_id, epoch, holder)
            self._note_epoch_locked(doc_id, epoch)
            return True, "promised"

    # ---- remote observations ---------------------------------------------

    def observe_remote(self, doc_id: str, holder: str, epoch: int,
                       state: str, ttl_s: float) -> None:
        """Fold a peer's lease claim (grant message or /replicate/docs
        piggyback). Higher epoch wins. Equal epoch + same holder
        refreshes the record (renewal propagation) — except our own
        lease, whose TTL only we manage (a peer's echo must never
        shorten it). Equal epoch + DIFFERING holders is the arbitration
        event documented in the module docstring: lexically smaller
        holder id wins, counted in `leases.tie_breaks`."""
        now = self.clock()
        with self.lock:
            cur = self.leases.get(doc_id)
            if cur is not None:
                if cur.epoch > epoch:
                    return
                if cur.epoch == epoch:
                    if cur.holder == holder:
                        if cur.holder == self.self_id:
                            return
                        cur.state = state
                        cur.expires_at = now + max(ttl_s, 0.0)
                        return
                    self._bump("tie_breaks")
                    self._event("lease_tie_break", doc_id, epoch,
                                incumbent=cur.holder, claimant=holder)
                    if cur.holder < holder:
                        return       # incumbent (smaller id) wins
                    # incoming smaller id wins: fall through, replace
            self.leases[doc_id] = Lease(
                doc_id, holder, epoch, state, now + max(ttl_s, 0.0),
                now=now)
            self._note_epoch_locked(doc_id, epoch)

    def accept_grant(self, doc_id: str, epoch: int,
                     ttl_s: float) -> bool:
        """Remote handoff step 1 (receiver): record the offered lease
        as GRANTED-not-active. Idempotent; refuses stale epochs (both
        vs the current lease and vs the fencing floor)."""
        now = self.clock()
        with self.lock:
            if epoch < self.max_epoch.get(doc_id, 0):
                return False
            cur = self.leases.get(doc_id)
            if cur is not None and cur.epoch >= epoch \
                    and not (cur.holder == self.self_id
                             and cur.epoch == epoch):
                return False
            self.leases[doc_id] = Lease(doc_id, self.self_id, epoch,
                                        GRANTED, now + max(ttl_s, 0.0),
                                        now=now)
            self._note_epoch_locked(doc_id, epoch)
            self._event("lease_granted", doc_id, epoch)
            return True

    def activate_grant(self, doc_id: str, epoch: int) -> bool:
        """Remote handoff final step (receiver): flip GRANTED→ACTIVE.
        Idempotent (duplicate activate messages are harmless). The
        quorum round for the new epoch runs BEFORE this (node-level),
        so activation here is purely local state."""
        now = self.clock()
        with self.lock:
            cur = self.leases.get(doc_id)
            if cur is None or cur.holder != self.self_id \
                    or cur.epoch != epoch:
                return False
            if cur.state == ACTIVE:
                return True
            if cur.state != GRANTED:
                return False
            cur.state = ACTIVE
            cur.expires_at = now + self.ttl_s
            self._note_epoch_locked(doc_id, epoch)
            self._log_activation_locked(doc_id, epoch)
            self._bump("acquires")
            self._event("lease_activated", doc_id, epoch)
            if self.journal is not None:
                self.journal.note_lease(doc_id, self.self_id, epoch,
                                        ACTIVE)
            return True

    # ---- handoff (sender side; steps driven by node.ReplicaNode) ---------

    def begin_handoff(self, doc_id: str) -> Optional[int]:
        """ACTIVE → GRANTING. Returns the epoch the NEW owner's lease
        will carry (max of ours and the fencing floor, plus one), or
        None if we don't hold the doc."""
        with self.lock:
            lease = self.leases.get(doc_id)
            if lease is None or lease.holder != self.self_id \
                    or lease.state != ACTIVE:
                return None
            lease.state = GRANTING
            new_epoch = max(lease.epoch,
                            self.max_epoch.get(doc_id, 0)) + 1
            self._event("handoff_granting", doc_id, new_epoch)
            return new_epoch

    def advance_handoff(self, doc_id: str, state: str) -> None:
        assert state in (DRAINING, TRANSFER)
        with self.lock:
            lease = self.leases[doc_id]
            lease.state = state
            self._event(f"handoff_{state}", doc_id, lease.epoch)

    def finish_handoff(self, doc_id: str, new_holder: str,
                       new_epoch: int) -> None:
        """Local release + record the new owner's active lease."""
        now = self.clock()
        with self.lock:
            self.leases[doc_id] = Lease(doc_id, new_holder, new_epoch,
                                        ACTIVE, now + self.ttl_s,
                                        now=now)
            self._note_epoch_locked(doc_id, new_epoch)
            self._bump("releases")
            self._event("lease_released", doc_id, new_epoch,
                        new_holder=new_holder)
            if self.journal is not None:
                self.journal.note_lease(doc_id, new_holder, new_epoch,
                                        ACTIVE)

    def abort_handoff(self, doc_id: str) -> None:
        """Roll a failed handoff back to ACTIVE (same epoch): the
        receiver's GRANTED lease is never activated and just expires."""
        with self.lock:
            lease = self.leases.get(doc_id)
            if lease is not None and lease.holder == self.self_id \
                    and lease.state in _HANDOFF_STATES:
                lease.state = ACTIVE
                lease.expires_at = self.clock() + self.ttl_s
                self._event("handoff_aborted", doc_id, lease.epoch)

    # ---- export ----------------------------------------------------------

    def as_json(self) -> dict:
        now = self.clock()
        with self.lock:
            return {d: lease.as_json(now)
                    for d, lease in sorted(self.leases.items())}
