"""Quorum-backed lease acquisition + durable replica state.

PR 2's takeover was TTL-delayed: a host that believed the owner's lease
expired simply self-granted the next epoch. Under an asymmetric
partition two hosts can believe that simultaneously — the exact
split-brain the ROADMAP marked open. This module closes it with a
single-round promise protocol (the prepare half of Paxos, which is all
a lease needs):

  * Before a lease (grant, takeover, or handoff activation) becomes
    ACTIVE at epoch E, the would-be holder must collect promises for
    (doc, E) from a MAJORITY of the membership voter set
    (membership.MembershipView.voters — LEFT excluded, DEAD still
    counted so a minority partition can never vote the other side out).
  * A voter promises (doc, E) to AT MOST ONE holder — ever. A second
    proposer at the same epoch is denied (counted as a
    `promise_conflict`); retries by the SAME holder are idempotent
    acks. Any two majorities intersect, so at most one holder can
    collect a quorum for (doc, E): **at most one ACTIVE lease per
    (doc, epoch)**, under any combination of partitions, crashes and
    membership churn.
  * Promising (or observing) epoch E raises the voter's per-doc
    fencing floor `max_epoch[doc]`. A holder whose ACTIVE lease sits
    below the floor has been superseded: its scheduler admits are
    revoked and its proxied writes are rejected (HTTP 409), not merged.

The promise table and fencing floors live in ownership.LeaseManager
(one lock for all per-doc lease state); this module provides the
coordinator that runs the network round, and the journal that makes the
floors survive a crash.

`ReplicaJournal` reuses the storage/ primitives (the checksummed `Wal`
+ double-blit-header `PageStore`): JSON records appended to
`{data_dir}/_replica.state.wal`, periodically compacted into
`{data_dir}/_replica.state`. Restored state: per-doc max epoch (the
safety payload — a restarted node must never re-issue a stale epoch),
the held-lease table (as expired hints), and the membership
incarnation (bumped on every restart so post-crash refutations are
fresh). A node that restores prior state boots into a fenced
"rejoining" mode: `ReplicaNode.owns` denies every merge until the node
has confirmed a quorum of voters reachable (see node.maintain).
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
from typing import Dict, Optional

from ..storage.store import PageStore, StorageError, Wal

# journal WAL records folded into one snapshot at compaction
_COMPACT_EVERY = 256


class ReplicaJournal:
    """Durable replica coordination state at `{prefix}.state[.wal]`.

    Record shapes (JSON, one per WAL frame):
      {"t": "incarnation", "n": int}
      {"t": "epoch", "doc": str, "n": int}          # per-doc max epoch
      {"t": "promise", "doc": str, "epoch": int, "holder": str}
      {"t": "lease", "doc": str, "holder": str, "epoch": int,
       "state": str}                                 # held-lease hint
      {"t": "drop_lease", "doc": str}
      {"t": "override", "doc": str, "target": str | null, "ver": int}
                                    # placement override (null = tombstone)
      {"t": "group", "doc": str, "epoch": int, "members": [str],
       "leader": str}               # writer-group registration
      {"t": "drop_group", "doc": str}

    Promises are persisted because they are the safety core: a voter
    that promised (doc, E) to A, crashed, and forgot could promise
    (doc, E) to B — and sit in the intersection of both majorities,
    breaking at-most-one-ACTIVE-per-(doc, epoch).

    Appends flush to the OS (process-crash durable) and fsync only when
    `sync=True` (incarnation bumps, compaction) — the soak kills
    processes, not power.
    """

    def __init__(self, prefix: str) -> None:
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        self.prefix = prefix
        # journal writes nest under the lease lock and take nothing
        # further — a leaf in the canonical order
        from ..analysis.witness import make_lock
        self._lock = make_lock("repl.journal", "leaf")
        self.state: dict = {"incarnation": 0, "max_epoch": {},
                            "leases": {}, "promises": {}}
        try:
            self._store: Optional[PageStore] = PageStore(
                prefix + ".state")
            self._wal: Optional[Wal] = Wal(prefix + ".state.wal")
        except StorageError:
            # corrupt beyond the double-header's protection: start
            # fresh rather than refuse to boot (the lease table is
            # reconstructible from the mesh; losing max_epoch degrades
            # to PR 2's behavior for this node only)
            for suffix in (".state", ".state.wal"):
                try:
                    os.remove(prefix + suffix)
                except OSError:
                    pass
            self._store = PageStore(prefix + ".state")
            self._wal = Wal(prefix + ".state.wal")
        base = self._store.read()
        if base:
            try:
                self.state = json.loads(base)
            except ValueError:
                pass
        self._pending = 0
        for rec in self._wal.records():
            try:
                self._apply(json.loads(rec))
                self._pending += 1
            except ValueError:
                continue

    # ---- state fold ------------------------------------------------------

    def _apply(self, rec: dict) -> None:
        t = rec.get("t")
        if t == "incarnation":
            self.state["incarnation"] = max(
                int(rec["n"]), int(self.state.get("incarnation", 0)))
        elif t == "epoch":
            me = self.state.setdefault("max_epoch", {})
            doc = rec["doc"]
            me[doc] = max(int(rec["n"]), int(me.get(doc, 0)))
        elif t == "promise":
            self.state.setdefault("promises", {})[rec["doc"]] = {
                "epoch": int(rec["epoch"]), "holder": rec["holder"]}
        elif t == "lease":
            self.state.setdefault("leases", {})[rec["doc"]] = {
                "holder": rec["holder"], "epoch": int(rec["epoch"]),
                "state": rec.get("state", "active")}
        elif t == "drop_lease":
            self.state.setdefault("leases", {}).pop(rec["doc"], None)
        elif t == "group":
            self.state.setdefault("groups", {})[rec["doc"]] = {
                "epoch": int(rec["epoch"]),
                "members": list(rec.get("members", [])),
                "leader": rec.get("leader", "")}
        elif t == "drop_group":
            self.state.setdefault("groups", {}).pop(rec["doc"], None)
        elif t == "override":
            # last-writer-wins by version, matching
            # rebalance.PlacementOverrides.merge (tombstones kept — a
            # restored table must remember retractions too)
            ov = self.state.setdefault("overrides", {})
            cur = ov.get(rec["doc"])
            if cur is None or int(rec["ver"]) >= int(cur.get("ver", 0)):
                ov[rec["doc"]] = {"target": rec.get("target"),
                                  "ver": int(rec["ver"])}

    def record(self, rec: dict, sync: bool = False) -> None:
        with self._lock:
            if self._wal is None:
                return
            self._wal.append(json.dumps(rec).encode("utf8"), sync=sync)
            self._apply(rec)
            self._pending += 1
            if self._pending >= _COMPACT_EVERY:
                self._compact_locked()

    def _compact_locked(self) -> None:
        self._store.write(json.dumps(self.state).encode("utf8"))
        self._wal.reset()
        self._pending = 0

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    # ---- typed appends ---------------------------------------------------

    def note_incarnation(self, n: int) -> None:
        self.record({"t": "incarnation", "n": int(n)}, sync=True)

    def note_epoch(self, doc: str, epoch: int) -> None:
        # dedup: only a raise of the floor is worth a frame
        with self._lock:
            if int(self.state.get("max_epoch", {}).get(doc, 0)) \
                    >= int(epoch):
                return
        self.record({"t": "epoch", "doc": doc, "n": int(epoch)})

    def note_promise(self, doc: str, epoch: int, holder: str) -> None:
        self.record({"t": "promise", "doc": doc, "epoch": int(epoch),
                     "holder": holder})

    def note_lease(self, doc: str, holder: str, epoch: int,
                   state: str) -> None:
        self.record({"t": "lease", "doc": doc, "holder": holder,
                     "epoch": int(epoch), "state": state})

    def drop_lease(self, doc: str) -> None:
        self.record({"t": "drop_lease", "doc": doc})

    def note_override(self, doc: str, target, ver: int) -> None:
        self.record({"t": "override", "doc": doc, "target": target,
                     "ver": int(ver)})

    def note_group(self, doc: str, epoch: int, members, leader: str) -> None:
        self.record({"t": "group", "doc": doc, "epoch": int(epoch),
                     "members": list(members), "leader": leader})

    def drop_group(self, doc: str) -> None:
        self.record({"t": "drop_group", "doc": doc})

    # ---- restored views --------------------------------------------------

    def restored_incarnation(self) -> int:
        return int(self.state.get("incarnation", 0))

    def restored_max_epochs(self) -> Dict[str, int]:
        return {d: int(n)
                for d, n in self.state.get("max_epoch", {}).items()}

    def restored_promises(self) -> Dict[str, dict]:
        return dict(self.state.get("promises", {}))

    def restored_leases(self) -> Dict[str, dict]:
        return dict(self.state.get("leases", {}))

    def restored_overrides(self) -> Dict[str, dict]:
        return dict(self.state.get("overrides", {}))

    def restored_groups(self) -> Dict[str, dict]:
        return dict(self.state.get("groups", {}))

    def has_prior_state(self) -> bool:
        return bool(self.state.get("incarnation", 0)
                    or self.state.get("max_epoch")
                    or self.state.get("leases")
                    or self.state.get("promises")
                    or self.state.get("overrides")
                    or self.state.get("groups"))

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._compact_locked()
                self._wal.close()
                self._store.close()
                self._wal = None
                self._store = None


class QuorumCoordinator:
    """Runs the proposer side of the promise round for one node.

    Stateless between rounds — the durable per-doc state (promises,
    fencing floors) lives in the LeaseManager on each voter; this class
    only fans the proposal out and counts acks. One instance per
    ReplicaNode, called with no locks held (the round does network I/O).
    """

    def __init__(self, node) -> None:
        self.node = node            # ReplicaNode (duck-typed)

    def acquire(self, doc_id: str, epoch: int,
                takeover: bool = False) -> bool:
        """Collect promises for (doc_id, epoch) from a majority of the
        voter set. Our own promise is taken first (and is binding: if
        we cannot promise to ourselves, someone beat us to the epoch).
        Best-effort short-circuit once the majority is reached."""
        from ..obs.trace import NOOP_SPAN, TRACE_HEADER
        node = self.node
        metrics = node.metrics
        obs = getattr(node, "obs", None)
        t0 = time.monotonic()
        span = NOOP_SPAN
        if obs is not None:
            span = obs.tracer.start(
                "repl.quorum", attrs={"doc": doc_id, "epoch": epoch,
                                      "takeover": bool(takeover)})
        hdrs = {TRACE_HEADER: span.header()} if span.sampled else None
        voters = node.membership.voters()
        need = len(voters) // 2 + 1
        metrics.bump("quorum", "proposals")
        ok, _reason = node.leases.promise(doc_id, epoch, node.self_id)
        if not ok:
            metrics.bump("quorum", "rounds_lost")
            metrics.observe_latency("quorum_round",
                                    time.monotonic() - t0)
            span.end(won=False, reason="self_promise_refused")
            return False
        acks = 1
        for v in voters:
            if v == node.self_id:
                continue
            if acks >= need:
                break
            try:
                resp = node.table.call_json(
                    v, "/replicate/lease",
                    {"action": "propose", "doc": doc_id,
                     "epoch": epoch, "holder": node.self_id,
                     "takeover": bool(takeover)},
                    headers=hdrs)
            except (OSError, KeyError, ValueError,
                    urllib.error.HTTPError):
                continue            # unreachable voter = no ack
            if resp.get("ok"):
                acks += 1
                metrics.bump("quorum", "acks")
            else:
                metrics.bump("quorum", "denials")
        won = acks >= need
        metrics.bump("quorum", "rounds_won" if won else "rounds_lost")
        metrics.observe_latency("quorum_round", time.monotonic() - t0)
        span.end(won=won, acks=acks, need=need)
        return won
