"""Per-node catch-up evidence for the follower-read staleness contract.

A follower may serve ``GET /doc/{id}`` locally only when it can bound
the response's staleness. The bound comes from two kinds of timestamped
evidence, both piggybacked on traffic the mesh already sends:

  * **Advertisement**: the owner's frontier as of time ``t`` (carried on
    ping gossip and on anti-entropy ``/replicate/docs`` rounds). If the
    local oplog DOMINATES that frontier — every advertised ``(agent,
    seq)`` head is locally known — then the local checkout is at least
    as new as the owner was at ``t``, so its staleness is at most
    ``now - t``.
  * **Reconcile**: a completed anti-entropy round with the owner that
    started at ``t`` proves the local oplog holds everything the owner
    had at ``t`` (the summary handshake pulls any remainder), giving the
    same ``now - t`` bound without a frontier comparison.

``staleness()`` returns the tightest bound across all usable evidence,
``None`` when there is none — an unbounded read, which the contract
treats as a miss (proxy to the owner). Owners answer 0 directly in
:class:`~diamond_types_tpu.read.path.ReadPath` and never consult this
index.

Timestamps are conservative lower bounds on "when the owner was in this
state": anti-entropy stamps *before* issuing the request; ping-gossip
folds stamp at fold time, accepting sub-RTT slop (the contract's useful
bounds are hundreds of milliseconds and up).
"""

import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis import make_lock

RemoteFrontier = Sequence[Sequence]          # [[agent, seq], ...]


def frontier_known(ol, frontier: RemoteFrontier) -> bool:
    """True iff the local oplog contains every ``(agent, seq)`` head of
    a remote frontier — i.e. the local state dominates it. Caller holds
    the store's oplog guard."""
    aa = ol.cg.agent_assignment
    for head in frontier:
        agent_name, seq = head[0], int(head[1])
        agent = aa.try_get_agent(agent_name)
        if agent is None:
            return False
        if aa.try_agent_version_to_lv(agent, seq) is None:
            return False
    return True


class _DocEvidence:
    __slots__ = ("adverts", "reconciled")

    def __init__(self):
        # peer_id -> (remote_frontier, as_of). Kept per-peer so a stale
        # lease holder's late advert can't clobber the real owner's.
        self.adverts: Dict[str, Tuple[List[List], float]] = {}
        # peer_id -> monotonic floor of completed-reconcile round starts.
        self.reconciled: Dict[str, float] = {}


class FollowerIndex:
    """Tracks, per doc, the owner's advertised frontier and our proven
    catch-up times. Fed by ping gossip and the anti-entropy loop; read
    by :class:`~diamond_types_tpu.read.path.ReadPath` on every follower
    read."""

    def __init__(self, metrics=None):
        self._read_lock = make_lock("read.follower", "io")
        self._docs: Dict[str, _DocEvidence] = {}
        self.metrics = metrics
        # obs.journey.OpJourney hook (wired by ReplicaNode when the
        # server carries an obs bundle): a peer's advert is the final
        # edit-to-visibility stage — a follower read can be served
        self.journey = None

    # ---- evidence feed ---------------------------------------------------

    def note_advert(self, doc_id: str, peer_id: str,
                    frontier: RemoteFrontier,
                    as_of: Optional[float] = None) -> None:
        """Record ``peer_id``'s frontier for ``doc_id`` as of ``as_of``
        (monotonic; defaults to now). Only adverts from the doc's
        current owner count toward staleness — callers record
        everything and ``staleness()`` filters."""
        t = time.monotonic() if as_of is None else as_of
        fr = [[h[0], int(h[1])] for h in frontier]
        with self._read_lock:
            ev = self._docs.setdefault(doc_id, _DocEvidence())
            prev = ev.adverts.get(peer_id)
            if prev is None or prev[1] <= t:
                ev.adverts[peer_id] = (fr, t)
        if self.metrics is not None:
            self.metrics.bump("adverts")
        j = self.journey
        if j is not None:
            # journey closes here: the advert proves the peer reached a
            # frontier at `t` — guarded inside the tracker so it only
            # lands after `applied_at_peer` from the same peer
            j.stamp_doc(doc_id, "advert_usable", peer=peer_id, t=t)

    def note_reconciled(self, doc_id: str, peer_id: str,
                        as_of: Optional[float] = None) -> None:
        """Record a COMPLETED anti-entropy reconcile with ``peer_id``
        whose round started at ``as_of``."""
        t = time.monotonic() if as_of is None else as_of
        with self._read_lock:
            ev = self._docs.setdefault(doc_id, _DocEvidence())
            ev.reconciled[peer_id] = max(ev.reconciled.get(peer_id, 0.0), t)
        if self.metrics is not None:
            self.metrics.bump("reconciles")

    def forget(self, doc_id: str) -> None:
        with self._read_lock:
            self._docs.pop(doc_id, None)

    # ---- queries ---------------------------------------------------------

    def advert_of(self, doc_id: str,
                  owner_id: str) -> Optional[Tuple[List[List], float]]:
        """The owner's latest advertised ``(frontier, as_of)``, if any."""
        with self._read_lock:
            ev = self._docs.get(doc_id)
            if ev is None:
                return None
            return ev.adverts.get(owner_id)

    def staleness(self, doc_id: str, owner_id: str, dominates,
                  now: Optional[float] = None) -> Optional[float]:
        """Tightest provable staleness bound (seconds) for a local read
        of ``doc_id`` whose owner is ``owner_id``, or ``None`` when no
        evidence applies. ``dominates(frontier)`` answers whether the
        local oplog contains the given remote frontier (the caller
        evaluates it under the store's oplog guard)."""
        t = time.monotonic() if now is None else now
        with self._read_lock:
            ev = self._docs.get(doc_id)
            if ev is None:
                return None
            advert = ev.adverts.get(owner_id)
            reconciled = ev.reconciled.get(owner_id)
        best: Optional[float] = reconciled
        if advert is not None:
            fr, as_of = advert
            if (best is None or as_of > best) and dominates(fr):
                best = as_of
        if best is None:
            return None
        return max(0.0, t - best)

    def lag(self, doc_id: str, owner_id: str, dominates) -> Optional[int]:
        """Number of owner-advertised frontier heads the local oplog is
        missing (0 = fully caught up to the last advert). ``None`` when
        the owner has never advertised. ``dominates`` is evaluated per
        single-head frontier, under the caller's oplog guard."""
        advert = self.advert_of(doc_id, owner_id)
        if advert is None:
            return None
        fr, _ = advert
        return sum(0 if dominates([h]) else 1 for h in fr)

    def snapshot(self) -> dict:
        """Debug view: per-doc advert/reconcile peer counts."""
        with self._read_lock:
            return {
                "docs": len(self._docs),
                "adverts": sum(len(e.adverts) for e in self._docs.values()),
                "reconciled": sum(len(e.reconciled)
                                  for e in self._docs.values()),
            }
