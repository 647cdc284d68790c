"""Invariants checked after every scheduler action.

Two kinds:

  * STATE invariants read the current world directly
    (floor-coverage, the per-scan half of single-active);
  * HISTORY invariants are phrased over auxiliary variables the
    checker accumulates across actions — promise grants, activation
    sets, floor watermarks. The history lives in the CHECKER, not in
    any node, so it survives simulated crashes; that is what makes
    "a recovered voter must not re-promise a taken epoch" checkable
    at all (the node's own table is exactly what the crash lost).

Deliberately NOT an invariant: "at most one host passes the merge
admit gate per doc" *across epochs*. An expired-lease holder renews
locally after a partition heals, and CRDT merges commute, so stale
merges reconcile — the protocol's actual safety claims are the
per-(doc, epoch) ones below plus convergence. See CHECKING.md.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ...replicate.ownership import (ACTIVE, DRAINING, GRANTED,
                                    GRANTING, TRANSFER)
from .world import SimWorld

_HELD = (ACTIVE, GRANTING, DRAINING, TRANSFER, GRANTED)

ALL_INVARIANTS = (
    "single-active",        # per (doc, epoch): at most one self-ACTIVE
    "promise-exclusivity",  # a voter promises (doc, epoch) to one holder
    "floor-monotonic",      # fencing floor never regresses (incl. restart)
    "floor-coverage",       # floor >= every promised / self-held epoch
    "own-lease-stability",  # peer echo never shortens our ACTIVE lease
    "tie-break-direction",  # equal-epoch arbitration keeps the smaller id
    "convergence",          # byte-identical state after quiesce (leaves)
    "no-acked-loss",        # every acked (queued) op survives to quiesce
    "group-epoch-exclusivity",  # no writer-group registration below
                                # its own host's fencing floor
)


class Violation(Exception):
    def __init__(self, invariant: str, message: str) -> None:
        self.invariant = invariant
        self.message = message
        super().__init__(f"{invariant}: {message}")


class InvariantChecker:
    def __init__(self, world: SimWorld,
                 names: Tuple[str, ...]) -> None:
        self.world = world
        self.names = tuple(names)
        # ghost state (survives node crashes by construction)
        self.active_holders: Dict[Tuple[str, int], set] = {}
        self.promise_hist: Dict[Tuple[str, str, int], str] = {}
        self.floor_hist: Dict[Tuple[str, str], int] = {}
        self.event_idx = 0
        self.pre: Dict[Tuple[str, str], Tuple[int, float]] = {}

    # ---- per-action protocol ----
    def snapshot_pre(self) -> None:
        """Capture every self-held ACTIVE lease before the action, for
        the own-lease-stability delta check."""
        pre = {}
        w = self.world
        for n in w.alive():
            mgr = w.nodes[n].leases
            with mgr.lock:
                for doc, l in mgr.leases.items():
                    if l.holder == n and l.state == ACTIVE:
                        pre[(n, doc)] = (l.epoch, l.expires_at)
        self.pre = pre

    def check_after(self, action_op: str) -> Optional[Violation]:
        """Fold the post-action world into the histories and evaluate
        every enabled invariant. Histories are ALWAYS folded (even for
        disabled invariants) so fingerprints and later checks see a
        consistent ledger. Returns the first violation found."""
        w = self.world
        failures: List[Violation] = []
        for n in w.alive():
            mgr = w.nodes[n].leases
            with mgr.lock:
                leases = {d: (l.holder, l.epoch, l.state, l.expires_at)
                          for d, l in mgr.leases.items()}
                promised = dict(mgr.promised)
                floors = dict(mgr.max_epoch)
                activations = [(e["doc"], e["epoch"])
                               for e in mgr.activation_log]
            for doc, ep in activations:
                self.active_holders.setdefault((doc, ep), set()).add(n)
            for d, (h, ep, st, _x) in leases.items():
                if h == n and st == ACTIVE:
                    self.active_holders.setdefault((d, ep),
                                                   set()).add(n)
            for d, (ep, h) in promised.items():
                key = (n, d, ep)
                prev = self.promise_hist.get(key)
                if prev is None:
                    self.promise_hist[key] = h
                elif prev != h and "promise-exclusivity" in self.names:
                    failures.append(Violation(
                        "promise-exclusivity",
                        f"voter {n} promised (doc {d}, epoch {ep}) to "
                        f"both {prev} and {h}"))
            for d in set(floors) | set(promised) | set(leases):
                f = floors.get(d, 0)
                key2 = (n, d)
                prev_f = self.floor_hist.get(key2, 0)
                if f < prev_f and "floor-monotonic" in self.names:
                    failures.append(Violation(
                        "floor-monotonic",
                        f"node {n} doc {d} fencing floor regressed "
                        f"{prev_f} -> {f}"))
                self.floor_hist[key2] = max(prev_f, f)
                if "floor-coverage" in self.names:
                    p = promised.get(d)
                    if p is not None and f < p[0]:
                        failures.append(Violation(
                            "floor-coverage",
                            f"node {n} doc {d} floor {f} below its own "
                            f"promise for epoch {p[0]} — the fencing "
                            f"token was not raised"))
                    ld = leases.get(d)
                    if ld is not None and ld[0] == n \
                            and ld[2] in _HELD and f < ld[1]:
                        failures.append(Violation(
                            "floor-coverage",
                            f"node {n} doc {d} floor {f} below held "
                            f"lease epoch {ld[1]}"))
            if "group-epoch-exclusivity" in self.names:
                groups = getattr(w.nodes[n], "writergroups", None)
                if groups is not None:
                    for d, g in groups.entries():
                        f = floors.get(d, 0)
                        if g.epoch < f:
                            failures.append(Violation(
                                "group-epoch-exclusivity",
                                f"node {n} doc {d} holds a writer-"
                                f"group registration at epoch "
                                f"{g.epoch} below its own fencing "
                                f"floor {f} — a member of the "
                                f"superseded group could still admit "
                                f"writes"))
        if "single-active" in self.names:
            for (d, ep), holders in self.active_holders.items():
                if len(holders) > 1:
                    failures.append(Violation(
                        "single-active",
                        f"doc {d} epoch {ep} was ACTIVE on "
                        f"{sorted(holders)} — two majorities for one "
                        f"epoch"))
        if "own-lease-stability" in self.names \
                and action_op in ("ae", "dup"):
            for (n, d), (ep, exp) in self.pre.items():
                if n in w.crashed:
                    continue
                l = w.nodes[n].leases.get(d)
                if l is not None and l.holder == n and l.epoch == ep \
                        and l.state == ACTIVE \
                        and l.expires_at < exp - 1e-9:
                    failures.append(Violation(
                        "own-lease-stability",
                        f"node {n} doc {d} epoch {ep}: own ACTIVE "
                        f"lease shortened by a peer echo "
                        f"({exp:.3f} -> {l.expires_at:.3f})"))
        new_events = w.events[self.event_idx:]
        self.event_idx = len(w.events)
        if "tie-break-direction" in self.names:
            for ev in new_events:
                if ev.get("kind") != "lease_tie_break":
                    continue
                n = ev["node"]
                if n in w.crashed:
                    continue
                want = min(ev["incumbent"], ev["claimant"])
                l = w.nodes[n].leases.get(ev["doc"])
                if l is not None and l.epoch == ev["epoch"] \
                        and l.holder != want:
                    failures.append(Violation(
                        "tie-break-direction",
                        f"node {n} doc {ev['doc']} epoch "
                        f"{ev['epoch']}: arbitration kept {l.holder}, "
                        f"deterministic rule requires {want}"))
        return failures[0] if failures else None

    # ---- leaf-only quiescence check (mutates the world) ----
    def check_convergence(self, max_rounds: int = 6) \
            -> Optional[Violation]:
        """Heal every link, restart every crashed node, flush every
        surviving admission queue, run bounded anti-entropy to
        fixpoint: all replicas must reach byte-identical text and
        identical frontiers, and every op still on the acked ledger
        must appear in the converged state (no-acked-loss — queued
        work a completed migration evicted without draining is exactly
        what this catches). Run only at leaf states — it consumes the
        world."""
        if "convergence" not in self.names \
                and "no-acked-loss" not in self.names:
            return None
        w = self.world
        for pair in list(w.cut_links):
            a, b = tuple(pair)
            w.heal(a, b)
        for n in list(w.crashed):
            w.restart(n)
        # surviving queues eventually flush; only ops DROPPED earlier
        # (not merely still queued) can violate no-acked-loss
        for n in w.node_ids:
            w.stores[n].scheduler.drain()
        docs = set()
        for n in w.node_ids:
            docs |= set(w.stores[n].docs)
        if not docs:
            return None
        for _ in range(max_rounds):
            if self._frontiers_equal(docs):
                break
            for n in w.node_ids:
                w.nodes[n].antientropy.run_round()
        if "convergence" in self.names:
            if not self._frontiers_equal(docs):
                return Violation(
                    "convergence",
                    f"frontiers still differ after {max_rounds} "
                    f"quiesce rounds")
            for d in sorted(docs):
                texts = {n: w.text_of(n, d) for n in w.node_ids}
                if len(set(texts.values())) > 1:
                    return Violation(
                        "convergence",
                        f"doc {d} texts diverge after quiesce: "
                        f"{ {n: t[:24] for n, t in texts.items()} }")
        if "no-acked-loss" in self.names:
            for d, chars in sorted(w.acked.items()):
                for n in w.node_ids:
                    text = w.text_of(n, d)
                    missing = [c for c in chars if c not in text]
                    if missing:
                        return Violation(
                            "no-acked-loss",
                            f"doc {d}: acked ops {missing} absent "
                            f"from {n}'s converged text {text[:24]!r}")
        return None

    def _frontiers_equal(self, docs) -> bool:
        w = self.world
        for d in docs:
            frontiers = {self._canon(w.frontier_of(n, d))
                         for n in w.node_ids}
            if len(frontiers) > 1:
                return False
        return True

    @staticmethod
    def _canon(frontier) -> str:
        if isinstance(frontier, (list, tuple)):
            return json.dumps(sorted(
                (json.dumps(x, sort_keys=True, default=str)
                 for x in frontier)))
        return json.dumps(frontier, sort_keys=True, default=str)
