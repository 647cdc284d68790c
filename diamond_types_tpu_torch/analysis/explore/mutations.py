"""Seeded protocol mutations: the checker's own test of power.

Each mutation re-introduces a specific protocol bug (patched onto the
real objects at world-build time) together with the scenario in which
the explorer must find it and the invariant(s) expected to fire.
`dt-explore --mutate` runs all of them and fails unless EVERY mutation
is detected with a minimized, replayable trace — an analyzer that
cannot catch known-bad variants proves nothing about the real tree.

Node-level patches are re-applied on simulated restart (the world
rebuilds nodes through the same hook), so a mutation cannot be
"cured" by crashing.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ...replicate.ownership import Lease


class Mutation:
    def __init__(self, name: str, scenario: str,
                 expect: Tuple[str, ...], description: str,
                 apply_node: Optional[Callable] = None,
                 apply_world: Optional[Callable] = None,
                 depth: int = 5) -> None:
        self.name = name
        self.scenario = scenario
        self.expect = expect            # acceptable firing invariants
        self.description = description
        self.apply_node = apply_node    # fn(ReplicaNode) -> None
        self.apply_world = apply_world  # fn(SimWorld) -> None
        self.depth = depth              # search depth that suffices


def _observe_remote_variant(mgr, own_guard: bool,
                            smaller_wins: bool) -> Callable:
    """Re-implementation of LeaseManager.observe_remote with the two
    guards the mutations remove made explicit. With both flags True
    this is behavior-identical to the real method."""

    def observe_remote(doc_id: str, holder: str, epoch: int,
                       state: str, ttl_s: float) -> None:
        now = mgr.clock()
        with mgr.lock:
            cur = mgr.leases.get(doc_id)
            if cur is not None:
                if cur.epoch > epoch:
                    return
                if cur.epoch == epoch:
                    if cur.holder == holder:
                        if own_guard and cur.holder == mgr.self_id:
                            return
                        cur.state = state
                        cur.expires_at = now + max(ttl_s, 0.0)
                        return
                    mgr._bump("tie_breaks")
                    mgr._event("lease_tie_break", doc_id, epoch,
                               incumbent=cur.holder, claimant=holder)
                    keep = (cur.holder < holder) if smaller_wins \
                        else (cur.holder > holder)
                    if keep:
                        return
            mgr.leases[doc_id] = Lease(
                doc_id, holder, epoch, state, now + max(ttl_s, 0.0),
                now=now)
            mgr._note_epoch_locked(doc_id, epoch)

    return observe_remote


def _mut_floor_drop(node) -> None:
    # promises/observations no longer raise the fencing floor
    node.leases._note_epoch_locked = lambda doc_id, epoch: None


def _mut_promise_skip(world) -> None:
    # voter promises are granted in memory but never persisted: a
    # crashed voter forgets and can re-promise a taken epoch
    for j in world.journals.values():
        j.note_promise = lambda doc_id, epoch, holder: None


def _mut_own_echo(node) -> None:
    node.leases.observe_remote = _observe_remote_variant(
        node.leases, own_guard=False, smaller_wins=True)


def _mut_tiebreak_invert(node) -> None:
    node.leases.observe_remote = _observe_remote_variant(
        node.leases, own_guard=True, smaller_wins=False)


def _mut_group_drain_skip(node) -> None:
    # the member-side demotion fence evicts the admission queue
    # WITHOUT the drain barrier: acked member writes die at demote
    node._group_demote_drains = False


def _mut_promote_unratified(node) -> None:
    # promotion commits without a majority round and without raising
    # the leader's own fencing floor — one coherent bug ("the group
    # grant is self-issued"): the leader's re-keyed lease epoch is not
    # covered by its floor, so nothing fences the superseded epoch
    real = node.promote_writer_group

    def promote(doc_id, members):
        rq = node._run_quorum
        note = node.leases._note_epoch_locked
        node._run_quorum = lambda d, e, t: True
        node.leases._note_epoch_locked = lambda d, e: None
        try:
            return real(doc_id, members)
        finally:
            node._run_quorum = rq
            node.leases._note_epoch_locked = note

    node.promote_writer_group = promote


def _mut_drain_skip(world) -> None:
    # the handoff's drain barrier no-ops: the final transfer patch is
    # cut while acked writes still sit in the admission queue, and the
    # source's post-migration eviction then drops them on the floor.
    # Applied to the STORES (which survive simulated crash/restart),
    # so a restart cannot cure it.
    for store in world.stores.values():
        store.scheduler.drain = lambda: None


MUTATIONS: Dict[str, Mutation] = {m.name: m for m in (
    Mutation(
        "floor-drop", scenario="renewal",
        expect=("floor-coverage",),
        description="_note_epoch_locked no-ops: promising or observing "
                    "an epoch no longer raises the fencing floor, so "
                    "stale holders are never fenced off",
        apply_node=_mut_floor_drop, depth=2),
    Mutation(
        "promise-persist-skip", scenario="crash-recovery",
        expect=("promise-exclusivity", "single-active"),
        description="journal.note_promise no-ops: a voter's promise "
                    "table does not survive a crash, so a recovered "
                    "voter can promise one epoch to two holders — two "
                    "majorities for one (doc, epoch)",
        apply_world=_mut_promise_skip, depth=5),
    Mutation(
        "own-echo-ttl", scenario="renewal",
        expect=("own-lease-stability",),
        description="observe_remote loses the own-lease guard: a "
                    "peer's stale echo of our lease overwrites the "
                    "locally-renewed TTL, shortening our own ACTIVE "
                    "lease",
        apply_node=_mut_own_echo, depth=6),
    Mutation(
        "tie-break-invert", scenario="tiebreak",
        expect=("tie-break-direction",),
        description="equal-epoch arbitration keeps the lexically "
                    "LARGER holder: hosts that see the two claims in "
                    "different orders resolve to different winners",
        apply_node=_mut_tiebreak_invert, depth=3),
    Mutation(
        "drain-skip", scenario="migration",
        expect=("no-acked-loss",),
        description="the migration handoff skips the drain barrier: "
                    "the transfer patch misses still-queued acked "
                    "writes and the source's post-migration eviction "
                    "loses them — an acknowledged op vanishes from "
                    "the converged state",
        apply_world=_mut_drain_skip, depth=2),
    Mutation(
        "demote-without-drain", scenario="writer-group",
        expect=("no-acked-loss",),
        description="the member-side demotion fence skips its drain "
                    "barrier: a fenced member evicts its admission "
                    "queue with acked group writes still in it — an "
                    "acknowledged member write vanishes from the "
                    "converged state",
        apply_node=_mut_group_drain_skip, depth=3),
    Mutation(
        "promote-floor-drop", scenario="writer-group",
        expect=("floor-coverage", "single-active"),
        description="promotion commits without quorum ratification or "
                    "the leader's floor raise: the re-keyed lease "
                    "epoch is uncovered by the fencing floor, so the "
                    "superseded single-writer epoch is never fenced "
                    "off",
        apply_node=_mut_promote_unratified, depth=2),
)}
