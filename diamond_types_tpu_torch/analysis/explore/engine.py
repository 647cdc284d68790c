"""Replay-based exhaustive exploration with sleep-set reduction.

The protocol objects hold locks and thread primitives, so worlds are
not snapshot/restore-able. Instead each DFS edge rebuilds a FRESH
world and deterministically replays the choice prefix — O(depth) work
per visited transition, bought back by:

  * fingerprint dedup — a canonical hash of all protocol-visible
    state (leases, floors, promises, membership, frontiers, journals,
    link/crash/clock state, action budgets). Revisiting a fingerprint
    skips the subtree, with the standard sleep-set soundness rule: a
    cached state only covers a new visit when it was explored with a
    sleep set that is a SUBSET of the current one;
  * sleep sets — after exploring sibling `a`, later siblings need not
    re-explore orders that merely commute with `a`; the child of `b`
    inherits {x in sleep : independent(b, x)}.

On violation, the witness trace is minimized by greedy
choice-deletion to fixpoint and re-validated by replay from a fresh
world — the emitted trace is replayable verbatim (`replay_trace`),
which is how pytest pins it.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Dict, List, Optional, Tuple

from .invariants import ALL_INVARIANTS, InvariantChecker, Violation
from .model import SCENARIOS, Action, Scenario, independent
from .world import SimWorld


class _Budget(Exception):
    """Raised to unwind the DFS when max_states is hit."""


def _fingerprint(world: SimWorld, counts: Dict[str, int]) -> str:
    """Canonical hash of everything that can influence future
    transitions. Floats rounded so equal virtual-time states compare
    equal."""
    doc: dict = {"now": round(world.now, 3),
                 "crashed": sorted(world.crashed),
                 "cut": sorted(sorted(p) for p in world.cut_links),
                 "counts": dict(sorted(counts.items())),
                 "edit_seq": world.edit_seq,
                 "acked": {d: list(v)
                           for d, v in sorted(world.acked.items())},
                 "last_msg": {k: v for k, v in
                              sorted(world.last_lease_msg.items())},
                 "nodes": {}}
    for n in world.node_ids:
        journal = world.journals[n].fingerprint()
        pending = {d: list(v) for d, v in
                   sorted(world.stores[n].pending.items())}
        if n in world.crashed:
            doc["nodes"][n] = {"crashed": True, "journal": journal,
                               "pending": pending}
            continue
        node = world.nodes[n]
        mgr = node.leases
        with mgr.lock:
            leases = {d: [l.holder, l.epoch, l.state,
                          round(l.expires_at, 3)]
                      for d, l in sorted(mgr.leases.items())}
            promised = {d: list(p)
                        for d, p in sorted(mgr.promised.items())}
            floors = dict(sorted(mgr.max_epoch.items()))
        frontiers = {d: world.frontier_of(n, d)
                     for d in world.stores[n].doc_ids()}
        doc["nodes"][n] = {
            "leases": leases, "promised": promised, "floors": floors,
            "rejoining": node.rejoining,
            "incarnation": node.membership.self_incarnation,
            "members": node.membership.gossip_payload(),
            "merged": sorted(node.merged_docs),
            "frontiers": frontiers,
            "journal": journal,
            "pending": pending,
            "overrides": node.overrides.as_json(),
            "groups": node.writergroups.fingerprint(),
        }
    blob = json.dumps(doc, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf8")).hexdigest()


def _run_trace(scenario: Scenario, actions: List[Action],
               invariants: Tuple[str, ...], mutation=None,
               converge: bool = False):
    """Fresh world + deterministic replay. Returns
    (world, checker, violation | None, step_index)."""
    world = scenario.build(mutation)
    checker = InvariantChecker(world, invariants)
    checker.check_after("init")
    for i, a in enumerate(actions):
        if not a.enabled(world):
            # can happen only for hand-edited or shrunk candidate
            # traces (e.g. restart with its crash deleted): reject the
            # trace rather than apply an impossible action
            return world, checker, None, i
        checker.snapshot_pre()
        a.apply(world)
        v = checker.check_after(a.op)
        if v is not None:
            return world, checker, v, i
    if converge:
        v = checker.check_convergence()
        if v is not None:
            return world, checker, v, len(actions) - 1
    return world, checker, None, len(actions)


def _shrink(scenario: Scenario, actions: List[Action],
            invariants: Tuple[str, ...], invariant: str,
            mutation=None) -> List[Action]:
    """Greedy choice-deletion to fixpoint: drop any single action whose
    removal preserves a violation of the SAME invariant, truncate past
    the violation point, repeat until no deletion survives."""
    conv = invariant == "convergence"
    changed = True
    while changed:
        changed = False
        for i in range(len(actions)):
            cand = actions[:i] + actions[i + 1:]
            _w, _c, v, step = _run_trace(scenario, cand, invariants,
                                         mutation, converge=conv)
            if v is not None and v.invariant == invariant:
                actions = cand if conv else cand[:step + 1]
                changed = True
                break
    return actions


def explore(scenario_name: str, depth: int = 4, seed: int = 0,
            max_states: Optional[int] = None,
            invariants: Optional[Tuple[str, ...]] = None,
            mutation=None, shrink: bool = True) -> dict:
    """Exhaustively enumerate interleavings of `scenario_name` to
    `depth`, checking invariants at every state. Stops at the first
    violation (minimized + replayable); otherwise reports the explored
    envelope honestly (complete vs truncated-by-budget)."""
    scenario = SCENARIOS[scenario_name]
    inv = tuple(invariants) if invariants else scenario.invariants
    for name in inv:
        if name not in ALL_INVARIANTS:
            raise ValueError(f"unknown invariant {name!r}")
    t0 = time.monotonic()
    stats = {"states": 1, "transitions": 0, "dedup_hits": 0,
             "sleep_skips": 0, "truncated": False}
    seen: Dict[str, List[frozenset]] = {}
    found: List[dict] = []

    def order(acts: List[Action]) -> List[Action]:
        acts = sorted(acts, key=lambda a: a.label)
        if seed:
            import random
            random.Random((seed, len(acts))).shuffle(acts)
        return acts

    def covered(fp: str, sleep: frozenset) -> bool:
        prior = seen.get(fp)
        if prior is not None:
            for ss in prior:
                if ss <= sleep:
                    stats["dedup_hits"] += 1
                    return True
            prior.append(sleep)
        else:
            seen[fp] = [sleep]
        return False

    def dfs(world: SimWorld, trace: List[Action],
            counts: Dict[str, int], sleep: frozenset,
            d: int) -> None:
        if found:
            return
        enabled = order(scenario.enabled_actions(world, counts))
        cur_sleep = set(sleep)
        for a in enabled:
            if found:
                return
            if a.label in cur_sleep:
                stats["sleep_skips"] += 1
                continue
            if max_states is not None \
                    and stats["states"] >= max_states:
                stats["truncated"] = True
                raise _Budget()
            child = trace + [a]
            is_leaf = d + 1 >= depth
            w2, c2, v, step = _run_trace(scenario, child, inv,
                                         mutation, converge=is_leaf)
            stats["transitions"] += 1
            stats["states"] += 1
            if v is not None:
                witness = child[:step + 1] if v.invariant != \
                    "convergence" else child
                minimized = _shrink(scenario, list(witness), inv,
                                    v.invariant, mutation) \
                    if shrink else list(witness)
                found.append({
                    "invariant": v.invariant, "message": v.message,
                    "trace": [x.as_json() for x in witness],
                    "minimized_trace": [x.as_json()
                                        for x in minimized]})
                return
            if not is_leaf:
                counts2 = dict(counts)
                counts2[a.op] = counts2.get(a.op, 0) + 1
                child_sleep = frozenset(
                    x for x in cur_sleep
                    if independent(a, _label_map[x]))
                fp = _fingerprint(w2, counts2)
                if not covered(fp, child_sleep):
                    dfs(w2, child, counts2, child_sleep, d + 1)
            cur_sleep.add(a.label)

    _label_map = {a.label: a for a in scenario.actions}
    root = scenario.build(mutation)
    root_checker = InvariantChecker(root, inv)
    v0 = root_checker.check_after("init")
    if v0 is not None:
        found.append({"invariant": v0.invariant, "message": v0.message,
                      "trace": [], "minimized_trace": []})
    try:
        if not found:
            dfs(root, [], {}, frozenset(), 0)
    except _Budget:
        pass
    wall = max(time.monotonic() - t0, 1e-9)
    report = {
        "scenario": scenario_name, "depth": depth, "seed": seed,
        "invariants": list(inv),
        "mutation": getattr(mutation, "name", None),
        "bounds": dict(scenario.bounds),
        "states": stats["states"],
        "transitions": stats["transitions"],
        "dedup_hits": stats["dedup_hits"],
        "sleep_skips": stats["sleep_skips"],
        "max_states": max_states,
        "truncated": stats["truncated"],
        "complete": not stats["truncated"] and not found,
        "wall_s": round(wall, 3),
        "states_per_s": round(stats["states"] / wall, 1),
        "violations": found,
        "ok": not found,
    }
    return report


def replay_trace(trace_doc: dict, mutation=None) -> dict:
    """Re-execute an emitted (minimized) trace from a fresh world.
    `trace_doc` is one entry of report['violations'] plus the
    scenario/invariants context, i.e. the JSON `dt-explore` writes.
    Returns {ok, violation, invariant, message}: ok=True means the
    replay REPRODUCED the recorded invariant violation."""
    scenario = SCENARIOS[trace_doc["scenario"]]
    inv = tuple(trace_doc.get("invariants") or scenario.invariants)
    actions = [Action.from_json(a)
               for a in trace_doc["minimized_trace"]]
    conv = trace_doc.get("invariant") == "convergence"
    _w, _c, v, _step = _run_trace(scenario, actions, inv, mutation,
                                  converge=conv)
    return {
        "ok": v is not None
        and v.invariant == trace_doc.get("invariant"),
        "violation": v is not None,
        "invariant": v.invariant if v is not None else None,
        "message": v.message if v is not None else None,
    }


# ---- obs publication (same pattern as analysis.lint) ----
_last_report: Optional[dict] = None


def publish_report(report: dict) -> None:
    global _last_report
    _last_report = {
        "scenario": report["scenario"], "depth": report["depth"],
        "states": report["states"],
        "states_per_s": report["states_per_s"],
        "violations": len(report["violations"]),
        "complete": report["complete"], "ok": report["ok"],
    }


def last_report() -> Optional[dict]:
    return _last_report
