"""Elastic mesh: SLO-driven hot-doc rebalancing over the lease handoff.

Rendezvous hashing gives every doc a stable home, but a flash crowd on
one doc pins its owner host no matter how many peers sit idle — the
mesh can OBSERVE the overload (obs/slo.py burn rates, obs/attrib.py
hot-doc sketch) yet cannot act on it. This module closes the loop:

  * `PlacementOverrides` is a versioned doc -> host table LAYERED OVER
    rendezvous hashing. `ReplicaNode.desired_owner` consults it first,
    so the merge-admission gate, write proxying, the maintain loop and
    the follower read path all follow an override the moment it lands.
    Entries are last-writer-wins by (version, target) — every host
    folds remote entries with `merge`, newer version (tie: lexically
    smaller target) wins, removals are tombstones (target None) so they
    gossip the same way. The table rides SWIM ping bodies
    (`ReplicaNode.ping_json` / `_on_ping`) and is journaled through
    `ReplicaJournal.note_override` so placement survives crash-restart.

  * `Rebalancer` is the closed loop: each control tick it evaluates the
    SLO engine; when an objective is `warning`/`burning` it ranks this
    host's held docs by the hot-doc sketch, picks the least-loaded
    healthy peer (load = held-lease counts gossiped on pings), and
    live-migrates the offenders over the EXISTING epoch-fenced handoff
    (grant -> drain -> transfer -> activate, replicate/ownership.py).
    The override is written before the grant and shipped ON the grant
    message, so the target keeps the doc instead of rendezvous handing
    it straight back; a failed handoff aborts back to ACTIVE at the
    source with the fence intact and the override is tombstoned — a
    failed target never strands a doc. After a successful migration the
    source parks its warm copy back to the snapshot+WAL home
    (hydrator.evict_to_snapshot), completing the residency move.

A host joining mid-soak simply gossips a load of zero and becomes the
preferred target — scale-out under load needs no operator action.
Safety never depends on this module: overrides only steer placement;
every activation still runs the quorum round and every write is still
epoch-fenced.

Locking: `repl.rebalance` is a new rung between `repl.maintain` and
`repl.leases` (the tick plans under it; migrations run OUTSIDE it and
take the lease lock through `node.handoff`). See
analysis/rules/locks.py ORDER_LEVELS.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..analysis.witness import make_lock

# overrides gossiped per ping body (tables are tiny — one entry per
# actively-migrated doc — but the cap keeps a pathological table from
# bloating every probe)
_GOSSIP_CAP = 64


class PlacementOverrides:
    """Versioned placement-override table (doc -> target host).

    Merge rule: higher version wins; equal versions tie-break on the
    lexically smaller target string so every host converges to the
    same entry without coordination. A cleared override is a tombstone
    (target None) at a bumped version — it gossips and journals like
    any entry, which is what lets an abort roll BACK an override that
    other hosts may already have folded.
    """

    def __init__(self, journal=None, metrics=None) -> None:
        # consulted from desired_owner (no lock held) and from the
        # maintain loop (repl.maintain, rung 0) — repl.rebalance (1)
        # nests under maintain and outside repl.leases (2)
        self._rebalance_lock = make_lock("repl.rebalance.overrides",
                                         "repl.rebalance")
        # doc -> (target | None, version)
        self._entries: Dict[str, Tuple[Optional[str], int]] = {}
        self.journal = journal
        self.metrics = metrics
        if journal is not None:
            restore = getattr(journal, "restored_overrides", None)
            if restore is not None:
                for doc, ent in restore().items():
                    tgt = ent.get("target")
                    self._entries[doc] = (tgt, int(ent.get("ver", 0)))

    # ---- local writes ----------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.bump("rebalance", key, n)

    def _journal(self, doc: str, target: Optional[str],
                 ver: int) -> None:
        if self.journal is not None:
            note = getattr(self.journal, "note_override", None)
            if note is not None:
                note(doc, target, ver)

    def set(self, doc_id: str, target: str) -> int:
        """Pin `doc_id`'s placement to `target`; returns the version
        the entry was written at (for the grant-message rider)."""
        with self._rebalance_lock:
            _old, ver = self._entries.get(doc_id, (None, 0))
            ver += 1
            self._entries[doc_id] = (target, ver)
        self._journal(doc_id, target, ver)
        self._bump("overrides_set")
        return ver

    def clear(self, doc_id: str) -> int:
        """Tombstone the override (rollback / un-pin). No-op version
        bump when no entry exists — nothing to retract."""
        with self._rebalance_lock:
            _old, ver = self._entries.get(doc_id, (None, 0))
            ver += 1
            self._entries[doc_id] = (None, ver)
        self._journal(doc_id, None, ver)
        self._bump("overrides_cleared")
        return ver

    # ---- reads -----------------------------------------------------------

    def target_of(self, doc_id: str) -> Optional[str]:
        with self._rebalance_lock:
            ent = self._entries.get(doc_id)
            return ent[0] if ent is not None else None

    def version_of(self, doc_id: str) -> int:
        with self._rebalance_lock:
            ent = self._entries.get(doc_id)
            return ent[1] if ent is not None else 0

    def size(self) -> int:
        """Active (non-tombstone) entries — the prom gauge."""
        with self._rebalance_lock:
            return sum(1 for t, _v in self._entries.values()
                       if t is not None)

    def as_json(self) -> dict:
        with self._rebalance_lock:
            return {d: {"target": t, "ver": v}
                    for d, (t, v) in sorted(self._entries.items())}

    # ---- gossip ----------------------------------------------------------

    def gossip_payload(self, cap: int = _GOSSIP_CAP) -> list:
        """[[doc, target|null, version], ...] — tombstones included so
        clears propagate exactly like sets."""
        with self._rebalance_lock:
            items = sorted(self._entries.items())[:cap]
            return [[d, t, v] for d, (t, v) in items]

    def merge(self, payload, journal: bool = True) -> int:
        """Fold a peer's gossiped entries; returns how many local
        entries changed. Newly-learned entries are journaled too —
        placement must survive a crash on EVERY host, not just the one
        that initiated the migration."""
        if not isinstance(payload, list):
            return 0
        changed: List[Tuple[str, Optional[str], int]] = []
        with self._rebalance_lock:
            for row in payload:
                if not (isinstance(row, list) and len(row) == 3):
                    continue
                doc, target, ver = row
                if not isinstance(doc, str) \
                        or not isinstance(ver, int) \
                        or not (target is None
                                or isinstance(target, str)):
                    continue
                cur_t, cur_v = self._entries.get(doc, (None, 0))
                if ver < cur_v:
                    continue
                if ver == cur_v and (cur_t is None
                                     or (target is not None
                                         and target >= cur_t)):
                    continue        # equal version: smaller target wins
                self._entries[doc] = (target, ver)
                changed.append((doc, target, ver))
        if journal:
            for doc, target, ver in changed:
                self._journal(doc, target, ver)
        if changed:
            self._bump("override_merges", len(changed))
        return len(changed)


class Rebalancer:
    """The closed loop: SLO burn state -> offender docs -> live
    migration. One instance per ReplicaNode; `tick()` runs from the
    node's probe/maintain loop (and from the soaks' single-threaded
    control-plane step). Planning happens under the rebalance lock;
    migrations (network + lease lock) run strictly outside it."""

    def __init__(self, node, obs=None, *,
                 max_migrations_per_tick: int = 1,
                 cooldown_s: float = 3.0,
                 top_n: int = 4,
                 min_load_gap: int = 1,
                 act_on: Tuple[str, ...] = ("warning", "burning"),
                 enabled: bool = True,
                 split_hot_docs: bool = False,
                 group_size: int = 2,
                 promote_after_ticks: int = 2,
                 promote_min_share: float = 0.5,
                 demote_after_s: float = 6.0) -> None:
        self.node = node
        self.obs = obs if obs is not None else getattr(node, "obs",
                                                       None)
        self.max_migrations_per_tick = max_migrations_per_tick
        self.cooldown_s = cooldown_s
        self.top_n = top_n
        # only migrate when our held-lease count exceeds the target's
        # gossiped load by at least this much (ping-pong damper)
        self.min_load_gap = min_load_gap
        # SLO states that arm a migration; a conservative deployment
        # narrows this to ("burning",) so transient warnings never
        # move a doc
        self.act_on = tuple(act_on)
        self.enabled = enabled
        # hot-doc write splitting (replicate/writergroup.py): when a
        # held doc stays a top offender for `promote_after_ticks`
        # consecutive stressed ticks, promote it to a writer group of
        # `group_size` instead of migrating it (a flash crowd on ONE
        # doc cannot be migrated away — splitting the write path can).
        # Cooled groups demote after `demote_after_s` without burn.
        # OFF by default: the single-writer path stays byte-identical.
        self.split_hot_docs = split_hot_docs
        self.group_size = max(2, int(group_size))
        self.promote_after_ticks = max(1, int(promote_after_ticks))
        # splitting is for a DOMINANT doc: promotion also requires the
        # doc to carry at least this share of the attributed burn, so
        # merely ranking in the top-N (which migration is happy with)
        # never splits a cold doc
        self.promote_min_share = float(promote_min_share)
        self.demote_after_s = demote_after_s
        self._rebalance_lock = make_lock("repl.rebalance.plan",
                                         "repl.rebalance")
        self._last_attempt: Dict[str, float] = {}
        # doc -> consecutive stressed ticks it ranked as an offender
        self._hot_ticks: Dict[str, int] = {}
        # doc -> last time a group we lead saw hot-doc burn
        self._group_hot: Dict[str, float] = {}

    # ---- selection -------------------------------------------------------

    def _stressed(self) -> List[str]:
        """Objective names currently warning/burning (empty = healthy)."""
        if self.obs is None or getattr(self.obs, "slo", None) is None:
            return []
        try:
            rows = self.obs.slo.evaluate()
        except Exception:       # pragma: no cover - obs must never kill
            return []
        return [r["name"] for r in rows
                if r.get("state") in self.act_on]

    def _attrib_scores(self) -> Dict[str, float]:
        """Per-doc hot-doc attribution (ops + bytes sketches merged)."""
        scores: Dict[str, float] = {}
        attrib = getattr(self.obs, "attrib", None) \
            if self.obs is not None else None
        if attrib is not None:
            for kind in ("ops", "bytes"):
                for key, count, _err in attrib.top("doc", kind,
                                                   self.top_n * 4):
                    scores[key] = scores.get(key, 0.0) + count
        return scores

    def _offenders(self, scores: Optional[Dict[str, float]] = None
                   ) -> List[str]:
        """This host's held docs ranked by hot-doc attribution score
        (ops + bytes sketches merged); falls back to held order when
        the sketch is cold so a burning host can still shed load."""
        node = self.node
        held = list(node.leases.held_ids())
        if not held:
            return []
        if scores is None:
            scores = self._attrib_scores()
        held.sort(key=lambda d: (-scores.get(d, 0.0), d))
        return held[:self.top_n]

    def _pick_target(self) -> Optional[str]:
        """Least-loaded healthy peer by gossiped held-lease counts —
        a freshly joined host has load 0 and becomes the preferred
        target, which is exactly scale-out under load."""
        node = self.node
        self_load = node.leases.held_count()
        best: Optional[Tuple[int, str]] = None
        for m in node.membership.universe():
            if m == node.self_id or not node.table.is_healthy(m):
                continue
            load = int(node.peer_load.get(m, 0))
            if load + self.min_load_gap > self_load:
                continue
            if best is None or (load, m) < best:
                best = (load, m)
        return best[1] if best is not None else None

    def _pick_members(self, n: int) -> List[str]:
        """Up to `n` co-writer candidates, least-loaded first. Unlike
        `_pick_target` there is no load-gap damper: splitting does not
        move the doc, it only shares its write path, so any healthy
        peer helps."""
        node = self.node
        ranked = sorted(
            (int(node.peer_load.get(m, 0)), m)
            for m in node.membership.universe()
            if m != node.self_id and node.table.is_healthy(m))
        return [m for _load, m in ranked[:n]]

    # ---- migration -------------------------------------------------------

    def migrate(self, doc_id: str, target: str) -> bool:
        """One live migration: override first (shipped on the grant so
        the target keeps the doc), then the epoch-fenced handoff; on
        failure the handoff aborts back to ACTIVE at the source and the
        override is tombstoned. Returns True on a completed move."""
        node = self.node
        metrics = node.metrics
        metrics.bump("rebalance", "migrations_started")
        self._last_attempt[doc_id] = node.clock()
        ver = node.overrides.set(doc_id, target)
        ok = node.handoff(doc_id, target, override_version=ver)
        if ok:
            metrics.bump("rebalance", "migrations_completed")
            if node.obs is not None:
                node.obs.recorder.record("rebalance_migrated",
                                         doc=doc_id, to=target,
                                         override_version=ver)
            self._park_source_copy(doc_id)
            return True
        # rollback: lease already rolled back to ACTIVE (same epoch) by
        # abort_handoff inside node.handoff; retract the override so
        # routing stays at the source
        node.overrides.clear(doc_id)
        metrics.bump("rebalance", "migrations_aborted")
        if node.obs is not None:
            node.obs.recorder.record("rebalance_aborted", doc=doc_id,
                                     to=target)
        return False

    def _park_source_copy(self, doc_id: str) -> None:
        """Residency half of the move: the source's warm copy goes back
        to its snapshot+WAL home (the target hydrates its own). Best
        effort — the doc stays servable for follower reads either way."""
        sched = getattr(self.node.store, "scheduler", None)
        hydrator = getattr(sched, "hydrator", None) \
            if sched is not None else None
        if hydrator is None:
            return
        try:
            hydrator.evict_to_snapshot(doc_id)
        except Exception:       # pragma: no cover - eviction is advisory
            pass

    # ---- the loop --------------------------------------------------------

    def tick(self) -> dict:
        """One control-loop evaluation. Returns a small report dict
        (soaks fold it into their round logs). Planning happens under
        the rebalance lock; migrations AND group promotions/demotions
        (network + lease lock) run strictly outside it."""
        out = {"stressed": [], "migrated": [], "aborted": [],
               "promoted": [], "demoted": []}
        if not self.enabled or self.node.rejoining:
            return out
        plan: List[Tuple[str, str]] = []
        promote_plan: List[Tuple[str, List[str]]] = []
        demote_plan: List[str] = []
        node = self.node
        groups = getattr(node, "writergroups", None)
        with self._rebalance_lock:
            stressed = self._stressed()
            out["stressed"] = stressed
            now = node.clock()
            scores = self._attrib_scores() if stressed else {}
            offenders = self._offenders(scores) if stressed else []
            led = {d for d, g in groups.entries()
                   if g.leader == node.self_id} \
                if groups is not None else set()
            if self.split_hot_docs and groups is not None:
                total = sum(scores.values())
                hot = {d for d in offenders
                       if total > 0.0 and scores.get(d, 0.0)
                       >= self.promote_min_share * total}
                for d in list(self._hot_ticks):
                    if d not in hot:
                        self._hot_ticks.pop(d, None)
                for doc_id in sorted(hot):
                    if doc_id in led:
                        self._group_hot[doc_id] = now
                        continue
                    ticks = self._hot_ticks.get(doc_id, 0) + 1
                    self._hot_ticks[doc_id] = ticks
                    if ticks >= self.promote_after_ticks:
                        members = self._pick_members(
                            self.group_size - 1)
                        if members:
                            promote_plan.append((doc_id, members))
                for doc_id in sorted(led):
                    if doc_id in hot:
                        continue
                    last = self._group_hot.get(doc_id, 0.0)
                    if now - last >= self.demote_after_s:
                        demote_plan.append(doc_id)
            if stressed:
                target = self._pick_target()
                if target is not None:
                    # group-led docs are pinned to their leader, and a
                    # doc accumulating toward promotion splits rather
                    # than migrates — moving the burn is not fixing it
                    skip = led | {d for d, _m in promote_plan}
                    if self.split_hot_docs:
                        skip |= set(self._hot_ticks)
                    for doc_id in offenders:
                        if len(plan) >= self.max_migrations_per_tick:
                            break
                        if doc_id in skip:
                            continue    # group-led docs are pinned
                        last = self._last_attempt.get(doc_id, 0.0)
                        if now - last < self.cooldown_s:
                            continue
                        plan.append((doc_id, target))
        for doc_id, members in promote_plan:
            if node.promote_writer_group(doc_id, members):
                out["promoted"].append([doc_id, members])
                self._group_hot[doc_id] = node.clock()
                self._hot_ticks.pop(doc_id, None)
        for doc_id in demote_plan:
            if node.can_demote(doc_id) \
                    and node.demote_writer_group(doc_id):
                out["demoted"].append(doc_id)
                self._group_hot.pop(doc_id, None)
        for doc_id, target in plan:
            if self.migrate(doc_id, target):
                out["migrated"].append([doc_id, target])
            else:
                out["aborted"].append([doc_id, target])
        return out


def attach_rebalancer(node, obs=None, **opts) -> Rebalancer:
    """Hang a Rebalancer on a ReplicaNode (node.rebalancer); the node's
    probe/maintain loop ticks it. Mirrors attach_replication's shape."""
    rb = Rebalancer(node, obs=obs, **opts)
    node.rebalancer = rb
    return rb
