"""Deterministic doc-id -> shard routing (rendezvous hashing).

A verbatim copy of the JAX package's `serve/router.py`: the same doc ids
land on the same shards in both packages.

Every process that sees the same (doc_id, n_shards, salt) must pick the
same shard — routing happens in the sync server, in serve-bench workers
and in soak tools, and a disagreement would put two live sessions of one
document on different chips. Python's builtin `hash` is per-process
randomized, so scores come from blake2b instead.

Rendezvous (highest-random-weight) hashing rather than `hash % n`: when
the shard count changes, only the docs whose argmax shard changed move
(expected fraction |n' - n| / max(n, n')), instead of nearly all of
them. `rebalance()` makes that movement explicit: it returns exactly the
docs that moved so the caller can drain/flush their sessions before the
new placement takes effect.

The elastic-mesh rebalancer adds one escape hatch: `pin(doc_id, shard)`
overrides the hash for a specific doc (a host absorbing a migrated hot
doc steers it onto its least-loaded shard). Pins are local,
process-lifetime state — cross-host placement authority lives in the
replication tier's PlacementOverrides table, not here.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple


def _score(doc_id: str, shard: int, salt: bytes) -> int:
    h = hashlib.blake2b(digest_size=8, salt=salt[:16])
    h.update(doc_id.encode("utf8"))
    h.update(shard.to_bytes(4, "little"))
    return int.from_bytes(h.digest(), "little")


class ShardRouter:
    """Stateless `shard_of` + a registry of live assignments so rebalance
    can report movement (the registry is bookkeeping, not authority: the
    hash alone decides placement)."""

    def __init__(self, n_shards: int, salt: str = "dt-serve") -> None:
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self.salt = salt.encode("utf8")
        self.assignments: Dict[str, int] = {}
        # rebalancer pins: doc -> shard, consulted before the hash
        self.pins: Dict[str, int] = {}

    def pin(self, doc_id: str, shard: int) -> None:
        if not (0 <= shard < self.n_shards):
            raise ValueError("shard out of range")
        self.pins[doc_id] = shard
        # a live assignment must follow the pin or counts() lies
        if doc_id in self.assignments:
            self.assignments[doc_id] = shard

    def unpin(self, doc_id: str) -> None:
        self.pins.pop(doc_id, None)

    def shard_of(self, doc_id: str) -> int:
        pinned = self.pins.get(doc_id)
        if pinned is not None and pinned < self.n_shards:
            return pinned
        best, best_score = 0, -1
        for s in range(self.n_shards):
            sc = _score(doc_id, s, self.salt)
            # ties broken by the lower shard id (sc > best_score, not >=)
            if sc > best_score:
                best, best_score = s, sc
        return best

    def assign(self, doc_id: str) -> int:
        s = self.assignments.get(doc_id)
        if s is None:
            s = self.assignments[doc_id] = self.shard_of(doc_id)
        return s

    def forget(self, doc_id: str) -> None:
        self.assignments.pop(doc_id, None)

    def counts(self) -> List[int]:
        out = [0] * self.n_shards
        for s in self.assignments.values():
            out[s] += 1
        return out

    def rebalance(self, n_shards: int) -> Dict[str, Tuple[int, int]]:
        """Re-route every registered doc for a new shard count. Returns
        {doc_id: (old_shard, new_shard)} for exactly the docs that moved;
        the registry is updated in place. The caller owns draining the
        moved docs' old-shard sessions BEFORE resuming submits."""
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        old = dict(self.assignments)
        self.n_shards = n_shards
        moved: Dict[str, Tuple[int, int]] = {}
        for doc_id, prev in old.items():
            new = self.shard_of(doc_id)
            self.assignments[doc_id] = new
            if new != prev:
                moved[doc_id] = (prev, new)
        return moved
