"""Concurrency analysis: the runtime lock witness.

The JAX package's `analysis/witness.py`, copied whole. The scheduler's
global, shard and device locks, the bank's first-touch lock, the
hydrator's warm-map lock, the tiered store's locks, the sync server's
`store.io` and `store.oplog`, the wire channel's `wire.frames` and the
replication mesh's `repl.*` locks are witness locks (`make_lock`) under
the JAX package's names, order classes and ranks, so `witness_enable()`
records the same lock-order graph there and the soaks' acyclicity gates
cover the scheduler and the mesh. The canonical order: replicate
maintenance → leases → membership/peers → scheduler global → sorted shard
locks → io → oplog guard → sorted per-device locks → leaf (the replica
journal among them). The static lint (`analysis/lint.py` and its rules)
is not ported yet.
"""

from __future__ import annotations

from .witness import (WitnessLock, make_lock, witness_assert_acyclic,
                      witness_disable, witness_enable, witness_reset,
                      witness_snapshot)

__all__ = [
    "WitnessLock", "make_lock", "witness_enable", "witness_disable",
    "witness_reset", "witness_snapshot", "witness_assert_acyclic",
]
