"""Concurrency analysis: the runtime lock witness.

The JAX package's `analysis/witness.py`, copied whole. The scheduler's
global, shard and device locks, the bank's first-touch lock, the
hydrator's warm-map lock and the tiered store's locks are witness locks
(`make_lock`) under the JAX package's names, order classes and ranks, so
`witness_enable()` records the same lock-order graph there and the
storage soak's acyclicity gate covers the scheduler. The canonical order:
scheduler global → sorted shard locks → io → oplog guard → sorted
per-device locks → leaf. The static lint (`analysis/lint.py` and its
rules) is not ported yet.
"""

from __future__ import annotations

from .witness import (WitnessLock, make_lock, witness_assert_acyclic,
                      witness_disable, witness_enable, witness_reset,
                      witness_snapshot)

__all__ = [
    "WitnessLock", "make_lock", "witness_enable", "witness_disable",
    "witness_reset", "witness_snapshot", "witness_assert_acyclic",
]
