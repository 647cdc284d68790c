"""Concurrency invariant analysis: static lint + runtime lock witness.

Two halves of one correctness story the chaos soaks only sample:

  lint.py / rules/   AST-based linter over serve/, replicate/, gpu/,
                     parallel/ and tools/ — lock-order violations,
                     unsorted multi-lock acquisition, device dispatch
                     under the global/oplog lock, unfenced doc-state
                     mutation on write paths, impurity inside
                     jitted/shard_map bodies. CLI: `dt-lint`.
  witness.py         lockdep-style instrumented Lock wrapper, off by
                     default; records actual held-while-acquiring
                     edges during tests/soaks and asserts the global
                     lock-order graph stays acyclic.

The JAX package's `analysis/`, copied. The lint walks `gpu/` where the
JAX package's walks `tpu/`, and its device-dispatch set adds the port's
own dispatch names (the `gpu/kernels.py` wrappers, `synchronize`, the
batched checkouts); the jit-purity rules have nothing to match in the
port's tree (no `jax.jit`, `shard_map` or jit cache) and still fire on
the shared fixtures. `explore/` drives the port's replication code.

The scheduler's global, shard and device locks, the bank's first-touch
lock, the hydrator's warm-map lock, the tiered store's locks, the sync
server's `store.io` and `store.oplog`, the wire channel's `wire.frames`
and the replication mesh's `repl.*` locks are witness locks
(`make_lock`) under the JAX package's names, order classes and ranks, so
`witness_enable()` records the same lock-order graph there and the soaks'
acyclicity gates cover the scheduler and the mesh.

The canonical lock order both halves enforce (serve/README.md
"Concurrency invariants"): replicate maintenance → leases →
membership/peers/quorum → scheduler global → sorted shard locks →
oplog guard → sorted per-device locks → leaf (jit caches, first-touch
init, io).
"""

from __future__ import annotations

from .lint import (Violation, last_report, publish_report, render_human,
                   run_lint)
from .witness import (WitnessLock, make_lock, witness_assert_acyclic,
                      witness_disable, witness_enable, witness_reset,
                      witness_snapshot)

__all__ = [
    "Violation", "run_lint", "render_human", "publish_report",
    "last_report",
    "WitnessLock", "make_lock", "witness_enable", "witness_disable",
    "witness_reset", "witness_snapshot", "witness_assert_acyclic",
]
