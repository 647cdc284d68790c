"""Cross-host replication: peer mesh, doc-ownership leases, anti-entropy.

The serve/ scheduler made one process own many documents across many
chips; this package makes N *processes* (sync-server instances) jointly
own the document space. The wire format is the one the single server
already speaks — version summaries (`causalgraph/summary.py`) plus v1
binary patches — reused verbatim for inter-server anti-entropy, so a
peer is just another sync client with a lease protocol on top.

Layers (each its own module, composed by `node.ReplicaNode`):

  peers.py        peer table (seeded + dynamic add/remove), health
                  probes, consecutive-failure circuit breaker,
                  jittered exponential `Backoff`, gossip piggyback on
                  ping, timeout on every HTTP call
  membership.py   dynamic membership view: join/leave/suspect/dead
                  states, incarnation refutation, the rendezvous
                  universe and the quorum voter set
  ownership.py    doc-ownership leases on top of rendezvous placement
                  extended to hosts (same blake2b scheme as
                  serve/router.py), epoch fencing floors, the voter
                  promise table, and an explicit handoff protocol
  quorum.py       majority promise rounds (at most one ACTIVE lease
                  per (doc, epoch)) + the crash-durable ReplicaJournal
                  on the storage/ Wal + PageStore primitives
  antientropy.py  background reconciliation: summary exchange + binary
                  patch pull/push for divergent docs
  faults.py       deterministic fault injection (drop / delay /
                  duplicate / asymmetric partition / link latency /
                  clock skew, by seed) for tests + soak
  metrics.py      replication counters merged into `GET /metrics`
  node.py         ReplicaNode — wires the above to a DocStore
  writergroup.py  writer groups: a hot doc's write path split across a
                  quorum-ratified group of members
  rebalance.py    placement overrides and the SLO-driven rebalancer

The JAX package's `replicate/` with the same exports; every module named
above is a byte-identical copy. Its soaks (`soak.py`, `rebalance_soak.py`)
are not ported yet. In the port a replica merges on the card: the server's
`MergeScheduler` is the fused device engine, and `attach_replication`
hands it the ownership gate (`admit`), the lease-epoch fence (`epoch_of`)
and the Hydrator's `remote_fetch`.
"""

from .faults import FaultDrop, FaultInjector
from .membership import MembershipView
from .metrics import ReplicationMetrics
from .node import ReplicaNode, attach_replication
from .ownership import LeaseManager, owner_of
from .peers import Backoff, CircuitOpen, PeerTable, call_with_retries
from .quorum import QuorumCoordinator, ReplicaJournal

__all__ = [
    "Backoff", "CircuitOpen", "FaultDrop", "FaultInjector",
    "LeaseManager", "MembershipView", "PeerTable", "QuorumCoordinator",
    "ReplicaJournal", "ReplicaNode", "ReplicationMetrics",
    "attach_replication", "call_with_retries", "owner_of",
]
