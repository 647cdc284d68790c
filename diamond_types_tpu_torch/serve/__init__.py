"""Sharded multi-document merge scheduling on the device.

Port of the JAX package's `serve/`: many independent documents become
continuously fed, shape-bucketed, per-shard batches, each flushed through
the device replay (K1) and, with `device_plan`, device planning (K2):

  * `router`     — deterministic doc-id -> shard assignment
                   (rendezvous hashing, explicit rebalance)
  * `admission`  — shape-bucketed pending-merge queues with a
                   size-or-deadline flush trigger and bounded depth +
                   backpressure
  * `bank`       — per-shard `FusedDocSession` bank with LRU eviction and
                   device-slot capacity accounting
  * `metrics`    — JSON-exportable counters and latency histograms
  * `scheduler`  — the composition: submit/pump/drain/text
  * `driver`     — the serve-bench workload driver with a byte-parity gate
                   against the host merge (`python -m
                   diamond_types_tpu_torch.serve`)
  * `hydrate`    — the residency tier's `Hydrator` (cold documents on
                   disk -> warm oplogs), wired in by
                   `MergeScheduler.attach_hydrator`
"""

from .admission import AdmissionQueue, Backpressure, shape_bucket
from .bank import SessionBank
from .metrics import ServeMetrics
from .router import ShardRouter
from .scheduler import MergeScheduler

__all__ = [
    "AdmissionQueue", "Backpressure", "MergeScheduler", "ServeMetrics",
    "SessionBank", "ShardRouter", "shape_bucket",
]
