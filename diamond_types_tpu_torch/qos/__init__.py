"""Adaptive admission: closed-loop QoS for batching, deadlines, shed.

The subsystem that closes ROADMAP item 1's loop from telemetry back to
admission:

  classes.py     the per-request class taxonomy (interactive / bulk /
                 catchup) + ingress classification and the tenant key
  controller.py  the periodic closed-loop controller publishing
                 per-(shard, class) effective flush deadlines (JiT
                 dynamic-batching law + hysteresis + floors/ceilings)
  shed.py        mesh-aware load shedding (429 + Retry-After from the
                 SLO burn rate) and per-tenant token-bucket isolation
  metrics.py     QosMetrics v1 — per-class counters double-written to
                 the live TimeSeries, rendered as dt_qos_* prom
                 families and stamped into scenario scorecards

Wired through serve/admission.py (per-class deadline lookup + depth
budgets; static trigger byte-identical when detached), serve/
scheduler.py (`attach_qos` + lifecycle), tools/server.py (`--qos`,
ingress classification, /debug/qos, 429 sheds) and workload/runner.py
(lane tagging + the `qos` scorecard block).
"""

from .classes import (QOS_CLASSES, QOS_HEADER, QOS_PRIORITY, QosClass,
                      classify_headers, default_classes, tenant_of)
from .controller import QosController
from .metrics import (QOS_CLASS_KEYS, QOS_CTL_KEYS, QosMetrics,
                      merge_snapshots)
from .shed import ShedPolicy, TokenBucket

__all__ = [
    "QOS_CLASSES", "QOS_HEADER", "QOS_PRIORITY", "QosClass",
    "classify_headers", "default_classes", "tenant_of",
    "QosController",
    "QOS_CLASS_KEYS", "QOS_CTL_KEYS", "QosMetrics", "merge_snapshots",
    "ShedPolicy", "TokenBucket",
]
