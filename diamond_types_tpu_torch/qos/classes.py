"""Per-request QoS class taxonomy for the admission path.

Every mutation entering the serve tier carries one of three classes:

  interactive   a human editing session's keystrokes — the latency-
                sensitive class. Its flush deadline may only ever be
                TIGHTENED by the controller (ceiling = the static
                trigger), so adaptive batching can never push the
                interactive p99 past what the static trigger allowed.
  bulk          import/migration traffic — throughput-sensitive,
                latency-tolerant. The controller stretches its
                deadline (up to `ceiling_s`) to fill pow2 shape
                buckets, and it is the FIRST class shed when the mesh
                burns.
  catchup       anti-entropy / replication catch-up writes — the
                continuous-ingest class ("Formal Foundations of
                Continuous Graph Processing" framing): deprioritizable
                behind user traffic, but with a hard deadline ceiling
                so a loaded host still converges (catchup can be
                deferred, never starved).

Classification happens once, at server ingress (`tools/server.py`):
an explicit `X-DT-QoS` header wins; `X-DT-Replication` (host-targeted
anti-entropy) is heuristically `catchup`; everything else defaults to
`interactive`. Proxied writes re-send the header so the owner admits
under the original class. The class rides `AdmissionQueue` items from
there; per-tenant subclassing is the tenant dimension (`tenant_of`)
used by the shed policy's token buckets, not a fourth class.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

QOS_HEADER = "X-DT-QoS"

# canonical class names, in priority order (smaller index = more
# urgent; a coalescing re-submit keeps the more urgent class)
QOS_CLASSES = ("interactive", "bulk", "catchup")

QOS_PRIORITY = {name: i for i, name in enumerate(QOS_CLASSES)}


@dataclass(frozen=True)
class QosClass:
    """One class's admission contract. `deadline_s` is the static/base
    flush deadline; the controller publishes an *effective* deadline in
    [floor_s, ceiling_s] around it. `depth_share` bounds how much of a
    shard's `max_pending` this class may occupy (per-class queue-depth
    budget); `objective` names the SLO objective whose burn state
    guards this class (non-ok => the controller pins the class to its
    floor); `sheddable` marks classes the mesh-burn shed policy may
    429."""

    name: str
    deadline_s: float
    floor_s: float
    ceiling_s: float
    depth_share: float
    objective: str
    sheddable: bool

    def clamp(self, deadline_s: float) -> float:
        return min(max(deadline_s, self.floor_s), self.ceiling_s)


def default_classes(base_deadline_s: float = 0.05) -> Dict[str, QosClass]:
    """The default taxonomy, scaled from the queue's static flush
    deadline so a scheduler built with a non-default trigger keeps the
    same relative contract. Interactive's ceiling IS the static
    deadline: with the controller attached, interactive work can only
    flush earlier than the static trigger would have, never later."""
    b = float(base_deadline_s)
    return {
        "interactive": QosClass(
            "interactive", deadline_s=b, floor_s=b / 10.0, ceiling_s=b,
            depth_share=1.0, objective="flush_p99", sheddable=False),
        "bulk": QosClass(
            "bulk", deadline_s=5.0 * b, floor_s=b, ceiling_s=40.0 * b,
            depth_share=0.5, objective="queue_wait_p99", sheddable=True),
        "catchup": QosClass(
            "catchup", deadline_s=10.0 * b, floor_s=b,
            ceiling_s=100.0 * b, depth_share=0.25,
            objective="visibility_p99", sheddable=True),
    }


def with_base(classes: Dict[str, QosClass],
              base_deadline_s: float) -> Dict[str, QosClass]:
    """Rescale a taxonomy's interactive rung onto a queue's actual
    static deadline (bind-time adjustment; other classes keep their
    absolute contracts unless they came from default_classes)."""
    spec = classes.get("interactive")
    if spec is None or spec.deadline_s == base_deadline_s:
        return classes
    out = dict(classes)
    out["interactive"] = replace(
        spec, deadline_s=base_deadline_s,
        floor_s=min(spec.floor_s, base_deadline_s / 10.0),
        ceiling_s=base_deadline_s)
    return out


def classify_headers(headers) -> str:
    """Ingress classification: explicit `X-DT-QoS` header wins (unknown
    values fall back to interactive — a typo must not accidentally
    deprioritize a user edit); a host-targeted anti-entropy push
    (`X-DT-Replication`) is catchup."""
    explicit = headers.get(QOS_HEADER)
    if explicit:
        name = explicit.strip().lower()
        if name in QOS_PRIORITY:
            return name
    if headers.get("X-DT-Replication") is not None:
        return "catchup"
    return "interactive"


def tenant_of(doc_id: Optional[str]) -> Optional[str]:
    """The tenant namespace of a doc id under the workload grammar
    ("t{tenant}-..."), or None for ids outside it. This is the key the
    shed policy's per-tenant token buckets isolate on."""
    if not doc_id:
        return None
    head, sep, _rest = doc_id.partition("-")
    if sep and len(head) > 1 and head[0] == "t" and head[1:].isdigit():
        return head
    return None
