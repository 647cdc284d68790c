"""Follower reads: serve checkouts from any replica under an explicit
staleness contract.

Writes stay owner-fenced (``replicate/``); this package turns the other
N-1 hosts into read bandwidth. A follower may answer ``GET /doc/{id}``
locally iff it can prove the response is no staler than the client's
``?max_staleness=`` bound and dominates the client's ``X-DT-Min-Version``
read-your-writes token; otherwise it proxies the read to the owner (or
refuses with 503 when the owner is unreachable).

Pieces:
  * :class:`~diamond_types_tpu.read.follower.FollowerIndex` — per-doc
    catch-up evidence (owner frontier advertisements piggybacked on ping
    gossip + anti-entropy rounds, completed-reconcile timestamps) that
    answers "how stale can a local read be, at most?".
  * :class:`~diamond_types_tpu.read.cache.CheckoutCache` — bounded LRU of
    materialized checkouts keyed ``(doc, frontier)`` with single-flight
    coalescing, invalidated by flush completion (owners) and
    anti-entropy apply (followers).
  * :class:`~diamond_types_tpu.read.path.ReadPath` — the serve decision:
    local / wait-then-local / proxy / refuse, with metrics + spans.
  * :class:`~diamond_types_tpu.read.metrics.ReadMetrics` — the ServeMetrics
    v8 ``read`` block, rendered as ``dt_read_*`` prom families.
  * :func:`~diamond_types_tpu.read.bench.run_read_bench` — two-server A/B
    driver (``cli read-bench``): follower reads vs owner-only proxying.
"""

from .cache import CheckoutCache
from .follower import FollowerIndex, frontier_known
from .metrics import READ_KEYS, ReadMetrics
from .path import ReadPath, attach_follower_reads

__all__ = [
    "CheckoutCache",
    "FollowerIndex",
    "frontier_known",
    "READ_KEYS",
    "ReadMetrics",
    "ReadPath",
    "attach_follower_reads",
]
