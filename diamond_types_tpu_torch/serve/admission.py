"""Shape-bucketed admission queues with bounded depth + backpressure.

A verbatim copy of the JAX package's `serve/admission.py`. `qos` is the
QoS controller that `MergeScheduler.attach_qos` wires in (None: the static
trigger runs).

The device tier amortizes dispatch overhead only when work of one padded
shape is flushed together (the zone session's jit cache is keyed on the
padded micro-tape length; a flush whose docs share a bucket shares one
compiled program). Pending merges are therefore bucketed by the
next-power-of-two of their pending op count and flushed when EITHER
trigger fires (Just-in-Time Dynamic Batching, arxiv 1904.07421):

  * size     — a bucket reached `flush_docs` distinct documents;
  * deadline — the bucket's OLDEST entry has waited `flush_deadline_s`
               (latency bound: a lone doc is never starved by the size
               trigger).

Depth is bounded per shard. A submit that would push a shard past
`max_pending` pending DOCUMENTS raises `Backpressure` with a
`retry_after` hint instead of growing the queue — the caller (HTTP
handler, bench driver) surfaces it as a 429-style reject-with-retry.
Re-submitting a doc that is already queued never adds depth: the
pending entry coalesces (its op count accumulates; it may migrate to a
larger shape bucket; its deadline clock keeps the ORIGINAL enqueue time
so coalescing cannot starve the deadline trigger).

QoS (qos/): every item carries a class (interactive/bulk/catchup).
With a controller attached (`self.qos`, set by MergeScheduler.
attach_qos) the deadline trigger consults the controller's published
per-(shard, class) effective deadline instead of the static
`flush_deadline_s` — each class's OWN oldest entry is checked, so a
mixed bucket flushes when the earliest per-class deadline passes (a
stretched bulk deadline never delays an interactive doc queued behind
it) — and each class is additionally bounded to its own
depth budget (a fraction of `max_pending`). With no controller the
static trigger runs byte-identically to before — the qos field rides
along inert.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..qos.classes import QOS_PRIORITY


def shape_bucket(n_ops: int) -> int:
    """Next power of two >= n_ops (minimum 1) — the padded shape class."""
    n = max(int(n_ops), 1)
    b = 1
    while b < n:
        b <<= 1
    return b


@dataclass
class PendingMerge:
    doc_id: str
    n_ops: int
    enqueued_at: float
    # lease epoch under which the work was admitted (-1 = unfenced,
    # single-host). The scheduler rechecks it at flush time: work
    # admitted under a lease this host no longer holds is dropped, not
    # merged (the new owner merges the same durable oplog instead).
    epoch: int = -1
    # obs.trace.SpanContext of the sampled admit that queued this work
    # (None when unsampled/untraced) — lets the flush span parent on
    # the originating edit's trace
    trace: object = None
    # QoS class the work was admitted under (qos/classes.py); decides
    # which effective deadline the bucket's trigger consults when a
    # controller is attached
    qos: str = "interactive"


class Backpressure(Exception):
    """Shard queue is full; retry after `retry_after` seconds."""

    def __init__(self, shard: int, depth: int, retry_after: float) -> None:
        self.shard = shard
        self.depth = depth
        self.retry_after = retry_after
        super().__init__(
            f"shard {shard} admission queue full ({depth} pending); "
            f"retry after {retry_after:.3f}s")


class AdmissionQueue:
    def __init__(self, n_shards: int, max_pending: int = 256,
                 flush_docs: int = 8,
                 flush_deadline_s: float = 0.05) -> None:
        if max_pending < 1 or flush_docs < 1:
            raise ValueError("max_pending and flush_docs must be >= 1")
        self.n_shards = n_shards
        self.max_pending = max_pending
        self.flush_docs = flush_docs
        self.flush_deadline_s = flush_deadline_s
        # shard -> bucket -> doc_id -> PendingMerge (dict = FIFO order)
        self._q: List[Dict[int, Dict[str, PendingMerge]]] = [
            {} for _ in range(n_shards)]
        self._where: List[Dict[str, int]] = [{} for _ in range(n_shards)]
        # qos.QosController (or None = static trigger). Set by
        # MergeScheduler.attach_qos; read lock-free on the hot path.
        self.qos = None
        # shard -> class -> pending-doc count (per-class depth budgets;
        # maintained unconditionally, enforced only with a controller)
        self._class_depth: List[Dict[str, int]] = [
            {} for _ in range(n_shards)]

    # ---- intake ----------------------------------------------------------

    def depth(self, shard: int) -> int:
        return len(self._where[shard])

    def pending_bucket(self, shard: int, doc_id: str) -> Optional[int]:
        """The shape bucket `doc_id` is queued under, or None."""
        return self._where[shard].get(doc_id)

    def total_depth(self) -> int:
        return sum(len(w) for w in self._where)

    def class_depth(self, shard: int, qos: str) -> int:
        return self._class_depth[shard].get(qos, 0)

    def bucket_fill(self, shard: int) -> int:
        """Doc count of the shard's fullest shape bucket (0 = empty) —
        the controller's occupancy-gap input. Call under the same lock
        that guards submit/take (the scheduler's global lock)."""
        docs = self._q[shard]
        return max((len(d) for d in docs.values()), default=0)

    def _deadline_for(self, shard: int, qos: str) -> float:
        ctl = self.qos
        if ctl is None:
            return self.flush_deadline_s
        return ctl.effective_deadline(shard, qos)

    def submit(self, shard: int, doc_id: str, n_ops: int,
               now: float, epoch: int = -1, trace=None,
               qos: str = "interactive") -> int:
        """Queue (or coalesce) `n_ops` of pending merge work for
        `doc_id`. Returns the shape bucket it landed in. Raises
        Backpressure instead of exceeding `max_pending` docs/shard (or,
        with a controller attached, the class's own depth budget).
        Coalescing adopts the LATEST lease epoch — earlier queued ops
        are covered by the newer admit decision — keeps a sampled trace
        context if any submit in the batch carried one, and keeps the
        most URGENT class seen (an interactive re-touch of a queued
        bulk doc must not wait out the bulk deadline)."""
        where = self._where[shard]
        cdepth = self._class_depth[shard]
        old_bucket = where.get(doc_id)
        if old_bucket is not None:
            item = self._q[shard][old_bucket].pop(doc_id)
            item.n_ops += max(int(n_ops), 0)
            item.epoch = epoch
            if trace is not None:
                item.trace = trace
            if QOS_PRIORITY.get(qos, 0) < QOS_PRIORITY.get(item.qos, 0):
                cdepth[item.qos] = cdepth.get(item.qos, 1) - 1
                cdepth[qos] = cdepth.get(qos, 0) + 1
                item.qos = qos
            bucket = shape_bucket(item.n_ops)
            self._q[shard].setdefault(bucket, {})[doc_id] = item
            where[doc_id] = bucket
            return bucket
        ctl = self.qos
        if len(where) >= self.max_pending:
            # the deadline trigger drains the oldest bucket within one
            # deadline window; that is the honest earliest retry time
            raise Backpressure(shard, len(where),
                               self._deadline_for(shard, qos))
        if ctl is not None and cdepth.get(qos, 0) \
                >= ctl.depth_budget(qos, self.max_pending):
            raise Backpressure(shard, cdepth.get(qos, 0),
                               self._deadline_for(shard, qos))
        bucket = shape_bucket(n_ops)
        self._q[shard].setdefault(bucket, {})[doc_id] = PendingMerge(
            doc_id, max(int(n_ops), 1), now, epoch, trace, qos)
        where[doc_id] = bucket
        cdepth[qos] = cdepth.get(qos, 0) + 1
        return bucket

    # ---- flush triggers --------------------------------------------------

    def due(self, now: float,
            force: bool = False) -> List[Tuple[int, int, str]]:
        """(shard, bucket, reason) for every bucket whose size or
        deadline trigger fired (every non-empty bucket when `force`)."""
        out: List[Tuple[int, int, str]] = []
        for shard in range(self.n_shards):
            # class -> effective deadline, memoized per shard pass
            deadlines: Dict[str, float] = {}
            for bucket, docs in self._q[shard].items():
                if not docs:
                    continue
                if force:
                    out.append((shard, bucket, "force"))
                elif len(docs) >= self.flush_docs:
                    out.append((shard, bucket, "size"))
                else:
                    # deadline: fire when ANY entry has outlived its
                    # OWN class's effective deadline — equivalently,
                    # min over items of (enqueued_at + deadline(qos))
                    # has passed. A mixed bucket flushes on whichever
                    # class's oldest entry is due first, so a
                    # stretched bulk deadline can never starve an
                    # interactive doc queued behind it in the same
                    # shape bucket. (Checking every item, not just the
                    # first in dict order, also covers coalesced
                    # entries: coalescing re-inserts at the dict tail
                    # while keeping the original enqueue time.)
                    for item in docs.values():
                        d = deadlines.get(item.qos)
                        if d is None:
                            d = deadlines[item.qos] = \
                                self._deadline_for(shard, item.qos)
                        if now - item.enqueued_at >= d:
                            out.append((shard, bucket, "deadline"))
                            break
        return out

    def take(self, shard: int, bucket: int,
             limit: Optional[int] = None) -> List[PendingMerge]:
        """Dequeue up to `limit` (default `flush_docs`) docs from one
        bucket, FIFO."""
        docs = self._q[shard].get(bucket)
        if not docs:
            return []
        k = limit if limit is not None else self.flush_docs
        out = []
        cdepth = self._class_depth[shard]
        for doc_id in list(docs)[:k]:
            item = docs.pop(doc_id)
            out.append(item)
            del self._where[shard][doc_id]
            left = cdepth.get(item.qos, 1) - 1
            if left > 0:
                cdepth[item.qos] = left
            else:
                cdepth.pop(item.qos, None)
        if not docs:
            del self._q[shard][bucket]
        return out
