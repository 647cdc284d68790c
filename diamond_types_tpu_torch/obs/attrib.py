"""Hot-doc / hot-agent attribution via a space-saving top-K sketch.

"Which doc is burning the device budget this minute" needs per-doc
counters, but per-doc prom series are a cardinality bomb at millions
of docs. The space-saving sketch (Metwally et al.) keeps exactly K
slots per dimension: a hit on a tracked key increments it; a miss on a
full table evicts the minimum-count key and inherits its count as the
new key's error bound. Guarantees: any key with true count >
total/K is present, and every reported count overestimates truth by at
most the reported `err` — good enough to rank rebalancing and
follower-read-placement candidates, which is all this feeds.

Dimensions tracked (each per-doc and per-agent):

    ops           merged CRDT ops (scheduler flush path)
    bytes         request body bytes (server POST handlers)
    device_s      per-flush device seconds, split over the bucket docs
    cache_misses  hydration sync-points + checkout-cache misses

Surfaced at `GET /debug/hot` and as bounded `dt_hot_*` prom series
(top-N only, N << K). `_sketch_lock` is a leaf lock: note() calls run
under shard locks in the flush path.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..analysis.witness import make_lock

KINDS = ("ops", "bytes", "device_s", "cache_misses")
DIMS = ("doc", "agent")


class SpaceSaving:
    """Metwally space-saving heavy-hitter sketch, float-weighted.
    NOT thread-safe — the owning HotAttribution's lock guards it."""

    __slots__ = ("k", "counts", "errs", "total")

    def __init__(self, k: int) -> None:
        self.k = k
        self.counts: Dict[str, float] = {}
        self.errs: Dict[str, float] = {}
        self.total = 0.0

    def offer(self, key: str, n: float = 1.0) -> None:
        self.total += n
        if key in self.counts:
            self.counts[key] += n
            return
        if len(self.counts) < self.k:
            self.counts[key] = n
            self.errs[key] = 0.0
            return
        victim = min(self.counts, key=self.counts.__getitem__)
        floor = self.counts.pop(victim)
        self.errs.pop(victim, None)
        self.counts[key] = floor + n
        self.errs[key] = floor

    def top(self, n: int) -> List[Tuple[str, float, float]]:
        """[(key, count, err)] — count overestimates truth by <= err."""
        rows = sorted(self.counts.items(), key=lambda kv: -kv[1])[:n]
        return [(k, round(c, 6), round(self.errs.get(k, 0.0), 6))
                for k, c in rows]


class HotAttribution:
    """One sketch per (dimension, kind); bounded memory regardless of
    doc/agent cardinality. Disabled => one branch, no allocation."""

    def __init__(self, k: int = 64, enabled: bool = True) -> None:
        self.enabled = enabled
        self.k = k
        self.noted = 0
        self._sketch_lock = make_lock("obs.attrib", "leaf")
        self._sketches: Dict[Tuple[str, str], SpaceSaving] = {
            (dim, kind): SpaceSaving(k)
            for dim in DIMS for kind in KINDS}

    def note(self, kind: str, doc: str = None, agent: str = None,
             n: float = 1.0) -> None:
        if not self.enabled or n <= 0.0:
            return
        with self._sketch_lock:
            if doc is not None:
                self._sketches[("doc", kind)].offer(doc, n)
            if agent is not None:
                self._sketches[("agent", kind)].offer(agent, n)
            self.noted += 1

    def top(self, dim: str, kind: str,
            n: int = 10) -> List[Tuple[str, float, float]]:
        with self._sketch_lock:
            return self._sketches[(dim, kind)].top(n)

    def snapshot(self, top: int = 10) -> dict:
        out: dict = {"version": 1, "enabled": self.enabled,
                     "k": self.k, "noted": self.noted}
        with self._sketch_lock:
            for dim in DIMS:
                block = out[dim] = {}
                for kind in KINDS:
                    sk = self._sketches[(dim, kind)]
                    block[kind] = {
                        "total": round(sk.total, 6),
                        "tracked": len(sk.counts),
                        "top": [list(r) for r in sk.top(top)],
                    }
        return out
