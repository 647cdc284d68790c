"""Bounded LRU of materialized checkouts, keyed ``(doc, frontier)``.

Shared by every read endpoint on a node (text and state GETs hit the
same entries — the cached value is the checkout text; endpoints dress it
differently). Invalidated by flush completion on owners and by
anti-entropy apply on followers; because the key includes the frontier,
invalidation is a freshness/footprint concern, never a correctness one —
a stale entry can only be returned for the exact frontier it encodes.

Single-flight: a read flash-crowd on one hot ``(doc, frontier)``
materializes the checkout ONCE. The first miss becomes the leader and
materializes OUTSIDE the cache guard (``materialize`` re-enters the
store's oplog guard, which is a lower rung than this cache's io guard —
holding the cache guard across it would invert the canonical lock
order); followers block on the flight's event and reuse the result.
"""

from collections import OrderedDict
from typing import Callable, Optional, Tuple

import threading

from ..analysis import make_lock

FrontierKey = Tuple[Tuple[str, int], ...]


def frontier_key(frontier) -> FrontierKey:
    """Canonical hashable form of a remote frontier ([[agent, seq]...])."""
    return tuple(sorted((h[0], int(h[1])) for h in frontier))


class _Flight:
    __slots__ = ("done", "value", "error")

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None


class CheckoutCache:
    """LRU + single-flight for checkout materializations.

    ``get`` returns ``(value, outcome)`` with outcome one of ``"hit"``,
    ``"miss"`` (this caller materialized), ``"coalesced"`` (another
    caller's in-flight materialization was reused) or ``"timeout"``
    (the leader took too long; this caller materialized independently
    without caching — the flash-crowd degrades, it never deadlocks).
    """

    def __init__(self, capacity: int = 256, metrics=None,
                 flight_timeout_s: float = 5.0):
        self.capacity = max(1, int(capacity))
        self.flight_timeout_s = flight_timeout_s
        self.metrics = metrics
        self._cache_lock = make_lock("read.cache", "io")
        self._entries: "OrderedDict[Tuple[str, FrontierKey], object]" = \
            OrderedDict()
        self._flights = {}

    def _bump(self, key: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.bump(key, n)

    # ---- read path -------------------------------------------------------

    def get(self, doc_id: str, fkey: FrontierKey,
            materialize: Callable[[], object]):
        key = (doc_id, fkey)
        with self._cache_lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._bump("cache_hits")
                return self._entries[key], "hit"
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
            else:
                leader = False
        if not leader:
            if flight.done.wait(self.flight_timeout_s) \
                    and flight.error is None:
                self._bump("cache_coalesced")
                return flight.value, "coalesced"
            # Leader failed or is wedged: materialize for ourselves,
            # skipping the cache (the leader owns the flight slot).
            self._bump("cache_wait_timeouts")
            return materialize(), "timeout"
        try:
            value = materialize()
        except BaseException as e:
            flight.error = e
            with self._cache_lock:
                self._flights.pop(key, None)
            flight.done.set()
            raise
        flight.value = value
        evicted = 0
        with self._cache_lock:
            self._flights.pop(key, None)
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
        flight.done.set()
        self._bump("cache_misses")
        if evicted:
            self._bump("cache_evictions", evicted)
        return value, "miss"

    # ---- lifecycle -------------------------------------------------------

    def invalidate(self, doc_id: str) -> int:
        """Drop every cached frontier of ``doc_id``; returns the count."""
        with self._cache_lock:
            victims = [k for k in self._entries if k[0] == doc_id]
            for k in victims:
                del self._entries[k]
        if victims:
            self._bump("invalidated_entries", len(victims))
        return len(victims)

    def clear(self) -> None:
        with self._cache_lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._cache_lock:
            return len(self._entries)
