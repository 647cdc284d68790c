"""Deterministic fault injection for the peer mesh.

Every inter-server HTTP call funnels through `PeerTable.call`, which
consults one shared `FaultInjector` before touching the network. Tests
and the `cli replicate-soak` driver inject drops, delays, duplicates
and partitions from a fixed seed, so a failing convergence run replays
byte-for-byte.

Partitions are DIRECTED internally: `partition(a, b)` cuts both
directions, `partition(a, b, oneway=True)` cuts only a→b — the
asymmetric case PR 2 documented as unsafe for TTL-delayed takeover (a
can't renew toward b, but b still hears a's claims). Per-link latency
(`set_link_latency`) adds a deterministic jittered sleep to one
direction, and per-host clock skew (`set_clock_skew`) is bookkept for
tests that reason about disagreeing lease-expiry clocks (`now(host)`).

Determinism contract: outcomes are drawn from one `random.Random(seed)`
in call order. Drive the mesh single-threaded (tests call
`probe_once()` / `run_round()` inline) and the fault schedule is exact;
under the threaded soak driver it is still seed-stable per
interleaving. Link-latency jitter draws happen only for links that
configured jitter, so enabling it on one link does not shift the
global drop/dup schedule of the others.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Set, Tuple


class FaultDrop(ConnectionError):
    """An injected drop — indistinguishable from a connection failure to
    the caller, on purpose: the retry/circuit machinery must treat
    injected and real faults identically."""


class FaultInjector:
    def __init__(self, seed: int = 0, drop_rate: float = 0.0,
                 dup_rate: float = 0.0, delay_rate: float = 0.0,
                 max_delay_s: float = 0.0) -> None:
        self.rng = random.Random(seed)
        self.drop_rate = drop_rate
        self.dup_rate = dup_rate
        self.delay_rate = delay_rate
        self.max_delay_s = max_delay_s
        # directed edges: (src, dst) blocked
        self._partitions: Set[Tuple[str, str]] = set()
        # (src, dst) -> (latency_s, jitter_s)
        self._link_latency: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._clock_skew: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "drops": 0, "delays": 0, "dups": 0, "partition_blocks": 0,
            "link_delays": 0}

    # ---- partitions ------------------------------------------------------

    def partition(self, a: str, b: str, oneway: bool = False) -> None:
        """Cut the link a→b; both directions unless `oneway` (the
        asymmetric-partition case quorum must survive)."""
        with self._lock:
            self._partitions.add((a, b))
            if not oneway:
                self._partitions.add((b, a))

    def heal(self, a: str = None, b: str = None) -> None:
        """Heal one link (both directions) or every partition (no
        args)."""
        with self._lock:
            if a is None:
                self._partitions.clear()
            else:
                self._partitions.discard((a, b))
                self._partitions.discard((b, a))

    def partitioned(self, a: str, b: str) -> bool:
        """Is the DIRECTED link a→b cut?"""
        with self._lock:
            return (a, b) in self._partitions

    # ---- per-link latency / clock skew -----------------------------------

    def set_link_latency(self, src: str, dst: str, latency_s: float,
                         jitter_s: float = 0.0) -> None:
        """Add `latency_s` (+ uniform jitter in [0, jitter_s)) of sleep
        to every src→dst call. Directed — model an asymmetric slow
        link by setting only one direction. Zero both to clear."""
        with self._lock:
            if latency_s <= 0.0 and jitter_s <= 0.0:
                self._link_latency.pop((src, dst), None)
            else:
                self._link_latency[(src, dst)] = (max(latency_s, 0.0),
                                                  max(jitter_s, 0.0))

    def set_clock_skew(self, host: str, skew_s: float) -> None:
        """Bookkeep a per-host clock skew. Nothing in the mesh reads
        wall clocks cross-host (lease TTLs are local monotonic), so
        skew does not alter the fault schedule — tests use `now(host)`
        to model hosts disagreeing about lease expiry."""
        with self._lock:
            if skew_s == 0.0:
                self._clock_skew.pop(host, None)
            else:
                self._clock_skew[host] = float(skew_s)

    def now(self, host: str) -> float:
        """This host's (skewed) view of the monotonic clock."""
        with self._lock:
            return time.monotonic() + self._clock_skew.get(host, 0.0)

    # ---- call-site hook --------------------------------------------------

    def before_call(self, src: str, dst: str) -> bool:
        """Run the fault schedule for one outbound call. Raises
        `FaultDrop` for a drop/partition, sleeps for a delay, and
        returns True when the call should be DUPLICATED (sent twice;
        peer endpoints are idempotent, so dups must be harmless)."""
        if self.partitioned(src, dst):
            with self._lock:
                self.counters["partition_blocks"] += 1
            raise FaultDrop(f"partitioned: {src} -> {dst}")
        with self._lock:
            # one rng draw per configured fault class, in fixed order,
            # so enabling delays does not shift the drop schedule
            drop = self.drop_rate and self.rng.random() < self.drop_rate
            delay = (self.delay_rate
                     and self.rng.random() < self.delay_rate)
            dup = self.dup_rate and self.rng.random() < self.dup_rate
            delay_s = (self.rng.random() * self.max_delay_s
                       if delay else 0.0)
            link = self._link_latency.get((src, dst))
            if link is not None and not drop:
                base, jitter = link
                delay_s += base + (self.rng.random() * jitter
                                   if jitter else 0.0)
                self.counters["link_delays"] += 1
            if drop:
                self.counters["drops"] += 1
            elif delay:
                self.counters["delays"] += 1
            if not drop and dup:
                self.counters["dups"] += 1
        if drop:
            raise FaultDrop(f"injected drop: {src} -> {dst}")
        if delay_s:
            time.sleep(delay_s)
        return bool(not drop and dup)

    def snapshot(self) -> dict:
        with self._lock:
            # a pair is "oneway" when its reverse edge is not also cut
            oneway = sorted(
                [src, dst] for (src, dst) in self._partitions
                if (dst, src) not in self._partitions)
            return {"partitions": sorted(
                        [src, dst] for (src, dst) in self._partitions),
                    "oneway_partitions": oneway,
                    "link_latency": {
                        f"{s}->{d}": {"latency_s": lat,
                                      "jitter_s": jit}
                        for (s, d), (lat, jit) in
                        sorted(self._link_latency.items())},
                    "clock_skew": dict(sorted(
                        self._clock_skew.items())),
                    **self.counters}
