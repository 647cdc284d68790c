"""JSON-exportable scheduler metrics.

The JAX package's `serve/metrics.py` `ServeMetrics`, copied for the
layers the port has: plain host-side counters, so recording a sample never
touches the device. The residency tier's `hydration` block (the JAX
package's `HYDRATION_KEYS`, copied) and its cold-start histogram are in.
Left out until their layers are ported: the follower-read `read` block,
the Pallas-rung fallback counter, and the obs layer's flight recorder and
time-series double-writes.

Schema (snapshot()):

  {"version": 3, "uptime_s": s, "shards": N, "flush_docs": B,
   "max_pending": P,
   "totals": {"submits", "coalesced", "rejects", "denied", "fenced",
              "flushes", "flushed_docs", "flushed_ops", "builds",
              "evictions", "resyncs", "syncs", "host_fallbacks",
              "fused_calls", "fused_docs"},
   "batch_occupancy": mean(flush size) / flush_docs,   # 0..1
   "host_fallback_ratio": host_fallbacks / max(syncs, 1),
   "flush_reasons": {"size": n, "deadline": n, "force": n, "read": n},
   "flush_size_hist": {"1": n, "2": n, ...},
   "fused": {"device_calls", "docs",          # fused bucket replays
             "occupancy",                     # docs per device call
             "occupancy_hist": {"2": n, ...}},
   "window": {"windows", "device_windows", "dispatches",
              "device_calls_per_window", "docs",
              "mesh_docs", "mesh_padded_rows",  # flush-window rows
              "mesh_occupancy",               # docs / padded rows
              "staged_bytes",                 # host->device, windows
              "staged_bytes_per_window",
              "shards_hist": {"2": n, ...}},  # shards per window
   "transform": {"device_docs", "host_docs", "fallbacks", "batches",
                 "device_ratio"},             # device tail planning
   "hydration": {"prefetches", "warm_hits", "hydrations", ...},
                                    # the residency tier (HYDRATION_KEYS;
                                    # all zero until a Hydrator is attached)
   "max_depth_seen": d,
   "queue_bound_violations": 0,     # depth observed above max_pending
   "latencies": {"flush": hist,     # obs.hist snapshot w/ p50/p90/p99
                 "queue_wait": hist,             # admit -> flush start
                 "hydration_cold_start": hist},  # prefetch/miss -> warm
   "per_shard": [{"shard", "queue_depth", "footprint_slots",
                  "flush_wall_s", "device_sync_s", <totals' keys>}, ...]}
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from ..obs.hist import Histogram

_SHARD_KEYS = ("submits", "coalesced", "rejects", "denied", "fenced",
               "flushes", "flushed_docs", "flushed_ops", "builds",
               "evictions", "resyncs", "syncs", "host_fallbacks",
               "fused_calls", "fused_docs")

# the residency tier's counter set (serve.hydrate.Hydrator feeds these
# through record_hydration; hydrate.py imports the tuple so the two
# surfaces can never drift)
HYDRATION_KEYS = (
    "prefetches",           # async hydrations queued on first admit
    "warm_hits",            # resolve served from the warm map
    "hydrations",           # cold -> warm installs (async + sync)
    "sync_hydrations",      # resolve cold misses hydrated inline
    "attempts", "retries",  # load attempts / attempts after the first
    "timeouts",             # per-attempt HydrationTimeouts
    "load_errors",          # unexpected load exceptions (transient)
    "hydrate_gave_up",      # async ladder exhausted; doc left cold
    "quarantined",          # docs the HYDRATOR quarantined
    "quarantined_drops",    # flush-gate drops of quarantined docs
    "deferrals",            # cold docs requeued for a delayed flush
    "defer_escalations",    # 2nd gate visit: hydrated sync in-flush
    "defer_gave_up",        # defer budget exhausted -> quarantined
    "deferred_drops",       # deferral requeue hit backpressure
    "prefetch_queue_full",  # prefetch rejected, bounded queue full
    "flush_leaks",          # resolve raised INSIDE a batch (must be 0)
    "snapshot_requests",    # bank eviction hook enqueues
    "snapshots",            # successful doc-file persists
    "snapshot_queue_full",  # hook enqueue rejected
    "snapshot_errors",      # persist failed (doc stays warm)
    "evictions_to_snapshot",  # warm evictions that saved first
    "eviction_aborts",      # eviction raced a resolve; doc kept warm
    "spills_to_snapshot",   # device-tier spills: warm state persisted
                            # to the snapshot home under bank/warm-map
                            # pressure (eviction + bank-evict persists)
    "spill_bytes",          # on-disk bytes those spills wrote (home
                            # file growth, clamped at 0 per spill —
                            # compaction can shrink the home)
    "remote_fills",         # cold misses whose empty home was filled
                            # from a peer's snapshot frame (wire tier)
    "remote_fill_errors",   # remote snapshot fetch/apply failures
                            # (doc stays a legitimate fresh-empty doc)
)


class ServeMetrics:
    # the port's own counter-set version; bump whenever it changes
    # (2: the flush window's super-batch and staging fields; 3: the
    # residency tier's `hydration` block and
    # `latencies.hydration_cold_start`)
    SCHEMA_VERSION = 3

    def __init__(self, n_shards: int, flush_docs: int,
                 max_pending: int) -> None:
        self.n_shards = n_shards
        self.flush_docs = flush_docs
        self.max_pending = max_pending
        self.started_at = time.monotonic()
        # flush recording happens OUTSIDE the scheduler's global lock
        # (per-shard flush locks); counters get their own lock
        self._lock = threading.Lock()
        self.shard: List[Dict[str, int]] = [
            {k: 0 for k in _SHARD_KEYS} for _ in range(n_shards)]
        self.flush_reasons: Dict[str, int] = {}
        self.flush_size_hist: Dict[int, int] = {}
        self.fused_occupancy_hist: Dict[int, int] = {}
        # flush-window dispatch accounting (scheduler-level)
        self.windows = 0             # pump rounds that took >= 1 bucket
        self.device_windows = 0      # windows issuing >= 1 dispatch
        self.window_dispatches = 0   # window replays / worker handoffs
        self.window_docs = 0
        self.mesh_docs = 0           # docs replayed by the flush window
        self.mesh_padded_rows = 0    # its launched rows, padding included
        self.window_staged_bytes = 0  # host->device bytes it staged
        self.window_shards_hist: Dict[int, int] = {}
        # device-transform planning accounting (scheduler-level: the
        # batched dispatch is shared across a bucket)
        self.xform_device_docs = 0   # tails planned by the device xform
        self.xform_host_docs = 0     # tails the extractor host-planned
        self.xform_fallbacks = 0     # device cross-check -> host re-plan
        self.xform_batches = 0       # batched xform dispatches
        self.max_depth_seen = 0
        self.queue_bound_violations = 0
        self.queue_depth: List[int] = [0] * n_shards
        self.footprint_slots: List[int] = [0] * n_shards
        # residency tier (serve.hydrate.Hydrator via attach_hydrator)
        self.hydration: Dict[str, int] = {k: 0 for k in HYDRATION_KEYS}
        self.cold_start_latency = Histogram()
        self.flush_latency = Histogram()
        self.queue_wait_latency = Histogram()
        self.flush_wall_s: List[float] = [0.0] * n_shards
        self.device_sync_s: List[float] = [0.0] * n_shards

    # ---- recording -------------------------------------------------------

    def bump(self, shard: int, key: str, n: int = 1) -> None:
        with self._lock:
            self.shard[shard][key] += n

    def record_flush(self, shard: int, n_docs: int, n_ops: int,
                     reason: str, dur_s: float = 0.0) -> None:
        with self._lock:
            c = self.shard[shard]
            c["flushes"] += 1
            c["flushed_docs"] += n_docs
            c["flushed_ops"] += n_ops
            self.flush_reasons[reason] = \
                self.flush_reasons.get(reason, 0) + 1
            self.flush_size_hist[n_docs] = \
                self.flush_size_hist.get(n_docs, 0) + 1
        # histogram carries its own lock; record outside ours
        self.flush_latency.record(dur_s)

    def record_fused(self, shard: int, n_docs: int) -> None:
        """One fused bucket replay: `n_docs` documents folded into a
        single device call (the occupancy histogram is the arithmetic-
        intensity signal the fused flush exists to raise)."""
        with self._lock:
            c = self.shard[shard]
            c["fused_calls"] += 1
            c["fused_docs"] += n_docs
            self.fused_occupancy_hist[n_docs] = \
                self.fused_occupancy_hist.get(n_docs, 0) + 1

    def record_window(self, dispatches: int, n_docs: int,
                      n_shards: int, mesh_docs: int = 0,
                      padded_rows: int = 0, staged_bytes: int = 0) -> None:
        """One pump round: `dispatches` flush-window replays (one per
        (cap, max_ins) class) or per-shard worker handoffs (inline
        flushes) covering `n_docs` docs across `n_shards` shards. The
        flush window also gives the docs it replayed, the rows it
        launched (padding included) and the host->device bytes it staged.
        `device_calls_per_window` in the snapshot is dispatches / windows
        with device work."""
        with self._lock:
            self.windows += 1
            if dispatches > 0:
                self.device_windows += 1
            self.window_dispatches += dispatches
            self.window_docs += n_docs
            self.mesh_docs += mesh_docs
            self.mesh_padded_rows += padded_rows
            self.window_staged_bytes += staged_bytes
            self.window_shards_hist[n_shards] = \
                self.window_shards_hist.get(n_shards, 0) + 1

    def record_transform(self, shard: int, device_docs: int = 0,
                         host_docs: int = 0, fallbacks: int = 0,
                         batches: int = 0) -> None:
        """One bucket's device-transform planning outcome: how many tails
        resolved their merge positions on the device vs. fell to the host
        tracker walk."""
        with self._lock:
            self.xform_device_docs += device_docs
            self.xform_host_docs += host_docs
            self.xform_fallbacks += fallbacks
            self.xform_batches += batches

    def observe_device_time(self, shard: int, wall_s: float,
                            device_s: float) -> None:
        """Per-shard wall vs. fence (blocked on the device) seconds for
        one replay."""
        with self._lock:
            self.flush_wall_s[shard] += wall_s
            self.device_sync_s[shard] += device_s

    def observe_queue(self, shard: int, depth: int) -> None:
        with self._lock:
            self.queue_depth[shard] = depth
            if depth > self.max_depth_seen:
                self.max_depth_seen = depth
            if depth > self.max_pending:
                # must stay 0: the bounded-queue contract (admission
                # raises Backpressure before this point)
                self.queue_bound_violations += 1

    def observe_footprint(self, shard: int, slots: int) -> None:
        with self._lock:
            self.footprint_slots[shard] = int(slots)

    def record_hydration(self, event: str, n: int = 1) -> None:
        """One residency-tier event (a HYDRATION_KEYS key). Unknown
        keys are created rather than dropped."""
        with self._lock:
            self.hydration[event] = self.hydration.get(event, 0) + n

    def observe_cold_start(self, dur_s: float) -> None:
        """Cold-start latency: prefetch enqueue (or resolve miss) to
        warm install. The histogram has its own lock."""
        self.cold_start_latency.record(dur_s)

    def observe_queue_wait(self, dur_s: float) -> None:
        """Admit (or coalesce origin) -> flush-start wait for one queued
        merge."""
        self.queue_wait_latency.record(dur_s)

    # ---- export ----------------------------------------------------------

    def snapshot(self) -> dict:
        # the histograms have their own locks: snapshot them before
        # taking ours (never nest)
        flush_hist = self.flush_latency.snapshot()
        queue_wait_hist = self.queue_wait_latency.snapshot()
        cold_hist = self.cold_start_latency.snapshot()
        with self._lock:
            totals = {k: sum(s[k] for s in self.shard)
                      for k in _SHARD_KEYS}
            flushes = max(totals["flushes"], 1)
            occupancy = (totals["flushed_docs"] / flushes) \
                / self.flush_docs
            return {
                "version": self.SCHEMA_VERSION,
                "uptime_s": round(time.monotonic() - self.started_at, 3),
                "shards": self.n_shards,
                "flush_docs": self.flush_docs,
                "max_pending": self.max_pending,
                "totals": totals,
                "batch_occupancy": round(occupancy, 4),
                "host_fallback_ratio": round(
                    totals["host_fallbacks"] / max(totals["syncs"], 1), 4),
                "flush_reasons": dict(self.flush_reasons),
                "flush_size_hist": {str(k): v for k, v in
                                    sorted(self.flush_size_hist.items())},
                "fused": {
                    "device_calls": totals["fused_calls"],
                    "docs": totals["fused_docs"],
                    "occupancy": round(
                        totals["fused_docs"]
                        / max(totals["fused_calls"], 1), 4),
                    "occupancy_hist": {
                        str(k): v for k, v in
                        sorted(self.fused_occupancy_hist.items())},
                },
                "window": {
                    "windows": self.windows,
                    "device_windows": self.device_windows,
                    "dispatches": self.window_dispatches,
                    "device_calls_per_window": round(
                        self.window_dispatches
                        / max(self.device_windows, 1), 4),
                    "docs": self.window_docs,
                    "mesh_docs": self.mesh_docs,
                    "mesh_padded_rows": self.mesh_padded_rows,
                    "mesh_occupancy": round(
                        self.mesh_docs
                        / max(self.mesh_padded_rows, 1), 4),
                    "staged_bytes": self.window_staged_bytes,
                    "staged_bytes_per_window": round(
                        self.window_staged_bytes
                        / max(self.device_windows, 1), 2),
                    "shards_hist": {
                        str(k): v for k, v in
                        sorted(self.window_shards_hist.items())},
                },
                "transform": {
                    "device_docs": self.xform_device_docs,
                    "host_docs": self.xform_host_docs,
                    "fallbacks": self.xform_fallbacks,
                    "batches": self.xform_batches,
                    "device_ratio": round(
                        self.xform_device_docs
                        / max(self.xform_device_docs + self.xform_host_docs
                              + self.xform_fallbacks, 1), 4),
                },
                "hydration": dict(self.hydration),
                "max_depth_seen": self.max_depth_seen,
                "queue_bound_violations": self.queue_bound_violations,
                "latencies": {"flush": flush_hist,
                              "queue_wait": queue_wait_hist,
                              "hydration_cold_start": cold_hist},
                "per_shard": [
                    {"shard": i, "queue_depth": self.queue_depth[i],
                     "footprint_slots": self.footprint_slots[i],
                     "flush_wall_s": round(self.flush_wall_s[i], 6),
                     "device_sync_s": round(self.device_sync_s[i], 6),
                     **self.shard[i]}
                    for i in range(self.n_shards)],
            }
