"""JSON-exportable scheduler metrics.

The JAX package's `serve/metrics.py` `ServeMetrics`, copied for the
layers the port has: plain host-side counters, so recording a sample never
touches the device. The residency tier's `hydration` block (the JAX
package's `HYDRATION_KEYS`, copied) and its cold-start histogram are in,
and so is the obs layer's wiring (`MergeScheduler.attach_obs`): the flight
recorder (`recorder`, a `queue_bound_violation` event) and the live
time-series double-writes (`ts`: `serve.<counter>`, `serve.flush`,
`serve.flushed_ops`, `serve.queue_wait`, `serve.xform_device_docs`,
`serve.hydration.<event>`, `serve.hydration_cold_start`), which the QoS
controller and the SLO engine read, and the follower-read tier's `read`
block (`read.attach_follower_reads` wires `read`, a `ReadMetrics`; null
until then). Left out: the Pallas-rung fallback counter (the port has no
Pallas rung).

Port-only since version 5: the flush's phases (`FLUSH_PHASES`), timed
inside every bank flush by a `FlushClock` and recorded once a flush
(`record_phases`); the oplog lock's wait and holds at the bank's three
acquisitions; and the wait from admit to flush start (`admit_wait`). A
phase's seconds are wall time on the flushing thread, waits for the
interpreter (GIL) included: what the flush pays, not what it computes.
`per_shard` `flush_wall_s` (every phase) and `device_sync_s` (the fence)
are derived from the phase counters. Since version 6: the transform
block's `linearized_kernel` and `linearized_plain`, resolve calls by the
linearizer they ran (the linearize kernel on a card, or the plain chain
on the CPU). Since version 7: the zone-session bank's `zone` block
(`ZONE_COUNTS`, `gpu/zone_session.py`: syncs continued and resynced,
resyncs by cause, X8 launches and the launched tapes' shapes; all zero on
the fused engine) and the zone sync's three phases. Since version 8:
the residency tier's phases (`build`, a session build inside a flush;
`gate`, the hydration gate with its inline hydrations) and its own block,
`residency` (`RESIDENCY_TIMERS`: the durable homes' loads and saves and
the oplog lock held inside a save, seconds and counts on `perf_counter`,
fed by `storage/tier.py` `TieredStore` through `record_residency`; zero
until a Hydrator is attached).

Schema (snapshot()):

  {"version": 7, "uptime_s": s, "shards": N, "flush_docs": B,
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
                 "linearized_kernel",         # resolves by linearizer
                 "linearized_plain",
                 "device_ratio"},             # device tail planning
   "hydration": {"prefetches", "warm_hits", "hydrations", ...},
                                    # the residency tier (HYDRATION_KEYS;
                                    # all zero until a Hydrator is attached)
   "read": {...} | null,            # ReadMetrics.snapshot() once a
                                    # ReadPath is attached
   "flush_phases": {"seconds": {<FLUSH_PHASES>: s},  # over shards
                    "count": {<FLUSH_PHASES>: n},    # flushes timing it
                    "oplog_wait_s": s,   # blocked before taking the lock
                    "oplog_hold_s": s, "oplog_holds": n},
   "zone": {<ZONE_COUNTS>: n},      # zone sessions (record_zone)
   "residency": {"load_s", "loads", "save_s", "saves",
                 "save_hold_s", "save_holds"},   # RESIDENCY_TIMERS
   "max_depth_seen": d,
   "queue_bound_violations": 0,     # depth observed above max_pending
   "latencies": {"flush": hist,     # obs.hist snapshot w/ p50/p90/p99
                 "queue_wait": hist,             # admit -> commit
                 "hydration_cold_start": hist,   # prefetch/miss -> warm
                 "oplog_hold": hist,             # one sample a hold
                 "admit_wait": hist},            # admit -> flush start
   "per_shard": [{"shard", "queue_depth", "footprint_slots",
                  "flush_wall_s",                # sum of its phases
                  "device_sync_s",               # its fence phase
                  <totals' keys>}, ...]}
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..gpu.zone_session import ZONE_COUNTS
from ..obs.hist import Histogram
from ..obs.trace import NOOP_SPAN

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


# the counters `record_transform` takes: per-document planning outcomes,
# resolve calls (`batches`), and resolve calls by the linearizer they ran
# (`linearized_<path>` for each of LINEARIZE_PATHS: the linearize kernel,
# or the plain chain)
LINEARIZE_PATHS = ("kernel", "plain")
TRANSFORM_KEYS = ("device_docs", "host_docs", "fallbacks", "batches") \
    + tuple(f"linearized_{p}" for p in LINEARIZE_PATHS)


# the phases of one bank flush, in the order a flush runs them:
#   extract  resolve the oplogs, get or build each session, take each tail
#            (`xform.extract_tail` / `plan_tail`), under the oplog lock
#   resolve  the device plan: linearisation and K2 (`resolve_windows`)
#   plan     group the plans by (cap, max_ins), under the oplog lock
#   pack     pack each fused group and enqueue K1, up to the fence
#   fence    the length fetch that completes the replay
#   adopt    commit the fenced rows, count syncs, evict failed rows
#   serial   the per-doc rung for items that could not fuse (its own
#            pack and fence count here, not above); on the zone engine
#            every item, less the zone phases below
#   zone_compose  a zone sync's entries composed, packed and filled into
#            its micro-tape (`DeviceZoneSession.sync`)
#   zone_tape     the micro-tape's and the new slots' keys' upload and
#            the X8 launch
#   zone_resync   a zone session's rebuild: `prepare_zone`, the rebuild
#            tape and its launch
#   build    a session built inside a flush (`SessionBank.session` on a
#            miss: the evictions that make room and the build), carved out
#            of the phase it interrupts (`extract`, or `serial`)
#   gate     the residency tier's flush gate (`Hydrator.flush_gate`, its
#            inline hydrations included), before the flush proper; timed
#            only with a Hydrator attached
# The wait to take the oplog lock is in no phase (`oplog_wait_s`).
FLUSH_PHASES = ("extract", "resolve", "plan", "pack", "fence", "adopt",
                "serial", "zone_compose", "zone_tape", "zone_resync",
                "build", "gate")
_SPAN_NAMES = {p: f"bank.{p}" for p in FLUSH_PHASES}

# the residency tier's timers (`storage/tier.py` `TieredStore` records them
# through `record_residency`): a home's load, a save, and the oplog lock
# held inside a save (the unsaved suffix's encode)
RESIDENCY_TIMERS = ("load", "save", "save_hold")


class FlushClock:
    """One flush's phase timer on `time.perf_counter()`: `enter_phase(p)`
    ends the running phase and starts `p` (None: no phase runs), so phases
    never nest and every second between two calls belongs to one phase.
    `oplog(lock)` takes the oplog lock with its wait in no phase, and
    keeps each hold's seconds (`oplog_holds`).

    With a tracer and a parent span context (a traced flush) each stretch
    of a phase is also a leaf span `bank.<phase>` under that parent, with
    `attrs` (shard or shards, docs). With no parent it opens no span and
    allocates none: a phase costs one branch."""

    __slots__ = ("seconds", "oplog_wait_s", "oplog_holds", "_tracer",
                 "_parent", "_attrs", "_phase", "_t", "_span")

    def __init__(self, tracer=None, parent=None,
                 attrs: Optional[dict] = None) -> None:
        self.seconds: Dict[str, float] = dict.fromkeys(FLUSH_PHASES, 0.0)
        self.oplog_wait_s = 0.0
        self.oplog_holds: List[float] = []
        self._tracer = tracer
        self._parent = parent if tracer is not None else None
        self._attrs = attrs
        self._phase: Optional[str] = None
        self._t = 0.0
        self._span = NOOP_SPAN

    def enter_phase(self, phase: Optional[str]) -> Optional[str]:
        """End the running phase and start `phase`; returns the phase that
        was running, so a phase that interrupts another can hand back."""
        prev = self._phase
        if phase == prev:
            return prev
        now = time.perf_counter()
        if self._phase is not None:
            self.seconds[self._phase] += now - self._t
        self._span.end()
        self._phase, self._t = phase, now
        if phase is None or self._parent is None:
            self._span = NOOP_SPAN
        else:
            self._span = self._tracer.start(_SPAN_NAMES[phase],
                                            parent=self._parent,
                                            attrs=self._attrs)
        return prev

    def end(self) -> None:
        """Stop the running phase."""
        self.enter_phase(None)

    def share(self, other: "FlushClock", fraction: float) -> None:
        """Add `fraction` of `other`'s phase seconds to this clock's (the
        flush window's shared phases, split over its shards)."""
        for p, s in other.seconds.items():
            self.seconds[p] += s * fraction

    @contextlib.contextmanager
    def oplog(self, lock):
        """Hold the oplog lock `lock` inside the running phase: the wait to
        take it counts in `oplog_wait_s`, not in the phase, and the hold
        is one entry of `oplog_holds`. None, or no real lock
        (`contextlib.nullcontext`), is held untimed."""
        if lock is None or isinstance(lock, contextlib.nullcontext):
            yield
            return
        phase = self._phase
        self.enter_phase(None)
        t0 = time.perf_counter()
        with lock:
            t1 = time.perf_counter()
            self.oplog_wait_s += t1 - t0
            self.enter_phase(phase)
            try:
                yield
            finally:
                self.oplog_holds.append(time.perf_counter() - t1)


class ServeMetrics:
    # the port's own counter-set version; bump whenever it changes
    # (2: the flush window's super-batch and staging fields; 3: the
    # residency tier's `hydration` block and
    # `latencies.hydration_cold_start`; 4: the follower-read `read` block;
    # 5: the `flush_phases` block, `latencies.oplog_hold` and
    # `latencies.admit_wait`, per_shard times derived from the phases;
    # 6: the transform block's `linearized_kernel` and `linearized_plain`;
    # 7: the `zone` block and the zone sync's phases; 8: the `build` and
    # `gate` phases and the `residency` block)
    SCHEMA_VERSION = 8

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
        self.xform_linearized = dict.fromkeys(LINEARIZE_PATHS, 0)
        self.max_depth_seen = 0
        self.queue_bound_violations = 0
        self.queue_depth: List[int] = [0] * n_shards
        self.footprint_slots: List[int] = [0] * n_shards
        # residency tier (serve.hydrate.Hydrator via attach_hydrator)
        self.hydration: Dict[str, int] = {k: 0 for k in HYDRATION_KEYS}
        self.cold_start_latency = Histogram()
        self.flush_latency = Histogram()
        self.queue_wait_latency = Histogram()
        self.oplog_hold_latency = Histogram()
        self.admit_wait_latency = Histogram()
        # follower-read tier (read/metrics.py ReadMetrics), wired by
        # read.attach_follower_reads; the `read` block is its snapshot,
        # null until a ReadPath is attached
        self.read = None
        # the flush's phases (record_phases): seconds and flushes that
        # timed each, per shard; the oplog lock's wait and holds
        self.phase_s: List[Dict[str, float]] = [
            dict.fromkeys(FLUSH_PHASES, 0.0) for _ in range(n_shards)]
        self.phase_n: List[Dict[str, int]] = [
            dict.fromkeys(FLUSH_PHASES, 0) for _ in range(n_shards)]
        self.oplog_wait_s = 0.0
        self.oplog_hold_s = 0.0
        self.oplog_holds = 0
        # the zone-session bank's counters (record_zone)
        self.zone: Dict[str, int] = dict.fromkeys(ZONE_COUNTS, 0)
        # the residency tier's timers (record_residency)
        self.residency_s: Dict[str, float] = dict.fromkeys(
            RESIDENCY_TIMERS, 0.0)
        self.residency_n: Dict[str, int] = dict.fromkeys(
            RESIDENCY_TIMERS, 0)
        # obs.recorder.FlightRecorder, wired by
        # MergeScheduler.attach_obs; only rare events touch it
        self.recorder = None
        # live-telemetry tier (obs/timeseries.py TimeSeries), wired by
        # MergeScheduler.attach_obs; None (or disabled) => every
        # double-write below is a single branch, no allocation
        self.ts = None

    # ---- recording -------------------------------------------------------

    def bump(self, shard: int, key: str, n: int = 1) -> None:
        with self._lock:
            self.shard[shard][key] += n
        if self.ts is not None:
            self.ts.inc(f"serve.{key}", n)

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
        if self.ts is not None:
            self.ts.observe("serve.flush", dur_s)
            self.ts.inc("serve.flushed_ops", n_ops)

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
                         batches: int = 0, linearized_kernel: int = 0,
                         linearized_plain: int = 0) -> None:
        """One bucket's device-transform planning outcome: how many tails
        resolved their merge positions on the device vs. fell to the host
        tracker walk; resolve calls, and those calls by the linearizer
        they ran."""
        with self._lock:
            self.xform_device_docs += device_docs
            self.xform_host_docs += host_docs
            self.xform_fallbacks += fallbacks
            self.xform_batches += batches
            self.xform_linearized["kernel"] += linearized_kernel
            self.xform_linearized["plain"] += linearized_plain
        if self.ts is not None and device_docs:
            self.ts.inc("serve.xform_device_docs", device_docs)

    def record_phases(self, shard: int, phases: Dict[str, float],
                      oplog_wait_s: float = 0.0,
                      oplog_holds: Sequence[float] = ()) -> None:
        """One flush's phase seconds (FLUSH_PHASES keys; a phase that took
        no time is not counted as run), the wait for the oplog lock, and
        each hold of it (one `latencies.oplog_hold` sample a hold)."""
        with self._lock:
            s, n = self.phase_s[shard], self.phase_n[shard]
            for p, sec in phases.items():
                if sec > 0.0:
                    s[p] += sec
                    n[p] += 1
            self.oplog_wait_s += oplog_wait_s
            self.oplog_hold_s += sum(oplog_holds)
            self.oplog_holds += len(oplog_holds)
        for h in oplog_holds:
            self.oplog_hold_latency.record(h)

    def record_zone(self, shard: int, counts: Dict[str, int]) -> None:
        """A zone session's counters since its last take (`ZONE_COUNTS`
        keys; `DeviceZoneSession.take_counts`), added to the `zone`
        block; an undeclared key raises."""
        with self._lock:
            z = self.zone
            for k, n in counts.items():
                z[k] += n

    def record_residency(self, timer: str, seconds: float) -> None:
        """One timed step of the residency tier (a `RESIDENCY_TIMERS` key:
        a home's load, a save, the oplog lock held inside a save); an
        undeclared key raises."""
        with self._lock:
            self.residency_s[timer] += seconds
            self.residency_n[timer] += 1

    def observe_queue(self, shard: int, depth: int) -> None:
        with self._lock:
            self.queue_depth[shard] = depth
            if depth > self.max_depth_seen:
                self.max_depth_seen = depth
            violated = depth > self.max_pending
            if violated:
                # must stay 0: the bounded-queue contract (admission
                # raises Backpressure before this point)
                self.queue_bound_violations += 1
        if violated and self.recorder is not None:
            self.recorder.record("queue_bound_violation", shard=shard,
                                 depth=depth,
                                 max_pending=self.max_pending)

    def observe_footprint(self, shard: int, slots: int) -> None:
        with self._lock:
            self.footprint_slots[shard] = int(slots)

    def record_hydration(self, event: str, n: int = 1) -> None:
        """One residency-tier event (a HYDRATION_KEYS key). Unknown
        keys are created rather than dropped."""
        with self._lock:
            self.hydration[event] = self.hydration.get(event, 0) + n
        if self.ts is not None:
            self.ts.inc(f"serve.hydration.{event}", n)

    def observe_cold_start(self, dur_s: float) -> None:
        """Cold-start latency: prefetch enqueue (or resolve miss) to
        warm install. The histogram has its own lock."""
        self.cold_start_latency.record(dur_s)
        if self.ts is not None:
            self.ts.observe("serve.hydration_cold_start", dur_s)

    def observe_queue_wait(self, dur_s: float) -> None:
        """Admit (or coalesce origin) -> commit for one queued merge:
        recorded once its flush has ended, so it spans the wait in the
        queue and the flush."""
        self.queue_wait_latency.record(dur_s)
        if self.ts is not None:
            self.ts.observe("serve.queue_wait", dur_s)

    def observe_admit_wait(self, dur_s: float) -> None:
        """Admit (or coalesce origin) -> flush start for one queued merge:
        the wait in the queue alone, what the admission deadline costs."""
        self.admit_wait_latency.record(dur_s)

    # ---- export ----------------------------------------------------------

    def snapshot(self) -> dict:
        # the histograms have their own locks: snapshot them before
        # taking ours (never nest)
        flush_hist = self.flush_latency.snapshot()
        queue_wait_hist = self.queue_wait_latency.snapshot()
        cold_hist = self.cold_start_latency.snapshot()
        hold_hist = self.oplog_hold_latency.snapshot()
        admit_hist = self.admit_wait_latency.snapshot()
        read_snap = self.read.snapshot() if self.read is not None else None
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
                    **{f"linearized_{p}": v
                       for p, v in self.xform_linearized.items()},
                    "device_ratio": round(
                        self.xform_device_docs
                        / max(self.xform_device_docs + self.xform_host_docs
                              + self.xform_fallbacks, 1), 4),
                },
                "hydration": dict(self.hydration),
                "read": read_snap,
                "flush_phases": {
                    "seconds": {p: round(sum(s[p] for s in self.phase_s),
                                         6) for p in FLUSH_PHASES},
                    "count": {p: sum(n[p] for n in self.phase_n)
                              for p in FLUSH_PHASES},
                    "oplog_wait_s": round(self.oplog_wait_s, 6),
                    "oplog_hold_s": round(self.oplog_hold_s, 6),
                    "oplog_holds": self.oplog_holds,
                },
                "zone": dict(self.zone),
                "residency": {
                    k: v for t in RESIDENCY_TIMERS
                    for k, v in ((f"{t}_s", round(self.residency_s[t], 6)),
                                 (f"{t}s", self.residency_n[t]))},
                "max_depth_seen": self.max_depth_seen,
                "queue_bound_violations": self.queue_bound_violations,
                "latencies": {"flush": flush_hist,
                              "queue_wait": queue_wait_hist,
                              "hydration_cold_start": cold_hist,
                              "oplog_hold": hold_hist,
                              "admit_wait": admit_hist},
                "per_shard": [
                    {"shard": i, "queue_depth": self.queue_depth[i],
                     "footprint_slots": self.footprint_slots[i],
                     "flush_wall_s": round(
                         sum(self.phase_s[i].values()), 6),
                     "device_sync_s": round(self.phase_s[i]["fence"], 6),
                     **self.shard[i]}
                    for i in range(self.n_shards)],
            }
