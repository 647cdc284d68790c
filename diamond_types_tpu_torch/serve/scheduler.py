"""The multi-document merge scheduler: router x admission x banks.

Port of the JAX package's `serve/scheduler.py`. A document edit lands as
`submit(doc_id, n_ops)`; the scheduler routes it to its shard, coalesces it
into a shape bucket, and `pump()` flushes due buckets into the shard's
session bank, where one flush replays the bucket's documents together
(one K1 launch per (cap, max_ins) group on a CUDA device).

Threading: the global `lock` guards router + queue mutation only; each
shard's bank has its own lock, so flushes run with the global lock
RELEASED and different shards flush concurrently. With
`flush_workers=True` (default) `pump()` only TAKES due buckets under the
global lock and hands them to per-shard worker threads; `drain()` waits
for the workers to go idle and `stop_workers()`/`stop_pump()` join them.
The lease-epoch recheck runs inside the worker (`_fence`), at merge time.

`sync_lock` is the OPLOG guard (e.g. DocStore.lock), held around host-side
oplog reads in the bank; device execution is guarded by a PER-DEVICE lock
(shards placed on the same card share one). Lock order is always
global → shard → sync(oplog) → device, never reversed. The global, shard
and device locks are witness locks (`analysis.witness.make_lock`) under
the JAX package's names, classes and ranks, so `witness_enable()` records
the lock-order graph the storage soak holds acyclic.

Faults are not swallowed: an exception in a flush (a kernel error, a
failed session build) propagates out of `pump()` inline; from a worker
thread or the background pump it is stored, and the next `drain()`,
`stop_workers()` or `stop_pump()` raises the first one stored. Only the
length fence sends a document to the host (`SessionBank`). Whoever
catches that raise, the scheduler keeps the first exception that escaped
a flush in `fault`, which is never cleared: the port's server answers
every request with 503 once it is set, and its replica node stops
(fail-stop), so a catch-all above a flush cannot hide a kernel fault.

Ownership gate: `admit(doc_id) -> bool` (cross-host replication) refuses
merge work for docs whose lease this host does not hold; with `epoch_of`
also set, each submit is stamped with its lease epoch and work whose lease
moved before the flush is dropped (`fenced`), its ops still durable in the
oplog.

Flush window (`mesh_window=True`): instead of one handoff per due
bucket, `pump()` folds EVERY due bucket of every shard into one window
(`_flush_window`) on the calling thread: one K1 launch per (cap, max_ins)
class and device, and one device resolve (K2) per device for the whole
window's tails. Its faults propagate the same way; there is no fallback
rung. The window, like `device_plan`, rides on the fused engine only.

Zone sessions (`fused=False` on the device engine): each shard's bank
keeps `DeviceZoneSession`s, and a flush syncs its bucket's documents one
by one, each continuing its resident carry with one X8 launch.

Residency tier (`attach_hydrator`, a `serve.hydrate.Hydrator`): `submit`
rejects a quarantined document and prefetches a document on its first
admit; both flush paths gate each taken bucket right after the lease
fence (`_hydration_gate`: warm docs flush, quarantined docs drop, cold
docs requeue for a later pump), resolve through `_flush_resolve` (which
counts a resolve that raises inside a batch as a flush leak), and every
bank eviction routes the doc to its snapshot. The Hydrator never touches
the device.

Adaptive admission (`attach_qos`, a `qos.QosController`): the queue's
deadline trigger reads the controller's published per-(shard, class)
deadlines, `submit` counts each admit in its class (the controller's
arrival rates), and `start_pump`/`stop_pump` start and stop the
controller's thread. The controller takes its telemetry from the
observability bundle (`attach_obs`, in either order), or from
`QosController.attach_obs(holder)`, any object with a `ts` time series.

Observability (`attach_obs`, an `obs.Observability` bundle): sampled
spans on the admit → flush → device-sync path (`serve.admit`,
`serve.ownership_gate`, `serve.flush`, `serve.device_sync`; in the window
`serve.mesh_window` and one `serve.mesh_dispatch` per class), the
journey's `queued` stamp at submit (the bank stamps the rest), a flush
exemplar when the flush rode a sampled trace, per-doc ops and device-time
attribution, the metrics' time-series double writes (`serve.flush` among
them, which the QoS controller and the SLO engine read) and the flight
recorder's rare events (fenced work, docs the hydration gate dropped,
evictions, fence failures). The window reports each class's replay to
`obs.devprof.PROFILER.observe_window`. With no bundle attached every
touchpoint is one attribute check.

Replication (`replicate.attach_replication`, as `tools/server.serve`
wires it): `admit` is the node's lease gate (`ReplicaNode.owns`) and
`epoch_of` its `active_epoch`, so a server merges only the documents whose
lease it holds, on the card, and drops work whose lease moved before the
flush.

Follower reads (`read.attach_follower_reads`): `read_invalidate` is the
read path's `on_flush`, called for every document a flush committed, on
the per-shard path and in the window, so the checkout cache drops the
document's entries.
"""

from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from ..analysis.witness import make_lock
from ..obs.devprof import PROFILER
from ..obs.trace import NOOP_SPAN
from ..parallel.mesh import (mesh_fused_replay, serve_mesh,
                             serve_shard_devices)
from ..qos.classes import QOS_PRIORITY
from .admission import AdmissionQueue, Backpressure
from .bank import SessionBank, resolve_windows
from .metrics import ServeMetrics
from .router import ShardRouter


class MergeScheduler:
    def __init__(self, n_shards: int,
                 resolve: Callable[[str], object],
                 engine: str = "device",
                 max_sessions_per_shard: int = 8,
                 max_slots_per_shard: int = 1 << 24,
                 max_pending: int = 256,
                 flush_docs: int = 8,
                 flush_deadline_s: float = 0.05,
                 place_on_devices: bool = False,
                 session_opts: Optional[dict] = None,
                 sync_lock=None,
                 admit: Optional[Callable[[str], bool]] = None,
                 fused: bool = True,
                 fused_opts: Optional[dict] = None,
                 flush_workers: bool = True,
                 warmup: bool = False,
                 mesh_window: bool = False,
                 device_plan: bool = False) -> None:
        """`resolve(doc_id) -> OpLog` is the document authority —
        DocStore.get fits directly; it is always called OUTSIDE
        `sync_lock`. `engine="device"` keeps each shard's sessions on
        `fused_opts["device"]` (`session_opts["device"]` with
        `fused=False`; None: CUDA, which must exist), or with
        `place_on_devices=True` shard i on `cuda:(i % device_count)`.
        `fused=False` on the device engine keeps zone sessions
        (`DeviceZoneSession`, options `session_opts`) and syncs each
        document of a flush on its own. `mesh_window=True` (fused device
        engine only) flushes through the window coordinator
        (`_flush_window`) instead of per-shard buckets. `device_plan=True`
        (fused only) plans tails through the device transform (K2) instead
        of the host tracker walk; `warmup=True` starts bank 0's warm-up
        (fused only, see SessionBank), which with the window also covers
        its classes."""
        self.resolve = resolve
        self._sync_lock = sync_lock if sync_lock is not None \
            else contextlib.nullcontext()
        self.router = ShardRouter(n_shards)
        self.queue = AdmissionQueue(n_shards, max_pending=max_pending,
                                    flush_docs=flush_docs,
                                    flush_deadline_s=flush_deadline_s)
        self.metrics = ServeMetrics(n_shards, flush_docs, max_pending)
        devices: List[Optional[torch.device]] = [None] * n_shards
        if place_on_devices and engine == "device":
            devices = serve_shard_devices(n_shards)
        # the window rides on fused sessions: the host engine and the zone
        # sessions ignore it
        self.mesh_window = bool(mesh_window) and engine == "device" \
            and bool(fused)
        self._mesh: Optional[List[torch.device]] = None   # lazy
        self.banks = [
            SessionBank(i, max_sessions=max_sessions_per_shard,
                        max_slots=max_slots_per_shard, engine=engine,
                        device=devices[i], metrics=self.metrics,
                        session_opts=session_opts,
                        fused=fused, fused_opts=fused_opts,
                        warmup=(warmup and i == 0),
                        flush_docs=flush_docs, device_plan=device_plan,
                        mesh_shards=n_shards if self.mesh_window else 0,
                        mesh_devices=len(serve_mesh(devices))
                        if devices[0] is not None else 1)
            for i in range(n_shards)]
        self.fused = self.banks[0].fused
        self.device_plan = self.banks[0].device_plan
        # per-DEVICE locks: shards placed on the same card share one;
        # unplaced shards get their own (contention there is a perf
        # matter, not a correctness one). The witness rank is the first
        # shard index mapped to the device, so rank order is the
        # sorted-shard order `_flush_window` takes them in.
        by_dev: Dict[object, object] = {}
        self._device_locks: List = []
        for i, dev in enumerate(devices):
            key = str(dev) if dev is not None else ("shard", i)
            lock = by_dev.get(key)
            if lock is None:
                lock = by_dev[key] = make_lock(f"device[{i}]", "device",
                                               rank=i)
            self._device_locks.append(lock)
        # `admit(doc_id) -> bool` — the cross-host ownership gate; None =
        # single-host, admit all
        self.admit = admit
        # `epoch_of(doc_id) -> int` — the ACTIVE lease epoch this host
        # holds; None = unfenced
        self.epoch_of: Optional[Callable[[str], int]] = None
        # obs.Observability bundle (attach_obs); None = zero overhead:
        # every obs touchpoint below is guarded by this one attribute
        self.obs = None
        # serve.hydrate.Hydrator (attach_hydrator); None = every document
        # stays resident: no prefetch, no flush gate
        self.hydrator = None
        # qos.QosController (attach_qos); None = the static size-or-
        # deadline trigger
        self.qos = None
        # read.attach_follower_reads wires this to ReadPath.on_flush: a
        # committed flush moved the doc's merged tip, so the follower-read
        # checkout cache drops the doc's entries. Called outside the
        # shard and bank locks, right after record_flush, for every item
        # of the flush on either path.
        self.read_invalidate: Optional[Callable[[str], None]] = None
        # docs the hydration gate requeued (written under self.lock):
        # drain() counts a pump that only deferred as progress
        self._deferred = 0
        self.lock = make_lock("scheduler.global", "global")
        self._shard_locks = [make_lock(f"shard[{i}]", "shard", rank=i)
                             for i in range(n_shards)]
        self._pump_stop = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None
        # per-shard flush workers (lazy-spawned daemons): pump() hands
        # taken batches to these so distinct shards' flushes overlap;
        # _inflight + the condvar make drain() deterministic, and the
        # first exception a worker (or the background pump) meets waits
        # in _error for drain()/stop_workers() to raise
        self._flush_workers = bool(flush_workers)
        self._work_qs: List[_queue.Queue] = [
            _queue.Queue() for _ in range(n_shards)]
        self._workers: List[Optional[threading.Thread]] = \
            [None] * n_shards
        self._inflight = 0
        self._idle_cv = threading.Condition()
        self._error: Optional[Exception] = None
        # the first exception that escaped a flush on any path (inline,
        # worker, pump, read); unlike _error it is never consumed
        self.fault: Optional[Exception] = None

    def attach_obs(self, obs) -> None:
        """Wire an obs.Observability bundle into the admit→flush path:
        spans on submit/flush/device-sync, flush latencies into the
        metrics' time series, rare events (evictions, fence failures,
        queue-bound violations, fenced flushes) into the flight recorder,
        journey stamps through the banks, and the bundle to an attached
        QoS controller as its telemetry."""
        self.obs = obs
        self.metrics.recorder = obs.recorder
        # live-telemetry tier: counters/latencies double-write into the
        # windowed TimeSeries (rate()/quantile() "now" queries + SLO
        # burn rates); per-doc usage feeds the top-K sketch
        self.metrics.ts = getattr(obs, "ts", None)
        if self.qos is not None:
            self.qos.attach_obs(obs)
        for bank in self.banks:
            bank.recorder = obs.recorder
            bank.journey = getattr(obs, "journey", None)
        if self.hydrator is not None:
            self.hydrator.recorder = obs.recorder
            self.hydrator.attrib = getattr(obs, "attrib", None)

    def attach_hydrator(self, hydrator) -> None:
        """Wire the residency tier in: `submit` prefetches on a doc's
        first admit (budgeted by the bucket flush deadline), the flush
        paths gate on warmth right after the lease fence (cold docs
        requeue, quarantined docs drop before they can join a batch), and
        every bank eviction routes through the hydrator's snapshot queue.
        The scheduler's `resolve` should be `hydrator.resolve`;
        `attach_hydrator` does not rebind it."""
        self.hydrator = hydrator
        if hydrator.metrics is None:
            hydrator.metrics = self.metrics
        if hydrator.oplog_lock is None and not isinstance(
                self._sync_lock, contextlib.nullcontext):
            hydrator.oplog_lock = self._sync_lock
        if self.obs is not None:
            hydrator.recorder = self.obs.recorder
            hydrator.attrib = getattr(self.obs, "attrib", None)
        for bank in self.banks:
            bank.snapshot_hook = hydrator.request_snapshot

    def attach_qos(self, controller) -> None:
        """Wire a qos.QosController into the admission path: the queue
        consults its published per-(shard, class) effective deadlines in
        place of the static trigger, submits bump its per-class counters,
        and start_pump/stop_pump own its control-loop thread. The
        controller takes its `qos` witness lock BEFORE this scheduler's
        global lock (qos(8) -> global(10) in the canonical order) when it
        reads queue fill each step."""
        controller.bind(self.queue, queue_lock=self.lock,
                        n_shards=self.queue.n_shards)
        if self.obs is not None:
            controller.attach_obs(self.obs)
        self.qos = controller
        self.queue.qos = controller

    # ---- intake ----------------------------------------------------------

    def submit(self, doc_id: str, n_ops: int = 1,
               now: Optional[float] = None, trace=None,
               qos: Optional[str] = None) -> dict:
        """Queue pending merge work. Returns {"accepted": True, "shard",
        "bucket"}, {"accepted": False, "retry_after"} on backpressure, or
        {"accepted": False, "reason": "not_owner"} when the ownership gate
        denies, or "quarantined" when the residency tier holds the doc in
        quarantine (never raises — rejects and denials are normal
        operation). `trace` is an optional obs SpanContext (the
        originating edit); when its trace is sampled the admit, the
        ownership gate, and later the flush and device sync all join it.
        `qos` is the ingress-classified class (default interactive);
        unknown classes normalize to interactive."""
        now = time.monotonic() if now is None else now
        qos_cls = qos if qos in QOS_PRIORITY else "interactive"
        obs = self.obs
        span = NOOP_SPAN
        if obs is not None:
            span = obs.tracer.start("serve.admit", parent=trace,
                                    attrs={"doc": doc_id,
                                           "n_ops": n_ops})
        if self.admit is not None:
            gate = NOOP_SPAN if not span.sampled else obs.tracer.start(
                "serve.ownership_gate", parent=span.context(),
                attrs={"doc": doc_id})
            admitted = self.admit(doc_id)
            gate.end(admitted=admitted)
            if not admitted:
                # shard_of (not assign): a denied doc must not register
                # a live assignment this host will never flush
                shard = self.router.shard_of(doc_id)
                self.metrics.bump(shard, "denied")
                span.end(outcome="denied")
                return {"accepted": False, "shard": shard,
                        "reason": "not_owner"}
        hyd = self.hydrator
        if hyd is not None:
            if hyd.store.is_quarantined(doc_id) is not None:
                span.end(outcome="quarantined")
                return {"accepted": False,
                        "shard": self.router.shard_of(doc_id),
                        "reason": "quarantined"}
            # async prefetch on FIRST admit, budgeted by the bucket flush
            # deadline. The unlocked peek is a benign race: a doc already
            # warm or pending makes prefetch a no-op.
            if doc_id not in self.router.assignments:
                hyd.prefetch(doc_id, budget_s=self.queue.flush_deadline_s)
        # stamp the admit-time lease epoch; the flush rechecks it
        epoch = self.epoch_of(doc_id) if self.epoch_of is not None \
            else -1
        with self.lock:
            shard = self.router.assign(doc_id)
            self.metrics.bump(shard, "submits")
            already = self.queue.pending_bucket(shard, doc_id) is not None
            try:
                bucket = self.queue.submit(shard, doc_id, n_ops, now,
                                           epoch=epoch,
                                           trace=span.context(),
                                           qos=qos_cls)
            except Backpressure as bp:
                self.metrics.bump(shard, "rejects")
                span.end(outcome="backpressure")
                return {"accepted": False, "shard": shard,
                        "retry_after": bp.retry_after, "qos": qos_cls}
            if already:
                self.metrics.bump(shard, "coalesced")
            self.metrics.observe_queue(shard, self.queue.depth(shard))
        if self.qos is not None:
            # per-class admitted counter: also the controller's
            # arrival-rate input (the qos.admitted.<cls> series)
            self.qos.metrics.bump_class(qos_cls, "admitted")
        span.end(outcome="queued", shard=shard, bucket=bucket)
        if obs is not None and span.sampled:
            # journey: open at the scheduler when the edit's ingress did
            # not — begin() is first-wins, so an ingress-admitted journey
            # keeps its (agent, seq)
            j = obs.journey
            j.begin(None, None, doc=doc_id, trace=span.trace_id)
            j.stamp(span.trace_id, "queued")
        return {"accepted": True, "shard": shard, "bucket": bucket}

    # ---- flush -----------------------------------------------------------

    def pump(self, now: Optional[float] = None,
             force: bool = False) -> int:
        """Flush every due bucket. Returns the number of docs dispatched
        (synced inline, or handed to a shard worker). Queue mutation
        (due/take) happens under the global lock only; the flush work
        runs on per-shard worker threads (or inline without workers)
        under each shard's OWN lock."""
        now = time.monotonic() if now is None else now
        taken = []      # (shard, reason, items)
        with self.lock:
            for shard, bucket, reason in self.queue.due(now, force=force):
                items = self.queue.take(shard, bucket)
                if items:
                    taken.append((shard, reason, items))
        synced = 0
        try:
            if taken and self.mesh_window:
                # every due bucket of every shard in ONE window
                synced = self._flush_window(taken)
            else:
                for shard, reason, items in taken:
                    if self._flush_workers:
                        self._dispatch(shard, reason, items)
                    else:
                        self._flush_items(shard, reason, items)
                    synced += len(items)
        except Exception as e:
            self._note_fault(e)
            raise
        if taken and not self.mesh_window:
            # one handoff (>= one device call) per taken bucket
            self.metrics.record_window(len(taken), synced,
                                       len({s for s, _r, _i in taken}))
        if taken:
            with self.lock:
                for shard in {s for s, _r, _i in taken}:
                    self.metrics.observe_queue(
                        shard, self.queue.depth(shard))
        return synced

    # ---- worker pool -----------------------------------------------------

    def _dispatch(self, shard: int, reason: str, items) -> None:
        """Hand one taken batch to its shard's worker (spawned lazily)."""
        with self._idle_cv:
            self._inflight += 1
        if self._workers[shard] is None:
            t = threading.Thread(target=self._worker_loop, args=(shard,),
                                 name=f"flush-worker-{shard}",
                                 daemon=True)
            self._workers[shard] = t
            t.start()
        self._work_qs[shard].put((reason, items))

    def _note_fault(self, e: Exception) -> None:
        with self._idle_cv:
            if self.fault is None:
                self.fault = e

    def _store_error(self, e: Exception) -> None:
        self._note_fault(e)
        with self._idle_cv:
            if self._error is None:
                self._error = e

    def _raise_stored_error(self) -> None:
        """Raise (once) the first exception a worker or the background
        pump stored."""
        with self._idle_cv:
            e, self._error = self._error, None
        if e is not None:
            raise e

    def _worker_loop(self, shard: int) -> None:
        q = self._work_qs[shard]
        while True:
            job = q.get()
            if job is None:
                return
            reason, items = job
            try:
                self._flush_items(shard, reason, items)
            except Exception as e:    # raised by drain()/stop_workers()
                self._store_error(e)
            finally:
                with self._idle_cv:
                    self._inflight -= 1
                    self._idle_cv.notify_all()

    def _wait_idle(self, timeout: float = 600.0) -> None:
        """Block until every dispatched batch has been flushed; raises
        TimeoutError if one is still in flight after `timeout`."""
        deadline = time.monotonic() + timeout
        with self._idle_cv:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{self._inflight} flushes still in flight after "
                        f"{timeout} s")
                self._idle_cv.wait(timeout=left)

    def stop_workers(self) -> None:
        """Join the flush workers deterministically (after a drain()),
        then raise the first exception one of them stored. Safe to call
        repeatedly; workers respawn on the next pump."""
        self._wait_idle()
        for i, w in enumerate(self._workers):
            if w is not None:
                self._work_qs[i].put(None)
        for i, w in enumerate(self._workers):
            if w is not None:
                w.join(timeout=5)
                self._workers[i] = None
        self._raise_stored_error()

    def _fence(self, shard: int, items) -> list:
        """Lease-epoch recheck: drop work admitted under an epoch this
        host no longer holds (`fenced`) — its ops stay durable in the
        oplog for the new owner."""
        if self.epoch_of is None:
            return items
        kept = []
        for item in items:
            if item.epoch != -1 \
                    and self.epoch_of(item.doc_id) != item.epoch:
                self.metrics.bump(shard, "fenced")
                if self.obs is not None:
                    self.obs.recorder.record("flush_fenced",
                                             doc=item.doc_id,
                                             shard=shard,
                                             admit_epoch=item.epoch)
            else:
                kept.append(item)
        return kept

    def _flush_resolve(self, doc_id: str):
        """The flush paths' resolve: `self.resolve`, except that an
        exception inside a batch is counted as a flush leak (the
        hydration gate should have filtered the doc) before it
        propagates."""
        try:
            return self.resolve(doc_id)
        except Exception as e:
            if self.hydrator is not None:
                self.hydrator.note_flush_leak(doc_id, e)
            raise

    def _hydration_gate(self, shard: int, items) -> list:
        """Residency recheck right after the lease fence: keep warm docs,
        drop quarantined ones (they never join a batch) and requeue
        still-cold ones, a delayed flush on a later pump once hydration
        lands, never a batch stalled on disk."""
        hyd = self.hydrator
        if hyd is None:
            return items
        keep, defer, dropped = hyd.flush_gate(shard, items)
        if defer:
            now = time.monotonic()
            with self.lock:
                self._deferred += len(defer)
                for it in defer:
                    try:
                        self.queue.submit(shard, it.doc_id, it.n_ops, now,
                                          epoch=it.epoch, trace=it.trace)
                    except Backpressure:
                        # the queue refilled meanwhile; the doc's ops are
                        # durable, so its merge work drops like a fenced
                        # item's
                        hyd._bump("deferred_drops")
        if dropped and self.obs is not None:
            self.obs.recorder.record(
                "flush_gate_dropped", shard=shard, docs=len(dropped))
        return keep

    def _flush_items(self, shard: int, reason: str, items) -> None:
        """Sync one taken batch into its shard's bank, under that shard's
        lock only (items are already off the queue, so a concurrent
        submit for the same doc simply queues fresh work). The lease
        recheck runs first, the hydration gate second. A flush whose
        items carry a sampled trace opens `serve.flush` under the first
        such trace, with one `serve.device_sync` child around the bank's
        sync (the whole bucket is at best one K1 launch)."""
        obs = self.obs
        items = self._fence(shard, items)
        items = self._hydration_gate(shard, items)
        if not items:
            return
        fspan = NOOP_SPAN
        if obs is not None:
            parent = next(
                (i.trace for i in items if i.trace is not None), None)
            if parent is not None:
                fspan = obs.tracer.start(
                    "serve.flush", parent=parent,
                    attrs={"shard": shard, "reason": reason,
                           "docs": len(items)})
        t0 = time.perf_counter()
        with self._shard_locks[shard]:
            dspan = NOOP_SPAN if not fspan.sampled else \
                obs.tracer.start("serve.device_sync",
                                 parent=fspan.context(),
                                 attrs={"docs": len(items)})
            res = self.banks[shard].sync_docs(
                items, self._flush_resolve, oplog_lock=self._sync_lock,
                device_lock=self._device_locks[shard])
            dspan.end(fused_calls=res["fused_calls"],
                      fused_docs=res["fused_docs"])
        dur = time.perf_counter() - t0
        fspan.end(dur_s=round(dur, 6))
        self.metrics.record_flush(
            shard, len(items), sum(i.n_ops for i in items), reason,
            dur_s=dur)
        # live telemetry: admit->flush queue wait per merged item, a
        # flush-latency exemplar when this flush rode a sampled trace,
        # and per-doc ops/device-time attribution
        now_m = time.monotonic()
        for it in items:
            self.metrics.observe_queue_wait(
                max(0.0, now_m - it.enqueued_at))
        if obs is not None:
            if fspan.sampled:
                obs.exemplars.note("serve.flush", dur,
                                   fspan.context().trace_id)
            dev_share = dur / len(items)
            for it in items:
                obs.attrib.note("ops", doc=it.doc_id, n=it.n_ops)
                obs.attrib.note("device_s", doc=it.doc_id, n=dev_share)
        if self.read_invalidate is not None:
            for it in items:
                self.read_invalidate(it.doc_id)

    # ---- flush window ----------------------------------------------------

    def _get_mesh(self) -> List[torch.device]:
        """The window's devices (`serve_mesh` over the banks' devices),
        built at first use under the global lock, so it is called before
        any shard lock is taken (lock order: global -> shard)."""
        if self._mesh is None:
            with self.lock:
                if self._mesh is None:
                    self._mesh = serve_mesh([b.device for b in self.banks])
        return self._mesh

    def _flush_window(self, taken) -> int:
        """The flush-window coordinator: every due bucket in `taken`,
        across all shards, in one window on the calling thread.

          1. the lease-epoch recheck (window assembly is merge time) and
             the hydration gate;
          2. planning in three steps: each shard's `extract_window` under
             the oplog lock, ONE `resolve_windows` for the whole window (a
             K2 resolve per device, where the JAX window resolves once per
             shard; each plan is per document, so the plans are the same),
             then each shard's `_plan_fused(min_fuse=1)`: a lone document
             joins the shared launch;
          3. the fusable rows of every shard concatenated by
             (cap, max_ins) class, in sorted class order, and replayed by
             `mesh_fused_replay`: one K1 launch per class and device;
          4. each shard's `adopt_window`: fence failures go to the host,
             serial items take the per-doc rung.

        No rung catches a fault: a K1 or resolve error propagates out of
        `pump()` (from the background pump, out of the next `drain()`),
        so the JAX window's fallback events (`mesh_window_fallback`,
        `pallas_window_fallback`) have no counterpart. With a bundle
        attached the window opens `serve.mesh_window` under the first
        sampled trace, one `serve.mesh_dispatch` per class, and stamps
        each replayed row's journey `device_replayed`; each class's
        replay goes to `PROFILER.observe_window`.
        Lock order: the shard locks (sorted), the oplog lock inside the
        planning and adoption steps, then the device locks of the
        window's shards (sorted by shard, deduped) around each replay.
        Returns the number of docs flushed after fencing."""
        entries = []        # (shard, reason, items), post-fencing
        for shard, reason, items in taken:
            items = self._fence(shard, items)
            items = self._hydration_gate(shard, items)
            if items:
                entries.append((shard, reason, items))
        if not entries:
            # an all-fenced window still counts (dispatches 0 keeps it
            # out of the device_calls_per_window denominator)
            self.metrics.record_window(0, 0,
                                       len({s for s, _r, _i in taken}))
            return 0
        obs = self.obs
        mesh = self._get_mesh()     # takes self.lock: before shard locks
        shards = sorted({s for s, _r, _i in entries})
        n_docs = sum(len(i) for _s, _r, i in entries)
        fspan = NOOP_SPAN
        if obs is not None:
            parent = next((i.trace for _s, _r, its in entries
                           for i in its if i.trace is not None), None)
            if parent is not None:
                fspan = obs.tracer.start(
                    "serve.mesh_window", parent=parent,
                    attrs={"shards": len(shards), "docs": n_docs})
        t0 = time.perf_counter()
        with contextlib.ExitStack() as sstack:
            for s in shards:
                sstack.enter_context(self._shard_locks[s])
            wins = [self.banks[s].extract_window(
                        items, self._flush_resolve,
                        oplog_lock=self._sync_lock)
                    for s, _r, items in entries]
            resolve_windows(wins)
            for (s, _r, _items), win in zip(entries, wins):
                self.banks[s]._plan_fused(win, self._sync_lock, min_fuse=1)
            classes: Dict[tuple, list] = {}
            for ei, win in enumerate(wins):
                for sessions, plans, doc_ids in win["groups"]:
                    for sess, plan, d in zip(sessions, plans, doc_ids):
                        classes.setdefault(
                            (sess.cap, sess.max_ins), []).append(
                                (ei, sess, plan, d))
            seen: set = set()
            dlocks = [lk for s in shards
                      if id(lk := self._device_locks[s]) not in seen
                      and not seen.add(id(lk))]
            dispatches = mesh_docs = padded_rows = staged_bytes = 0
            failed: List[List[str]] = [[] for _ in entries]
            replayed: List[set] = [set() for _ in entries]
            for (cap, mi), rows in sorted(classes.items()):
                t_cls = time.perf_counter()
                with contextlib.ExitStack() as dstack:
                    for lk in dlocks:
                        dstack.enter_context(lk)
                    dspan = NOOP_SPAN if not fspan.sampled else \
                        obs.tracer.start(
                            "serve.mesh_dispatch",
                            parent=fspan.context(),
                            attrs={"docs": len(rows), "cap": cap,
                                   "max_ins": mi})
                    ok, device_s, bp, staged = mesh_fused_replay(
                        mesh, [r[1] for r in rows], [r[2] for r in rows])
                    dspan.end(padded_b=bp, staged_bytes=staged)
                dispatches += 1
                mesh_docs += len(rows)
                padded_rows += bp
                staged_bytes += staged
                PROFILER.observe_window(time.perf_counter() - t_cls,
                                        device_s, len(rows), len(shards),
                                        staged_bytes=staged)
                for good, (ei, _sess, _plan, d) in zip(ok, rows):
                    if good:
                        replayed[ei].add(d)
                    else:
                        failed[ei].append(d)
            # journey: the window runs the device phase itself, so the
            # device_replayed stamp lives here (planned and adopted ride
            # the banks' planning and adoption on both paths)
            if obs is not None:
                j = obs.journey
                for ei, (_s, _r, its) in enumerate(entries):
                    for it in its:
                        if (it.trace is not None and it.trace.sampled
                                and it.doc_id in replayed[ei]):
                            j.stamp(it.trace.trace_id, "device_replayed")
            for ei, (s, reason, items) in enumerate(entries):
                self.banks[s].adopt_window(
                    wins[ei], failed[ei], oplog_lock=self._sync_lock,
                    device_lock=self._device_locks[s])
                self.metrics.record_flush(
                    s, len(items), sum(i.n_ops for i in items), reason,
                    dur_s=time.perf_counter() - t0)
                # every item of the entry, the capacity-pressure victims
                # that `adopt_window` re-synced on the per-doc rung among
                # them, is committed by now
                if self.read_invalidate is not None:
                    for it in items:
                        self.read_invalidate(it.doc_id)
        dur = time.perf_counter() - t0
        fspan.end(dur_s=round(dur, 6), dispatches=dispatches)
        self.metrics.record_window(dispatches, n_docs, len(shards),
                                   mesh_docs=mesh_docs,
                                   padded_rows=padded_rows,
                                   staged_bytes=staged_bytes)
        # live telemetry (mirrors _flush_items): queue waits, a flush
        # exemplar off the window span, per-doc attribution
        now_m = time.monotonic()
        dev_share = dur / max(n_docs, 1)
        for _s, _r, its in entries:
            for it in its:
                self.metrics.observe_queue_wait(
                    max(0.0, now_m - it.enqueued_at))
                if obs is not None:
                    obs.attrib.note("ops", doc=it.doc_id, n=it.n_ops)
                    obs.attrib.note("device_s", doc=it.doc_id,
                                    n=dev_share)
        if obs is not None and fspan.sampled:
            obs.exemplars.note("serve.flush", dur,
                               fspan.context().trace_id)
        return n_docs

    def drain(self) -> int:
        """Flush everything regardless of triggers (shutdown, rebalance,
        parity checks), then wait for the shard workers to go idle — the
        return means every dispatched doc has actually merged — and raise
        the first exception a worker stored. A hydration-gate deferral
        requeues from inside a flush, so after the workers go idle the
        depth is checked again: deferred docs get further rounds until
        they hydrate (the gate defers a doc once, then hydrates it in the
        flush) or the queue is empty."""
        total = 0
        while True:
            progressed = False
            while self.queue.total_depth():
                deferred0 = self._deferred
                n = self.pump(force=True)
                if n == 0 and self._deferred == deferred0:
                    break     # defensive: a take() returning nothing
                progressed = True
                total += n
            self._wait_idle()
            self._raise_stored_error()
            if not self.queue.total_depth() or not progressed:
                return total

    # ---- reads / control -------------------------------------------------

    def text(self, doc_id: str) -> str:
        """Merged text from the doc's shard (device-resident state when
        present). Pending queued work for the doc is flushed first so the
        answer reflects every accepted submit. Reads never dispatch device
        work under the oplog guard: a session behind the durable oplog
        serves the oplog's tip snapshot instead."""
        with self.lock:
            shard = self.router.assign(doc_id)
            bucket = self.queue.pending_bucket(shard, doc_id)
            items = []
            if bucket is not None:
                # flush the doc's whole bucket (its neighbors share the
                # shape anyway), counted as a read-triggered flush
                items = self.queue.take(shard, bucket,
                                        limit=self.queue.max_pending)
        if items:
            try:
                self._flush_items(shard, "read", items)
            except Exception as e:
                self._note_fault(e)
                raise
            with self.lock:
                self.metrics.observe_queue(shard,
                                           self.queue.depth(shard))
        ol = self.resolve(doc_id)
        # a deposed or never-owner host must not serve its device session
        # for the doc — the durable oplog is the only truth it still holds
        if self.admit is not None and not self.admit(doc_id):
            with self._sync_lock:
                return ol.checkout_tip().snapshot()
        with self._shard_locks[shard]:
            return self.banks[shard].text(
                doc_id, ol, oplog_lock=self._sync_lock,
                device_lock=self._device_locks[shard])

    def rebalance(self, n_shards: int) -> Dict[str, tuple]:
        """Shrink (or restore) the live shard count: drain pending work,
        re-route, and evict moved docs' sessions from their OLD shards
        (they rebuild on the new shard at next merge). Growing past the
        constructed bank count needs a new scheduler."""
        if n_shards > len(self.banks):
            raise ValueError(
                f"cannot grow past the constructed {len(self.banks)} "
                "shards; build a new MergeScheduler")
        self.drain()
        with self.lock:
            moved = self.router.rebalance(n_shards)
        for doc_id, (old, _new) in moved.items():
            with self._shard_locks[old]:
                self.banks[old].evict(doc_id)
        return moved

    def metrics_json(self) -> dict:
        snap = self.metrics.snapshot()
        snap["router_counts"] = self.router.counts()
        return snap

    # ---- background pump -------------------------------------------------

    def start_pump(self, interval_s: Optional[float] = None) -> None:
        """Pump every `interval_s` (default half the flush deadline) on a
        background thread, and start the QoS controller's loop when one is
        attached. An exception ends the pump loop and is raised by the
        next drain()/stop_pump()."""
        if self._pump_thread is not None:
            return
        interval = interval_s if interval_s is not None else \
            max(self.queue.flush_deadline_s / 2, 0.01)

        def loop():
            while not self._pump_stop.wait(interval):
                try:
                    self.pump()
                except Exception as e:
                    self._store_error(e)
                    return

        self._pump_thread = threading.Thread(target=loop, daemon=True)
        self._pump_thread.start()
        if self.qos is not None:
            # the controller's loop lives and dies with the pump: no
            # pump, no flushes, nothing for the deadlines to steer
            self.qos.start()

    def stop_pump(self, drain: bool = True) -> None:
        if self.qos is not None:
            self.qos.stop()
        self._pump_stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=2)
            self._pump_thread = None
        self._pump_stop = threading.Event()
        if drain:
            self.drain()
        self.stop_workers()
