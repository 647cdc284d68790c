"""Per-shard session bank: LRU-bounded device residency + host fallback.

Port of the JAX package's `serve/bank.py`. One bank per shard owns every
device-resident session of that shard: a `FusedDocSession` on the fused
engine (`fused=True`, the default), a `DeviceZoneSession`
(`gpu/zone_session.py`, the zone engine's resident carry) with
`fused=False`. Residency is bounded two ways:

  * `max_sessions` — at most N documents resident at once;
  * `max_slots`    — total device-slot footprint (sum of each session's
                     `footprint_slots()`: a fused session's `[cap]` buffer,
                     a zone session's W_cap x (n_rows + 7) planes) stays
                     under a budget. A session that GROWS past the budget
                     on resync evicts its least-recently-used neighbors.

Eviction drops the device state; the document itself lives in its host
OpLog, so an evicted doc costs one rebuild on its next merge. With the
residency tier attached (`MergeScheduler.attach_hydrator`), every
eviction — LRU, footprint, explicit, and the stale-oplog rebuild of a
re-hydrated document — calls `snapshot_hook(doc_id, pending_ops)`, so
the doc's warm oplog is persisted to its durable home.

Fused flush: `sync_docs` replays a whole taken bucket in ONE device call
per (cap, max_ins) group. The ladder, most-fused first:

  1. fused group   — ≥2 resident sessions sharing (cap, max_ins) whose
                     tails fit: one `flush_fuse.kernel_fused_replay` call
                     (K1 on CUDA sessions).
  2. per-doc       — the host engine, capacity eviction mid-batch, a tail
                     that overflows its buffer, or a bucket with <2
                     fusable docs: `sync_doc` per item, whose
                     `FusedDocSession.sync` launches K1 for that doc alone.
  3. host          — a poisoned or mismatched length (the fence:
                     `adopt_results` for a group row, `FenceMismatch` from
                     a per-doc sync): evict the session and serve the doc
                     from `oplog.checkout_tip()`, counted in
                     `host_fallbacks`.

Zone-session flush (`fused=False`): every item of a bucket is a per-doc
`sync_doc`, whose `DeviceZoneSession.sync` continues the resident carry
with one X8 launch (`kernels.zone_tape_run`) per sync, or resyncs.

Unlike the JAX package's bank, no rung catches a fault and drops to
another: a kernel error, a failed session build, a zone session's fault or
any other exception propagates to the caller (the JAX `sync_doc` serves a
failed zone sync from the host). Only the fused engine's length fence sends
a document to the host.

Locking contract for `sync_docs`: `oplog_lock` (the scheduler's oplog
guard, e.g. DocStore.lock) is held only around the HOST-side phases
(session build, tail extraction and planning, fallback bookkeeping);
`device_lock` (per device) only around the device replay, so shards flush
concurrently. The first CUDA touch in the process runs once under a module
lock (a witness lock, `first_touch`, as in the JAX package); kernels and
the native library build at first use under their own locks.

Planning runs in three steps, so that the scheduler's flush window
(`mesh_window=True`) can resolve every shard's tails at once: `extract_window`
(session build and tail extraction, under `oplog_lock`), `resolve_windows`
(the device resolve, K2, one call per device over any number of windows,
outside it) and `_plan_fused` (grouping by (cap, max_ins), under it again).
`plan_window` chains the three for one bank; `adopt_window` is the shared
tail (sync counts, fence failures to the host, the per-doc rung).
`sync_docs` is `plan_window`, one replay per group, `adopt_window`.

Observability (`MergeScheduler.attach_obs`): the flight recorder takes
every eviction (`session_evicted`, with its pending ops and whether the
snapshot path took them) and every fence failure (`host_fallback`); the
journey stamps each sampled item `planned`, `device_replayed` and
`adopted`; the process-wide `obs.devprof.PROFILER` takes each fused group
(`observe_fused`: wall and the length fetch's wait) and each per-doc sync
(`observe_flush`). While the profiler is enabled, a per-doc sync on a CUDA
session is followed by a `torch.cuda.synchronize`, timed as its device
wait (the JAX bank's `block_until_ready`); with the profiler off no sync
point is added.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from ..analysis.witness import make_lock
from ..gpu import flush_fuse, kernels, resolve_device, xform
from ..gpu.steer import STEER, WARMUP_SHAPE_CLASSES, _pow2, cap_class, \
    warmup_batches
from ..gpu.zone_session import DeviceZoneSession
from ..obs.devprof import PROFILER
from ..parallel.mesh import pad_batch_count
from .metrics import ServeMetrics

# the first CUDA touch in the process initialises the driver and its
# device table; it runs exactly once, under this lock
_first_touch_lock = make_lock("first_touch", "leaf")
_first_touch_done = False


def _ensure_cuda_ready(device: torch.device) -> None:
    global _first_touch_done
    if device.type != "cuda" or _first_touch_done:
        return
    with _first_touch_lock:
        if not _first_touch_done:
            torch.cuda.init()
            _first_touch_done = True


class _HostDoc:
    """Host-engine stand-in for a device session: the oplog IS the
    state, so sync is a no-op and text is a tracker checkout."""

    resyncs = 0
    fence_s = 0.0

    def __init__(self, oplog) -> None:
        self.oplog = oplog
        self.synced_to = len(oplog)

    def sync(self) -> int:
        new = len(self.oplog) - self.synced_to
        self.synced_to = len(self.oplog)
        return max(new, 0)

    def text(self) -> str:
        return self.oplog.checkout_tip().snapshot()

    def footprint_slots(self) -> int:
        return 0


class SessionBank:
    def __init__(self, shard_id: int, max_sessions: int = 8,
                 max_slots: int = 1 << 24, engine: str = "device",
                 device=None, metrics: Optional[ServeMetrics] = None,
                 session_opts: Optional[dict] = None,
                 fused: bool = True,
                 fused_opts: Optional[dict] = None,
                 warmup: bool = False,
                 flush_docs: int = 8,
                 device_plan: bool = False,
                 mesh_shards: int = 0,
                 mesh_devices: int = 1) -> None:
        """`engine="device"` keeps sessions on `device`, else on the
        sessions' options' "device" (`fused_opts` on the fused engine,
        `session_opts` with `fused=False`); None means CUDA, and the
        constructor raises without it. `fused_opts` (cap / max_ins /
        headroom / device) go to each `FusedDocSession`; `session_opts`
        (n_rows / headroom / max_blocks / max_chars / max_dels / device)
        to each `DeviceZoneSession`. `device_plan` (fused engine only)
        plans tails through the device transform (`xform.extract_tail` +
        `resolve_positions`, K2) instead of the host tracker walk.

        `warmup=True` (device engine) starts a thread that builds the
        kernels and launches K1 once per (batch class of
        `warmup_batches(flush_docs)`, pow2 op class of `WARMUP_SHAPE_CLASSES`)
        at the default capacity class, on the bank's device, noting each
        class warm for steering; with `mesh_shards > 0` (the scheduler's
        flush window over that many shards and `mesh_devices` devices) it
        also launches every super-batch class such a window can assemble
        and notes it under "mesh". `join_warmup()` waits for it and raises
        what it raised."""
        if engine not in ("device", "host"):
            raise ValueError(f"unknown engine {engine!r}")
        self.shard_id = shard_id
        self.max_sessions = max(int(max_sessions), 1)
        self.max_slots = int(max_slots)
        self.engine = engine
        self.metrics = metrics
        self.fused = bool(fused) and engine == "device"
        self.fused_opts = dict(fused_opts or {})
        self.session_opts = dict(session_opts or {})
        self.device = None
        if engine == "device":
            opts = self.fused_opts if self.fused else self.session_opts
            self.device = resolve_device(
                device if device is not None else opts.get("device"))
            opts["device"] = self.device
        self.flush_docs = int(flush_docs)
        self.device_plan = bool(device_plan) and self.fused
        self.mesh_shards = int(mesh_shards)
        self.mesh_devices = max(int(mesh_devices), 1)
        self.sessions: "OrderedDict[str, object]" = OrderedDict()
        self._resyncs_seen: Dict[str, int] = {}
        # obs.recorder.FlightRecorder (MergeScheduler.attach_obs);
        # evictions and fallbacks are rare enough to record each one
        self.recorder = None
        # obs.journey.OpJourney (same attach path): planned /
        # device_replayed / adopted stamps for sampled-trace items
        self.journey = None
        # residency tier (MergeScheduler.attach_hydrator): called as
        # snapshot_hook(doc_id, pending_ops) at every eviction site so
        # the doc's state is persisted, not dropped. Enqueue-only by
        # contract: eviction runs under shard/oplog locks and must never
        # wait on disk.
        self.snapshot_hook = None
        self._warmup_thread: Optional[threading.Thread] = None
        self._warmup_error: Optional[Exception] = None
        if warmup and self.fused:
            self._warmup_thread = threading.Thread(
                target=self._warmup, daemon=True)
            self._warmup_thread.start()

    def _warmup(self) -> None:
        try:
            _ensure_cuda_ready(self.device)
            if self.device.type == "cuda":
                kernels.build()
            cap = cap_class(self.fused_opts.get("cap",
                                                flush_fuse.DEFAULT_CAP))
            mi = self.fused_opts.get("max_ins", flush_fuse.DEFAULT_MAX_INS)
            dev = self.device

            def launch(b: int, n: int, length: int) -> None:
                z = torch.zeros((b, n), dtype=torch.int32, device=dev)
                kernels.apply_ops_window(
                    torch.zeros((b, cap), dtype=torch.int32, device=dev),
                    torch.full((b,), length, dtype=torch.int32, device=dev),
                    z, z, z, torch.zeros((b, n, mi), dtype=torch.int32,
                                         device=dev), mi)
            # the pow2 op classes a flush pads its tape to, as the JAX
            # package's warm-up notes them
            classes = sorted({_pow2(k) for k in WARMUP_SHAPE_CLASSES})
            for b in warmup_batches(self.flush_docs):
                for n in classes:
                    launch(b, n, 0)
                    # both replay keys: groups ("kernel") and per-doc
                    # syncs ("fused") launch K1
                    STEER.note_warm("kernel", mi, cap, b, n)
                    STEER.note_warm("fused", mi, cap, b, n)
            if self.mesh_shards > 0:
                # every padded class a window over mesh_shards shards can
                # assemble (up to flush_docs each), as inert padding rows;
                # this bank's device launches its slice of each
                nd = self.mesh_devices
                bps = sorted({pad_batch_count(b, nd) for b in
                              range(1, self.mesh_shards * self.flush_docs
                                    + 1)})
                for bp in bps:
                    for n in classes:
                        launch(bp // nd, n, -1)
                        STEER.note_warm("mesh", mi, cap, bp, n)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except Exception as e:     # re-raised by join_warmup
            self._warmup_error = e

    def join_warmup(self, timeout: float = 60.0) -> None:
        """Block until the warm-up finishes; raise what it raised."""
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout=timeout)
            if self._warmup_thread.is_alive():
                raise TimeoutError(f"warm-up still running after "
                                   f"{timeout} s")
        if self._warmup_error is not None:
            raise self._warmup_error

    # ---- accounting ------------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.bump(self.shard_id, key, n)

    def footprint_slots(self) -> int:
        return sum(s.footprint_slots() for s in self.sessions.values())

    @staticmethod
    def _pending_ops(sess) -> int:
        """Ops the session's oplog holds beyond its synced frontier:
        what a lossy eviction would have dropped."""
        return max(len(sess.oplog) - sess.synced_to, 0)

    def _drop(self, doc_id: str, sess, why: str) -> None:
        """Shared eviction tail: forget the doc's resync baseline, count
        the eviction, with a residency tier attached route the doc to its
        snapshot (`why` names the site: capacity, explicit or
        stale-oplog), and record the flight-recorder event with the
        pending-op count. The hook only enqueues; what it raises
        propagates."""
        self._resyncs_seen.pop(doc_id, None)
        self._bump("evictions")
        pending = self._pending_ops(sess)
        snapshotted = False
        if self.snapshot_hook is not None:
            snapshotted = bool(self.snapshot_hook(doc_id, pending))
        if self.recorder is not None:
            self.recorder.record("session_evicted",
                                 shard=self.shard_id, doc=doc_id,
                                 why=why, pending_ops=pending,
                                 snapshotted=snapshotted)

    def _evict_until_fits(self, keep: Optional[str] = None) -> None:
        def over() -> bool:
            return (len(self.sessions) > self.max_sessions or
                    self.footprint_slots() > self.max_slots)
        while self.sessions and over():
            victim = next((k for k in self.sessions if k != keep), None)
            if victim is None:
                break      # only `keep` is resident; nothing to evict
            self._drop(victim, self.sessions.pop(victim), why="capacity")

    def evict(self, doc_id: str) -> bool:
        sess = self.sessions.pop(doc_id, None)
        if sess is not None:
            self._drop(doc_id, sess, why="explicit")
            return True
        return False

    # ---- residency -------------------------------------------------------

    def _build(self, doc_id: str, oplog):
        if self.engine == "host":
            return _HostDoc(oplog)
        _ensure_cuda_ready(self.device)
        if self.fused:
            sess = flush_fuse.FusedDocSession(oplog, **self.fused_opts)
        else:
            sess = DeviceZoneSession(oplog, **self.session_opts)
        # the initial build counts as this doc's baseline, not a resync
        self._resyncs_seen[doc_id] = sess.resyncs
        return sess

    def session(self, doc_id: str, oplog):
        """Get-or-build the doc's resident session, updating LRU order
        and enforcing both residency bounds."""
        sess = self.sessions.get(doc_id)
        if sess is not None and sess.oplog is not oplog:
            # the doc's oplog was replaced (residency churn: evicted from
            # the warm tier and re-hydrated into a new OpLog): a session
            # bound to the old one would serve a frozen view forever.
            # Rebuild against the live oplog (counted as an eviction,
            # snapshot-routed like any other).
            self.sessions.pop(doc_id)
            self._drop(doc_id, sess, why="stale-oplog")
            sess = None
        if sess is not None:
            self.sessions.move_to_end(doc_id)
            return sess
        # make room BEFORE the expensive build (the new session's exact
        # footprint is unknown until built; re-check after)
        self._evict_until_fits()
        sess = self._build(doc_id, oplog)
        self._bump("builds")
        self.sessions[doc_id] = sess
        self._evict_until_fits(keep=doc_id)
        if self.metrics is not None:
            self.metrics.observe_footprint(self.shard_id,
                                           self.footprint_slots())
        return sess

    # ---- merge path ------------------------------------------------------

    def sync_doc(self, doc_id: str, oplog) -> dict:
        """Fold the doc's appended ops into its shard-resident state. A
        fence failure (`FenceMismatch`, fused sessions) evicts the session
        and serves the doc from the host engine; any other exception,
        a zone session's included, propagates."""
        self._bump("syncs")
        t0 = time.perf_counter()
        sess = self.session(doc_id, oplog)
        try:
            steps = sess.sync()
        except flush_fuse.FenceMismatch as e:
            self.evict(doc_id)
            self._bump("host_fallbacks")
            if self.recorder is not None:
                self.recorder.record(
                    "host_fallback", shard=self.shard_id, doc=doc_id,
                    error=f"{e.__class__.__name__}: {e}"[:120])
            return {"engine": "host", "steps": _HostDoc(oplog).sync(),
                    "error": f"{e.__class__.__name__}: {e}"[:200]}
        # wall vs device attribution: the session's own fence wait, plus
        # (profiler on, CUDA) the wait for work the sync left queued. The
        # extra sync point is only paid while profiling.
        device_s = sess.fence_s
        if PROFILER.enabled and self.engine == "device" \
                and self.device.type == "cuda":
            td = time.perf_counter()
            torch.cuda.synchronize(self.device)
            device_s += time.perf_counter() - td
        seen = self._resyncs_seen.get(doc_id)
        if seen is not None and sess.resyncs > seen:
            self._bump("resyncs", sess.resyncs - seen)
            self._resyncs_seen[doc_id] = sess.resyncs
        if self.metrics is not None:
            self.metrics.observe_footprint(self.shard_id,
                                           self.footprint_slots())
            self.metrics.observe_device_time(
                self.shard_id, time.perf_counter() - t0, device_s)
        PROFILER.observe_flush(self.shard_id, time.perf_counter() - t0,
                               device_s)
        return {"engine": self.engine, "steps": int(steps)}

    def plan_window(self, items, resolve, oplog_lock=None,
                    min_fuse: int = 2) -> dict:
        """The host-side half of `sync_docs`, with no replay issued:
        session build and tail extraction under `oplog_lock`
        (`extract_window`), the device resolve outside it
        (`resolve_windows`), then grouping back under it (`_plan_fused`).
        The flush window runs the three steps itself, so that it resolves
        every shard's extracts at once.

        Returns the window dict: {"items", "ols", "serial", "groups", ...}
        with `groups` [(sessions, plans, doc_ids)] by (cap, max_ins)."""
        win = self.extract_window(items, resolve, oplog_lock)
        resolve_windows([win])
        self._plan_fused(win, oplog_lock, min_fuse=min_fuse)
        return win

    def _journey_stamp(self, items, stage: str, docs=None) -> None:
        """Journey stamps for sampled-trace items; `docs` narrows to a
        doc-id subset. No-op until attach_obs wires `self.journey`."""
        j = self.journey
        if j is None or not j.enabled:
            return
        for it in items:
            tr = it.trace
            if tr is None or not tr.sampled:
                continue
            if docs is not None and it.doc_id not in docs:
                continue
            j.stamp(tr.trace_id, stage)

    def extract_window(self, items, resolve, oplog_lock=None) -> dict:
        """First step of planning: `resolve(doc_id) -> OpLog` for every
        item OUTSIDE `oplog_lock` (DocStore.get takes that same
        non-reentrant lock), then, under it, get/build each document's
        session and take its tail: a `TailExtract` for the device resolve
        with `device_plan`, else the host `plan_tail()`. The host engine
        plans nothing: every item is serial."""
        olock = oplog_lock if oplog_lock is not None \
            else contextlib.nullcontext()
        ols = {it.doc_id: resolve(it.doc_id) for it in items}
        win = {"bank": self, "items": items, "ols": ols, "serial": [],
               "planned": [], "groups": []}
        if not self.fused:
            win["serial"] = list(items)
            return win
        with olock:
            for it in items:
                sess = self.session(it.doc_id, ols[it.doc_id])
                half = xform.extract_tail(sess) if self.device_plan \
                    else sess.plan_tail()
                win["planned"].append([it, sess, half])
        return win

    def _plan_fused(self, win: dict, oplog_lock=None,
                    min_fuse: int = 2) -> None:
        """Last step of planning, under `oplog_lock`: host re-plan for a
        device/host length disagreement, then group fusable sessions by
        (cap, max_ins) into `win["groups"]`. Anything that can't fuse (an
        overflowing tail, a session LRU-evicted mid-batch, fewer than
        `min_fuse` fusable documents) lands in `win["serial"]`. The
        per-shard path keeps `min_fuse=2` (a lone document amortizes
        nothing); the flush window passes 1, since its launch is shared.
        Every item of the window is then stamped `planned`."""
        olock = oplog_lock if oplog_lock is not None \
            else contextlib.nullcontext()
        serial = win["serial"]
        fusable: List[tuple] = []    # (sess, plan, item)
        with olock:
            for it, sess, plan in win["planned"]:
                if plan is None:
                    # device/host length disagreement: host re-plan
                    plan = sess.plan_tail()
                if not plan.fits(sess.cap):
                    serial.append(it)   # overflow -> per-doc resync
                    continue
                # building session N can LRU-evict already-planned M:
                # only still-resident sessions may commit device state
                if self.sessions.get(it.doc_id) is not sess:
                    serial.append(it)
                elif plan.n_ops == 0:
                    # frontier advance with no visible ops (e.g. a
                    # delete of an already-deleted span): no device work
                    sess.commit_host(plan)
                    self._bump("syncs")
                else:
                    fusable.append((sess, plan, it))
        if len(fusable) < min_fuse:
            serial.extend(it for _s, _p, it in fusable)
        else:
            by_shape: Dict[tuple, list] = {}
            for row in fusable:
                by_shape.setdefault((row[0].cap, row[0].max_ins),
                                    []).append(row)
            win["groups"] = [(
                [s for s, _p, _it in grp],
                [p for _s, p, _it in grp],
                [it.doc_id for _s, _p, it in grp],
            ) for grp in by_shape.values()]
        self._journey_stamp(win["items"], "planned")

    def adopt_window(self, win: dict, failed: List[str], oplog_lock=None,
                     device_lock=None) -> dict:
        """Result adoption for this bank's share of a flush (its own
        bucket, or its slice of a flush window): count a sync for every
        fused row (their commits happened at the fence), evict `failed`
        documents (poisoned or length-drift rows, whose device state is
        untrusted) to the host, and run the per-doc rung for the serial
        items. One code path for both flush forms. Every item is then
        stamped `adopted`."""
        dlock = device_lock if device_lock is not None \
            else contextlib.nullcontext()
        olock = oplog_lock if oplog_lock is not None \
            else contextlib.nullcontext()
        for _sessions, _plans, doc_ids in win["groups"]:
            self._bump("syncs", len(doc_ids))
        with olock:
            for d in failed:
                # serve the doc from the host oracle until its rebuild
                self.evict(d)
                self._bump("host_fallbacks")
                if self.recorder is not None:
                    self.recorder.record(
                        "host_fallback", shard=self.shard_id, doc=d,
                        error="fused_poisoned_or_len_mismatch")
            for it in win["serial"]:
                with dlock:
                    # The serial fallback rung interleaves oplog reads
                    # (span walk, agent keys, host checkouts) with its
                    # device continuation inside one sess.sync(), so it
                    # cannot drop the oplog guard the way the fused
                    # phases do. It is the rare rung — unfusable,
                    # overflowing or poisoned docs — and stalling
                    # oplog readers here is the documented cost of
                    # falling off the fused path.
                    self.sync_doc(it.doc_id, win["ols"][it.doc_id])  # dt-lint: ignore[device-under-lock]
            if self.metrics is not None:
                self.metrics.observe_footprint(self.shard_id,
                                               self.footprint_slots())
        # every surviving item is merged once adoption ends: fused rows
        # committed at the fence, serial and failed rows just now
        self._journey_stamp(win["items"], "adopted")
        return {"docs": len(win["items"]),
                "fused_calls": 0,
                "fused_docs": 0,
                "fallback_docs": len(win["serial"]) + len(failed)}

    def sync_docs(self, items, resolve,
                  oplog_lock=None, device_lock=None) -> dict:
        """Flush one taken bucket, fusing where possible (module
        docstring: the ladder): `plan_window`, one replay per fused group
        under `device_lock` only, then `adopt_window`. `items` are
        admission PendingMerge rows; `resolve(doc_id) -> OpLog` is called
        OUTSIDE `oplog_lock`.

        Returns {"docs", "fused_calls", "fused_docs", "fallback_docs"}.
        """
        dlock = device_lock if device_lock is not None \
            else contextlib.nullcontext()
        win = self.plan_window(items, resolve, oplog_lock=oplog_lock)
        # ---- device phase: one replay per fused group, under the device
        # lock ONLY — host threads keep mutating other oplogs
        failed: List[str] = []
        for sessions, plans, doc_ids in win["groups"]:
            t0 = time.perf_counter()
            with dlock:
                ok, device_s = flush_fuse.kernel_fused_replay(sessions,
                                                              plans)
            wall = time.perf_counter() - t0
            if self.metrics is not None:
                self.metrics.record_fused(self.shard_id, len(sessions))
                self.metrics.observe_device_time(self.shard_id, wall,
                                                 device_s)
            PROFILER.observe_fused(self.shard_id, wall, device_s,
                                   len(sessions))
            failed.extend(d for good, d in zip(ok, doc_ids) if not good)
        if win["groups"]:
            fused = {d for _s, _p, ds in win["groups"] for d in ds}
            self._journey_stamp(items, "device_replayed",
                                docs=fused.difference(failed))
        out = self.adopt_window(win, failed, oplog_lock=oplog_lock,
                                device_lock=device_lock)
        out["fused_calls"] = len(win["groups"])
        out["fused_docs"] = sum(len(g[0]) for g in win["groups"])
        return out

    def text(self, doc_id: str, oplog, oplog_lock=None,
             device_lock=None) -> str:
        """Merged text for the doc — from the resident session when it
        is caught up with the durable oplog (device parity surface),
        host checkout otherwise. Host-side reads under `oplog_lock`; the
        device fetch under `device_lock` only."""
        olock = oplog_lock if oplog_lock is not None \
            else contextlib.nullcontext()
        dlock = device_lock if device_lock is not None \
            else contextlib.nullcontext()
        with olock:
            sess = self.sessions.get(doc_id)
            if sess is None or sess.synced_to < len(oplog):
                return oplog.checkout_tip().snapshot()
            if self.engine == "host":
                # host sessions read the oplog itself; stay guarded
                return sess.text()
        with dlock:
            return sess.text()


def resolve_windows(wins: List[dict]) -> int:
    """The device half of planning for one or more windows from
    `SessionBank.extract_window`: every `TailExtract` among them, grouped
    by device, in ONE `xform.resolve_positions` call per device, outside
    every oplog lock (extracts are self-contained). Each extract's slot
    in its window's `planned` becomes its TailPlan, or None for a
    device/host length disagreement (re-planned on the host by
    `_plan_fused`).

    Per-document transform counters are recorded per bank, as the JAX
    package's per-bank resolve records them; `batches` counts the real
    resolve calls, so a flush window over one card records one where the
    JAX window records one per shard. Returns the number of calls."""
    stats = [{"device_docs": 0, "host_docs": 0, "fallbacks": 0}
             for _ in wins]
    by_dev: Dict[str, tuple] = {}     # str(device) -> (device, rows)
    for st, win in zip(stats, wins):
        bank = win["bank"]
        if not bank.device_plan:
            continue                  # host plans only: nothing to count
        for row in win["planned"]:
            if isinstance(row[2], xform.TailExtract):
                by_dev.setdefault(str(bank.device),
                                  (bank.device, []))[1].append((st, row))
            else:
                st["host_docs"] += 1
    for device, rows in by_dev.values():
        resolved = xform.resolve_positions([row[2] for _st, row in rows],
                                           device=device)
        for (st, row), plan in zip(rows, resolved):
            row[2] = plan
            st["fallbacks" if plan is None else "device_docs"] += 1
    metrics = wins[0]["bank"].metrics if wins else None
    if metrics is not None:
        for st, win in zip(stats, wins):
            if any(st.values()):
                metrics.record_transform(win["bank"].shard_id, **st)
        if by_dev:
            metrics.record_transform(wins[0]["bank"].shard_id,
                                     batches=len(by_dev))
    return len(by_dev)
