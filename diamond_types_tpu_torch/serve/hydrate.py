"""Deadline-aware hydration: the cold -> warm pump of the residency tier.

The `Hydrator` sits between the `TieredStore` (cold: durable per-doc
homes on disk) and the scheduler's resolve path (warm: host OpLogs the
session banks build device state from). Three jobs:

  * **prefetch on first admit** — `MergeScheduler.submit` calls
    `prefetch(doc_id, budget_s=flush_deadline)` the first time a doc is
    routed; worker threads hydrate it off the request path with a
    per-attempt timeout, jittered retry/backoff (`replicate.peers.
    Backoff`) and a deadline budget derived from the bucket's flush
    deadline, so the doc is usually warm before its bucket is due;
  * **resolve** — the scheduler's `resolve(doc_id) -> OpLog`: warm hit
    returns the resident oplog; a cold miss hydrates synchronously
    (bounded by `sync_wait_s`); a quarantined doc raises the typed
    `DocQuarantined` instead of serving garbage. A writer appends
    through `edit(doc_id, fn)` (port-only), which re-resolves when the
    doc was evicted between its resolve and the oplog guard. A load
    that ran while another resolve installed the doc and evicted it to
    its home is stale and never installed (port-only): resolve loads
    again, a prefetch leaves the doc cold;
  * **flush gating + eviction-to-snapshot** — `flush_gate` classifies a
    taken bucket right after the lease fence: warm docs flush now,
    quarantined docs drop (never poisoning the batch), still-cold docs
    DEFER (requeued by the scheduler — a delayed flush, never a
    stalled one). Warm-map pressure and `SessionBank` evictions route
    through `evict_to_snapshot` / `request_snapshot`, so eviction
    persists pending state instead of dropping it.

Failure containment is per-doc by construction: every quarantine,
timeout and defer names exactly one doc; the rest of its bucket
flushes on time.

The JAX package's `serve/hydrate.py`, copied whole. The Hydrator never
touches the device: its retry, timeout, quarantine and defer ladder is the
tier's contract, so the catch-alls that keep its workers alive cannot hide
a kernel fault. `replicate.attach_replication` wires `remote_fetch` to the
node's `fetch_remote_snapshot` when a Hydrator is attached to the server's
scheduler (`tools/server.serve` attaches none).

Locking: `hydrate.warm` (io rung) guards the warm map / defer table /
eviction marks and is NEVER held across disk IO or sleeps — loads and
saves run lock-free and re-validate on completion (an install never
overwrites a warm oplog that arrived first; an eviction aborts when a
resolve claimed the doc mid-save). The tier's own io-rung locks nest
inside (same class, unranked — no witness edge), and the oplog guard
nests inside those (the documented io -> oplog order).
"""

from __future__ import annotations

import contextlib
import os
import queue as _queue
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from ..analysis.witness import make_lock
from ..obs.hist import Histogram
from ..replicate.peers import Backoff
from ..storage.tier import DocQuarantined, HydrationTimeout, TieredStore
from .metrics import HYDRATION_KEYS


class Hydrator:
    def __init__(self, store: TieredStore, workers: int = 2,
                 queue_max: int = 256, warm_max: int = 1024,
                 attempt_timeout_s: float = 0.25,
                 max_attempts: int = 4,
                 backoff: Optional[Backoff] = None,
                 sync_wait_s: float = 5.0,
                 defer_budget_s: float = 10.0,
                 gate_wait_s: float = 0.005,
                 evict_grace_s: float = 0.05,
                 oplog_lock=None, metrics=None, recorder=None,
                 seed: int = 0) -> None:
        self.store = store
        self.warm_max = max(int(warm_max), 1)
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.max_attempts = max(int(max_attempts), 1)
        self.sync_wait_s = float(sync_wait_s)
        # the JAX package's backstop: there, a deferred doc still cold
        # this long after its first deferral quarantines. The port's
        # gate hydrates a doc inline on its second visit whenever that
        # comes (a failure there quarantines, bounded by sync_wait_s),
        # so no doc defers twice and the budget never applies; kept
        # for the JAX package's signature
        self.defer_budget_s = float(defer_budget_s)
        # how long flush_gate waits for an in-flight hydration before
        # deferring — bounds the requeue spin during force-drains
        self.gate_wait_s = float(gate_wait_s)
        # a doc resolved within this window is never PICKED as an
        # eviction victim: the caller is still between resolve() and
        # its append, the one gap the unsaved-suffix recheck in
        # evict_to_snapshot cannot see (warm_max is soft under a fully
        # hot working set as a result)
        self.evict_grace_s = float(evict_grace_s)
        self.oplog_lock = oplog_lock
        self.metrics = metrics      # ServeMetrics (attach_hydrator)
        self.recorder = recorder    # obs FlightRecorder, may be None
        self.attrib = None          # obs HotAttribution (attach_obs):
                                    # per-doc cache-miss attribution
        # elastic mesh: called as on_warm(doc_id, ol) after a hydration
        # installs (read.attach_follower_reads wires the checkout-cache
        # pre-materializer here). Invoked with NO hydrator locks held.
        self.on_warm = None
        # wire tier: remote_fetch(doc_id) -> snapshot frame bytes (or
        # None). Wired by attach_replication; a cold miss whose durable
        # home is empty pulls the owner's compacted snapshot instead of
        # serving a spuriously-fresh doc. Called lock-free.
        self.remote_fetch = None
        self.backoff = backoff if backoff is not None else Backoff(
            base_s=0.002, cap_s=0.05, seed=seed, key="hydrate")
        self._hydrate_lock = make_lock("hydrate.warm", "io")
        self._warm: "OrderedDict[str, object]" = OrderedDict()
        self._pending: Dict[str, float] = {}    # doc -> enqueue ts
        self._evicting: Set[str] = set()
        self._touched: Dict[str, float] = {}    # doc -> last resolve ts
        self._defers: Dict[str, Tuple[int, float]] = {}
        # doc -> times evicted to its home (port-only): a load that began
        # before the doc's latest eviction read a home that eviction
        # rewrote, so `_finish` discards it
        self._evicted: Dict[str, int] = {}
        self.counters = {k: 0 for k in HYDRATION_KEYS}
        # `edit` calls that found the doc evicted under them, and loads
        # discarded as stale (port-only; HYDRATION_KEYS stays the JAX
        # package's)
        self.edit_retries = 0
        self.stale_loads = 0
        self._counter_lock = threading.Lock()
        self.cold_start = Histogram()
        # plain condvar used ONLY as a wakeup signal (never guards
        # state) — flush_gate waits on it instead of spinning
        self._warm_cv = threading.Condition(threading.Lock())
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(queue_max, 1))
        self._snap_q: "_queue.Queue" = _queue.Queue(
            maxsize=max(queue_max, 1))
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        for i in range(max(int(workers), 1)):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"hydrate-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._snapshot_loop,
                             name="hydrate-snapshot", daemon=True)
        t.start()
        self._threads.append(t)

    # ---- accounting ------------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[key] += n
        if self.metrics is not None:
            self.metrics.record_hydration(key, n)

    def _observe_cold_start(self, dur_s: float) -> None:
        self.cold_start.record(dur_s)
        if self.metrics is not None:
            self.metrics.observe_cold_start(dur_s)

    def _record(self, event: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.record(event, **fields)

    def status(self, doc_id: str) -> str:
        """"warm" | "quarantined" | "pending" | "cold"."""
        with self._hydrate_lock:
            if doc_id in self._warm:
                return "warm"
        if self.store.is_quarantined(doc_id) is not None:
            return "quarantined"
        with self._hydrate_lock:
            if doc_id in self._pending:
                return "pending"
        return "cold"

    def warm_count(self) -> int:
        with self._hydrate_lock:
            return len(self._warm)

    # ---- prefetch (async cold -> warm) -----------------------------------

    def prefetch(self, doc_id: str,
                 budget_s: Optional[float] = None) -> bool:
        """Queue an async hydration. `budget_s` is the caller's
        deadline hint (the scheduler passes its bucket flush deadline);
        it is floored so at least one full retry ladder fits — a tight
        flush deadline degrades to a DELAYED flush via the defer path,
        never to a doc spuriously timed out before its first attempt."""
        floor = self.attempt_timeout_s * self.max_attempts
        budget = max(budget_s if budget_s is not None
                     else self.sync_wait_s, floor)
        with self._hydrate_lock:
            if doc_id in self._warm or doc_id in self._pending:
                return False
            self._pending[doc_id] = time.monotonic()
        if self.store.is_quarantined(doc_id) is not None:
            with self._hydrate_lock:
                self._pending.pop(doc_id, None)
            return False
        try:
            self._q.put_nowait((doc_id, time.monotonic() + budget))
        except _queue.Full:
            self._bump("prefetch_queue_full")
            with self._hydrate_lock:
                self._pending.pop(doc_id, None)
            return False
        self._bump("prefetches")
        return True

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                doc_id, deadline = self._q.get(timeout=0.05)
            except _queue.Empty:
                continue
            try:
                self._hydrate(doc_id, deadline)
            except Exception:   # pragma: no cover - keep workers alive
                with self._hydrate_lock:
                    self._pending.pop(doc_id, None)

    def _hydrate(self, doc_id: str, deadline: float) -> None:
        t0 = time.monotonic()
        gen = self._evicted.get(doc_id, 0)
        try:
            ol = self._load_with_retries(doc_id, deadline)
        except DocQuarantined:
            self._note_quarantined(doc_id)
            return
        if ol is None:
            # deadline/attempts exhausted without a permanent verdict:
            # leave the doc COLD — the flush gate hydrates it inline on
            # its next visit, and only a sync resolve turns persistent
            # failure into a quarantine
            self._bump("hydrate_gave_up")
            with self._hydrate_lock:
                self._pending.pop(doc_id, None)
            return
        # a stale load leaves the doc cold: the gate prefetches it again
        self._finish(doc_id, self._maybe_remote_fill(doc_id, ol), t0, gen)

    def _load_with_retries(self, doc_id: str, deadline: float):
        """One bounded retry ladder. Returns the hydrated OpLog, None
        when the deadline/attempt budget ran out on transient errors,
        raises DocQuarantined on a permanent per-doc verdict."""
        attempt = 0
        while attempt < self.max_attempts:
            left = deadline - time.monotonic()
            if left <= 0:
                return None
            self._bump("attempts")
            if attempt:
                self._bump("retries")
            try:
                return self.store.load(
                    doc_id, timeout_s=min(self.attempt_timeout_s, left))
            except HydrationTimeout:
                self._bump("timeouts")
            except DocQuarantined:
                raise
            except Exception as e:
                self._bump("load_errors")
                self._record("hydration_load_error", doc=doc_id,
                             error=f"{e.__class__.__name__}: {e}"[:120])
            attempt += 1
            if attempt < self.max_attempts:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                time.sleep(min(self.backoff.delay(attempt - 1), left))
        return None

    def _maybe_remote_fill(self, doc_id: str, ol):
        """A hydration that came back EMPTY may be a doc this host has
        simply never seen: ask the mesh (wire tier snapshot fetch)
        before installing a fresh oplog. Best-effort — any failure
        keeps the legitimate fresh-empty semantics."""
        fetch = self.remote_fetch
        if fetch is None or ol is None or len(ol) > 0:
            return ol
        try:
            frame = fetch(doc_id)
            if frame:
                from ..wire.snapshot import apply_snapshot
                if apply_snapshot(ol, frame):
                    self._bump("remote_fills")
        except Exception:
            self._bump("remote_fill_errors")
        return ol

    def _note_quarantined(self, doc_id: str) -> None:
        with self._hydrate_lock:
            self._pending.pop(doc_id, None)
            self._warm.pop(doc_id, None)
            self._defers.pop(doc_id, None)
            self._touched.pop(doc_id, None)
            self._evicting.discard(doc_id)
        self._record("doc_quarantined", doc=doc_id,
                     reason=self.store.is_quarantined(doc_id) or "?")
        with self._warm_cv:
            self._warm_cv.notify_all()

    def _finish(self, doc_id: str, ol, t0: float, gen: int):
        """Install a hydration result. NEVER overwrites an oplog that
        is already warm — a concurrent sync resolve may have installed
        (and begun appending to) its own copy; the first install wins
        and this one is discarded. Returns the canonical warm oplog, or
        None when the doc was evicted to its home since the load began
        (`gen`, its eviction count then; port-only): another resolve
        installed, extended and evicted it meanwhile, so this load may
        lack ops the home now holds, and an agent's next op appended to
        it would reuse one of their ids, which the next save drops as
        already persisted. Nothing is installed then."""
        victims: List[str] = []
        with self._hydrate_lock:
            self._pending.pop(doc_id, None)
            have = self._warm.get(doc_id)
            stale = have is None and self._evicted.get(doc_id, 0) != gen
            if not stale:
                # _defers is NOT cleared here: under thrash a doc can
                # hydrate and be evicted again between two gate visits,
                # and a reset visit count would keep it deferring
                # forever — only passing a gate (or quarantine) clears
                # the entry
                self._evicting.discard(doc_id)
                self._touched[doc_id] = time.monotonic()
                if have is not None:
                    self._warm.move_to_end(doc_id)
                    ol = have
                else:
                    self._warm[doc_id] = ol
                    victims = self._pick_victims_locked(exclude=doc_id)
        if stale:
            with self._counter_lock:
                self.stale_loads += 1
            return None
        self._bump("hydrations")
        self._observe_cold_start(time.monotonic() - t0)
        with self._warm_cv:
            self._warm_cv.notify_all()
        self._evict_victims(victims)
        cb = self.on_warm
        if cb is not None:
            try:
                cb(doc_id, ol)
            except Exception:   # pragma: no cover - warm is best-effort
                pass
        return ol

    # ---- resolve (the scheduler's document authority) --------------------

    def resolve(self, doc_id: str):
        """`MergeScheduler(resolve=...)` entry point. Warm hit returns
        the resident oplog (and aborts any in-flight eviction of it);
        cold miss hydrates synchronously, again when the load went stale
        (`_finish`); quarantined raises the typed DocQuarantined."""
        reason = self.store.is_quarantined(doc_id)
        if reason is not None:
            raise DocQuarantined(doc_id, reason)
        with self._hydrate_lock:
            ol = self._warm.get(doc_id)
            if ol is not None:
                self._warm.move_to_end(doc_id)
                self._touched[doc_id] = time.monotonic()
                # claim it back from a mid-save eviction: the saver
                # sees the mark gone and keeps the entry resident
                self._evicting.discard(doc_id)
            gen = self._evicted.get(doc_id, 0)
        if ol is not None:
            self._bump("warm_hits")
            return ol
        self._bump("sync_hydrations")
        # a sync hydration is the residency tier's cache miss — the
        # per-doc hot sketch is how "one doc thrashes the warm set"
        # shows up at /debug/hot
        if self.attrib is not None:
            self.attrib.note("cache_misses", doc=doc_id)
        t0 = time.monotonic()
        try:
            ol = self._load_with_retries(doc_id, t0 + self.sync_wait_s)
        except DocQuarantined:
            self._note_quarantined(doc_id)
            raise
        if ol is None:
            self.store.quarantine(doc_id, "hydration_timeout")
            self._bump("quarantined")
            self._note_quarantined(doc_id)
            raise DocQuarantined(doc_id, "hydration_timeout")
        ol = self._finish(doc_id, self._maybe_remote_fill(doc_id, ol), t0,
                          gen)
        # None: the load went stale (`_finish`); resolve again
        return ol if ol is not None else self.resolve(doc_id)

    def warm_oplog(self, doc_id: str):
        """The doc's warm OpLog, or None when it is not warm: a peek that
        neither touches the LRU order nor takes a lock (one dict read),
        so it may run under the oplog guard."""
        return self._warm.get(doc_id)

    def edit(self, doc_id: str, fn):
        """`fn(oplog)` on the doc's warm oplog under the oplog guard, for
        a writer appending ops: resolve, take the guard, and run `fn` only
        if that oplog is still the warm one, else resolve again. Between
        a resolve and the guard the doc can be evicted to its snapshot
        (a writer that waits past `evict_grace_s` for the guard is no
        longer protected by the grace), and ops appended to the evicted
        oplog would be in no home and no warm map. Under the guard no
        eviction can pop the doc, and one that saved before the append
        aborts on the unsaved-suffix recheck. Returns what `fn`
        returns."""
        olock = self.oplog_lock if self.oplog_lock is not None \
            else contextlib.nullcontext()
        while True:
            ol = self.resolve(doc_id)
            with olock:
                if self.warm_oplog(doc_id) is ol:
                    return fn(ol)
            with self._counter_lock:
                self.edit_retries += 1

    def wait_warm(self, doc_id: str, timeout_s: float) -> bool:
        """Wait (briefly) for an in-flight hydration to land. True when
        the doc is warm; False on timeout or a quarantine verdict."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._hydrate_lock:
                if doc_id in self._warm:
                    return True
            if self.store.is_quarantined(doc_id) is not None:
                return False
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            with self._warm_cv:
                self._warm_cv.wait(timeout=min(left, 0.01))

    # ---- flush gating ----------------------------------------------------

    def flush_gate(self, shard: int, items) -> tuple:
        """Classify one taken bucket right after the lease fence:
        returns (keep, defer, dropped). Warm docs flush now; a
        quarantined doc is dropped HERE, before its rows can join a
        batch; a cold doc defers once (the scheduler requeues it — a
        delayed flush) with a fresh prefetch, and on its next visit
        hydrates inline, where a failure quarantines it."""
        keep, defer, dropped = [], [], []
        now = time.monotonic()
        for it in items:
            d = it.doc_id
            if self.store.is_quarantined(d) is not None:
                dropped.append(it)
                self._bump("quarantined_drops")
                self._record("quarantined_drop", doc=d, shard=shard)
                continue
            if self.wait_warm(d, self.gate_wait_s):
                with self._hydrate_lock:
                    if d in self._warm:
                        self._warm.move_to_end(d)
                        self._touched[d] = now
                        self._evicting.discard(d)
                    self._defers.pop(d, None)
                keep.append(it)
                continue
            if self.store.is_quarantined(d) is not None:
                dropped.append(it)
                self._bump("quarantined_drops")
                self._record("quarantined_drop", doc=d, shard=shard)
                continue
            with self._hydrate_lock:
                n, first = self._defers.get(d, (0, now))
                self._defers[d] = (n + 1, first)
            if n >= 1:
                # second visit: the async path had its round and the
                # doc is STILL cold at gate time. Deferring again can
                # livelock — when the queued working set outnumbers
                # warm_max, every deferred doc's re-prefetch evicts
                # the docs the gate is about to check. Hydrate HERE
                # instead, bounded by sync_wait_s: an undersized warm
                # tier degrades to a delayed flush, never a spinning
                # drain. (The visit count survives hydrate/evict
                # thrash between visits — it clears only on a gate
                # pass or quarantine — so the escalation is certain.)
                # However long the requeued item waited: the JAX
                # package first quarantines a doc whose second visit
                # comes `defer_budget_s` after its first deferral
                # ("hydration_stuck"), which a long queue alone brings
                # about for a healthy doc, and drops its merge work.
                try:
                    self.resolve(d)
                except DocQuarantined:
                    dropped.append(it)
                    self._bump("quarantined_drops")
                    self._record("quarantined_drop", doc=d, shard=shard)
                    continue
                with self._hydrate_lock:
                    self._defers.pop(d, None)
                self._bump("defer_escalations")
                keep.append(it)
                continue
            self._bump("deferrals")
            defer.append(it)
            self.prefetch(d)
        return keep, defer, dropped

    def note_flush_leak(self, doc_id: str, exc: BaseException) -> None:
        """A resolve inside a flush batch raised — the gate should have
        filtered this doc. Counted so the soak can assert it stays 0."""
        self._bump("flush_leaks")
        self._record("flush_leak", doc=doc_id,
                     error=f"{exc.__class__.__name__}: {exc}"[:120])

    # ---- eviction-to-snapshot --------------------------------------------

    def _pick_victims_locked(self,
                             exclude: Optional[str] = None) -> List[str]:
        """Mark LRU victims while over `warm_max` (caller holds
        `_lock`). Marked docs stay resident until their snapshot
        lands — `_evict_victims` finishes the job lock-free."""
        victims: List[str] = []
        floor = time.monotonic() - self.evict_grace_s
        while len(self._warm) - len(victims) > self.warm_max:
            v = next((k for k in self._warm
                      if k != exclude and k not in self._evicting
                      and self._touched.get(k, 0.0) <= floor), None)
            if v is None:
                break
            self._evicting.add(v)
            victims.append(v)
        return victims

    def _evict_victims(self, victims: List[str]) -> None:
        for v in victims:
            self.evict_to_snapshot(v, why="pressure")

    def evict_to_snapshot(self, doc_id: str,
                          why: str = "explicit") -> bool:
        """Persist the doc's warm oplog to its durable home, then drop
        it from the warm map. Aborts (keeps the doc warm) when a
        resolve claimed it mid-save, when an append raced in AFTER the
        snapshot was encoded (the persisted op count no longer matches
        the live oplog), or when the save failed transiently —
        eviction must NEVER drop unsaved state."""
        with self._hydrate_lock:
            ol = self._warm.get(doc_id)
            if ol is None:
                self._evicting.discard(doc_id)
                return False
            self._evicting.add(doc_id)
        saved = quarantined = False
        saved_len = -1
        size_before = self._home_size(doc_id)
        try:
            saved_len = self.store.save(doc_id, ol,
                                        oplog_lock=self.oplog_lock)
            saved = True
        except DocQuarantined:
            quarantined = True      # nothing durable to protect now
        except Exception as e:
            self._bump("snapshot_errors")
            self._record("snapshot_error", doc=doc_id, why=why,
                         error=f"{e.__class__.__name__}: {e}"[:120])
        if saved:
            self._bump("snapshots")
        if not saved and not quarantined:
            with self._hydrate_lock:
                self._evicting.discard(doc_id)
            return False
        olock = self.oplog_lock if self.oplog_lock is not None \
            else contextlib.nullcontext()
        with self._hydrate_lock:
            # the oplog guard nests inside (io -> oplog) and freezes
            # len(ol) for the unsaved-suffix recheck below
            with olock:
                if self._warm.get(doc_id) is not ol:
                    # another eviction popped the oplog this saved, and
                    # the doc may be warm again in a new one that holds
                    # ops no home has: never pop that (port-only), and
                    # leave the mark to the eviction that made it
                    aborted = True
                elif doc_id not in self._evicting:
                    aborted = True      # resolve() claimed it mid-save
                elif saved and len(ol) != saved_len:
                    # a handler appended between the snapshot encode
                    # and this pop: dropping now would lose that
                    # suffix — keep the doc warm, retry under the next
                    # pressure round
                    aborted = True
                    self._evicting.discard(doc_id)
                else:
                    aborted = False
                    self._evicting.discard(doc_id)
                    self._warm.pop(doc_id, None)
                    self._touched.pop(doc_id, None)
                    self._evicted[doc_id] = self._evicted.get(doc_id, 0) + 1
        if aborted:
            self._bump("eviction_aborts")
            return False
        self._bump("evictions_to_snapshot")
        if saved:
            self._record_spill(doc_id, size_before)
        self._record("evicted_to_snapshot", doc=doc_id, why=why,
                     saved=saved)
        return True

    def _home_size(self, doc_id: str) -> int:
        """On-disk size of the doc's durable home (0 when absent) —
        the before/after probe spill-byte accounting is built on."""
        try:
            return os.path.getsize(self.store.path(doc_id))
        except OSError:
            return 0

    def _record_spill(self, doc_id: str, size_before: int) -> None:
        """One device-tier spill: warm state persisted to the snapshot
        home under bank/warm-map pressure. Bytes are the home file's
        growth, clamped at 0 (compaction can shrink the home)."""
        self._bump("spills_to_snapshot")
        grew = self._home_size(doc_id) - size_before
        if grew > 0:
            self._bump("spill_bytes", grew)

    # ---- bank snapshot hook (SessionBank.snapshot_hook) ------------------

    def request_snapshot(self, doc_id: str, pending_ops: int = 0) -> bool:
        """Async persistence request — the bank calls this from its
        eviction sites, possibly under shard/oplog locks, so it must
        only enqueue (never touch tier locks or disk)."""
        self._bump("snapshot_requests")
        try:
            self._snap_q.put_nowait((doc_id, pending_ops))
        except _queue.Full:
            self._bump("snapshot_queue_full")
            return False
        return True

    def _snapshot_loop(self) -> None:
        while not self._stop.is_set():
            try:
                doc_id, _pending = self._snap_q.get(timeout=0.05)
            except _queue.Empty:
                continue
            try:
                self._snapshot_job(doc_id)
            except Exception:   # pragma: no cover - keep worker alive
                pass

    def _snapshot_job(self, doc_id: str) -> None:
        with self._hydrate_lock:
            ol = self._warm.get(doc_id)
        if ol is None:
            return      # not warm here: nothing newer than the home
        size_before = self._home_size(doc_id)
        try:
            self.store.save(doc_id, ol, oplog_lock=self.oplog_lock)
            self._bump("snapshots")
            self._record_spill(doc_id, size_before)
        except DocQuarantined:
            pass
        except Exception as e:
            self._bump("snapshot_errors")
            self._record("snapshot_error", doc=doc_id, why="bank_evict",
                         error=f"{e.__class__.__name__}: {e}"[:120])

    # ---- lifecycle -------------------------------------------------------

    def drain_snapshots(self, timeout_s: float = 10.0) -> None:
        deadline = time.monotonic() + timeout_s
        while not self._snap_q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)

    def checkpoint_all(self) -> int:
        """Persist every warm doc (shutdown / parity checks). Docs stay
        warm; returns the number snapshotted."""
        self.drain_snapshots()
        with self._hydrate_lock:
            docs = list(self._warm.items())
        n = 0
        for doc_id, ol in docs:
            try:
                self.store.save(doc_id, ol, oplog_lock=self.oplog_lock)
                self._bump("snapshots")
                n += 1
            except DocQuarantined:
                pass
            except Exception:
                self._bump("snapshot_errors")
        return n

    def stop(self, checkpoint: bool = True) -> None:
        """`checkpoint=False` models a crash: threads are abandoned
        mid-flight and nothing unsaved survives — exactly what the
        soak's crash-restart event needs."""
        if checkpoint:
            self.checkpoint_all()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        self._threads = []

    def counters_snapshot(self) -> dict:
        with self._counter_lock:
            out = dict(self.counters)
        out["warm_docs"] = self.warm_count()
        return out
