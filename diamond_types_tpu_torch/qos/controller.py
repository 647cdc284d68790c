"""Closed-loop admission controller: telemetry in, deadlines out.

A periodic controller (own daemon thread) that closes ROADMAP item 1's
loop: it reads per-class arrival rates and flush-latency quantiles
from `Observability.ts`, SLO burn states from `Observability.slo`, the
per-peer convergence-lag rollup from `Observability.journey`, and the
hot-doc attribution sketch — and publishes per-(shard, class)
*effective* flush deadlines that `AdmissionQueue.due()` consults in
place of the static trigger.

The deadline law (Just-in-Time Dynamic Batching, arxiv 1904.07421):
the fused/mesh flush ladder only pays off when pow2 shape buckets are
full, so the marginal wait worth paying is the expected time for the
arrival process to deliver the docs still missing from the fullest
bucket:

  gap        = flush_docs - fullest_bucket_fill        (docs missing)
  fill_time  = gap / (class arrival rate per shard)
  target     = clamp(fill_time, floor, ceiling)   if fill_time fits
               floor                              otherwise

Light load (rate ~ 0): fill_time is unreachable, target drops to the
floor — lone docs flush immediately instead of paying the static
deadline for occupancy nobody needs. Heavy load: the size trigger
fires first and the deadline is moot. The interesting middle is where
stretching fills buckets. Guards stack on top of the law:

  * SLO guard — a class whose objective is non-ok is pinned to its
    floor (counted `floors`): latency SLOs always beat occupancy.
  * interactive latency budget — interactive's target is additionally
    capped at `ceiling - flush_p99` so queue wait + flush together fit
    inside the static deadline.
  * mesh-warning deferral — sheddable classes are pinned to their
    ceiling (counted `ceilings`) while the shed policy is in warning:
    maximum batching for the traffic we are deliberately deprioritizing.
  * hysteresis — targets are EMA-damped (`alpha`) and only re-published
    when they move more than `deadband` relative, so the deadline
    cannot thrash on a noisy rate estimate (decisions counted
    stretched/shrunk/held).

Locking: the controller owns the new `qos` witness rung, deliberately
BELOW `global` in the canonical order (qos(8) -> global(10)): `step()`
takes the qos lock first and may then take the scheduler's global lock
to read queue fill. The hot admission path never takes the qos lock —
`effective_deadline()` reads an immutable table published by atomic
reference swap, so `due()` under the global lock stays lock-free with
respect to the controller.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Dict, Optional, Tuple

from ..analysis.witness import make_lock
from .classes import QosClass, default_classes, with_base
from .metrics import QosMetrics
from .shed import ShedPolicy


class QosController:
    def __init__(self, classes: Optional[Dict[str, QosClass]] = None,
                 interval_s: float = 0.25,
                 alpha: float = 0.4,
                 deadband: float = 0.1,
                 rate_window_s: float = 5.0,
                 shed_opts: Optional[dict] = None,
                 clock=time.monotonic) -> None:
        self.classes = classes
        self.interval_s = float(interval_s)
        self.alpha = float(alpha)
        self.deadband = float(deadband)
        self.rate_window_s = float(rate_window_s)
        self.clock = clock
        self.metrics = QosMetrics()
        self.shed = ShedPolicy(classes=classes, metrics=self.metrics,
                               clock=clock, **(shed_opts or {}))
        self._qos_lock = make_lock("qos.controller", "qos")
        self.obs = None
        self.queue = None
        self._queue_lock = None
        self.n_shards = 1
        # published effective-deadline table: (shard, cls) -> seconds.
        # IMMUTABLE once published; replaced wholesale by step() so hot
        # paths read it without the qos lock.
        self._table: Dict[Tuple[int, str], float] = {}
        self._damped: Dict[Tuple[int, str], float] = {}
        self._forced_mesh: Optional[Tuple[str, float]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- wiring -----------------------------------------------------------

    def bind(self, queue, queue_lock=None,
             n_shards: Optional[int] = None) -> None:
        """Attach to a scheduler's AdmissionQueue (MergeScheduler.
        attach_qos calls this). Derives the class taxonomy from the
        queue's static deadline unless one was given explicitly."""
        self.queue = queue
        self._queue_lock = queue_lock
        self.n_shards = int(n_shards if n_shards is not None
                            else queue.n_shards)
        if self.classes is None:
            self.classes = default_classes(queue.flush_deadline_s)
        else:
            self.classes = with_base(self.classes,
                                     queue.flush_deadline_s)
        self.shed.classes = self.classes
        for cls, spec in self.classes.items():
            self.metrics.set_deadline(cls, spec.deadline_s)

    def attach_obs(self, obs) -> None:
        self.obs = obs
        if obs is not None:
            self.metrics.ts = getattr(obs, "ts", None)

    # ---- hot-path reads (lock-free) ---------------------------------------

    def effective_deadline(self, shard: int, cls: str) -> float:
        t = self._table
        v = t.get((shard, cls))
        if v is not None:
            return v
        spec = (self.classes or {}).get(cls)
        return spec.deadline_s if spec is not None else 0.05

    def depth_budget(self, cls: str, max_pending: int) -> int:
        spec = (self.classes or {}).get(cls)
        share = spec.depth_share if spec is not None else 1.0
        return max(int(max_pending * share), 1)

    # ---- admission gate ---------------------------------------------------

    def admit(self, cls: str, tenant: Optional[str] = None,
              now: Optional[float] = None) -> Tuple[bool, float, str]:
        """Ingress shed gate (tools/server consults this BEFORE the
        mutation touches the oplog). Returns (admitted, retry_after_s,
        reason); see ShedPolicy.admit."""
        with self._qos_lock:
            return self.shed.admit(cls, tenant=tenant, now=now)

    def force_mesh_state(self, state: Optional[str],
                         retry_after: float = 1.0) -> None:
        """Test/debug override pinning the shed policy's mesh gate
        (None releases it). Survives controller steps — refresh()
        re-applies the forced state after every telemetry read."""
        with self._qos_lock:
            self._forced_mesh = (state, retry_after) if state else None
            if state:
                self.shed._mesh_state = state
                self.shed._mesh_why = "forced"
                self.shed._retry_after = retry_after

    # ---- control loop -----------------------------------------------------

    def _bucket_fill(self, shard: int) -> int:
        q = self.queue
        if q is None:
            return 0
        return q.bucket_fill(shard)

    def step(self, now: Optional[float] = None) -> dict:
        """One control-loop iteration: read telemetry, refresh the
        shed gate, recompute + publish the deadline table. Returns the
        decisions taken (for tests and /debug/qos)."""
        now = self.clock() if now is None else now
        obs = self.obs
        with self._qos_lock:
            ts = getattr(obs, "ts", None) if obs is not None else None
            slo = getattr(obs, "slo", None) if obs is not None else None
            rows = slo.evaluate() if slo is not None else []
            states = {r.get("name"): r.get("state", "ok") for r in rows}
            journey = getattr(obs, "journey", None) \
                if obs is not None else None
            lag = journey.lag_summary() if journey is not None else None
            attrib = getattr(obs, "attrib", None) \
                if obs is not None else None
            hot = self.shed.hot_tenants_from_attrib(attrib) \
                if attrib is not None else None
            self.shed.refresh(rows, lag=lag, hot_tenants=hot)
            if self._forced_mesh is not None:
                st, ra = self._forced_mesh
                self.shed._mesh_state = st
                self.shed._mesh_why = "forced"
                self.shed._retry_after = ra
            mesh_state = self.shed._mesh_state
            flush_p99 = ts.quantile("serve.flush", 0.99, window_s=30.0) \
                if ts is not None else 0.0
            flush_docs = self.queue.flush_docs if self.queue is not None \
                else 8
            fills = []
            guard = self._queue_lock if self._queue_lock is not None \
                else nullcontext()
            with guard:
                for shard in range(self.n_shards):
                    fills.append(self._bucket_fill(shard))
            decisions = {"stretched": 0, "shrunk": 0, "held": 0,
                         "floors": 0, "ceilings": 0}
            table: Dict[Tuple[int, str], float] = {}
            for cls, spec in (self.classes or {}).items():
                lam = (ts.rate(f"qos.admitted.{cls}",
                               window_s=self.rate_window_s)
                       if ts is not None else 0.0)
                lam_shard = lam / max(self.n_shards, 1)
                cls_state = states.get(spec.objective, "ok")
                for shard in range(self.n_shards):
                    gap = max(flush_docs - fills[shard], 1)
                    if lam_shard > 1e-9:
                        fill_time = gap / lam_shard
                        target = spec.clamp(fill_time) \
                            if fill_time <= spec.ceiling_s \
                            else spec.floor_s
                    else:
                        target = spec.floor_s
                    if cls_state != "ok":
                        target = spec.floor_s
                        decisions["floors"] += 1
                    elif spec.sheddable and mesh_state == "warning":
                        target = spec.ceiling_s
                        decisions["ceilings"] += 1
                    if cls == "interactive" and flush_p99 > 0:
                        target = spec.clamp(
                            min(target, spec.ceiling_s - flush_p99))
                    key = (shard, cls)
                    prev = self._damped.get(key, spec.deadline_s)
                    damped = prev + self.alpha * (target - prev)
                    self._damped[key] = damped
                    published = self._table.get(key, spec.deadline_s)
                    if abs(damped - published) \
                            > self.deadband * max(published, 1e-9):
                        table[key] = damped
                        decisions["stretched" if damped > published
                                  else "shrunk"] += 1
                    else:
                        table[key] = published
                        decisions["held"] += 1
            self._table = table
            for cls in (self.classes or {}):
                per = [table[(s, cls)] for s in range(self.n_shards)]
                if per:
                    self.metrics.set_deadline(cls, sum(per) / len(per))
            self.metrics.bump_ctl("steps")
            for k, n in decisions.items():
                if n:
                    self.metrics.bump_ctl(k, n)
            return decisions

    # ---- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception:   # pragma: no cover - defensive
                    # the controller must never take admission down
                    # with it; a failed step keeps the last table
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="qos-controller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    # ---- exposition -------------------------------------------------------

    def export(self) -> dict:
        """The /metrics + /debug/qos document: metrics snapshot plus
        the live controller/shed state. prom (obs/prom.py) renders the
        `classes` and `controller` keys as dt_qos_* families."""
        snap = self.metrics.snapshot()
        snap["enabled"] = True
        snap["running"] = self._thread is not None
        snap["interval_s"] = self.interval_s
        snap["n_shards"] = self.n_shards
        snap["shed"] = self.shed.snapshot()
        snap["specs"] = {
            cls: {"base_s": spec.deadline_s, "floor_s": spec.floor_s,
                  "ceiling_s": spec.ceiling_s,
                  "depth_share": spec.depth_share,
                  "objective": spec.objective,
                  "sheddable": spec.sheddable}
            for cls, spec in (self.classes or {}).items()}
        return snap
