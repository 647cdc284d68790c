"""Mesh-aware load shedding + per-tenant noisy-neighbor isolation.

Two independent admission gates, consulted at server ingress BEFORE a
mutation touches the oplog (a shed edit is never durable, so shedding
is a real load shield, not queue-depth theater):

  mesh gate     driven by the SLO burn state of the mesh-facing
                objectives: when `visibility_p99` burns — or the
                per-peer convergence lag (obs/journey.py lag rollup)
                exceeds its threshold — the mesh is falling behind on
                replication, and sheddable classes (bulk, catchup) are
                429'd with a `Retry-After` derived from the burn rate
                BEFORE interactive traffic degrades. A `warning` state
                defers instead of shedding: the work is admitted (and
                counted `deferred`) while the controller pins its
                deadlines to the ceiling.
  tenant gate   per-tenant token buckets refilled at `tenant_rate`
                ops/s. Tenants flagged hot by the top-K attribution
                sketch (obs/attrib.py: one tenant owning more than
                `hot_share` of attributed ops) refill at
                `isolation_factor` of that rate — a noisy neighbor
                exhausts its own bucket and gets 429s while everyone
                else's admission is untouched. The tenant gate applies
                to every class (isolating a tenant IS throttling its
                interactive traffic; the mesh gate alone never is).

Thread-safety: all state here is guarded by the owning controller's
`qos` witness lock — `refresh()` and `admit()` are only called with it
held (see controller.py). The policy itself takes no locks.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

from .classes import QosClass, default_classes

# classes a mesh-burn may shed, in shed order (catchup first: its own
# backlog is what anti-entropy retries are FOR; bulk next; interactive
# never — that ordering is the acceptance gate's "shed before
# interactive degrades" invariant)
_MESH_SIGNALS = ("visibility_p99",)


class TokenBucket:
    """Plain token bucket (externally synchronized)."""

    def __init__(self, rate: float, burst: float,
                 now: float = 0.0) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = float(now)

    def take(self, now: float, n: float = 1.0) -> bool:
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class ShedPolicy:
    def __init__(self, classes: Optional[Dict[str, QosClass]] = None,
                 metrics=None,
                 tenant_rate: float = 400.0,
                 tenant_burst: float = 800.0,
                 hot_share: float = 0.5,
                 isolation_factor: float = 0.25,
                 lag_threshold_s: float = 10.0,
                 clock=time.monotonic) -> None:
        self.classes = classes or default_classes()
        self.metrics = metrics
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst)
        self.hot_share = float(hot_share)
        self.isolation_factor = float(isolation_factor)
        self.lag_threshold_s = float(lag_threshold_s)
        self.clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._hot: frozenset = frozenset()
        self._mesh_state = "ok"
        self._mesh_why = ""
        self._retry_after = 0.0

    # ---- control-loop inputs (called from QosController.step) ------------

    def refresh(self, slo_rows: Iterable[dict],
                lag: Optional[Dict[str, dict]] = None,
                hot_tenants: Optional[Iterable[str]] = None) -> None:
        """Recompute the mesh gate from the latest SLO evaluation rows
        (obs/slo.py `evaluate()` dicts) + the per-peer convergence-lag
        rollup, and adopt the attribution pass's hot-tenant set."""
        state, why, burn = "ok", "", 0.0
        for row in slo_rows or ():
            if row.get("name") not in _MESH_SIGNALS:
                continue
            st = row.get("state", "ok")
            if st == "ok":
                continue
            if st == "burning" or state == "ok":
                state = st
                why = row["name"]
            burn = max(burn, float((row.get("fast") or {})
                                   .get("burn", 0.0) or 0.0))
        for peer, row in (lag or {}).items():
            if float(row.get("mean_s", 0.0) or 0.0) > self.lag_threshold_s:
                state, why = "burning", f"convergence_lag:{peer}"
                burn = max(burn, 2.0)
        self._mesh_state = state
        self._mesh_why = why
        # Retry-After from the burn rate: at the fast-window alert
        # threshold (burn ~14.4x) back off ~3.6s, scaling linearly and
        # clamped to [0.25s, 10s] — hotter burn, longer backoff.
        self._retry_after = min(10.0, max(0.25, 0.25 * burn)) \
            if state == "burning" else 0.0
        if hot_tenants is not None:
            hot = frozenset(hot_tenants)
            if hot != self._hot:
                self._hot = hot
                # changed isolation tier => rebuild on next take
                self._buckets.clear()

    def hot_tenants_from_attrib(self, attrib) -> frozenset:
        """Derive the hot-tenant set from the top-K sketch: tenants
        owning more than `hot_share` of attributed per-doc ops."""
        from .classes import tenant_of
        try:
            tops = attrib.top("doc", "ops", 16)
        except (KeyError, AttributeError):
            return frozenset()
        per: Dict[str, float] = {}
        total = 0.0
        for doc, count, _err in tops:
            total += count
            ten = tenant_of(doc)
            if ten is not None:
                per[ten] = per.get(ten, 0.0) + count
        if total <= 0:
            return frozenset()
        return frozenset(t for t, c in per.items()
                         if c / total > self.hot_share)

    # ---- admission gate ---------------------------------------------------

    def admit(self, cls: str, tenant: Optional[str] = None,
              now: Optional[float] = None) -> Tuple[bool, float, str]:
        """(admitted, retry_after_s, reason). reason is "" for a plain
        admit, "deferred" for an admit the caller should count as
        deferred (mesh warning), "mesh_burn"/"tenant" for rejects."""
        spec = self.classes.get(cls)
        sheddable = spec.sheddable if spec is not None else True
        if sheddable and self._mesh_state == "burning":
            if self.metrics is not None:
                self.metrics.bump_class(cls, "shed")
            return False, self._retry_after, f"mesh_burn:{self._mesh_why}"
        if tenant is not None:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                rate = self.tenant_rate * (self.isolation_factor
                                           if tenant in self._hot else 1.0)
                burst = self.tenant_burst * (self.isolation_factor
                                             if tenant in self._hot
                                             else 1.0)
                bucket = self._buckets[tenant] = TokenBucket(
                    rate, burst, now=self.clock() if now is None else now)
            if not bucket.take(self.clock() if now is None else now):
                if self.metrics is not None:
                    self.metrics.bump_class(cls, "shed")
                return False, max(1.0 / max(bucket.rate, 1e-9),
                                  0.05), "tenant"
        if sheddable and self._mesh_state == "warning":
            if self.metrics is not None:
                self.metrics.bump_class(cls, "deferred")
            return True, 0.0, "deferred"
        return True, 0.0, ""

    def snapshot(self) -> dict:
        return {"mesh_state": self._mesh_state,
                "mesh_why": self._mesh_why,
                "retry_after_s": round(self._retry_after, 3),
                "hot_tenants": sorted(self._hot),
                "tenant_buckets": len(self._buckets)}
