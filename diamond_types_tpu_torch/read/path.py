"""The follower-read serve decision: local, wait-then-local, proxy, or
refuse.

``ReadPath`` sits between ``tools/server.py``'s GET handlers and the
store. On every read it classifies this node's relationship to the doc:

  * **owner** (holds the ACTIVE lease, or no replication is attached):
    serve locally with staleness 0 — through the cache.
  * **follower**: serve locally iff (a) the client's ``X-DT-Min-Version``
    token is dominated by the local oplog (waiting up to ``max_wait_s``
    for the anti-entropy stream to deliver it), and (b) the
    :class:`FollowerIndex` can bound the read's staleness within the
    client's ``?max_staleness=`` budget. Either miss proxies the read to
    the owner over the peer table (so fault injection and circuit
    breakers apply); an unreachable owner refuses with 503 rather than
    serve an out-of-contract response.

Proxied reads fetch the owner's ``/doc/{id}/state`` (the frontier rides
in the JSON, so the relayed ``X-DT-Frontier`` is authoritative) with
``X-DT-Proxied`` as the loop guard: the owner side serves locally,
still enforcing the min-version token but never proxying again.

The store's replica is resolved per-request, not at construction —
tests and the soak/bench drivers attach replication *after* the HTTP
server exists.

Checkouts go through ``store.checkout`` (``tools/server.py``), which
merges on the store's device: the engine policy may give a checkout to
the zone engine, and a server asked for the CPU keeps it there.
"""

import json
import time
from typing import List, Optional

from ..obs.trace import NOOP_SPAN, TRACE_HEADER, format_context
from .cache import CheckoutCache, frontier_key
from .follower import FollowerIndex, frontier_known
from .metrics import ReadMetrics

MIN_VERSION_HEADER = "X-DT-Min-Version"
FRONTIER_HEADER = "X-DT-Frontier"
SOURCE_HEADER = "X-DT-Read-Source"
STALENESS_HEADER = "X-DT-Staleness"


class ReadResult:
    __slots__ = ("status", "body", "ctype", "headers", "source")

    def __init__(self, status: int, body: bytes, ctype: str,
                 headers: dict, source: str):
        self.status = status
        self.body = body
        self.ctype = ctype
        self.headers = headers
        self.source = source


class ReadPath:
    """Per-node follower-read coordinator: FollowerIndex + CheckoutCache
    + the serve/proxy/refuse decision."""

    def __init__(self, store, metrics: Optional[ReadMetrics] = None,
                 cache_entries: int = 256, max_wait_s: float = 0.25,
                 poll_interval_s: float = 0.02,
                 proxy_timeout_s: float = 2.0):
        self.store = store
        self.metrics = metrics or ReadMetrics()
        self.index = FollowerIndex(self.metrics)
        self.cache = CheckoutCache(cache_entries, self.metrics)
        self.max_wait_s = max_wait_s
        self.poll_interval_s = poll_interval_s
        self.proxy_timeout_s = proxy_timeout_s

    # ---- environment -----------------------------------------------------

    @property
    def node(self):
        return getattr(self.store, "replica", None)

    @property
    def obs(self):
        return getattr(self.store, "obs", None)

    def _span(self, name: str, trace=None, **attrs):
        obs = self.obs
        if obs is None:
            return NOOP_SPAN
        return obs.tracer.start(name, parent=trace, attrs=attrs or None)

    # ---- invalidation hooks ----------------------------------------------

    def on_flush(self, doc_id: str) -> None:
        """Owner-side: a scheduler flush completed for the doc — its tip
        moved, so cached checkouts are stale-frontier footprint."""
        self.metrics.bump("flush_invalidations")
        self.cache.invalidate(doc_id)

    def on_antientropy_apply(self, doc_id: str) -> None:
        """Follower-side: anti-entropy pulled a patch into the doc."""
        self.metrics.bump("ae_invalidations")
        self.cache.invalidate(doc_id)

    def on_local_mutation(self, doc_id: str) -> None:
        """A locally-accepted write moved the tip (owner edits, pushed
        patches). Frontier-keyed entries stay correct; dropping them
        keeps the cache from pinning superseded checkouts."""
        self.cache.invalidate(doc_id)

    # ---- contract evaluation ---------------------------------------------

    def _dominates(self, ol, frontier) -> bool:
        with self.store.lock:
            return frontier_known(ol, frontier)

    def _wait_for_version(self, ol, min_version, trace=None,
                          doc_id: str = "") -> bool:
        """Bounded wait for the anti-entropy stream to deliver the
        client's read-your-writes token. Returns satisfaction."""
        if self._dominates(ol, min_version):
            return True
        self.metrics.bump("catchup_waits")
        span = self._span("read.wait", trace, doc=doc_id)
        t0 = time.monotonic()
        ok = False
        try:
            deadline = t0 + self.max_wait_s
            while time.monotonic() < deadline:
                time.sleep(self.poll_interval_s)
                if self._dominates(ol, min_version):
                    ok = True
                    break
        finally:
            dt = time.monotonic() - t0
            self.metrics.observe_wait(dt)
            self.metrics.bump(
                "catchup_satisfied" if ok else "catchup_timeouts")
            span.end(satisfied=ok, wait_s=round(dt, 4))
        return ok

    # ---- materialization -------------------------------------------------

    def _local_body(self, doc_id: str, ol, kind: str):
        """Checkout at the current tip via the cache. Returns
        (body, ctype, remote_frontier)."""
        with self.store.lock:
            frontier = list(ol.version)
            remote = ol.cg.local_to_remote_frontier(frontier)
        fkey = frontier_key(remote)

        def materialize():
            with self.store.lock:
                return self.store.checkout(ol, frontier).snapshot()

        text, _outcome = self.cache.get(doc_id, fkey, materialize)
        if kind == "state":
            body = json.dumps({"text": text, "version": remote}) \
                .encode("utf8")
            return body, "application/json", remote
        return text.encode("utf8"), "text/plain; charset=utf-8", remote

    def _serve_local(self, doc_id: str, ol, kind: str,
                     staleness: Optional[float]) -> ReadResult:
        body, ctype, remote = self._local_body(doc_id, ol, kind)
        headers = {FRONTIER_HEADER: json.dumps(remote),
                   SOURCE_HEADER: "local"}
        if staleness is not None:
            headers[STALENESS_HEADER] = f"{staleness:.3f}"
            self.metrics.observe_staleness(staleness)
        self.metrics.bump("local")
        return ReadResult(200, body, ctype, headers, "local")

    # ---- proxy / refuse --------------------------------------------------

    def _refuse(self, reason: str) -> ReadResult:
        self.metrics.bump("refused")
        body = json.dumps({"error": "read contract unsatisfiable",
                           "reason": reason}).encode("utf8")
        return ReadResult(503, body, "application/json",
                          {SOURCE_HEADER: "refused"}, "refused")

    def _proxy(self, doc_id: str, owner: str, kind: str, reason: str,
               min_version, trace=None,
               soft_fail: bool = False) -> Optional[ReadResult]:
        """``soft_fail`` (steered-follower attempts) returns None on any
        failure instead of minting a 503 — the caller falls back to the
        owner, so the read is not refused and must not count as one."""
        node = self.node
        span = self._span("read.proxy", trace, doc=doc_id, target=owner,
                          reason=reason)
        headers = {"X-DT-Proxied": "1"}
        if min_version is not None:
            headers[MIN_VERSION_HEADER] = json.dumps(min_version)
        ctx = span.context() if span.sampled else trace
        if ctx is not None:
            headers[TRACE_HEADER] = format_context(ctx)
        # advertise wire v1 so the owner may frame the mesh leg; the
        # end client still gets JSON — the saving is hop-only
        wire = getattr(node, "wire", None)
        wire_hdr = wire.header_value() if wire is not None else None
        if wire_hdr is not None:
            from ..wire.frames import WIRE_HEADER
            headers[WIRE_HEADER] = wire_hdr
        try:
            status, body = node.table.call(
                owner, f"/doc/{doc_id}/state",
                timeout=self.proxy_timeout_s, headers=headers)
        except Exception as e:
            span.end(outcome="unreachable", error=e.__class__.__name__)
            if soft_fail:
                return None
            return self._refuse(f"{reason}; owner unreachable")
        if status != 200:
            span.end(outcome=f"status_{status}")
            if soft_fail:
                return None
            return self._refuse(f"{reason}; owner answered {status}")
        try:
            from ..wire.frames import (FRAME_STATE, WireError,
                                       decode_frame, decode_state,
                                       is_frame)
            if is_frame(body):
                ftype, payload = decode_frame(body)
                if ftype != FRAME_STATE:
                    raise WireError("proxy: expected STATE frame")
                text, remote = decode_state(payload)
            else:
                state = json.loads(body)
                text, remote = state["text"], state["version"]
        except (ValueError, KeyError, TypeError):
            span.end(outcome="bad_body")
            if soft_fail:
                return None
            return self._refuse(f"{reason}; bad owner response")
        span.end(outcome="ok")
        self.metrics.bump("proxied_min_version" if reason == "min_version"
                          else "proxied_staleness")
        out_headers = {FRONTIER_HEADER: json.dumps(remote),
                       SOURCE_HEADER: "proxied"}
        if kind == "state":
            # re-inflate for the client regardless of transport framing
            return ReadResult(200, json.dumps(
                {"text": text, "version": remote}).encode("utf8"),
                "application/json", out_headers, "proxied")
        return ReadResult(200, text.encode("utf8"),
                          "text/plain; charset=utf-8", out_headers,
                          "proxied")

    # ---- elastic-mesh hooks ----------------------------------------------

    def warm_on_hydrate(self, doc_id: str, ol=None) -> bool:
        """Hydrator completion hook: pre-materialize the checkout cache
        entry for the doc's current frontier, so the first read after a
        migration/hydration is a cache hit instead of a cold checkout.
        ``ol`` is the freshly-installed oplog when the hydrator calls
        this; store-resident docs pass None and resolve by id.
        Best-effort — a doc evicted between hydrate and this call just
        skips the warm."""
        try:
            with self.store.lock:
                if ol is None:
                    ol = self.store.docs.get(doc_id)
                if ol is None:
                    return False
                frontier = list(ol.version)
                remote = ol.cg.local_to_remote_frontier(frontier)
            fkey = frontier_key(remote)

            def materialize():
                with self.store.lock:
                    return self.store.checkout(ol, frontier).snapshot()

            _text, outcome = self.cache.get(doc_id, fkey, materialize)
        except Exception:       # pragma: no cover - warm must not wedge
            return False
        if outcome == "miss":   # freshly installed, not already warm
            self.metrics.bump("warmed_on_hydrate")
        return outcome in ("miss", "hit")

    def _steer_target(self, doc_id: str, owner: str,
                      max_staleness: Optional[float]):
        """Pick a lightly loaded follower to absorb a staleness proxy
        instead of the owner. Returns (peer_id, owner_advert_frontier)
        or (None, None). Safety comes from the proxy protocol, not the
        load table: we forward the owner's advertised frontier as the
        min-version token, so the steered follower serves only if its
        oplog provably contains it (and refuses otherwise — we then
        fall back to the owner). The load numbers (gossiped held-lease
        counts) only decide WHO to try."""
        node = self.node
        advert = self.index.advert_of(doc_id, owner)
        if advert is None:
            return None, None
        frontier, as_of = advert
        age = max(0.0, time.monotonic() - as_of)
        if max_staleness is not None and age > max_staleness:
            return None, None   # evidence too old to promise anything
        loads = getattr(node, "peer_load", None)
        if not loads:
            return None, None
        owner_load = loads.get(owner)
        if owner_load is None:
            return None, None
        cands = [(load, pid) for pid, load in loads.items()
                 if pid not in (owner, node.self_id)
                 and pid in node.ownership_ids() and load < owner_load]
        if not cands:
            return None, None
        return min(cands)[1], frontier

    # ---- the decision ----------------------------------------------------

    def read(self, doc_id: str, kind: str = "text",
             max_staleness: Optional[float] = None,
             min_version: Optional[List] = None,
             forced_local: bool = False, trace=None) -> ReadResult:
        """Serve one GET under the staleness contract. ``kind`` is
        ``"text"`` (GET /doc/{id}) or ``"state"`` (GET /doc/{id}/state).
        ``forced_local`` marks the owner side of a proxy hop: never
        proxy again (loop guard), but still honor the token."""
        self.metrics.bump("reads")
        obs = self.obs
        if obs is not None and getattr(obs, "attrib", None) is not None:
            # per-doc read attribution: "which doc is hot" is exactly
            # what follower-read placement wants out of /debug/hot
            obs.attrib.note("ops", doc=doc_id)
        ol = self.store.get(doc_id)
        node = self.node

        if node is None:
            # Single-node server: always authoritative.
            return self._serve_local(doc_id, ol, kind, 0.0)

        if forced_local:
            self.metrics.bump("proxied_forced")
            if min_version is not None \
                    and not self._wait_for_version(ol, min_version, trace,
                                                   doc_id):
                return self._refuse("min_version (proxied hop)")
            staleness = 0.0 if node.leases.active_epoch(doc_id) > 0 \
                else None
            return self._serve_local(doc_id, ol, kind, staleness)

        if node.leases.active_epoch(doc_id) > 0:
            # Owner: authoritative, staleness 0. The token is trivially
            # satisfied for writes routed here; a token minted on
            # another replica's degraded local accept may still be
            # missing, so check it.
            if min_version is not None \
                    and not self._wait_for_version(ol, min_version, trace,
                                                   doc_id):
                return self._refuse("min_version (owner missing token)")
            return self._serve_local(doc_id, ol, kind, 0.0)

        # Follower.
        owner = node.route_mutation(doc_id)
        if min_version is not None \
                and not self._wait_for_version(ol, min_version, trace,
                                               doc_id):
            if owner == node.self_id:
                return self._refuse("min_version; no reachable owner")
            return self._proxy(doc_id, owner, kind, "min_version",
                               min_version, trace)

        if max_staleness is not None:
            staleness = self.index.staleness(
                doc_id, owner, lambda fr: self._dominates(ol, fr))
            if staleness is None or staleness > max_staleness:
                if owner == node.self_id:
                    return self._refuse("staleness; no reachable owner")
                # elastic mesh: try a lightly loaded follower first,
                # proving freshness via the min-version token (the
                # owner's advertised frontier, merged with the
                # client's own token); any failure falls back to the
                # owner proxy
                target, adv = self._steer_target(doc_id, owner,
                                                 max_staleness)
                if target is not None:
                    token = list(adv) + list(min_version or [])
                    res = self._proxy(doc_id, target, kind, "staleness",
                                      token, trace, soft_fail=True)
                    if res is not None:
                        self.metrics.bump("proxied_steered")
                        return res
                return self._proxy(doc_id, owner, kind, "staleness",
                                   min_version, trace)
            return self._serve_local(doc_id, ol, kind, staleness)

        # No staleness bound requested: serve local, reporting the
        # bound we could prove (if any) for observability.
        staleness = self.index.staleness(
            doc_id, owner, lambda fr: self._dominates(ol, fr))
        return self._serve_local(doc_id, ol, kind, staleness)


def attach_follower_reads(store, **opts) -> ReadPath:
    """Build a ReadPath, hang it on the store (``store.reads``), and
    wire the owner-side flush-completion invalidation hook when a
    scheduler is attached. Mirrors ``attach_replication``'s shape."""
    rp = ReadPath(store, **opts)
    store.reads = rp
    sched = getattr(store, "scheduler", None)
    if sched is not None:
        sched.read_invalidate = rp.on_flush
        if getattr(sched, "metrics", None) is not None:
            sched.metrics.read = rp.metrics
        # elastic mesh: pre-materialize the checkout cache whenever the
        # residency tier brings a doc warm (first read after a
        # migration/hydration hits instead of checking out cold)
        if getattr(sched, "hydrator", None) is not None:
            sched.hydrator.on_warm = rp.warm_on_hydrate
    # live-telemetry double-write: read counters/staleness/waits land
    # in the windowed TimeSeries for the read-staleness SLO
    obs = getattr(store, "obs", None)
    if obs is not None and getattr(obs, "ts", None) is not None:
        rp.metrics.ts = obs.ts
    return rp
