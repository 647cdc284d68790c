"""Anti-entropy: background convergence between peer servers.

Each round, for each healthy peer, exchange doc lists and version
summaries (`summarize_versions` / `intersect_with_summary` — the exact
handshake `SyncClient` already speaks) and move v1 binary patches for
divergent docs:

  * pull — the peer has ops we lack (`intersect_with_summary` returned
    a remainder): POST our summary to its `/doc/{id}/pull`, decode the
    patch into the local oplog;
  * push — we have ops past the common frontier: encode a patch from
    `common` and POST it to the peer's `/doc/{id}/push` (symmetric, so
    one round converges a pair instead of waiting for the peer's own
    pull pass).

Ownership is irrelevant here on purpose: NON-owners converge too, so a
dead owner's docs are recoverable — the rendezvous successor already
holds the bytes when it takes the lease over. Scheduler merge work
stays owner-only via the admit gate; a pulled patch on a non-owner just
lands in the oplog (host state), no device merge.

Doc-list responses piggyback lease claims, which keeps every host's
lease view fresh without a separate gossip channel. They also
piggyback per-doc frontiers, and an advertised frontier EQUAL to ours
short-circuits the whole per-doc handshake — a frontier uniquely
names its causal downset, so equal frontiers mean nothing to exchange.
Most docs are idle in any given round, which makes this the wire
tier's single biggest bandwidth lever.

Transport rides the wire tier when the peer negotiated it (binary
SUMMARY frames both ways, lz4 PATCH frames, and one SNAPSHOT frame
instead of a patch replay for a peer lagging past the snapshot
threshold); JSON + raw-patch fallback otherwise. Every request body
sent here lands in the `antientropy` wire channel accounting — framed
or not — so before/after scorecards stay comparable.
"""

from __future__ import annotations

import threading
import time
import urllib.error
from typing import Dict, List, Optional

from ..causalgraph.summary import intersect_with_summary, \
    summarize_versions
from ..encoding.decode import decode_into
from ..encoding.encode import ENCODE_PATCH, encode_oplog
from ..wire.frames import (FRAME_DOCS, FRAME_PATCH, FRAME_SUMMARY,
                           WIRE_HEADER, WireError, decode_docs,
                           decode_frame, decode_summary, encode_frame,
                           encode_summary, is_frame)
from ..wire.snapshot import build_snapshot, should_ship_snapshot


class AntiEntropy:
    def __init__(self, node, interval_s: float = 0.5, push: bool = True,
                 max_docs_per_round: Optional[int] = None) -> None:
        self.node = node                  # ReplicaNode (duck-typed)
        self.interval_s = interval_s
        self.push = push
        self.max_docs_per_round = max_docs_per_round
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- one round -------------------------------------------------------

    def run_round(self, peer_id: Optional[str] = None) -> dict:
        """Reconcile with one peer (or every currently-healthy peer).
        Never raises: per-doc failures are counted and the round moves
        on — a flaky link degrades convergence speed, not the loop."""
        node = self.node
        t0 = time.monotonic()
        peers = [peer_id] if peer_id is not None \
            else [p for p in node.table.peer_ids()
                  if node.table.is_healthy(p)]
        # writer-group co-members reconcile FIRST: a split hot doc's
        # in-group visibility lag is the one convergence path user
        # writes now depend on, so it gets the front of every round
        groups = getattr(node, "writergroups", None)
        co = groups.peer_set() if groups is not None else frozenset()
        if co:
            peers.sort(key=lambda p: (p not in co, p))
        report = {"peers": {}, "pulled": 0, "pushed": 0, "errors": 0}
        for p in peers:
            rep = self._round_with(p)
            report["peers"][p] = rep
            report["pulled"] += rep["pulled"]
            report["pushed"] += rep["pushed"]
            report["errors"] += rep["errors"]
        node.metrics.bump("antientropy", "rounds")
        node.metrics.observe_latency("antientropy_round",
                                     time.monotonic() - t0)
        return report

    def _round_with(self, peer_id: str) -> dict:
        node = self.node
        rep = {"docs": 0, "pulled": 0, "pushed": 0, "errors": 0}
        # advert timestamp: stamped BEFORE the request so it is a
        # conservative lower bound on "when the peer was in this state"
        t0 = time.monotonic()
        try:
            listing = self._fetch_listing(peer_id)
        except (OSError, ValueError, urllib.error.HTTPError):
            node.metrics.bump("antientropy", "errors")
            rep["errors"] += 1
            return rep
        remote_docs = listing.get("docs") or {}
        remote_frontiers = {}
        reads = getattr(node.store, "reads", None)
        # piggybacked lease claims keep the lease view fresh
        for doc_id, info in remote_docs.items():
            lease = (info or {}).get("lease")
            if lease:
                node.leases.observe_remote(
                    doc_id, lease["holder"], int(lease["epoch"]),
                    lease.get("state", "active"),
                    float(lease.get("ttl_s", 0.0)))
            # piggybacked frontier advertisement feeds the
            # follower-read staleness contract (read/follower.py);
            # only an advert from the doc's lease HOLDER proves
            # owner-side freshness, so record the peer's own frontier
            frontier = (info or {}).get("frontier")
            if frontier:
                remote_frontiers[doc_id] = frontier
            if reads is not None and frontier:
                reads.index.note_advert(doc_id, peer_id, frontier,
                                        as_of=t0)
                node.metrics.bump("antientropy", "frontier_adverts")
        doc_ids = sorted(set(remote_docs) | set(node.store.doc_ids()))
        if self.max_docs_per_round is not None:
            doc_ids = doc_ids[:self.max_docs_per_round]
        for doc_id in doc_ids:
            try:
                # frontier short-circuit: the peer advertised this
                # doc's frontier on the listing, and it equals ours —
                # equal frontiers imply identical causal downsets, so
                # the summary/pull/push round trip would move nothing.
                # Part of the wire tier: a node pinned to JSON
                # (DT_WIRE_DISABLED) reproduces the pre-wire protocol
                # exactly, which is what before/after baselines diff.
                adv = remote_frontiers.get(doc_id)
                if adv is not None and node.wire.enabled \
                        and self._frontier_matches(doc_id, adv):
                    node.metrics.bump("antientropy", "docs_skipped")
                    rep["docs"] += 1
                    if reads is not None:
                        reads.index.note_reconciled(doc_id, peer_id,
                                                    as_of=t0)
                    continue
                r = self._reconcile_doc(peer_id, doc_id)
                rep["docs"] += 1
                rep["pulled"] += r["pulled"]
                rep["pushed"] += r["pushed"]
            except (OSError, ValueError, KeyError,
                    urllib.error.HTTPError):
                node.metrics.bump("antientropy", "errors")
                rep["errors"] += 1
        return rep

    def _frontier_matches(self, doc_id: str, advert) -> bool:
        """Is the peer's advertised remote frontier identical to ours?
        Never materializes an absent doc (an advertised doc we lack
        must reconcile, not spring into existence here)."""
        store = self.node.store
        with store.lock:
            ol = store.docs.get(doc_id)
            if ol is None:
                return False
            local = ol.cg.local_to_remote_frontier(ol.version)
        return sorted(map(tuple, local)) == sorted(map(tuple, advert))

    def _fetch_listing(self, peer_id: str) -> dict:
        """GET the peer's doc listing — a DOCS frame when it honors the
        `X-DT-Wire` advert, JSON from old peers; the response magic
        decides, exactly like `_fetch_summary`."""
        node = self.node
        hdrs = None
        hv = node.wire.header_value()
        if hv is not None:
            hdrs = {WIRE_HEADER: hv}
        _st, body = node.table.call(peer_id, "/replicate/docs",
                                    headers=hdrs)
        if is_frame(body):
            ftype, payload = decode_frame(body)
            if ftype != FRAME_DOCS:
                raise WireError(f"expected docs frame, got {ftype}")
            return decode_docs(payload)
        import json
        return json.loads(body)

    def _fetch_summary(self, peer_id: str, doc_id: str) -> dict:
        """GET the peer's version summary — framed when it honors the
        `X-DT-Wire` advert, JSON from old peers; the response magic
        decides, so no capability cache is needed on the GET side."""
        node = self.node
        hdrs = None
        hv = node.wire.header_value()
        if hv is not None:
            hdrs = {WIRE_HEADER: hv}
        _st, body = node.table.call(
            peer_id, f"/doc/{doc_id}/summary", headers=hdrs)
        if is_frame(body):
            ftype, payload = decode_frame(body)
            if ftype != FRAME_SUMMARY:
                raise WireError(f"expected summary frame, got {ftype}")
            return decode_summary(payload)
        import json
        return json.loads(body)

    def _reconcile_doc(self, peer_id: str, doc_id: str) -> dict:
        """Summary handshake + patch/snapshot exchange for one doc."""
        import json
        node = self.node
        store = node.store
        node.metrics.bump("antientropy", "docs_checked")
        # reconcile timestamp: a COMPLETED handshake proves the local
        # oplog covers everything the peer had as of the round start
        t0 = time.monotonic()
        remote_summary = self._fetch_summary(peer_id, doc_id)
        ol = store.get(doc_id)
        wire_peer = node.wire.use_wire(peer_id)
        with store.lock:
            common, remainder = intersect_with_summary(
                ol.cg, remote_summary)
            local_summary = summarize_versions(ol.cg)
            # anything of ours past the common frontier, the peer
            # lacks. A peer lagging past the snapshot threshold gets
            # one compacted snapshot frame instead of a patch replay
            # (built outside the lock, frontier-keyed cache).
            push_patch = None
            ship_snapshot = False
            snap_key = ()
            if self.push and sorted(common) != sorted(ol.version):
                if wire_peer and should_ship_snapshot(
                        ol.cg, list(ol.version), common,
                        node.wire.snapshot_ops_threshold):
                    ship_snapshot = True
                    snap_key = tuple(sorted(map(
                        tuple,
                        ol.cg.local_to_remote_frontier(ol.version))))
                else:
                    push_patch = encode_oplog(ol, ENCODE_PATCH,
                                              from_version=common)
        if ship_snapshot:
            hyd = getattr(getattr(store, "scheduler", None),
                          "hydrator", None)
            tstore = getattr(hyd, "store", None)
            push_patch = node.wire.cached_snapshot(
                doc_id, snap_key,
                lambda: build_snapshot(ol, store=tstore, doc_id=doc_id,
                                       oplog_lock=store.lock))
        out = {"pulled": 0, "pushed": 0}
        if remainder:
            from ..obs.trace import NOOP_SPAN, TRACE_HEADER
            obs = getattr(node, "obs", None)
            span = NOOP_SPAN
            hdrs = None
            if obs is not None:
                span = obs.tracer.start(
                    "repl.ae_pull", attrs={"peer": peer_id,
                                           "doc": doc_id})
                if span.sampled:
                    hdrs = {TRACE_HEADER: span.header()}
            # pull request: our summary, framed for a v1 peer; the
            # X-DT-Wire advert asks for a framed (lz4) patch back
            pull_body = json.dumps(local_summary).encode("utf8")
            framed = False
            if wire_peer:
                f = encode_frame(FRAME_SUMMARY,
                                 encode_summary(local_summary),
                                 compress=True)
                if len(f) < len(pull_body):
                    pull_body, framed = f, True
            hv = node.wire.header_value()
            if hv is not None:
                hdrs = dict(hdrs or {})
                hdrs[WIRE_HEADER] = hv
            _st, patch = node.table.call(
                peer_id, f"/doc/{doc_id}/pull", data=pull_body,
                headers=hdrs)
            node.wire.account(
                "antientropy", sent_bytes=len(pull_body),
                json_bytes=len(json.dumps(local_summary)
                               .encode("utf8")) if framed else None,
                framed=framed)
            span.end(bytes=len(patch))
            recv_len = len(patch)
            if is_frame(patch):
                ftype, patch = decode_frame(patch)
                if ftype != FRAME_PATCH:
                    raise WireError(f"expected patch frame, {ftype}")
            with store.lock:
                pre_len = len(ol)
                decode_into(ol, patch)
                n_new = len(ol) - pre_len
            node.metrics.bump("antientropy", "docs_pulled")
            node.metrics.bump("antientropy", "bytes_pulled", recv_len)
            out["pulled"] = 1
            if n_new:
                store.mark_dirty(doc_id)
                store.notify(doc_id)
                # owner-gated: on a non-owner the admit gate denies and
                # the ops stay host-side until the lease moves here
                store.submit_merge(doc_id, n_new)
        reads = getattr(store, "reads", None)
        if reads is not None:
            if out["pulled"]:
                # the doc's tip moved under us: drop cached checkouts
                reads.on_antientropy_apply(doc_id)
            # pull (or no remainder at all) completed: local state now
            # dominates the peer's as of t0
            reads.index.note_reconciled(doc_id, peer_id, as_of=t0)
        if push_patch is not None:
            from ..obs.trace import NOOP_SPAN, TRACE_HEADER
            obs = getattr(node, "obs", None)
            span = NOOP_SPAN
            # X-DT-Replication marks the patch as host-targeted
            # anti-entropy traffic: the peer applies it locally instead
            # of routing it through the mutation proxy (which would
            # bounce an owner-pushed patch straight back to the owner,
            # a 200 no-op that converges nothing)
            hdrs = {"X-DT-Replication": "1"}
            # a raw v1 patch is already binary; the PATCH frame only
            # replaces it when lz4 actually wins. Snapshots are born
            # framed (build_snapshot) and count as one snapshot ship.
            send = push_patch
            framed = ship_snapshot
            if not ship_snapshot and wire_peer:
                f = encode_frame(FRAME_PATCH, push_patch,
                                 compress=True)
                if len(f) < len(push_patch):
                    send, framed = f, True
            if obs is not None:
                span = obs.tracer.start(
                    "repl.ae_push", attrs={"peer": peer_id,
                                           "doc": doc_id,
                                           "bytes": len(send),
                                           "snapshot": ship_snapshot})
                if span.sampled:
                    hdrs[TRACE_HEADER] = span.header()
            t_push = time.monotonic()
            st, _body = node.table.call(peer_id, f"/doc/{doc_id}/push",
                                        data=send, headers=hdrs)
            node.metrics.observe_latency("ae_ship",
                                         time.monotonic() - t_push)
            node.wire.account(
                "antientropy", sent_bytes=len(send),
                json_bytes=len(push_patch)
                if framed and not ship_snapshot else None,
                framed=framed, snapshot=ship_snapshot)
            span.end(status=st)
            node.metrics.bump("antientropy", "docs_pushed")
            node.metrics.bump("antientropy", "bytes_pushed", len(send))
            out["pushed"] = 1
            if obs is not None and st == 200:
                # journey (owner-side bookkeeping of peer facts): the
                # patch left this host AND the peer acknowledged
                # applying it — one round trip observes both stages
                obs.journey.stamp_doc(doc_id, "ae_shipped",
                                      peer=peer_id, t=t_push)
                obs.journey.stamp_doc(doc_id, "applied_at_peer",
                                      peer=peer_id)
        return out

    # ---- background loop -------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_round()
                except Exception:    # pragma: no cover - keep running
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self._stop = threading.Event()
