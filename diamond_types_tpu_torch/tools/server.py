"""Collaborative document sync server + client.

The JAX package's `tools/server.py`, ported. Two places reach the card:
`serve(serve_shards=N)` builds the fused device `MergeScheduler` with the
device plan (K2, then K1 for every flush), and with DT_SERVER_DEVICE set
the history strip is one `gpu/plan_kernels.texts_at_versions` call (K3).
Both take the server's `device` (`serve(device=...)`): None means CUDA,
which must exist, so neither ever falls back to the host engine. Every
checkout the server makes (`DocStore.checkout`) merges on that device
too, where the JAX server calls `OpLog.checkout`: the engine policy may
give a checkout to the zone engine. A fault under a flush is fail-stop:
once the scheduler holds one, every request answers 503 and the replica
node's loop ends.

Capability mirror of the reference's wiki demo app (reference:
wiki/server/server.ts:1-60 — an HTTP server holding an OpLog per document,
exchanging patches with clients, persisting .dt files with rate-limited
autosave; wiki/client/dt_doc.ts — the client keeping a local OpLog in sync).

Protocol (JSON/binary over HTTP; peer sync is stateless pull/push of
v1-format binary patches, and the browser tier's /changes endpoint
long-polls as the braid-subscription equivalent):

  GET  /doc/{id}            -> current document text
  GET  /doc/{id}/summary    -> version summary JSON
  POST /doc/{id}/pull       body: client's summary JSON
                            -> binary patch from the common version
  POST /doc/{id}/push       body: binary patch -> {"ok": true,
                            "collisions": n | null} — n > 0 when folding
                            the pushed ops into the pre-push document
                            resolved genuinely colliding concurrent
                            inserts (has_conflicts_when_merging)

Browser tier (the reference's "dumb client" OT mode — README.md:31-33;
clients are positional, the server's CRDT does the merging; see
web_assets.py for the pages):

  GET  /                    -> index page
  GET  /edit/{id}           -> collaborative editor (HTML/JS)
  GET  /vis/{id}            -> causal-graph visualizer (HTML/JS)
  GET  /doc/{id}/state      -> {"text": ..., "version": [[agent, seq]...]}
  POST /doc/{id}/edit       body {"agent", "version", "ops": [{kind:"ins",
                            pos, text} | {kind:"del", start, end}]}
                            -> {"version": ...} (ops applied AT that
                            version; concurrent edits merge via the CRDT)
  POST /doc/{id}/changes    body {"version": ..., "wait": seconds?} ->
                            {"op": traversal, "version": ...} — OT
                            catch-up since `version`; with `wait` the
                            request long-polls until new ops arrive or
                            the timeout lapses (the braid-subscription
                            equivalent: the reference wiki server streams
                            patches to subscribed clients)
  GET  /doc/{id}/graph      -> causal DAG runs JSON (visualizer data)
  GET  /metrics             -> {"serve": scheduler metrics | null,
                            "replication": ... | null, "obs": ...} —
                            JSON by default (Cache-Control: no-store);
                            `?format=prom` switches to Prometheus text
                            exposition (text/plain; version=0.0.4) with
                            every counter/gauge/histogram as dt_*
                            metrics (obs/prom.py); an Accept header
                            asking for application/openmetrics-text (or
                            `?format=openmetrics`) gets OpenMetrics 1.0
                            with trace exemplars and the # EOF
                            terminator
  GET  /debug/events        -> {"events": [...], "recorded", "dropped",
                            ...} — the flight recorder's bounded ring
                            of structured events (lease transitions,
                            fencing rejections, circuit opens,
                            evictions, queue-bound violations),
                            oldest-first (obs/recorder.py);
                            `?since=<seq>` returns only events after
                            that seq (incremental tailing)
  GET  /debug/slo           -> obs/slo.py snapshot: per-objective burn
                            rates (fast 5m / slow 1h) + alert states
                            (ok|warning|burning)
  GET  /debug/hot           -> obs/attrib.py snapshot: top-K docs and
                            agents by ops/bytes/device_s/cache_misses
  POST /doc/{id}/at         body {"lv": n} -> {"text": ...} time travel
  POST /doc/{id}/history    body {"n": k} -> {"snapshots": [{"lv",
                            "text"}...]} oldest-first history strip; with
                            DT_SERVER_DEVICE=1 the whole strip is ONE
                            batched device call (texts_at_versions,
                            one K3 launch)

Replication tier (--peers host:port,... — replicate/;
N server instances jointly own the document space):

  GET  /replicate/ping      -> {"ok", "id", "uptime_s", "incarnation",
                            "view_version", "rejoining", "members"}
                            — health probe + membership gossip
                            piggyback (the probe loop is the gossip
                            transport)
  GET  /replicate/docs      -> {"docs": {id: {"lease": {holder, epoch,
                            state, ttl_s} | null}}, "self"} — doc list
                            + piggybacked lease claims (anti-entropy)
  POST /replicate/lease     body {"action": "propose"|"grant"|
                            "activate"|"status", "doc", "epoch",
                            "holder"?, "ttl_s"?} -> {"ok": bool, ...}
                            — the quorum + handoff wire protocol
                            (idempotent); "propose" is the voter-side
                            promise round (quorum.py)
  POST /replicate/join      body {"id", "incarnation"} -> {"ok",
                            "members", "peers"} — dynamic join; the
                            response carries the responder's view so
                            the joiner learns the mesh in one trip
  POST /replicate/leave     body {"id"} -> {"ok"} — explicit removal
                            (the only operation that shrinks the
                            quorum denominator)

  Ownership: rendezvous placement of docs over the membership universe
  (replicate/membership.py) + quorum-backed epoch leases
  (replicate/ownership.py, replicate/quorum.py); mutations (/push,
  /edit, /ops) for a doc owned elsewhere are proxied to the lease
  holder (header X-DT-Proxied stops a second hop; X-DT-Lease-Epoch
  carries the fencing token — a receiver whose per-doc epoch floor has
  passed it answers 409 {"error": "fenced"} instead of merging; an
  unreachable owner degrades to a local accept that anti-entropy
  reconciles). Lease state machine, quorum safety argument and failure
  modes: serve/README.md.

Run: python -m diamond_types_tpu_torch.tools.server --port 8008 \
     --data-dir docs/ [--serve-shards N] [--device cpu|cuda]
     [--peers host:port,host:port,...] [--join host:port]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..causalgraph.summary import intersect_with_summary, summarize_versions
from ..encoding.decode import decode_into, load_oplog
from ..encoding.encode import ENCODE_FULL, ENCODE_PATCH, encode_oplog
from ..obs.trace import TRACE_HEADER, parse_header
from ..text.branch import Branch
from ..text.oplog import OpLog
from ..wire.frames import (FRAME_DOCS, FRAME_OPS, FRAME_PATCH,
                           FRAME_SNAPSHOT, FRAME_STATE, FRAME_SUMMARY,
                           WIRE_CTYPE, WIRE_HEADER, WireError,
                           decode_frame, decode_ops, decode_records,
                           decode_summary, encode_docs, encode_frame,
                           encode_state, encode_summary, is_frame)
from ..wire.snapshot import build_snapshot

# Doc ids are filenames (DocStore writes {data_dir}/{id}.dt) and are
# interpolated into the served pages: restrict to a safe charset.
_DOC_ID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


class DocStore:
    """In-memory OpLogs with rate-limited autosave to .dt files
    (reference: wiki/server rate-limited save + atomic replace)."""

    def __init__(self, data_dir: Optional[str] = None,
                 save_interval: float = 3.0) -> None:
        self.data_dir = data_dir
        self.save_interval = save_interval
        self.docs: Dict[str, OpLog] = {}
        self.dirty: Dict[str, float] = {}
        # doc -> consecutive flush failures (encode OR disk write);
        # drives exponential backoff so a persistently-unpersistable doc
        # can't spam stderr and burn O(doc) encode work on every flush
        # pass forever (ADVICE r4)
        self.flush_failures: Dict[str, int] = {}
        # Optional sharded merge scheduler (serve/): when attached, every
        # accepted mutation also queues device-merge work for the doc's
        # shard; its pump thread keeps the session banks warm so reads
        # can come off pre-merged state instead of a cold checkout.
        self.scheduler = None
        # Optional replication node (replicate/): peer mesh membership,
        # doc-ownership leases, anti-entropy. Attached via
        # replicate.attach_replication; when present, mutations for
        # docs this host doesn't own are proxied to the lease holder
        # and the scheduler's admit gate keeps merges owner-only.
        self.replica = None
        # Optional observability bundle (obs/): sampled tracer, flight
        # recorder, per-endpoint latency histograms. serve() attaches
        # one; attach_replication forwards it to the ReplicaNode.
        self.obs = None
        # Optional follower-read tier (read/): staleness-bounded local
        # GETs on non-owner replicas + the shared checkout cache.
        # Attached via read.attach_follower_reads (serve
        # --follower-reads); when absent, GETs keep the classic
        # always-local behavior.
        self.reads = None
        # torch device of the merge scheduler and the device history
        # strip; None = CUDA, which must exist (serve(device=...))
        self.device = None
        from ..analysis.witness import make_lock
        self.lock = make_lock("store.oplog", "oplog")
        # serializes flush passes; deliberately OUTER to the oplog
        # guard (its own `io` rung in the canonical lock order)
        self.io_lock = make_lock("store.io", "io")
        # Long-poll wakeups (one condition per doc; notified on new ops).
        self._conds: Dict[str, threading.Condition] = {}
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None

    def checkout(self, ol: OpLog, frontier) -> Branch:
        """`ol.checkout(frontier)` on the store's device (`checkout`)."""
        return checkout(ol, frontier, self.device)

    def start_flusher(self) -> None:
        """Run autosave on a background thread so the (lock-holding) encode
        never stalls request handlers (reference: the wiki server's
        rate-limited autosave is a timer, not inline in handlers)."""
        if self.data_dir is None or self._flusher is not None:
            return

        def loop():
            while not self._stop.wait(max(self.save_interval, 0.25)):
                try:
                    self.flush()
                except OSError:  # pragma: no cover - disk full etc.
                    pass

        self._flusher = threading.Thread(target=loop, daemon=True)
        self._flusher.start()

    def stop_flusher(self) -> None:
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2)
            self._flusher = None

    def attach_scheduler(self, scheduler) -> None:
        """Wire a serve.MergeScheduler built with resolve=self.get and
        sync_lock=self.lock (so bank syncs never race handler threads)."""
        self.scheduler = scheduler

    def submit_merge(self, doc_id: str, n_ops: int = 1, trace=None,
                     qos: Optional[str] = None):
        """Queue merge work for the doc's shard. No-op (returns None)
        when no scheduler is attached. Backpressure rejects are the
        scheduler's problem, not the edit's: the edit is already durably
        in the oplog, so a rejected submit only delays warm state — the
        next accepted submit or a read-triggered flush catches it up.
        MUST be called OUTSIDE self.lock (the pump thread takes
        scheduler.lock then self.lock; a caller holding self.lock here
        would invert that order and deadlock). `trace` is an optional
        obs SpanContext linking the queued work back to the HTTP
        request that produced it; `qos` the ingress-classified QoS
        class (qos/classes.py) deciding the work's flush deadline."""
        sched = self.scheduler
        if sched is None:
            return None
        return sched.submit(doc_id, n_ops=n_ops, trace=trace, qos=qos)

    def cond(self, doc_id: str) -> threading.Condition:
        with self.lock:
            c = self._conds.get(doc_id)
            if c is None:
                c = self._conds[doc_id] = threading.Condition()
            return c

    def notify(self, doc_id: str) -> None:
        c = self.cond(doc_id)
        with c:
            c.notify_all()

    def _path(self, doc_id: str) -> Optional[str]:
        if self.data_dir is None:
            return None
        return os.path.join(self.data_dir, doc_id + ".dt")

    def doc_ids(self):
        """Every doc this store knows: in-memory oplogs plus persisted
        .dt files not yet loaded (anti-entropy peers list against this,
        so a restarted server still offers its on-disk docs)."""
        with self.lock:
            ids = set(self.docs)
        if self.data_dir and os.path.isdir(self.data_dir):
            for name in os.listdir(self.data_dir):
                if name.endswith(".dt") and _DOC_ID_RE.match(name[:-3]):
                    ids.add(name[:-3])
        return sorted(ids)

    def get(self, doc_id: str) -> OpLog:
        with self.lock:
            ol = self.docs.get(doc_id)
            if ol is None:
                path = self._path(doc_id)
                if path and os.path.exists(path):
                    with open(path, "rb") as f:
                        ol = load_oplog(f.read())
                else:
                    ol = OpLog()
                    ol.doc_id = doc_id
                self.docs[doc_id] = ol
            return ol

    def mark_dirty(self, doc_id: str) -> None:
        with self.lock:
            now = time.monotonic()
            t = self.dirty.setdefault(doc_id, now)
            if t > now:
                # the doc was in encode-failure backoff; a new edit
                # changed its content, so a prompt retry is worth it
                self.dirty[doc_id] = now

    def flush(self, force: bool = False) -> None:
        if self.data_dir is None:
            return
        os.makedirs(self.data_dir, exist_ok=True)
        now = time.monotonic()
        # io_lock serializes whole flush passes: without it, a flusher
        # stalled mid-write could overwrite a NEWER snapshot written by a
        # concurrent flush(force=True) (e.g. server_close) with its stale
        # blob after the dirty flag was already cleared.
        with self.io_lock:
            # Encode UNDER the store lock (/push and /edit mutate oplogs
            # under it; an encode racing a mutation could crash or persist
            # a torn snapshot); only the disk write happens outside it.
            blobs = []
            with self.lock:
                due = [d for d, t in self.dirty.items()
                       if force or now - t >= self.save_interval]
                for d in due:
                    del self.dirty[d]
                    ol = self.docs.get(d)
                    if ol is None:
                        continue
                    try:
                        blobs.append((d, encode_oplog(ol, ENCODE_FULL)))
                    except Exception:
                        # One unencodable doc (e.g. poisoned before input
                        # validation existed) must not abort the pass and
                        # silently drop OTHER docs' dirty flags; re-mark
                        # it so the failure stays visible to retries —
                        # but with exponential backoff (cap 10 min) and
                        # the full traceback only on the FIRST failure,
                        # so a persistently-broken doc degrades to one
                        # retry per backoff window instead of stderr spam
                        # on every pass.
                        if self._note_flush_failure(d, now, "encode") == 1:
                            import traceback
                            traceback.print_exc()
            # Disk writes get the SAME per-doc failure handling: an
            # ENOSPC/EIO on one doc's tmp file must not abort the loop
            # and silently drop the remaining docs' (already-cleared)
            # dirty flags — an idle doc's edits would otherwise never be
            # persisted again.
            for doc_id, blob in blobs:
                path = self._path(doc_id)
                tmp = path + ".tmp"
                try:
                    with open(tmp, "wb") as f:
                        f.write(blob)
                    os.replace(tmp, path)  # atomic
                    # persistence truly completed: only now is the
                    # consecutive-failure streak over (clearing on encode
                    # success would reset a write-failure backoff every
                    # pass and bring back the per-pass log spam)
                    with self.lock:
                        self.flush_failures.pop(doc_id, None)
                    if self.obs is not None:
                        self.obs.journey.stamp_doc(doc_id,
                                                   "wal_durable")
                except OSError:
                    with self.lock:
                        self._note_flush_failure(doc_id, now, "write")

    def _note_flush_failure(self, d: str, now: float, stage: str) -> int:
        """Record one flush failure for doc `d` (caller holds self.lock
        and is inside the `except` block): bump the consecutive-failure
        counter, re-mark the doc dirty with exponential backoff, and log
        on the first failure / each doubling. Returns the new count."""
        fails = self.flush_failures.get(d, 0) + 1
        self.flush_failures[d] = fails
        e = sys.exc_info()[1]
        if fails == 1:
            print(f"flush: {stage} failed for doc {d!r}: {e!r}",
                  file=sys.stderr)
        elif (fails & (fails - 1)) == 0:  # 2, 4, 8, ...
            # keep the current exception text in the trail: the failure
            # REASON can change between passes (content changes cut the
            # backoff) and the first log line may describe a stale cause
            print(f"flush: {stage} still failing for doc {d!r} "
                  f"({fails} consecutive failures, backing off; "
                  f"latest: {e!r})", file=sys.stderr)
        # exponent bounded: 2**fails would overflow float->int conversion
        # near fails=1025 and kill the flusher thread for the whole server
        backoff = min(max(self.save_interval, 1.0)
                      * (2 ** min(fails, 10)), 600.0)
        if self.dirty.get(d) is None:
            # the write path runs outside self.lock: a handler thread may
            # have mark_dirty'd the doc mid-write (new edit -> prompt
            # retry); that timestamp must win over the backoff re-mark
            self.dirty[d] = now + backoff - self.save_interval
        return fails


def _utf8_clean(s: str) -> bool:
    """JSON happily delivers lone surrogates ("\\ud800"); they pass str
    checks but blow up every later encode (utf-8 wire, utf-32 arenas),
    so one accepted op would poison persistence for the whole store."""
    try:
        s.encode("utf8")
        return True
    except UnicodeEncodeError:
        return False


def _patch_agent_names(data: bytes):
    """Agent names declared by a v1 patch/snapshot blob (CHUNK_AGENTNAMES
    inside CHUNK_FILEINFO), WITHOUT applying the patch — push validation
    must run before decode_into mutates the live oplog."""
    from ..encoding.decode import (Buf, CHUNK_AGENTNAMES, CHUNK_FILEINFO,
                                   MAGIC)
    if data[:8] != MAGIC:
        raise ValueError("bad magic")
    buf = Buf(data, 8)
    buf.next_usize()   # protocol version
    names = []
    while not buf.is_empty():
        ctype, chunk = buf.next_chunk()
        if ctype != CHUNK_FILEINFO:
            continue
        while not chunk.is_empty():
            ct2, c2 = chunk.next_chunk()
            if ct2 == CHUNK_AGENTNAMES:
                while not c2.is_empty():
                    names.append(c2.next_str())
        break
    return names


def _agent_name_ok(s) -> bool:
    """Agent names additionally must be BMP-only: agent ordering is a
    CONVERGENCE tie-break, Python/native compare code points while the
    browser engine's `<` compares UTF-16 units, and the two orders
    diverge exactly on astral characters. The engine's single source
    (tools/crdt_replay_src.py) documents this edge as its precondition;
    this is where it is enforced."""
    if not (isinstance(s, str) and s and _utf8_clean(s)):
        return False
    for ch in s:
        if ord(ch) > 0xFFFF:
            return False
    return True


def _crdt_next_seq(aa, agent: int) -> int:
    nxt = 0
    for (lv0, lv1, ag, seq0) in aa.global_runs:
        if ag == agent:
            nxt = max(nxt, seq0 + (lv1 - lv0))
    return nxt


def checkout(ol: OpLog, frontier, device=None) -> Branch:
    """`ol.checkout(frontier)` with `Branch.merge`'s engines on `device`
    (None: CUDA, which must exist), so a server asked for the CPU never
    sends a checkout to the card when the engine policy picks the zone
    engine."""
    b = Branch()
    b.merge(ol, list(frontier), device=device)
    return b


def _crdt_apply_op(ol: OpLog, op: dict, cache: Optional[dict] = None,
                   device=None) -> None:
    """Fold one browser-CRDT op (original position + explicit parents)
    into the oplog; idempotent on (agent, seq) replays. Validation runs
    BEFORE any mutation: a bad op must not leave a half-appended log.

    `cache` (shared across one batch) carries (frontier, doc-length) from
    the previous op: client batches are almost always a linear chain
    (each op's parents = the previous op's result), so only the first op
    pays a full checkout — without it a reconnect pushing hundreds of
    queued ops would run O(ops x history) Branch merges under
    store.lock, stalling every other endpoint."""
    from operator import index as _ix
    name = op["agent"]
    if not _agent_name_ok(name):
        raise ValueError("bad agent name")
    seq = _ix(op["seq"])
    aa = ol.cg.agent_assignment
    # Resolve WITHOUT creating: a rejected op must not leave the agent
    # name registered (rejected-only traffic would otherwise grow the
    # agent table without bound, and the junk names get persisted by the
    # next legitimate flush). The agent is created only at mutation time.
    agent = aa.try_get_agent(name)
    nxt = 0 if agent is None else _crdt_next_seq(aa, agent)
    if seq < nxt:
        return   # already known (client re-push after a dropped response)
    if seq > nxt:
        raise ValueError(f"seq gap: client sent {seq}, log expects {nxt}")
    frontier = list(ol.cg.remote_to_local_frontier(
        [(str(a), _ix(s)) for (a, s) in op.get("parents") or []]))
    # Clients track their frontier as a per-agent max-seq map, so pushed
    # parents may contain dominated heads; store the minimal frontier the
    # rest of the codebase assumes (reference: Frontier is always minimal,
    # src/frontier.rs:23).
    if len(frontier) > 1:
        frontier = list(ol.cg.graph.find_dominators(frontier))
    # Positions are only meaningful against the document AT THE OP'S
    # PARENTS: an out-of-range op accepted here is persisted and poisons
    # every future merge on every peer, so length-check before mutating.
    if cache is not None and cache.get("frontier") == tuple(frontier):
        blen = cache["blen"]
    else:
        blen = len(checkout(ol, frontier, device))
    if op.get("kind") == "ins":
        pos = _ix(op["pos"])
        content = op.get("content")
        if not (isinstance(content, str) and content
                and _utf8_clean(content)):
            raise ValueError("bad ins content")
        if not 0 <= pos <= blen:
            raise ValueError(f"ins pos {pos} out of range 0..{blen}")
        if agent is None:
            agent = ol.get_or_create_agent_id(name)
        lv = ol.add_insert_at(agent, frontier, pos, content)
        blen += len(content)
    elif op.get("kind") == "del":
        start = _ix(op["pos"])
        n = _ix(op["len"])
        if n < 1 or not 0 <= start or start + n > blen:
            raise ValueError(
                f"del range {start}+{n} out of range 0..{blen}")
        # content=None: deleted text is recoverable from history; a full
        # checkout per unit delete under store.lock would be O(history)
        # per character
        if agent is None:
            agent = ol.get_or_create_agent_id(name)
        lv = ol.add_delete_at(agent, frontier, start, start + n, None)
        blen -= n
    else:
        raise ValueError("bad crdt op kind")
    if cache is not None:
        cache["frontier"] = (lv,)
        cache["blen"] = blen


def _crdt_ops_since(ol: OpLog, have: dict) -> list:
    """Every op whose (agent, seq) is at or past the client's next-seq
    map, as per-RUN JSON rows with original positions + remote parents."""
    from ..text.op import INS
    aa = ol.cg.agent_assignment
    g = ol.cg.graph
    out = []
    for (lv0, lv1, agent, seq0) in aa.global_runs:
        name = aa.agent_names[agent]
        nxt = int(have.get(name, 0))
        want_from = lv0 + max(0, nxt - seq0)
        if want_from >= lv1:
            continue
        for piece in ol.ops.iter_range((want_from, lv1)):
            a2, s2 = aa.local_to_agent_version(piece.lv)
            parents = ol.cg.local_to_remote_frontier(
                g.parents_at(piece.lv))
            row = {"agent": aa.agent_names[a2], "seq": s2,
                   "parents": parents,
                   "kind": "ins" if piece.kind == INS else "del",
                   "pos": piece.start, "fwd": bool(piece.fwd)}
            if piece.kind == INS:
                row["content"] = ol.ops.get_run_content(piece)
            else:
                row["len"] = len(piece)
            out.append(row)
    out.sort(key=lambda r: (r["agent"], r["seq"]))
    return out


def doc_history_strip(ol: OpLog, n: int, tip: Optional[list] = None,
                      device=None):
    """Up to `n` historical snapshots of `ol` up to the frozen frontier
    `tip`, oldest-first, as [{"lv", "text"}].

    With DT_SERVER_DEVICE=1 and a conflict zone present, the whole strip
    is materialized by ONE device call on `device` (None: CUDA, which must
    exist): gpu/plan_kernels.py texts_at_versions, one K3 launch — the
    reference can only checkout one version per tracker rebuild,
    src/list/oplog.rs:32. The default path samples host checkouts."""
    if len(ol) == 0:
        return []
    tip = list(ol.version) if tip is None else list(tip)
    from ..listmerge.plan2 import compile_plan2
    plan = compile_plan2(ol.cg.graph, [], tip)
    out = []
    n_entries = len(plan.entries)
    if n_entries and os.environ.get("DT_SERVER_DEVICE"):
        from ..native import native_available
        from ..gpu.plan_kernels import texts_at_versions
        if n == 1:   # strip budget fits only the merged-tip snapshot
            return [{"lv": int(max(t for t in tip)),
                     "text": checkout(ol, tip, device).snapshot()}]
        take = min(n - 1, n_entries)
        idxs = [round(i * (n_entries - 1) / max(take - 1, 1))
                for i in range(take)]
        idxs = sorted(set(idxs))
        source = "native" if native_available() and \
            not os.environ.get("DT_TPU_NO_NATIVE") else "python"
        texts = texts_at_versions(ol, idxs, merge_frontier=tip,
                                  source=source, device=device)
        for k, txt in zip(idxs, texts):
            out.append({"lv": int(plan.entries[k].span[1]) - 1,
                        "text": txt})
        # an entry's snapshot is its own causal cone; the strip's last
        # stop is the MERGED tip (all cones joined)
        out.append({"lv": int(max(t for t in tip)),
                    "text": checkout(ol, tip, device).snapshot()})
        return out
    # host path: sample versions along the LV axis (each checkout is a
    # fast native merge)
    top = max(tip) + 1
    take = min(n, top)
    lvs = sorted({round((i + 1) * top / take) - 1 for i in range(take)})
    for lv in lvs:
        f = ol.cg.graph.find_dominators([lv])
        out.append({"lv": int(lv),
                    "text": checkout(ol, f, device).snapshot()})
    if out and out[-1]["lv"] == top - 1 and len(tip) > 1:
        out[-1] = {"lv": top - 1,
                   "text": checkout(ol, tip, device).snapshot()}
    return out


def _parse_frontier_token(tok: str):
    """Parse an `X-DT-Min-Version` header: a JSON remote frontier
    ([[agent, seq], ...]). Raises ValueError/TypeError on any shape
    the read path couldn't evaluate safely."""
    v = json.loads(tok)
    if not isinstance(v, list):
        raise ValueError("token must be a list")
    out = []
    for h in v:
        if not (isinstance(h, (list, tuple)) and len(h) == 2
                and isinstance(h[0], str)):
            raise ValueError("bad frontier head")
        out.append([h[0], int(h[1])])
    return out


class SyncHandler(BaseHTTPRequestHandler):
    store: DocStore = None  # class attr, set by serve()

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str = "application/json",
              extra: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _wire(self):
        """This node's WireChannel, or None when replication is off
        (single-server mode has no mesh transport to account)."""
        node = self.store.replica
        return node.wire if node is not None else None

    def _wire_reply_ok(self) -> bool:
        """May this response be a binary frame? Only when the REQUEST
        advertised `X-DT-Wire` (so the caller decodes frames) AND this
        node's framing is on — a node pinned to JSON behaves like an
        old build end to end, though it still accepts inbound frames."""
        w = self._wire()
        return (w is not None and w.enabled
                and self.headers.get(WIRE_HEADER) is not None)

    def _route(self):
        # query string stripped: GET doc endpoints take contract
        # params (?max_staleness=) that must not leak into the action
        parts = self.path.split("?", 1)[0].strip("/").split("/")
        if len(parts) >= 2 and parts[0] == "doc" and _DOC_ID_RE.match(parts[1]):
            return parts[1], (parts[2] if len(parts) > 2 else "")
        return None, None

    def _endpoint_label(self) -> str:
        """Bounded-cardinality endpoint label for the per-endpoint
        latency histograms: doc ids collapse to the sub-action, unknown
        paths collapse to "other" (a scanner must not mint histogram
        series)."""
        path = self.path.split("?", 1)[0]
        parts = path.strip("/").split("/")
        head = parts[0] if parts else ""
        if head == "":
            return "index"
        if head == "doc":
            sub = parts[2] if len(parts) > 2 else "text"
            return "doc_" + (sub if sub in (
                "summary", "state", "graph", "pull", "push", "edit",
                "changes", "ops", "history", "at", "text",
                "snapshot") else "other")
        if head in ("replicate", "debug") and len(parts) == 2:
            return f"{head}_{parts[1]}"
        if head == "debug" and len(parts) == 3 \
                and parts[1] in ("trace", "incidents"):
            # trace/incident ids must not mint series
            return f"debug_{parts[1]}"
        if head in ("metrics", "edit", "vis", "crdt"):
            return head
        return "other"

    def _trace_ctx(self):
        """SpanContext of this request's http span (None when the
        request wasn't sampled) — threaded into scheduler submits and
        proxy hops so one edit yields one trace."""
        span = getattr(self, "_span", None)
        if span is not None and span.sampled:
            return span.context()
        return None

    def _refused_for_fault(self) -> bool:
        """Fail-stop: once the merge scheduler holds a fault (a K1/K2
        launch that raised under a flush, on whatever path caught it),
        every request answers 503 with the fault. Peers' probes of
        /replicate/ping fail with it, so they route around this node."""
        sched = self.store.scheduler
        fault = sched.fault if sched is not None else None
        if fault is None:
            return False
        # read the body off first: closing over unread bytes resets the
        # connection before the client reads the answer
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self._send(503, json.dumps(
            {"error": "scheduler_fault",
             "fault": f"{fault.__class__.__name__}: {fault}"[:200]})
            .encode("utf8"))
        return True

    def do_GET(self):
        if self._refused_for_fault():
            return
        obs = self.store.obs
        t0 = time.monotonic()
        try:
            self._do_get()
        finally:
            if obs is not None:
                obs.hist.observe("http_request", time.monotonic() - t0,
                                 endpoint=self._endpoint_label(),
                                 method="GET")

    def _do_get(self):
        from .web_assets import (CRDT_HTML, EDITOR_HTML, INDEX_HTML,
                                 VIS_HTML)

        if self.path == "/" or self.path == "":
            return self._send(200, INDEX_HTML.encode("utf8"),
                              "text/html; charset=utf-8")
        path = self.path.split("?", 1)[0]
        # segment routing off the query-stripped path: /debug/events
        # and /metrics take query parameters (?since=, ?format=)
        parts = path.strip("/").split("/")
        if path == "/metrics":
            # serve/ scheduler counters (queue depths, flush sizes,
            # occupancy, evictions...) + replicate/ counters (leases,
            # handoffs, anti-entropy, per-peer backoff state) + obs
            # snapshots — JSON for bench/soak scrapers by default,
            # `?format=prom` renders the SAME document as Prometheus
            # text exposition. no-store either way: a cached scrape is
            # a wrong scrape.
            sched = self.store.scheduler
            node = self.store.replica
            obs = self.store.obs
            doc = {"serve": sched.metrics_json() if sched else None,
                   "replication": node.metrics_json() if node else None,
                   "read": self.store.reads.metrics.snapshot()
                   if self.store.reads is not None else None,
                   "qos": sched.qos.export()
                   if sched is not None and sched.qos is not None
                   else None}
            if obs is not None:
                doc["obs"] = obs.snapshot()
            qs = urllib.parse.parse_qs(
                self.path.partition("?")[2], keep_blank_values=True)
            no_store = {"Cache-Control": "no-store"}
            fmt = qs.get("format", [""])[0]
            if fmt in ("prom", "openmetrics"):
                from ..obs.prom import (CONTENT_TYPE,
                                        OPENMETRICS_CONTENT_TYPE,
                                        render_metrics)
                # content negotiation: `?format=openmetrics` forces
                # OpenMetrics 1.0; `?format=prom` honors an Accept
                # header asking for it (how real Prometheus scrapers
                # request exemplar-capable exposition)
                accept = self.headers.get("Accept", "") or ""
                om = (fmt == "openmetrics"
                      or "application/openmetrics-text" in accept)
                text = render_metrics(doc, openmetrics=om)
                ctype = OPENMETRICS_CONTENT_TYPE if om else CONTENT_TYPE
                return self._send(200, text.encode("utf8"), ctype,
                                  extra=no_store)
            return self._send(200, json.dumps(doc).encode("utf8"),
                              extra=no_store)
        if parts[:1] == ["debug"]:
            obs = self.store.obs
            no_store = {"Cache-Control": "no-store"}
            if obs is not None and len(parts) == 2 \
                    and parts[1] == "events":
                # `?since=<seq>` tails the ring incrementally (obs-watch
                # polls this instead of re-downloading every event)
                qs = urllib.parse.parse_qs(
                    self.path.partition("?")[2], keep_blank_values=True)
                rec = obs.recorder
                out = dict(rec.stats())
                try:
                    since = int(qs.get("since", ["0"])[0] or 0)
                except ValueError:
                    return self._send(400, b'{"error": "bad since"}')
                out["since"] = since
                out["events"] = (rec.dump_since(since) if since > 0
                                 else rec.dump())
                return self._send(200, json.dumps(out).encode("utf8"),
                                  extra=no_store)
            if obs is not None and len(parts) == 2 and parts[1] == "slo":
                # live SLO burn rates + alert states (pull-evaluated)
                return self._send(
                    200, json.dumps(obs.slo.snapshot()).encode("utf8"),
                    extra=no_store)
            if obs is not None and len(parts) == 2 and parts[1] == "hot":
                # top-K hot-doc/agent attribution (bounded sketch)
                return self._send(
                    200,
                    json.dumps(obs.attrib.snapshot()).encode("utf8"),
                    extra=no_store)
            if len(parts) == 2 and parts[1] == "qos":
                # adaptive-admission controller state: per-class
                # effective deadlines + counters, shed gate, specs
                sched = self.store.scheduler
                qctl = sched.qos if sched is not None else None
                out = qctl.export() if qctl is not None \
                    else {"enabled": False}
                return self._send(200, json.dumps(out).encode("utf8"),
                                  extra=no_store)
            if obs is not None and parts[1:2] == ["trace"] \
                    and len(parts) == 3:
                # local spans of one trace, plus this host's monotonic
                # "now" — `cli dt-trace` pairs it with its own
                # send/recv timestamps to estimate the clock offset
                # (obs/assemble.py) before merging peers' spans
                node = self.store.replica
                host = node.self_id if node is not None else "local"
                out = {"host": host, "trace": parts[2],
                       "now": round(time.monotonic(), 6),
                       "spans": obs.tracer.find(parts[2])}
                return self._send(200, json.dumps(out).encode("utf8"),
                                  extra=no_store)
            if obs is not None and len(parts) == 2 \
                    and parts[1] == "incidents":
                # incident-bundle index: counts by kind + newest-first
                # rows (cli dt-incidents / obs-watch poll this)
                node = self.store.replica
                host = node.self_id if node is not None else "local"
                out = {"host": host, **obs.incidents.index_json()}
                return self._send(200, json.dumps(out).encode("utf8"),
                                  extra=no_store)
            if obs is not None and parts[1:2] == ["incidents"] \
                    and len(parts) == 3:
                # one full evidence bundle by id (404s after eviction —
                # the persisted JSON under the data dir outlives the
                # in-memory ring)
                bundle = obs.incidents.get(parts[2])
                if bundle is None:
                    return self._send(404, b"{}")
                return self._send(
                    200, json.dumps(bundle, default=str).encode("utf8"),
                    extra=no_store)
            if obs is not None and len(parts) == 2 \
                    and parts[1] == "traces":
                # recent sampled trace index (newest first): the entry
                # point for picking a trace id to assemble
                node = self.store.replica
                host = node.self_id if node is not None else "local"
                out = {"host": host,
                       "now": round(time.monotonic(), 6),
                       "traces": obs.tracer.index()}
                return self._send(200, json.dumps(out).encode("utf8"),
                                  extra=no_store)
            return self._send(404, b"{}")
        if parts and parts[0] == "replicate":
            node = self.store.replica
            if node is None:
                return self._send(404, b"{}")
            if len(parts) == 2 and parts[1] == "ping":
                body = json.dumps(node.ping_json()).encode("utf8")
                # ping IS the gossip transport: its response bytes are
                # the gossip channel's whole volume
                node.wire.account("gossip", sent_bytes=len(body))
                return self._send(200, body)
            if len(parts) == 2 and parts[1] == "docs":
                # doc list + piggybacked lease claims + frontier
                # adverts (anti-entropy round preamble). Re-sent every
                # round, so once deltas stop flowing this listing IS
                # the channel's steady-state cost — frame it.
                listing = node.docs_json()
                body = json.dumps(listing).encode("utf8")
                if self._wire_reply_ok():
                    frame = encode_frame(FRAME_DOCS,
                                         encode_docs(listing),
                                         compress=True)
                    node.wire.account("antientropy",
                                      sent_bytes=len(frame),
                                      json_bytes=len(body), framed=True)
                    return self._send(200, frame, WIRE_CTYPE)
                node.wire.account("antientropy", sent_bytes=len(body))
                return self._send(200, body)
            return self._send(404, b"{}")
        if len(parts) == 2 and parts[0] in ("edit", "vis", "crdt"):
            if not _DOC_ID_RE.match(parts[1]):
                return self._send(404, b"{}")
            page = {"edit": EDITOR_HTML, "vis": VIS_HTML,
                    "crdt": CRDT_HTML}[parts[0]]
            return self._send(200, page.replace("__DOC__", parts[1])
                              .encode("utf8"), "text/html; charset=utf-8")

        doc_id, action = self._route()
        if doc_id is None:
            return self._send(404, b"{}")
        # every checkout-bearing GET is frontier-dependent state: an
        # intermediary cache serving it stale would silently violate
        # the read contract, so all four doc views are no-store
        no_store = {"Cache-Control": "no-store"}
        if action in ("", "state") and self.store.reads is not None:
            return self._read_with_contract(doc_id, action, no_store)
        if action == "snapshot":
            # routed BEFORE store.get: 404ing a doc that was never
            # materialized here must not mint an empty oplog for it
            return self._doc_snapshot(doc_id, no_store)
        ol = self.store.get(doc_id)
        if action == "":
            with self.store.lock:
                text = self.store.checkout(ol, ol.version).snapshot()
                frontier = ol.cg.local_to_remote_frontier(ol.version)
            return self._send(200, text.encode("utf8"),
                              "text/plain; charset=utf-8",
                              extra={**no_store,
                                     "X-DT-Frontier":
                                     json.dumps(frontier)})
        if action == "summary":
            with self.store.lock:
                summary = summarize_versions(ol.cg)
            body = json.dumps(summary).encode("utf8")
            w = self._wire()
            if self._wire_reply_ok():
                frame = encode_frame(FRAME_SUMMARY,
                                     encode_summary(summary),
                                     compress=True)
                w.account("antientropy", sent_bytes=len(frame),
                          json_bytes=len(body), framed=True)
                return self._send(200, frame, WIRE_CTYPE, extra=no_store)
            if w is not None:
                w.account("antientropy", sent_bytes=len(body))
            return self._send(200, body, extra=no_store)
        if action == "state":
            with self.store.lock:
                frontier = ol.cg.local_to_remote_frontier(ol.version)
                body = json.dumps({
                    "text": self.store.checkout(ol, ol.version)
                    .snapshot(),
                    "version": frontier})
            return self._send(200, body.encode("utf8"),
                              extra={**no_store,
                                     "X-DT-Frontier":
                                     json.dumps(frontier)})
        if action == "graph":
            with self.store.lock:
                g = ol.cg.graph
                aa = ol.cg.agent_assignment
                runs = []
                for i in range(len(g.starts)):
                    agent, _seq = aa.local_to_agent_version(g.starts[i])
                    runs.append({"start": g.starts[i], "end": g.ends[i],
                                 "parents": list(g.parents[i]),
                                 "agent": aa.get_agent_name(agent)})
            return self._send(200, json.dumps({"runs": runs}).encode("utf8"),
                              extra=no_store)
        return self._send(404, b"{}")

    def _doc_snapshot(self, doc_id: str, no_store: dict):
        """GET /doc/{id}/snapshot — compacted-snapshot frame for
        far-behind peers and cold remote hydration fills. The frame is
        cached per frontier in the node's WireChannel, so a thundering
        herd of cold followers costs one encode. 404 when replication
        or framing is off, or the doc isn't materialized here."""
        node = self.store.replica
        if node is None or not node.wire.enabled:
            return self._send(404, b"{}")
        with self.store.lock:
            ol = self.store.docs.get(doc_id)
            if ol is None:
                return self._send(404, b"{}")
            key = tuple(sorted(map(
                tuple, ol.cg.local_to_remote_frontier(ol.version))))
        hyd = getattr(self.store.scheduler, "hydrator", None)
        tstore = getattr(hyd, "store", None)
        frame = node.wire.cached_snapshot(
            doc_id, key,
            lambda: build_snapshot(ol, store=tstore, doc_id=doc_id,
                                   oplog_lock=self.store.lock))
        node.wire.account("hydrate", sent_bytes=len(frame),
                          framed=True, snapshot=True)
        return self._send(200, frame, WIRE_CTYPE, extra=no_store)

    def _read_with_contract(self, doc_id: str, action: str,
                            no_store: dict):
        """Follower-read path for GET /doc/{id} and /doc/{id}/state:
        parse `?max_staleness=` + `X-DT-Min-Version`, then delegate the
        local/wait/proxy/refuse decision to the attached ReadPath
        (read/path.py). `X-DT-Proxied` marks the owner side of a proxy
        hop — served locally, never re-proxied."""
        from ..read.path import MIN_VERSION_HEADER
        qs = urllib.parse.parse_qs(self.path.partition("?")[2],
                                   keep_blank_values=True)
        raw = qs.get("max_staleness", [None])[0]
        max_staleness = None
        if raw not in (None, ""):
            try:
                max_staleness = float(raw)
            except ValueError:
                return self._send(400, json.dumps(
                    {"error": "bad max_staleness"}).encode("utf8"))
            if max_staleness < 0 or max_staleness != max_staleness:
                return self._send(400, json.dumps(
                    {"error": "bad max_staleness"}).encode("utf8"))
        min_version = None
        tok = self.headers.get(MIN_VERSION_HEADER)
        if tok:
            try:
                min_version = _parse_frontier_token(tok)
            except (ValueError, TypeError):
                return self._send(400, json.dumps(
                    {"error": "bad min_version token"}).encode("utf8"))
        proxied = self.headers.get("X-DT-Proxied") is not None
        res = self.store.reads.read(
            doc_id, "text" if action == "" else "state",
            max_staleness=max_staleness, min_version=min_version,
            forced_local=proxied,
            trace=parse_header(self.headers.get(TRACE_HEADER)))
        if proxied and action == "state" and res.status == 200:
            # owner side of a follower's proxy hop: the mesh leg can be
            # framed (the follower re-inflates JSON for its client);
            # accounted here because this host sends the response bytes
            w = self._wire()
            if w is not None:
                framed = False
                send = res.body
                if self._wire_reply_ok():
                    try:
                        state = json.loads(res.body)
                        frame = encode_frame(
                            FRAME_STATE,
                            encode_state(state["text"], state["version"]),
                            compress=True)
                        if len(frame) < len(res.body):
                            send, framed = frame, True
                    except (ValueError, KeyError, TypeError):
                        pass  # non-JSON body: fall through unframed
                w.account("proxy", sent_bytes=len(send),
                          json_bytes=len(res.body) if framed else None,
                          framed=framed)
                if framed:
                    return self._send(200, send, WIRE_CTYPE,
                                      extra={**no_store, **res.headers})
        return self._send(res.status, res.body, res.ctype,
                          extra={**no_store, **res.headers})

    def do_POST(self):
        # Malformed JSON bodies / missing keys / non-numeric values on any
        # browser endpoint — and corrupt binary patches on /push
        # (ParseError) — are client errors, not handler-thread crashes.
        from ..encoding.decode import ParseError
        if self._refused_for_fault():
            return
        obs = self.store.obs
        t0 = time.monotonic()
        if obs is not None:
            # Root (or continued) span for this request: an X-DT-Trace
            # header from a proxying peer or traced client stitches this
            # hop into the caller's trace; otherwise head-sampling here
            # decides for every downstream span (admit, flush, proxy).
            self._span = obs.tracer.start(
                "http." + self._endpoint_label(),
                parent=parse_header(self.headers.get(TRACE_HEADER)),
                attrs={"path": self.path.split("?", 1)[0]})
        try:
            self._do_post()
        except (ValueError, KeyError, TypeError, AttributeError,
                ParseError) as e:
            try:
                self._send(400, json.dumps(
                    {"error": f"bad request: {e.__class__.__name__}"})
                    .encode("utf8"))
            except OSError:
                pass  # client already gone
        finally:
            if obs is not None:
                span = getattr(self, "_span", None)
                if span is not None:
                    span.end()
                obs.hist.observe("http_request", time.monotonic() - t0,
                                 endpoint=self._endpoint_label(),
                                 method="POST")

    def _do_post(self):
        parts = self.path.strip("/").split("/")
        if parts[:1] == ["replicate"]:
            node = self.store.replica
            if node is None or len(parts) != 2 or parts[1] not in (
                    "lease", "join", "leave"):
                return self._send(404, b"{}")
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            handler = {"lease": node.handle_lease_message,
                       "join": node.handle_join,
                       "leave": node.handle_leave}[parts[1]]
            return self._send(200, json.dumps(handler(req))
                              .encode("utf8"))
        doc_id, action = self._route()
        if doc_id is None:
            return self._send(404, b"{}")
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        obs = self.store.obs
        if obs is not None and n and action in ("push", "edit", "ops"):
            # per-doc request-byte attribution (the agent dimension is
            # noted in the JSON handlers once the body names one)
            obs.attrib.note("bytes", doc=doc_id, n=float(n))
        # QoS ingress classification: explicit X-DT-QoS header wins,
        # anti-entropy pushes (X-DT-Replication) are catchup, everything
        # else interactive. Classified BEFORE the ownership proxy so a
        # forwarded mutation keeps its class at the owner. Mutations
        # ONLY: reads (e.g. the `changes` long-poll) never hit the shed
        # gate, so a hot tenant's polling can't drain — or be throttled
        # by — its own write token bucket.
        qos_cls = None
        if action in ("push", "edit", "ops"):
            from ..qos.classes import classify_headers, tenant_of
            qos_cls = classify_headers(self.headers)
        node = self.store.replica
        if node is not None and action in ("push", "edit", "ops"):
            # Fencing check first: a proxied mutation carries the lease
            # epoch its proxier routed by (X-DT-Lease-Epoch). If our
            # per-doc epoch floor has passed it, the routing was based
            # on a superseded lease — refuse with 409 rather than merge
            # under stale ownership (the proxier falls back to a local
            # accept and anti-entropy reconciles).
            claimed = self.headers.get("X-DT-Lease-Epoch")
            if claimed is not None:
                try:
                    claimed_epoch = int(claimed)
                except ValueError:
                    return self._send(400, b'{"error": "bad epoch"}')
                if not node.check_write_fence(doc_id, claimed_epoch):
                    return self._send(409, json.dumps(
                        {"error": "fenced",
                         "max_epoch": node.leases.max_epoch_of(doc_id)}
                        ).encode("utf8"))
            # Mutations belong on the doc's lease holder: proxy them
            # there so device merges run on exactly one host. A request
            # that already hopped once is never re-proxied (two hosts
            # with a split health view would otherwise bounce it
            # forever) and an unreachable owner degrades to a local
            # accept — the edit is durable here, the merge gate keeps
            # device work off this host, anti-entropy reconciles. A
            # writer-group member in good standing (group_accepts)
            # accepts locally too — splitting the hot doc's write path
            # across the group is the feature's whole point.
            target = node.route_mutation(doc_id)
            if target != node.self_id \
                    and not node.group_accepts(doc_id) \
                    and self.headers.get("X-DT-Replication") is None:
                # X-DT-Replication = host-targeted anti-entropy patch:
                # the sender chose THIS host deliberately (usually it
                # IS the owner pushing down to a follower), so routing
                # it back through the ownership proxy would return it
                # to the sender as a 200 no-op. Apply locally instead.
                if self.headers.get("X-DT-Proxied") is not None:
                    node.metrics.bump("proxy", "loops_refused")
                else:
                    relay = node.proxy(target, self.path, body,
                                       doc_id=doc_id,
                                       trace=self._trace_ctx(),
                                       qos=qos_cls)
                    if relay is not None:
                        status, resp = relay
                        return self._send(status, resp)
        if qos_cls is not None:
            # Shed gate — consulted BEFORE the mutation touches the
            # oplog, so a shed is a real load shield (nothing becomes
            # durable that a flush must later pay for). The controller
            # 429s sheddable classes when the mesh burns and any class
            # when its tenant's token bucket is dry; interactive under
            # a healthy mesh always passes.
            sched = self.store.scheduler
            qctl = sched.qos if sched is not None else None
            if qctl is not None:
                admitted, retry_after, reason = qctl.admit(
                    qos_cls, tenant=tenant_of(doc_id))
                if not admitted:
                    return self._send(
                        429,
                        json.dumps({"error": "shed", "qos": qos_cls,
                                    "reason": reason,
                                    "retry_after": round(retry_after, 3)}
                                   ).encode("utf8"),
                        extra={"Retry-After":
                               f"{max(retry_after, 0.0):.3f}",
                               "Cache-Control": "no-store"})
        ol = self.store.get(doc_id)
        if action == "pull":
            if is_frame(body):
                ftype, payload = decode_frame(body)
                if ftype != FRAME_SUMMARY:
                    raise WireError("pull body: expected SUMMARY frame")
                summary = decode_summary(payload)
            else:
                summary = json.loads(body or b"{}")
            with self.store.lock:
                common, _rem = intersect_with_summary(ol.cg, summary)
                patch = encode_oplog(ol, ENCODE_PATCH, from_version=common)
            w = self._wire()
            if self._wire_reply_ok():
                frame = encode_frame(FRAME_PATCH, patch, compress=True)
                if len(frame) < len(patch):
                    w.account("antientropy", sent_bytes=len(frame),
                              json_bytes=len(patch), framed=True)
                    return self._send(200, frame, WIRE_CTYPE)
            if w is not None:
                w.account("antientropy", sent_bytes=len(patch))
            return self._send(200, patch, "application/octet-stream")
        if action == "push":
            # wire frames unwrap FIRST: agent-name validation below must
            # see the raw DMNDTYPS blob(s), not the frame envelope. A
            # PATCH frame carries one patch; a SNAPSHOT frame carries a
            # record list (compacted far-behind catch-up) replayed in
            # order under the same lock.
            blobs = [body]
            if is_frame(body):
                ftype, payload = decode_frame(body)
                if ftype == FRAME_PATCH:
                    blobs = [payload]
                elif ftype == FRAME_SNAPSHOT:
                    blobs = decode_records(payload)
                else:
                    raise WireError(
                        "push body: expected PATCH or SNAPSHOT frame")
            # the binary path must enforce the same agent-name rules as
            # the JSON paths — a patch can register brand-new agents, and
            # an astral name would poison browser-vs-server convergence
            # for the whole doc (see _agent_name_ok)
            try:
                bad = [nm for blob in blobs
                       for nm in _patch_agent_names(blob)
                       if not _agent_name_ok(nm)]
            except Exception:
                return self._send(400, b'{"error": "bad patch"}')
            if bad:
                return self._send(400, b'{"error": "bad agent name"}')
            with self.store.lock:
                pre = list(ol.version)
                pre_len = len(ol)
                for blob in blobs:
                    decode_into(ol, blob)
                n_new = len(ol) - pre_len
                # Does folding the pushed ops into the pre-push document
                # actually collide (concurrent inserts at one gap)?
                # Surfaced so clients can flag ambiguous merges
                # (reference: has_conflicts_when_merging, merge.rs:51).
                # Cheap plan gate first: a push whose ops fast-forward
                # from `pre` (no conflict zone) can't collide — skip the
                # O(history) native transform for the common linear case.
                try:
                    from ..listmerge.plan2 import compile_plan2
                    plan = compile_plan2(ol.cg.graph, pre,
                                         list(ol.version))
                    collisions = 0 if not plan.entries else \
                        ol.count_conflicts_when_merging(pre)
                except Exception:
                    collisions = None
            self.store.mark_dirty(doc_id)
            self.store.notify(doc_id)
            if self.store.reads is not None:
                self.store.reads.on_local_mutation(doc_id)
            if n_new:
                tctx = self._trace_ctx()
                if obs is not None and tctx is not None \
                        and self.headers.get("X-DT-Replication") is None:
                    # journey opens at ingress (before submit_merge:
                    # begin is first-wins, the handler owns identity);
                    # binary patches carry agent names but no single
                    # (agent, seq), so identity is the first new agent.
                    # Anti-entropy patches are excluded: those edits'
                    # journeys live on their owner, not here.
                    agents = _patch_agent_names(blobs[0])
                    obs.journey.begin(agents[0] if agents else None,
                                      None, doc=doc_id,
                                      trace=tctx.trace_id)
                self.store.submit_merge(doc_id, n_new, trace=tctx,
                                        qos=qos_cls)
            return self._send(200, json.dumps(
                {"ok": True, "collisions": collisions}).encode("utf8"))
        if action == "edit":
            if is_frame(body):
                ftype, payload = decode_frame(body)
                if ftype != FRAME_OPS:
                    raise WireError("edit body: expected OPS frame")
                req = decode_ops(payload)
            else:
                req = json.loads(body)
            # Normalize each op ONCE (ints coerced exactly once, via
            # operator.index so floats like 3.7 are rejected, not
            # truncated) and use the normalized list for BOTH validation
            # and application — a value that passes validation can then
            # never reach the oplog in a different form.
            from operator import index as _ix
            ops = []
            for op in req["ops"]:
                if op.get("kind") == "ins":
                    ops.append(("ins", _ix(op["pos"]), op.get("text")))
                elif op.get("kind") == "del":
                    ops.append(("del", _ix(op["start"]), _ix(op["end"])))
                else:
                    return self._send(400, b'{"error": "bad op"}')
            if not _agent_name_ok(req.get("agent")):
                return self._send(400, b'{"error": "bad agent"}')
            if obs is not None:
                obs.attrib.note("ops", agent=req["agent"], n=len(ops))
                obs.attrib.note("bytes", agent=req["agent"], n=float(n))
            with self.store.lock:
                frontier = list(ol.cg.remote_to_local_frontier(
                    req.get("version") or []))
                # Validate the WHOLE batch against the doc length at the
                # client's version before touching the oplog: a rejected op
                # must not leave earlier batch ops half-applied.
                blen = len(self.store.checkout(ol, frontier))
                for op in ops:
                    if op[0] == "ins":
                        _k, pos, text = op
                        if not (isinstance(text, str) and text
                                and _utf8_clean(text)
                                and 0 <= pos <= blen):
                            return self._send(400, b'{"error": "bad op"}')
                        blen += len(text)
                    else:
                        _k, start, end = op
                        if not 0 <= start < end <= blen:
                            return self._send(400, b'{"error": "bad op"}')
                        blen -= end - start
                agent = ol.get_or_create_agent_id(req["agent"])
                for op in ops:
                    if op[0] == "ins":
                        lv = ol.add_insert_at(agent, frontier, op[1], op[2])
                    else:
                        lv = ol.add_delete_at(agent, frontier, op[1],
                                              op[2], None)
                    frontier = [lv]
                out = ol.cg.local_to_remote_frontier(frontier)
            self.store.mark_dirty(doc_id)
            self.store.notify(doc_id)
            if self.store.reads is not None:
                self.store.reads.on_local_mutation(doc_id)
            tctx = self._trace_ctx()
            if obs is not None and tctx is not None:
                # journey identity = the edit's (agent, last seq): the
                # post-apply remote frontier carries the agent's head
                seq = next((s for a, s in out if a == req["agent"]),
                           None)
                obs.journey.begin(req["agent"], seq, doc=doc_id,
                                  trace=tctx.trace_id)
            self.store.submit_merge(doc_id, len(ops), trace=tctx,
                                    qos=qos_cls)
            return self._send(200, json.dumps({"version": out})
                              .encode("utf8"))
        if action == "changes":
            from ..text import ot
            req = json.loads(body or b"{}")
            try:
                wait = min(max(float(req.get("wait") or 0), 0.0), 60.0)
            except (TypeError, ValueError):
                return self._send(400, b'{"error": "bad wait"}')
            deadline = time.monotonic() + wait
            c = self.store.cond(doc_id)
            # The condition is held around BOTH the emptiness check and the
            # wait (notify_all also runs under it), so a notify can never
            # land in between and be lost.
            with c:
                while True:
                    with self.store.lock:
                        frontier = list(ol.cg.remote_to_local_frontier(
                            req.get("version") or []))
                        trav = ot.xf_stream_to_traversal(
                            ol.iter_xf_operations_from(frontier, ol.version))
                        out = {"op": trav,
                               "version": ol.cg.local_to_remote_frontier(
                                   ol.cg.graph.version_union(frontier,
                                                             ol.version))}
                    remaining = deadline - time.monotonic()
                    if trav or remaining <= 0:
                        return self._send(200,
                                          json.dumps(out).encode("utf8"))
                    c.wait(timeout=min(remaining, 5.0))
        if action == "ops":
            # In-browser CRDT peer protocol (reference: the wiki app's
            # WASM client runs the full CRDT locally,
            # wiki/client/dt_doc.ts:40-171; here the browser runs a JS
            # engine — web_assets.CRDT_HTML — and exchanges ORIGINAL
            # positional ops with explicit parent versions, never
            # server-transformed positions):
            #   body {"have": {agent_name: next_seq...},
            #         "push": [{agent, seq, parents: [[a, s]...], kind,
            #                   pos, content|len}...]}
            #   -> {"ops": [...missing ops in the same shape...],
            #       "version": remote frontier}
            req = json.loads(body or b"{}")
            applied = 0
            try:
                with self.store.lock:
                    cache = {}   # (frontier, blen) carried across the batch
                    for op in req.get("push") or []:
                        try:
                            _crdt_apply_op(ol, op, cache,
                                           self.store.device)
                        except AssertionError as e:
                            # engine invariant tripped mid-apply (e.g. a doc
                            # poisoned before op validation existed): a
                            # client error, not a handler-thread crash loop
                            raise ValueError(
                                f"engine invariant: {e}") from e
                        applied += 1
                    out_ops = _crdt_ops_since(ol, req.get("have") or {})
                    ver = ol.cg.local_to_remote_frontier(ol.version)
            finally:
                if applied:
                    # ops before a mid-batch failure ARE in the log;
                    # flusher + long-pollers must see them either way
                    # (both helpers take store.lock themselves)
                    self.store.mark_dirty(doc_id)
                    self.store.notify(doc_id)
                    if self.store.reads is not None:
                        self.store.reads.on_local_mutation(doc_id)
                    tctx = self._trace_ctx()
                    if obs is not None and tctx is not None:
                        op0 = (req.get("push") or [{}])[0]
                        obs.journey.begin(op0.get("agent"),
                                          op0.get("seq"), doc=doc_id,
                                          trace=tctx.trace_id)
                    self.store.submit_merge(doc_id, applied,
                                            trace=tctx)
                    if obs is not None:
                        for op in req.get("push") or []:
                            a = op.get("agent")
                            if isinstance(a, str) and a:
                                obs.attrib.note("ops", agent=a)
            return self._send(200, json.dumps(
                {"ops": out_ops, "version": ver}).encode("utf8"))
        if action == "history":
            # Batched time travel: ONE device call materializes every
            # requested historical snapshot (gpu/plan_kernels.py
            # texts_at_versions — a visibility mask per version over one
            # shared linearization). The reference can only checkout one
            # version at a time, rebuilding a tracker per call
            # (src/list/oplog.rs:32). This powers the visualizer's
            # history strip as a product feature, not a test-only demo.
            from operator import index as _ix
            req = json.loads(body or b"{}")
            n = min(max(_ix(req.get("n", 16)), 1), 64)
            # Under the store lock like every other checkout endpoint:
            # checkouts share the per-oplog native context, and a
            # concurrent push rebuilding that context mid-call would be a
            # use-after-free. (Host strips are a few hundred ms worst
            # case; the device path is opt-in — see doc_history_strip.)
            # The opt-in device strip launches K3 (texts_at_versions)
            # under this lock for the same reason: its tape source is
            # built from the shared native context.
            with self.store.lock:
                snaps = doc_history_strip(ol, n, list(ol.version),  # dt-lint: ignore[device-under-lock]
                                          device=self.store.device)
            return self._send(200, json.dumps({"snapshots": snaps})
                              .encode("utf8"))
        if action == "at":
            from operator import index as _ix
            req = json.loads(body)
            try:
                lv = _ix(req["lv"])
            except (TypeError, KeyError):
                return self._send(400, b'{"error": "bad lv"}')
            with self.store.lock:
                if not 0 <= lv < len(ol):
                    return self._send(400, b'{"error": "lv out of range"}')
                f = ol.cg.graph.find_dominators([lv])
                text = self.store.checkout(ol, f).snapshot()
            return self._send(200, json.dumps({"text": text})
                              .encode("utf8"))
        return self._send(404, b"{}")


class _Server(ThreadingHTTPServer):
    store: DocStore = None

    def server_close(self):  # final flush on clean shutdown
        if self.store is not None:
            if self.store.replica is not None:
                self.store.replica.stop()
            if self.store.scheduler is not None:
                self.store.scheduler.stop_pump(drain=True)
            self.store.stop_flusher()
            self.store.flush(force=True)
        super().server_close()


def serve(port: int = 8008, data_dir: Optional[str] = None,
          serve_shards: int = 0, peers: Optional[list] = None,
          replicate_opts: Optional[dict] = None,
          obs_opts: Optional[dict] = None,
          follower_reads: bool = False,
          read_opts: Optional[dict] = None,
          qos: bool = False,
          qos_opts: Optional[dict] = None,
          device=None) -> ThreadingHTTPServer:
    """`peers` is the static mesh (["host:port", ...], may include
    this server's own address — it is dropped from the table). With
    peers set, a replicate.ReplicaNode is attached and started: health
    probes, lease maintenance and anti-entropy run in the background,
    and mutations for docs owned elsewhere are proxied. Tests that
    bind port 0 call replicate.attach_replication themselves once the
    ephemeral port is known. `obs_opts` are Observability kwargs
    (sample_rate etc.); every server gets a bundle — the tracer head-
    samples (1% default) and the recorder only fires on rare events,
    so the default is cheap enough to leave on. `device` is the torch
    device of the merge scheduler and the device history strip: None
    means CUDA, which must exist (with `serve_shards` and no CUDA this
    raises before anything starts); the CPU runs the kernels' plain
    versions."""
    from ..obs import Observability
    if serve_shards:
        from ..gpu import resolve_device
        resolve_device(device)
    store = DocStore(data_dir)
    store.device = device
    oo = dict(obs_opts or {})
    if data_dir is not None:
        # incident bundles park next to the journals/snapshots they
        # explain; callers may still override with their own dir
        oo.setdefault("incident_dir", data_dir)
    store.obs = Observability(**oo)
    if serve_shards:
        # the fused device engine with the device plan: every flush
        # plans its tails with K2 and replays them with K1 on `device`.
        # There is no host-engine server: a fault under a flush
        # propagates, and only the length fence sends a doc to the host.
        from ..serve.scheduler import MergeScheduler
        sched = MergeScheduler(serve_shards, resolve=store.get,
                               engine="device", device_plan=True,
                               fused_opts={"device": device},
                               sync_lock=store.lock)
        store.attach_scheduler(sched)
        sched.attach_obs(store.obs)
        if qos:
            # attach BEFORE start_pump so the controller thread starts
            # (and stops) with the scheduler's own lifecycle
            from ..qos import QosController
            sched.attach_qos(QosController(**(qos_opts or {})))
            # incident bundles freeze the controller state at capture
            store.obs.incidents.qos_provider = sched.qos.export
        sched.start_pump()
    if follower_reads:
        # staleness-bounded local GETs on non-owner replicas + the
        # shared checkout cache; harmless (always-owner) on a
        # single-node server
        from ..read import attach_follower_reads
        attach_follower_reads(store, **(read_opts or {}))
    handler = type("Handler", (SyncHandler,), {"store": store})
    httpd = _Server(("127.0.0.1", port), handler)
    httpd.store = store
    if peers is not None:
        from ..replicate import attach_replication
        opts = dict(replicate_opts or {})
        join_addr = opts.pop("join", None)
        self_id = f"127.0.0.1:{httpd.server_address[1]}"
        if data_dir is not None and "journal_prefix" not in opts:
            # lease epochs / promises / incarnation survive a crash
            opts["journal_prefix"] = os.path.join(data_dir, "_replica")
        node = attach_replication(httpd, self_id,
                                  [p for p in peers if p != self_id],
                                  **opts)
        node.start()
        if join_addr:
            node.join_mesh(join_addr)
    store.start_flusher()
    return httpd


class SyncClient:
    """Client-side replica (reference: wiki/client/dt_doc.ts:40-171).

    Transport errors on pull/push are retried `retries` times with the
    jittered exponential `Backoff` shared with the peer mesh
    (replicate/peers.py) — transient connection drops and HTTP 5xx are
    retried, 4xx application rejections raise immediately. Both
    operations are idempotent (summary-driven patch exchange), so a
    retry after a response lost mid-flight is harmless."""

    def __init__(self, base_url: str, doc_id: str, agent_name: str,
                 retries: int = 3, timeout: float = 10.0) -> None:
        self.base = base_url.rstrip("/")
        self.doc_id = doc_id
        self.retries = retries
        self.timeout = timeout
        self.oplog = OpLog()
        self.oplog.doc_id = doc_id
        self.agent = self.oplog.get_or_create_agent_id(agent_name)
        self.branch = self.oplog.checkout_tip()

    def _url(self, action: str) -> str:
        return f"{self.base}/doc/{self.doc_id}/{action}"

    def _fetch(self, action: str, data: Optional[bytes] = None) -> bytes:
        from ..replicate.peers import Backoff, call_with_retries
        req = urllib.request.Request(self._url(action), data=data)

        def once() -> bytes:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()

        return call_with_retries(
            once, retries=self.retries,
            backoff=Backoff(base_s=0.05, cap_s=1.0,
                            key=f"{self.doc_id}/{action}"))

    def pull(self) -> None:
        summary = json.dumps(summarize_versions(self.oplog.cg)).encode("utf8")
        patch = self._fetch("pull", data=summary)
        decode_into(self.oplog, patch)
        self.branch.merge(self.oplog, self.oplog.version)

    def push(self) -> None:
        server_summary = json.loads(self._fetch("summary"))
        common, _ = intersect_with_summary(self.oplog.cg, server_summary)
        patch = encode_oplog(self.oplog, ENCODE_PATCH, from_version=common)
        self._fetch("push", data=patch)

    def sync(self) -> None:
        self.push()
        self.pull()

    def insert(self, pos: int, text: str) -> None:
        self.branch.insert(self.oplog, self.agent, pos, text)

    def delete(self, start: int, end: int) -> None:
        self.branch.delete(self.oplog, self.agent, start, end)

    def text(self) -> str:
        return self.branch.snapshot()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--serve-shards", type=int, default=0,
                   help="enable the sharded merge scheduler with N "
                   "device-engine shards (0 = off); metrics at /metrics")
    p.add_argument("--device", default=None,
                   help="torch device of the merge scheduler and the "
                   "DT_SERVER_DEVICE history strip (default: CUDA, "
                   "which must exist; 'cpu' runs the kernels' plain "
                   "versions)")
    p.add_argument("--peers", default=None,
                   help="comma-separated host:port list of the full "
                   "replication mesh (this server's own address is "
                   "dropped); enables doc-ownership leases, mutation "
                   "proxying and anti-entropy")
    p.add_argument("--lease-ttl", type=float, default=2.0,
                   help="doc-ownership lease TTL in seconds")
    p.add_argument("--join", default=None,
                   help="host:port of an existing mesh member to "
                   "announce ourselves to at startup (dynamic "
                   "membership; the mesh is learned from its reply)")
    p.add_argument("--obs-sample-rate", type=float, default=0.01,
                   help="trace head-sampling rate (0 disables tracing; "
                   "histograms and the flight recorder are always on)")
    p.add_argument("--follower-reads", action="store_true",
                   help="serve GET /doc/{id}[/state] from this replica "
                   "under the staleness contract (?max_staleness= + "
                   "X-DT-Min-Version) instead of always locally; "
                   "contract misses proxy to the doc's owner")
    p.add_argument("--qos", action="store_true",
                   help="attach the adaptive-admission QoS controller "
                   "(qos/): per-class effective flush deadlines, depth "
                   "budgets and mesh-aware 429 load shedding; state at "
                   "/debug/qos (requires --serve-shards)")
    p.add_argument("--no-incidents", dest="incidents",
                   action="store_false", default=True,
                   help="disable the incident engine's anomaly "
                   "detector (the overhead A/B control arm); "
                   "/debug/incidents still answers, empty")
    args = p.parse_args()
    peers = [s.strip() for s in args.peers.split(",") if s.strip()] \
        if args.peers else ([] if args.join else None)
    httpd = serve(args.port, args.data_dir,
                  serve_shards=args.serve_shards, peers=peers,
                  replicate_opts={"lease_ttl_s": args.lease_ttl,
                                  "join": args.join},
                  obs_opts={"sample_rate": args.obs_sample_rate,
                            "incidents": args.incidents},
                  follower_reads=args.follower_reads,
                  qos=args.qos, device=args.device)
    print(f"serving on http://127.0.0.1:{args.port}"
          + (f" (mesh: {','.join(peers)})" if peers else ""))
    httpd.serve_forever()


if __name__ == "__main__":
    main()
