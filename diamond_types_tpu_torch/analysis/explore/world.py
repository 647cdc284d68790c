"""Simulated world for the protocol model checker.

The explorer drives the REAL protocol objects — `ReplicaNode`,
`LeaseManager`, `QuorumCoordinator`, `MembershipView`, `AntiEntropy` —
through three dependency seams the production constructors expose:

  * a virtual clock (`SimWorld.now`, advanced only by the scheduler's
    `tick` action, so timeouts fire as explicit choices);
  * a synchronous in-process transport (`SimTransport`, duck-typing
    `peers.PeerTable`) whose link state — partitions, crashes — is
    part of the explored state, not the physical network;
  * an in-memory journal (`MemJournal`, duck-typing
    `quorum.ReplicaJournal`) that survives a simulated crash, so
    restart re-runs the real restore path.

A crash discards the node OBJECT (all in-memory state) but keeps its
journal and oplog store: the journal is the real durability contract;
the oplog is treated as durable too (storage-tier crash safety is PR
8's separately-tested property, out of this model's scope — see
CHECKING.md).
"""

from __future__ import annotations

import json
import urllib.error
from typing import Callable, Dict, List, Optional, Set, Tuple

from ...causalgraph.summary import intersect_with_summary, \
    summarize_versions
from ...encoding.decode import decode_into
from ...encoding.encode import ENCODE_PATCH, encode_oplog
from ...replicate.node import ReplicaNode
from ...text.oplog import OpLog


class MemJournal:
    """Duck-type of quorum.ReplicaJournal backed by plain dicts.
    Lives in the WORLD (not the node), so a crash/restart cycle keeps
    it — exactly what the file-backed journal guarantees."""

    def __init__(self) -> None:
        self.incarnation = 0
        self.max_epochs: Dict[str, int] = {}
        self.promises: Dict[str, dict] = {}
        self.leases: Dict[str, dict] = {}
        self.overrides: Dict[str, dict] = {}
        self.groups: Dict[str, dict] = {}
        self._dirty = False

    # -- writes (mirror ReplicaJournal's semantics) --
    def note_incarnation(self, n: int) -> None:
        self.incarnation = int(n)
        self._dirty = True

    def note_epoch(self, doc_id: str, epoch: int) -> None:
        if epoch > self.max_epochs.get(doc_id, 0):
            self.max_epochs[doc_id] = int(epoch)
        self._dirty = True

    def note_promise(self, doc_id: str, epoch: int,
                     holder: str) -> None:
        self.promises[doc_id] = {"epoch": int(epoch),
                                 "holder": str(holder)}
        self._dirty = True

    def note_lease(self, doc_id: str, holder: str, epoch: int,
                   state: str) -> None:
        self.leases[doc_id] = {"holder": str(holder),
                               "epoch": int(epoch), "state": str(state)}
        self._dirty = True

    def drop_lease(self, doc_id: str) -> None:
        self.leases.pop(doc_id, None)
        self._dirty = True

    def note_group(self, doc_id: str, epoch: int, members,
                   leader: str) -> None:
        self.groups[doc_id] = {"epoch": int(epoch),
                               "members": [str(m) for m in members],
                               "leader": str(leader)}
        self._dirty = True

    def drop_group(self, doc_id: str) -> None:
        self.groups.pop(doc_id, None)
        self._dirty = True

    def note_override(self, doc_id: str, target, ver: int) -> None:
        # same LWW-by-version fold as ReplicaJournal._apply
        cur = self.overrides.get(doc_id)
        if cur is None or int(ver) >= int(cur.get("ver", 0)):
            self.overrides[doc_id] = {"target": target, "ver": int(ver)}
        self._dirty = True

    def record(self, *a, **k) -> None:
        self._dirty = True

    def compact(self) -> None:
        pass

    # -- restore views --
    def restored_incarnation(self) -> int:
        return self.incarnation

    def restored_max_epochs(self) -> Dict[str, int]:
        return dict(self.max_epochs)

    def restored_promises(self) -> Dict[str, dict]:
        return {d: dict(p) for d, p in self.promises.items()}

    def restored_leases(self) -> Dict[str, dict]:
        return {d: dict(l) for d, l in self.leases.items()}

    def restored_overrides(self) -> Dict[str, dict]:
        return {d: dict(o) for d, o in self.overrides.items()}

    def restored_groups(self) -> Dict[str, dict]:
        return {d: dict(g) for d, g in self.groups.items()}

    def has_prior_state(self) -> bool:
        return self._dirty

    def close(self) -> None:
        pass

    def fingerprint(self) -> dict:
        return {"inc": self.incarnation, "floors": self.max_epochs,
                "promises": self.promises, "leases": self.leases,
                "overrides": self.overrides, "groups": self.groups}


class _SimScheduler:
    """MergeScheduler duck-type exposing the one seam `node.handoff`'s
    drain phase uses: `drain()` flushes every queued (acknowledged)
    write into the oplog — the admission queue the real drain barrier
    empties before the final transfer patch is cut."""

    def __init__(self, store: "MemStore") -> None:
        self.store = store

    def drain(self) -> None:
        for doc_id in sorted(self.store.pending):
            self.store.flush_pending(doc_id)


class MemStore:
    """Minimal DocStore duck-type: real OpLogs, no scheduler/device
    tier beyond the `_SimScheduler` drain seam. Auto-creates docs on
    first touch (the anti-entropy union walk relies on that).

    `pending` models the admission queue: `qedit` actions ACK a write
    to the client but only queue it here; `flush`/drain moves it into
    the oplog. The queue is volatile — a crash loses it (and the model
    retracts those acks: client and server died together; queue
    durability is the storage soak's separately-tested property)."""

    def __init__(self, owner_id: str) -> None:
        from ..witness import make_lock
        self.owner_id = owner_id
        self.docs: Dict[str, OpLog] = {}
        self.lock = make_lock(f"sim.store.{owner_id}", "oplog",
                              reentrant=True)
        self.replica = None
        self.reads = None
        self.merge_submissions: List[Tuple[str, int]] = []
        self.pending: Dict[str, List[str]] = {}
        self.scheduler = _SimScheduler(self)

    def queue_edit(self, doc_id: str, ch: str) -> None:
        self.pending.setdefault(doc_id, []).append(ch)

    def flush_pending(self, doc_id: str) -> None:
        chars = self.pending.pop(doc_id, [])
        if not chars:
            return
        ol = self.get(doc_id)
        with self.lock:
            agent = ol.get_or_create_agent_id(
                f"agent-{self.owner_id}")
            for ch in chars:
                ol.add_insert(agent, 0, ch)

    def get(self, doc_id: str) -> OpLog:
        ol = self.docs.get(doc_id)
        if ol is None:
            ol = OpLog()
            ol.doc_id = doc_id
            self.docs[doc_id] = ol
        return ol

    def doc_ids(self) -> List[str]:
        return sorted(self.docs)

    def mark_dirty(self, doc_id: str) -> None:
        pass

    def notify(self, doc_id: str) -> None:
        pass

    def submit_merge(self, doc_id: str, n: int) -> None:
        self.merge_submissions.append((doc_id, n))


class SimRecorder:
    """FlightRecorder duck-type: every lease-manager event lands in the
    world's event log tagged with the emitting node (the
    tie-break-direction invariant reads these)."""

    def __init__(self, world: "SimWorld", node_id: str) -> None:
        self.world = world
        self.node_id = node_id

    def record(self, kind: str, **fields) -> None:
        ev = {"node": self.node_id, "kind": kind}
        ev.update(fields)
        self.world.events.append(ev)


class _SimPeerState:
    """PeerTable._PeerState duck-type: the two fields ReplicaNode's
    rejoin check reads. The sim has no circuit breaker — reachability
    is explicit link/crash state — so open_until stays 0.0."""

    __slots__ = ("addr", "last_ok", "open_until", "failures")

    def __init__(self, addr: str) -> None:
        self.addr = addr
        self.last_ok: Optional[float] = None
        self.open_until = 0.0
        self.failures = 0


class SimTransport:
    """peers.PeerTable duck-type: synchronous in-process dispatch.
    Reachability is a pure function of the world's cut-link set and
    crashed set; an unreachable call raises OSError exactly where the
    real transport would. Message loss/partition therefore happens at
    CALL time as a consequence of scheduler-chosen link state — there
    is no in-flight queue (see CHECKING.md for what that excludes)."""

    def __init__(self, world: "SimWorld", self_id: str) -> None:
        self.world = world
        self.self_id = self_id
        self.on_ping: Optional[Callable[[str, dict], None]] = None
        self.recorder = None
        self.metrics = None
        self.peers: Dict[str, _SimPeerState] = {
            p: _SimPeerState(p) for p in world.node_ids
            if p != self_id}

    # ---- membership / health views ----
    def add_peer(self, addr: str) -> bool:
        if not addr or addr == self.self_id or addr in self.peers:
            return False
        self.peers[addr] = _SimPeerState(addr)
        return True

    def remove_peer(self, addr: str) -> bool:
        return self.peers.pop(addr, None) is not None

    def peer_ids(self) -> List[str]:
        return sorted(self.peers)

    def all_ids(self) -> List[str]:
        return sorted(list(self.peers) + [self.self_id])

    def is_healthy(self, peer_id: str,
                   now: Optional[float] = None) -> bool:
        if peer_id == self.self_id:
            return True
        return peer_id in self.peers \
            and self.world.reachable(self.self_id, peer_id)

    def healthy_ids(self, now: Optional[float] = None) -> List[str]:
        return sorted([self.self_id] +
                      [p for p in self.peers if self.is_healthy(p)])

    def down_duration(self, peer_id: str,
                      now: Optional[float] = None) -> Optional[float]:
        if peer_id == self.self_id:
            return None
        if peer_id not in self.peers:
            return float("inf")
        t0 = self.world.down_since.get((self.self_id, peer_id))
        if t0 is None:
            return None
        return (self.world.now if now is None else now) - t0

    def state(self, peer_id: str) -> dict:
        st = self.peers[peer_id]
        return {"consecutive_failures": st.failures,
                "circuit_open": False, "backoff_s": 0.0,
                "last_ok_age_s": (round(self.world.now - st.last_ok, 3)
                                  if st.last_ok is not None else None)}

    def states(self) -> dict:
        return {p: self.state(p) for p in self.peer_ids()}

    # ---- calls ----
    def call(self, peer_id: str, path: str,
             data: Optional[bytes] = None,
             timeout: Optional[float] = None, probe: bool = False,
             headers: Optional[dict] = None) -> Tuple[int, bytes]:
        if peer_id not in self.peers:
            raise KeyError(f"unknown peer {peer_id!r}")
        st = self.peers[peer_id]
        if not self.world.reachable(self.self_id, peer_id):
            st.failures += 1
            raise OSError(f"sim: {self.self_id}->{peer_id} unreachable")
        status, body = self.world.dispatch(self.self_id, peer_id,
                                           path, data, headers)
        st.failures = 0
        st.last_ok = self.world.now
        return status, body

    def call_json(self, peer_id: str, path: str,
                  obj: Optional[dict] = None,
                  timeout: Optional[float] = None,
                  headers: Optional[dict] = None) -> dict:
        data = (json.dumps(obj).encode("utf8")
                if obj is not None else None)
        _status, body = self.call(peer_id, path, data=data,
                                  timeout=timeout, headers=headers)
        return json.loads(body or b"{}")

    # ---- probe loop (invoked by the `step` action, never a thread) ----
    def probe(self, peer_id: str) -> bool:
        try:
            status, body = self.call(peer_id, "/replicate/ping",
                                     probe=True)
        except (OSError, KeyError):
            return False
        if status == 200 and self.on_ping is not None:
            self.on_ping(peer_id, json.loads(body or b"{}"))
        return status == 200

    def probe_once(self) -> Dict[str, bool]:
        return {p: self.probe(p) for p in self.peer_ids()}

    def start_probe_loop(self, interval_s: float = 0.5) -> None:
        raise RuntimeError("sim transport never starts threads")

    def stop_probe_loop(self) -> None:
        pass


class SimWorld:
    """One configuration of the model: N real ReplicaNodes over the
    simulated transport/clock/journal, plus the explorer's auxiliary
    history (promise grants, floor watermarks, activations) that
    survives node crashes — the model-level ghost state several
    invariants are phrased over."""

    def __init__(self, node_ids: Tuple[str, ...],
                 docs: Tuple[str, ...] = ("d0",),
                 ttl_s: float = 2.0, quorum: bool = True,
                 mutation=None) -> None:
        self.node_ids = tuple(node_ids)
        self.docs = tuple(docs)
        self.ttl_s = ttl_s
        self.quorum = quorum
        self.mutation = mutation        # mutations.Mutation or None
        self.now = 0.0
        self.tick_s = 1.1               # Scenario.build overrides
        self.cut_links: Set[frozenset] = set()
        self.crashed: Set[str] = set()
        # (observer, peer) -> virtual time the peer became unreachable
        # from the observer's side (cut or crash event time)
        self.down_since: Dict[Tuple[str, str], float] = {}
        self.events: List[dict] = []
        self.edit_seq = 0
        # ghost ledger for the no-acked-loss invariant: every char the
        # model has acknowledged to a client, per doc (crash retracts
        # the crashed node's still-queued chars — see MemStore.pending)
        self.acked: Dict[str, List[str]] = {}
        # last lease message delivered to each node, for the `dup`
        # (duplicate delivery) action
        self.last_lease_msg: Dict[str, dict] = {}
        self.journals: Dict[str, MemJournal] = {
            n: MemJournal() for n in self.node_ids}
        self.stores: Dict[str, MemStore] = {
            n: MemStore(n) for n in self.node_ids}
        if mutation is not None and mutation.apply_world is not None:
            mutation.apply_world(self)
        self.nodes: Dict[str, ReplicaNode] = {}
        for n in self.node_ids:
            self.nodes[n] = self._build_node(n)

    # ---- construction / crash-restart ----
    def clock(self) -> float:
        return self.now

    def _build_node(self, node_id: str) -> ReplicaNode:
        table = SimTransport(self, node_id)
        node = ReplicaNode(
            self.stores[node_id], node_id, peer_addrs=[],
            lease_ttl_s=self.ttl_s, timeout_s=1.0,
            clock=self.clock, table=table,
            journal=self.journals[node_id])
        node.leases.recorder = SimRecorder(self, node_id)
        if not self.quorum:
            node.leases.quorum = None   # PR 2 standalone/TTL mode
        if self.mutation is not None \
                and self.mutation.apply_node is not None:
            self.mutation.apply_node(node)
        return node

    def crash(self, node_id: str) -> None:
        """Lose the node's in-memory state; keep journal + oplog. The
        admission queue is in-memory too: queued chars are gone, and
        their acks are retracted from the ghost ledger (the clients
        died with the server; queue durability is out of scope)."""
        store = self.stores[node_id]
        for doc_id, chars in list(store.pending.items()):
            acked = self.acked.get(doc_id)
            if acked:
                for ch in chars:
                    try:
                        acked.remove(ch)
                    except ValueError:
                        pass
        store.pending.clear()
        self.crashed.add(node_id)
        self.nodes.pop(node_id, None)
        for other in self.node_ids:
            if other != node_id:
                self.down_since.setdefault((other, node_id), self.now)

    def restart(self, node_id: str) -> None:
        """Rebuild the node from its journal — runs the real restore
        path, so it boots `rejoining` with restored floors/promises."""
        self.crashed.discard(node_id)
        for other in self.node_ids:
            if other != node_id \
                    and not self.is_cut(other, node_id):
                self.down_since.pop((other, node_id), None)
        self.nodes[node_id] = self._build_node(node_id)

    # ---- link state ----
    def is_cut(self, a: str, b: str) -> bool:
        return frozenset((a, b)) in self.cut_links

    def cut(self, a: str, b: str) -> None:
        self.cut_links.add(frozenset((a, b)))
        self.down_since.setdefault((a, b), self.now)
        self.down_since.setdefault((b, a), self.now)

    def heal(self, a: str, b: str) -> None:
        self.cut_links.discard(frozenset((a, b)))
        if b not in self.crashed:
            self.down_since.pop((a, b), None)
        if a not in self.crashed:
            self.down_since.pop((b, a), None)

    def reachable(self, a: str, b: str) -> bool:
        return b not in self.crashed and a not in self.crashed \
            and not self.is_cut(a, b)

    def alive(self) -> List[str]:
        return [n for n in self.node_ids if n not in self.crashed]

    # ---- wire dispatch (the simulated server side) ----
    def dispatch(self, src: str, dst: str, path: str,
                 data: Optional[bytes],
                 headers: Optional[dict]) -> Tuple[int, bytes]:
        node = self.nodes[dst]
        if path == "/replicate/ping":
            return 200, json.dumps(node.ping_json()).encode("utf8")
        if path == "/replicate/docs":
            return 200, json.dumps(node.docs_json()).encode("utf8")
        if path == "/replicate/lease":
            req = json.loads(data or b"{}")
            self.last_lease_msg[dst] = dict(req)
            resp = node.handle_lease_message(req)
            return 200, json.dumps(resp).encode("utf8")
        if path == "/replicate/join":
            resp = node.handle_join(json.loads(data or b"{}"))
            return 200, json.dumps(resp).encode("utf8")
        if path.startswith("/doc/"):
            _, _, rest = path.partition("/doc/")
            doc_id, _, action = rest.partition("/")
            store = node.store
            ol = store.get(doc_id)
            if action == "summary":
                with store.lock:
                    summary = summarize_versions(ol.cg)
                return 200, json.dumps(summary).encode("utf8")
            if action == "pull":
                # body = caller's summary; respond with a patch from
                # the common frontier (tools/server.py's pull handler)
                summary = json.loads(data or b"{}")
                with store.lock:
                    common, _rem = intersect_with_summary(ol.cg,
                                                          summary)
                    patch = encode_oplog(ol, ENCODE_PATCH,
                                         from_version=common)
                return 200, patch
            if action == "push":
                epoch_hdr = (headers or {}).get("X-DT-Lease-Epoch")
                if epoch_hdr is not None and not node.check_write_fence(
                        doc_id, int(epoch_hdr)):
                    raise urllib.error.HTTPError(
                        path, 409, "fenced", {}, None)
                with store.lock:
                    pre = len(ol)
                    decode_into(ol, data or b"")
                    n_new = len(ol) - pre
                if n_new:
                    store.submit_merge(doc_id, n_new)
                return 200, json.dumps({"ok": True,
                                        "new_ops": n_new}).encode()
        raise KeyError(f"sim: no handler for {path!r}")

    # ---- convenience used by actions/invariants ----
    def edit(self, node_id: str, doc_id: str) -> None:
        store = self.stores[node_id]
        ol = store.get(doc_id)
        with store.lock:
            agent = ol.get_or_create_agent_id(f"agent-{node_id}")
            ol.add_insert(agent, 0,
                          chr(ord("a") + self.edit_seq % 26))
        self.edit_seq += 1

    def qedit(self, node_id: str, doc_id: str) -> None:
        """Acknowledged-but-queued write: the char lands in the node's
        admission queue and in the ghost acked ledger — only a flush
        (or the handoff drain barrier) moves it into the oplog."""
        ch = chr(ord("a") + self.edit_seq % 26)
        self.edit_seq += 1
        self.stores[node_id].queue_edit(doc_id, ch)
        self.acked.setdefault(doc_id, []).append(ch)

    def migrate(self, node_id: str, peer: str, doc_id: str) -> bool:
        """The rebalancer's migration step: override first (rides the
        grant), epoch-fenced handoff, tombstone on abort. A completed
        move evicts the source's warm copy — with the drain barrier
        intact the queue is empty by then; without it (the seeded
        mutation) this is exactly where acked ops die."""
        node = self.nodes[node_id]
        ver = node.overrides.set(doc_id, peer)
        ok = node.handoff(doc_id, peer, override_version=ver)
        if ok:
            self.stores[node_id].pending.pop(doc_id, None)
        else:
            node.overrides.clear(doc_id)
        return ok

    def redeliver_last_lease_msg(self, node_id: str) -> None:
        req = self.last_lease_msg.get(node_id)
        if req is not None and node_id not in self.crashed:
            self.nodes[node_id].handle_lease_message(dict(req))

    def text_of(self, node_id: str, doc_id: str) -> str:
        # through the C++ tracker (`Branch.merge_reference`): a plain
        # `checkout_tip()` may go to the zone engine on CUDA once the
        # engine policy has measured it faster, and the model is host-only
        from ...text.branch import Branch
        store = self.stores[node_id]
        with store.lock:
            ol = store.get(doc_id)
            b = Branch()
            b.merge_reference(ol, ol.version)
            return b.snapshot()

    def frontier_of(self, node_id: str, doc_id: str):
        store = self.stores[node_id]
        with store.lock:
            ol = store.get(doc_id)
            return ol.cg.local_to_remote_frontier(ol.version)
