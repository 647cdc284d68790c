"""Peer table + health tracking for the replication mesh.

Peers are seeded at startup (`--peers host:port,...`) and can now
change at runtime: `add_peer`/`remove_peer` back the /replicate/join
and /replicate/leave endpoints, and the probe loop doubles as the
gossip transport — each ping response body is handed to the `on_ping`
hook, which membership.MembershipView uses to merge remote member
tables. Every outbound HTTP call gets a hard timeout, failures feed a
consecutive-failure circuit breaker, and re-probes back off with
jittered exponential delays so a dead peer costs one cheap probe per
backoff window instead of a timeout per request.

`Backoff` and `call_with_retries` are deliberately standalone: the
client-side `SyncClient` (tools/server.py) shares them for its bounded
pull/push retries.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from .faults import FaultInjector
from .metrics import ReplicationMetrics


class Backoff:
    """Jittered exponential backoff: delay(attempt) grows as
    base * 2**attempt, capped, with deterministic jitter in
    [0.5, 1.0) of the nominal delay (seeded so tests replay)."""

    def __init__(self, base_s: float = 0.05, cap_s: float = 5.0,
                 seed: int = 0, key: str = "") -> None:
        self.base_s = base_s
        self.cap_s = cap_s
        self._rng = random.Random(f"{seed}:{key}")

    def delay(self, attempt: int) -> float:
        # exponent bounded the same way as DocStore's flush backoff:
        # 2**attempt overflows float conversion near attempt=1025
        nominal = min(self.base_s * (2 ** min(max(attempt, 0), 20)),
                      self.cap_s)
        return nominal * (0.5 + 0.5 * self._rng.random())


def call_with_retries(fn: Callable, retries: int = 3,
                      backoff: Optional[Backoff] = None,
                      sleep: Callable[[float], None] = time.sleep):
    """Run `fn()` with up to `retries` retries on transient transport
    errors (connection failures, timeouts, HTTP 5xx). Client errors
    (HTTP 4xx) are NOT transient — retrying a rejected patch can't
    succeed — so they raise immediately."""
    backoff = backoff or Backoff()
    attempt = 0
    while True:
        try:
            return fn()
        except urllib.error.HTTPError as e:
            if e.code < 500 or attempt >= retries:
                raise
        except OSError:
            # URLError, ConnectionError, socket.timeout, FaultDrop
            if attempt >= retries:
                raise
        sleep(backoff.delay(attempt))
        attempt += 1


class CircuitOpen(ConnectionError):
    """Peer's circuit breaker is open; call refused without touching
    the network."""

    def __init__(self, peer_id: str, retry_at: float) -> None:
        self.peer_id = peer_id
        self.retry_at = retry_at
        super().__init__(f"circuit open for peer {peer_id}")


class _PeerState:
    __slots__ = ("addr", "failures", "open_until", "down_since",
                 "last_ok", "backoff")

    def __init__(self, addr: str, backoff: Backoff) -> None:
        self.addr = addr
        self.failures = 0          # consecutive
        self.open_until = 0.0      # monotonic; 0 = circuit closed
        self.down_since = 0.0      # when the circuit FIRST opened
        self.last_ok: Optional[float] = None
        self.backoff = backoff


class PeerTable:
    """Health-tracked view of the static mesh. `self_id` is this
    server's own `host:port` (its rendezvous identity); it is never a
    callable peer. Thread-safe; call() performs network I/O outside
    the table lock."""

    def __init__(self, self_id: str, peer_addrs: List[str],
                 timeout_s: float = 2.0, fail_threshold: int = 3,
                 backoff_base_s: float = 0.1, backoff_cap_s: float = 5.0,
                 seed: int = 0,
                 faults: Optional[FaultInjector] = None,
                 metrics: Optional[ReplicationMetrics] = None) -> None:
        self.self_id = self_id
        self.timeout_s = timeout_s
        self.fail_threshold = max(int(fail_threshold), 1)
        self.faults = faults
        self.metrics = metrics
        # obs.recorder.FlightRecorder (wired by ReplicaNode): circuit
        # transitions are the events partition post-mortems need
        self.recorder = None
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._seed = seed
        # gossip hook: on_ping(peer_id, parsed_ping_body) — wired by
        # ReplicaNode to fold the responder's member table
        self.on_ping: Optional[Callable[[str, dict], None]] = None
        from ..analysis.witness import make_lock
        self._lock = make_lock("repl.peers", "repl.peers")
        self.peers: Dict[str, _PeerState] = {}
        for addr in peer_addrs:
            if addr and addr != self_id:
                self.peers[addr] = _PeerState(
                    addr, Backoff(backoff_base_s, backoff_cap_s,
                                  seed=seed, key=f"{self_id}->{addr}"))
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # ---- membership / health views ---------------------------------------

    def add_peer(self, addr: str) -> bool:
        """Register a peer discovered at runtime (join announcement or
        gossip). Idempotent; never adds self."""
        if not addr or addr == self.self_id:
            return False
        with self._lock:
            if addr in self.peers:
                return False
            self.peers[addr] = _PeerState(
                addr, Backoff(self._backoff_base_s, self._backoff_cap_s,
                              seed=self._seed,
                              key=f"{self.self_id}->{addr}"))
            return True

    def remove_peer(self, addr: str) -> bool:
        """Drop a peer that explicitly left the mesh."""
        with self._lock:
            return self.peers.pop(addr, None) is not None

    def peer_ids(self) -> List[str]:
        return sorted(self.peers)

    def all_ids(self) -> List[str]:
        return sorted(list(self.peers) + [self.self_id])

    def is_healthy(self, peer_id: str, now: Optional[float] = None) -> bool:
        if peer_id == self.self_id:
            return True
        st = self.peers.get(peer_id)
        if st is None:
            return False
        return st.open_until == 0.0

    def healthy_ids(self, now: Optional[float] = None) -> List[str]:
        """Self plus every peer whose circuit is closed — the live host
        set rendezvous ownership is computed over."""
        return sorted([self.self_id] +
                      [p for p, st in self.peers.items()
                       if st.open_until == 0.0])

    def down_duration(self, peer_id: str,
                      now: Optional[float] = None) -> Optional[float]:
        """Seconds the peer has been continuously unhealthy (since its
        circuit first opened), or None while healthy. Ownership uses
        this to delay takeover past a full lease TTL — a short blip or
        partition must not produce two hosts that both believe they are
        the rendezvous owner."""
        if peer_id == self.self_id:
            return None
        st = self.peers.get(peer_id)
        if st is None:
            return float("inf")
        with self._lock:
            if st.open_until == 0.0:
                return None
            return (now if now is not None
                    else time.monotonic()) - st.down_since

    def state(self, peer_id: str) -> dict:
        st = self.peers[peer_id]
        now = time.monotonic()
        return {"consecutive_failures": st.failures,
                "circuit_open": st.open_until > 0.0,
                "backoff_s": round(max(st.open_until - now, 0.0), 3),
                "last_ok_age_s": (round(now - st.last_ok, 3)
                                  if st.last_ok is not None else None)}

    def states(self) -> dict:
        return {p: self.state(p) for p in self.peer_ids()}

    # ---- outcome accounting ----------------------------------------------

    def _record_ok(self, st: _PeerState) -> None:
        with self._lock:
            reopened = st.open_until > 0.0
            st.failures = 0
            st.open_until = 0.0
            st.last_ok = time.monotonic()
        if reopened:
            if self.metrics is not None:
                self.metrics.bump("probes", "circuit_closes")
            if self.recorder is not None:
                self.recorder.record("circuit_close", peer=st.addr)

    def _record_failure(self, st: _PeerState) -> None:
        with self._lock:
            st.failures += 1
            failures = st.failures
            opened = False
            if st.failures >= self.fail_threshold:
                now = time.monotonic()
                opened = st.open_until == 0.0
                if opened:
                    st.down_since = now
                st.open_until = now + st.backoff.delay(
                    st.failures - self.fail_threshold)
        if opened:
            if self.metrics is not None:
                self.metrics.bump("probes", "circuit_opens")
            if self.recorder is not None:
                self.recorder.record("circuit_open", peer=st.addr,
                                     failures=failures)

    # ---- calls -----------------------------------------------------------

    def call(self, peer_id: str, path: str, data: Optional[bytes] = None,
             timeout: Optional[float] = None, probe: bool = False,
             headers: Optional[dict] = None) -> Tuple[int, bytes]:
        """One HTTP request to a peer: fault injection first, then a
        hard-timeout urllib call. Returns (status, body). An open
        circuit refuses the call immediately (CircuitOpen) — except for
        probes once the backoff window has lapsed (half-open trial).
        Raises the transport error on failure; both refusal and failure
        feed the breaker."""
        st = self.peers.get(peer_id)
        if st is None:
            raise KeyError(f"unknown peer {peer_id!r}")
        now = time.monotonic()
        with self._lock:
            open_until = st.open_until
        if open_until > 0.0 and now < open_until:
            # inside the backoff window: refuse without touching the
            # network. Once the window lapses any call (probe or not)
            # is the half-open trial — success closes the circuit,
            # failure re-opens it with a longer window.
            raise CircuitOpen(peer_id, open_until)
        dup = False
        if self.faults is not None:
            try:
                dup = self.faults.before_call(self.self_id, peer_id)
            except OSError:
                # injected drops/partitions must feed the breaker
                # exactly like real transport failures
                self._record_failure(st)
                raise
        url = f"http://{st.addr}{path}"
        req = urllib.request.Request(url, data=data)
        req.add_header("X-DT-Peer", self.self_id)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        t = timeout if timeout is not None else self.timeout_s
        try:
            with urllib.request.urlopen(req, timeout=t) as r:
                body = r.read()
                status = r.status
            if dup:   # duplicate delivery: idempotent peer endpoints
                with urllib.request.urlopen(
                        urllib.request.Request(
                            url, data=data,
                            headers=dict(req.header_items())),
                        timeout=t) as r2:
                    body = r2.read()
                    status = r2.status
        except urllib.error.HTTPError as e:
            # the peer is UP and answered: not a health failure
            self._record_ok(st)
            raise
        except OSError:
            self._record_failure(st)
            raise
        self._record_ok(st)
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

    # ---- probe loop ------------------------------------------------------

    def probe(self, peer_id: str) -> bool:
        """One health probe (`GET /replicate/ping`). Returns up/down.
        A 200 body is parsed and handed to the `on_ping` gossip hook
        (membership piggyback rides the probe loop for free)."""
        body = b""
        t0 = time.monotonic()
        try:
            status, body = self.call(peer_id, "/replicate/ping",
                                     probe=True)
            ok = status == 200
        except CircuitOpen:
            return False        # still inside the backoff window
        except (OSError, urllib.error.HTTPError):
            ok = False
        if self.metrics is not None:
            self.metrics.bump("probes", "ok" if ok else "failed")
            self.metrics.observe_latency("probe",
                                         time.monotonic() - t0)
        if ok and self.on_ping is not None:
            try:
                self.on_ping(peer_id, json.loads(body or b"{}"))
            except (ValueError, TypeError):
                pass            # malformed gossip never fails a probe
        return ok

    def probe_once(self) -> Dict[str, bool]:
        return {p: self.probe(p) for p in self.peer_ids()}

    def start_probe_loop(self, interval_s: float = 0.5) -> None:
        if self._probe_thread is not None:
            return

        def loop():
            while not self._probe_stop.wait(interval_s):
                try:
                    self.probe_once()
                except Exception:    # pragma: no cover - keep probing
                    pass

        self._probe_thread = threading.Thread(target=loop, daemon=True)
        self._probe_thread.start()

    def stop_probe_loop(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=2)
            self._probe_thread = None
        self._probe_stop = threading.Event()
