"""Per-node wire state: negotiation cache, accounting, frame cache.

One ``WireChannel`` hangs off each ``ReplicaNode`` (and is reachable
from the read path via ``store.replica.wire``). It owns three things:

* **negotiation** — which peers speak wire v1. GET requests need no
  cache (the request advertises ``X-DT-Wire: v1`` and the response
  magic is sniffed), but POST *bodies* must be encoded before any
  response arrives, so capability is learned from ping gossip
  (``ping_json`` carries ``"wire": 1``; ``_on_ping`` folds it here).
  Unknown or old peers get the JSON fallback — a mixed-version mesh
  converges byte-identically, just at JSON prices.
* **accounting** — every send on every channel (framed OR JSON
  fallback) lands in ``ReplicationMetrics``'s wire group, so
  before/after scorecards both carry per-channel columns.
* **frame cache** — snapshot frames are frontier-keyed and reused
  across peers catching up to the same point. The cache lock sits on
  the io rung (``wire.frames``) like the rest of the residency tier's
  table guards, and is never held across an encode.

Framing is toggleable (``DT_WIRE_DISABLED=1`` pins a node to JSON —
how the mixed-version test and the before/after baselines simulate an
old peer); accounting is always on.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from ..analysis.witness import make_lock
from .frames import WIRE_CHANNELS, WIRE_KEYS, WIRE_VERSION
from .snapshot import SNAPSHOT_OPS_THRESHOLD


def wire_enabled() -> bool:
    """Process-wide kill switch: ``DT_WIRE_DISABLED=1`` pins this node
    to the JSON fallback (it still *accepts* frames, but peers never
    send it any, because it stops advertising ``"wire"`` in pings)."""
    return os.environ.get("DT_WIRE_DISABLED", "") in ("", "0")


class WireChannel:
    def __init__(self, metrics=None, enabled: Optional[bool] = None,
                 snapshot_ops_threshold: int = SNAPSHOT_OPS_THRESHOLD,
                 cache_entries: int = 64) -> None:
        self.metrics = metrics      # ReplicationMetrics (bump_wire)
        self.enabled = wire_enabled() if enabled is None else enabled
        self.snapshot_ops_threshold = int(snapshot_ops_threshold)
        # peer_id -> advertised wire version (0 / absent = JSON only);
        # plain lock: leaf-level, never nested around another guard
        self._peer_versions: Dict[str, int] = {}
        self._peer_lock = threading.Lock()
        self._frame_cache_lock = make_lock("wire.frames", "io")
        self._frame_cache: "OrderedDict[Tuple[str, tuple], bytes]" = \
            OrderedDict()
        self.cache_entries = max(int(cache_entries), 1)

    # ---- negotiation -----------------------------------------------------

    def header_value(self) -> Optional[str]:
        """The ``X-DT-Wire`` value to advertise on requests (None when
        framing is disabled — the header is simply omitted)."""
        return f"v{WIRE_VERSION}" if self.enabled else None

    def note_peer(self, peer_id: str, version) -> None:
        """Fold a gossiped capability (``ping_json``'s ``"wire"``)."""
        try:
            v = int(version or 0)
        except (TypeError, ValueError):
            v = 0
        with self._peer_lock:
            self._peer_versions[peer_id] = v

    def peer_wire(self, peer_id: str) -> int:
        with self._peer_lock:
            return self._peer_versions.get(peer_id, 0)

    def use_wire(self, peer_id: str) -> bool:
        """May POST bodies to this peer be framed? Requires both our
        own framing switch and the peer's gossiped capability."""
        return self.enabled and self.peer_wire(peer_id) >= WIRE_VERSION

    # ---- accounting ------------------------------------------------------

    def account(self, channel: str, sent_bytes: int = 0,
                json_bytes: Optional[int] = None, framed: bool = False,
                snapshot: bool = False) -> None:
        """One send on ``channel``: always counts ``bytes_sent``;
        framed sends also count ``frames`` and the bytes the frame
        saved over its JSON equivalent."""
        m = self.metrics
        if m is None:
            return
        if sent_bytes:
            m.bump_wire(channel, "bytes_sent", sent_bytes)
        if framed:
            m.bump_wire(channel, "frames")
            if json_bytes is not None and json_bytes > sent_bytes:
                m.bump_wire(channel, "bytes_saved",
                            json_bytes - sent_bytes)
        if snapshot:
            m.bump_wire(channel, "snapshot_ships")

    # ---- snapshot frame cache --------------------------------------------

    def cached_snapshot(self, doc_id: str, frontier_key: tuple,
                        build: Callable[[], bytes]) -> bytes:
        """Frontier-keyed snapshot frame, built at most once per tip
        (best effort — a race builds twice, caches once). The cache
        lock guards only the map, never the encode."""
        key = (doc_id, frontier_key)
        with self._frame_cache_lock:
            frame = self._frame_cache.get(key)
            if frame is not None:
                self._frame_cache.move_to_end(key)
                return frame
        frame = build()
        with self._frame_cache_lock:
            self._frame_cache[key] = frame
            self._frame_cache.move_to_end(key)
            while len(self._frame_cache) > self.cache_entries:
                self._frame_cache.popitem(last=False)
        return frame

    def invalidate(self, doc_id: str) -> None:
        with self._frame_cache_lock:
            stale = [k for k in self._frame_cache if k[0] == doc_id]
            for k in stale:
                del self._frame_cache[k]

    def counters(self) -> dict:
        """The wire counter block (all zeros without metrics) — used
        by tests; the scorecard reads ``ReplicationMetrics`` direct."""
        m = self.metrics
        if m is None:
            return {f"{c}_{k}": 0 for c in WIRE_CHANNELS
                    for k in WIRE_KEYS}
        return m.wire_counters()
