"""Compacted-snapshot shipping: one frame instead of an op replay.

Two transport paths want a whole document, not a delta:

* a peer whose version summary lags the local oplog by more than
  ``snapshot_ops_threshold`` ops (anti-entropy would otherwise encode
  and ship a near-full patch with per-op framing overhead);
* a cold hydration miss on a follower whose durable home is empty —
  fetching the owner's compacted snapshot beats replaying history.

The payload reuses the PR 8 ``PagedDocFile`` store: when the doc has a
durable home on disk, its already-compacted record chain (baseline +
patch WAL, each a ``DMNDTYPS`` blob) is shipped verbatim — no
re-encode on the hot path. A memory-resident doc falls back to one
``ENCODE_FULL`` record. Either way the receiver replays the chain
through ``decode_into``, which is idempotent and dedup-safe, so a
snapshot is applied exactly like a patch — double delivery merges to
the same bytes.

The JAX package's `wire/snapshot.py`, copied. The Hydrator's remote fill
imports `apply_snapshot`; `replicate.attach_replication` wires its
`remote_fetch` to the node's `fetch_remote_snapshot`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from ..encoding.decode import decode_into
from ..encoding.encode import ENCODE_FULL, encode_oplog
from .frames import (FRAME_SNAPSHOT, WireError, decode_frame,
                     decode_records, encode_frame, encode_records)

# a peer missing more ops than this receives one snapshot frame
# instead of a patch replay (the "snapshot-vs-replay decision rule")
SNAPSHOT_OPS_THRESHOLD = 512


def missing_ops(cg, local_version, common) -> int:
    """How many local ops the peer provably lacks: the span total of
    ``diff(local, common)``'s local-only side. Caller holds the
    store's oplog lock."""
    only_local, _only_common = cg.graph.diff(local_version, common)
    return sum(e - s for s, e in only_local)


def should_ship_snapshot(cg, local_version, common,
                         threshold: int = SNAPSHOT_OPS_THRESHOLD) -> bool:
    """True when the peer is far enough behind that one compacted
    snapshot beats replaying the missing ops."""
    if threshold <= 0:
        return False
    return missing_ops(cg, local_version, common) > threshold


def snapshot_records(ol, store=None, doc_id: Optional[str] = None,
                     oplog_lock=None) -> Tuple[List[bytes], bool]:
    """The doc's compacted record chain. Prefers the durable
    ``PagedDocFile`` home (records shipped verbatim, no re-encode) —
    but only when the home actually covers the live oplog (the warm
    copy may hold unsaved suffix ops). Returns (records, from_disk)."""
    if store is not None and doc_id is not None:
        try:
            path = store.path(doc_id)
            if os.path.exists(path) \
                    and store.is_quarantined(doc_id) is None:
                from ..storage.pages import PagedDocFile
                f = PagedDocFile(path)
                try:
                    covered = len(f.oplog)
                    records = list(f.store.records(f.BASELINE)) \
                        + list(f.store.records(f.PATCHES))
                finally:
                    f.close()
                if records and covered >= len(ol):
                    return records, True
        except Exception:
            pass        # unreadable home: fall through to a live encode
    if oplog_lock is not None:
        with oplog_lock:
            return [encode_oplog(ol, ENCODE_FULL)], False
    return [encode_oplog(ol, ENCODE_FULL)], False


def build_snapshot(ol, store=None, doc_id: Optional[str] = None,
                   oplog_lock=None) -> bytes:
    """One SNAPSHOT frame for the doc (lz4 over the record chain)."""
    records, _from_disk = snapshot_records(ol, store, doc_id,
                                           oplog_lock=oplog_lock)
    return encode_frame(FRAME_SNAPSHOT, encode_records(records),
                        compress=True)


def apply_snapshot(ol, frame: bytes) -> int:
    """Replay a SNAPSHOT frame into ``ol`` (caller holds the oplog
    lock). Returns the number of new ops merged. Raises WireError on
    a malformed frame and lets decode errors from a corrupt record
    propagate — never half-applies garbage silently."""
    ftype, payload = decode_frame(frame)
    if ftype != FRAME_SNAPSHOT:
        raise WireError(f"expected snapshot frame, got type {ftype}")
    pre = len(ol)
    for rec in decode_records(payload):
        decode_into(ol, rec)
    return len(ol) - pre
