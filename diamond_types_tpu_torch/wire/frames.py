"""Binary wire frames: one self-describing envelope for mesh transport.

Frame grammar (all integers LEB128 varints unless sized)::

    frame     := magic version ftype flags payload_len payload crc
    magic     := "DTWF"              (4 bytes)
    version   := u8                  (currently 1)
    ftype     := u8                  (FRAME_* below)
    flags     := u8                  (bit 0: payload is lz4-compressed)
    payload_len := varint            (byte length of payload as stored)
    payload   := payload_len bytes
    crc       := u32 LE CRC-32C over everything before it

A compressed payload (FLAG_LZ4) stores ``varint uncompressed_len``
followed by one lz4 block; the flag is set only when compression
actually wins. Decoding is total: bad magic, an unknown version, a
truncated buffer, a length overrun or a CRC mismatch all raise the
typed :class:`WireError` — a corrupt frame can never surface as
garbage ops.

Payload schemas (the delta encodings mirror the reference wire format:
agent tables interned once per frame, op runs as length-prefixed
spans — see encoding/encode.py for the patch body itself):

* ``SUMMARY`` — a version summary (causalgraph/summary.py): per agent
  an interned name plus delta-encoded ``[start, end)`` seq ranges.
* ``PATCH`` — a raw v1 ``DMNDTYPS`` patch (encoding/encode.py already
  does agent interning + RLE op spans; the frame adds the envelope).
* ``OPS`` — a proxied edit body: agent, remote-frontier version, and
  the op tape with ``mix_bit``-packed positions.
* ``STATE`` — a proxied read response: remote frontier + text.
* ``SNAPSHOT`` — a compacted snapshot: a record chain (baseline +
  patches, each a ``DMNDTYPS`` blob) replayed via ``decode_into``.
* ``DOCS`` — the anti-entropy doc listing: per doc an optional lease
  (holder interned, ttl in ms) and an optional frontier advert. The
  listing is re-sent every round to every peer, so it dominates the
  channel once deltas stop flowing — the binary form is what makes
  the steady-state round cheap.

The JAX package's `wire/frames.py`, copied: frames are byte-identical.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from ..encoding.crc32c import crc32c
from ..encoding.lz4 import lz4_compress_block, lz4_decompress_block
from ..encoding.varint import decode_leb, encode_leb, mix_bit, strip_bit

MAGIC = b"DTWF"
WIRE_VERSION = 1

# content negotiation: requests advertise `X-DT-Wire: v1`; responses
# are sniffed by magic (DTWF vs DMNDTYPS vs JSON), so old peers that
# ignore the header keep working mid-rolling-upgrade
WIRE_HEADER = "X-DT-Wire"
WIRE_CTYPE = "application/x-dt-wire"

FRAME_SUMMARY = 1
FRAME_PATCH = 2
FRAME_OPS = 3
FRAME_STATE = 4
FRAME_SNAPSHOT = 5
FRAME_DOCS = 6

_FRAME_TYPES = (FRAME_SUMMARY, FRAME_PATCH, FRAME_OPS, FRAME_STATE,
                FRAME_SNAPSHOT, FRAME_DOCS)

FLAG_LZ4 = 0x01

# the transport channels the metrics/scorecard split bytes across, and
# the per-channel counter keys — module-level so the dt-lint
# metrics-schema-drift rule can cross-reference producer bumps against
# them without importing a class
WIRE_CHANNELS = ("antientropy", "proxy", "hydrate", "gossip")
WIRE_KEYS = ("bytes_sent", "bytes_saved", "frames", "snapshot_ships")


class WireError(ValueError):
    """Typed decode rejection: the buffer is not a well-formed frame.
    Callers treat it exactly like a JSON parse error — fall back or
    400, never apply."""


def is_frame(data: bytes) -> bool:
    return data[:4] == MAGIC


# ---- envelope --------------------------------------------------------------

def encode_frame(ftype: int, payload: bytes,
                 compress: bool = False) -> bytes:
    """Wrap ``payload`` in one frame. ``compress=True`` tries lz4 and
    keeps it only when the block (plus its length prefix) is smaller
    than the raw payload."""
    flags = 0
    if compress and len(payload) > 64:
        block = encode_leb(len(payload)) + lz4_compress_block(payload)
        if len(block) < len(payload):
            payload = block
            flags |= FLAG_LZ4
    out = bytearray(MAGIC)
    out.append(WIRE_VERSION)
    out.append(ftype)
    out.append(flags)
    out += encode_leb(len(payload))
    out += payload
    out += struct.pack("<I", crc32c(bytes(out)))
    return bytes(out)


def decode_frame(data: bytes) -> Tuple[int, bytes]:
    """Returns ``(ftype, payload)``; raises WireError on anything that
    is not one intact, CRC-clean frame."""
    if len(data) < 12 or data[:4] != MAGIC:
        raise WireError("bad magic")
    if data[4] != WIRE_VERSION:
        raise WireError(f"unsupported wire version {data[4]}")
    ftype, flags = data[5], data[6]
    if ftype not in _FRAME_TYPES:
        raise WireError(f"unknown frame type {ftype}")
    if flags & ~FLAG_LZ4:
        raise WireError(f"unknown flags 0x{flags:02x}")
    try:
        plen, pos = decode_leb(data, 7)
    except Exception:
        raise WireError("truncated header")
    end = pos + plen
    if end + 4 != len(data):
        raise WireError("length mismatch")
    if struct.unpack("<I", data[end:end + 4])[0] != crc32c(data[:end]):
        raise WireError("crc mismatch")
    payload = data[pos:end]
    if flags & FLAG_LZ4:
        try:
            ulen, p = decode_leb(payload, 0)
            payload = lz4_decompress_block(payload[p:], ulen)
        except WireError:
            raise
        except Exception as e:
            raise WireError(f"bad lz4 payload: {e.__class__.__name__}")
    return ftype, payload


# ---- payload primitives ----------------------------------------------------

def _put_str(out: bytearray, s: str) -> None:
    b = s.encode("utf8")
    out += encode_leb(len(b))
    out += b


def _get_str(buf: bytes, pos: int) -> Tuple[str, int]:
    n, pos = decode_leb(buf, pos)
    end = pos + n
    if end > len(buf):
        raise WireError("truncated string")
    try:
        return buf[pos:end].decode("utf8"), end
    except UnicodeDecodeError:
        raise WireError("bad utf8")


def _put_frontier(out: bytearray, version) -> None:
    """Remote frontier: [[agent, seq], ...]."""
    out += encode_leb(len(version))
    for agent, seq in version:
        _put_str(out, agent)
        out += encode_leb(int(seq))


def _get_frontier(buf: bytes, pos: int) -> Tuple[List[list], int]:
    n, pos = decode_leb(buf, pos)
    version = []
    for _ in range(n):
        agent, pos = _get_str(buf, pos)
        seq, pos = decode_leb(buf, pos)
        version.append([agent, seq])
    return version, pos


def _decode_leb_checked(buf: bytes, pos: int) -> Tuple[int, int]:
    try:
        return decode_leb(buf, pos)
    except Exception:
        raise WireError("truncated varint")


# ---- SUMMARY ---------------------------------------------------------------

def encode_summary(summary: Dict[str, List[List[int]]]) -> bytes:
    """Version summary: agent table interned once, seq ranges
    delta-encoded (``start - prev_end``, ``end - start``) so long run
    chains cost a couple of bytes each."""
    out = bytearray()
    out += encode_leb(len(summary))
    for agent in sorted(summary):
        _put_str(out, agent)
        ranges = summary[agent]
        out += encode_leb(len(ranges))
        prev = 0
        for s, e in ranges:
            out += encode_leb(s - prev)
            out += encode_leb(e - s)
            prev = e
    return bytes(out)


def decode_summary(payload: bytes) -> Dict[str, List[List[int]]]:
    pos = 0
    n_agents, pos = _decode_leb_checked(payload, pos)
    out: Dict[str, List[List[int]]] = {}
    for _ in range(n_agents):
        agent, pos = _get_str(payload, pos)
        n_ranges, pos = _decode_leb_checked(payload, pos)
        ranges = []
        prev = 0
        for _ in range(n_ranges):
            gap, pos = _decode_leb_checked(payload, pos)
            span, pos = _decode_leb_checked(payload, pos)
            s = prev + gap
            ranges.append([s, s + span])
            prev = s + span
        out[agent] = ranges
    if pos != len(payload):
        raise WireError("trailing bytes in summary")
    return out


# ---- OPS (proxied edit body) -----------------------------------------------

def encode_ops(req: dict) -> bytes:
    """The JSON edit body ``{"agent", "version", "ops"}`` as a frame
    payload. Each op packs its position with ``mix_bit`` (the delete
    discriminator rides in the low bit, reference-style); inserts
    carry text, deletes a run length."""
    out = bytearray()
    _put_str(out, req["agent"])
    _put_frontier(out, req.get("version") or [])
    ops = req["ops"]
    out += encode_leb(len(ops))
    for op in ops:
        if op.get("kind") == "ins":
            out += encode_leb(mix_bit(int(op["pos"]), False))
            _put_str(out, op["text"])
        elif op.get("kind") == "del":
            start, end = int(op["start"]), int(op["end"])
            out += encode_leb(mix_bit(start, True))
            out += encode_leb(end - start)
        else:
            raise WireError(f"bad op kind {op.get('kind')!r}")
    return bytes(out)


def decode_ops(payload: bytes) -> dict:
    pos = 0
    agent, pos = _get_str(payload, pos)
    version, pos = _get_frontier(payload, pos)
    n_ops, pos = _decode_leb_checked(payload, pos)
    ops = []
    for _ in range(n_ops):
        mixed, pos = _decode_leb_checked(payload, pos)
        p, is_del = strip_bit(mixed)
        if is_del:
            span, pos = _decode_leb_checked(payload, pos)
            ops.append({"kind": "del", "start": p, "end": p + span})
        else:
            text, pos = _get_str(payload, pos)
            ops.append({"kind": "ins", "pos": p, "text": text})
    if pos != len(payload):
        raise WireError("trailing bytes in ops")
    return {"agent": agent, "version": version, "ops": ops}


# ---- STATE (proxied read response) -----------------------------------------

def encode_state(text: str, version) -> bytes:
    out = bytearray()
    _put_frontier(out, version)
    _put_str(out, text)
    return bytes(out)


def decode_state(payload: bytes) -> Tuple[str, List[list]]:
    pos = 0
    version, pos = _get_frontier(payload, pos)
    text, pos = _get_str(payload, pos)
    if pos != len(payload):
        raise WireError("trailing bytes in state")
    return text, version


# ---- DOCS (anti-entropy listing) -------------------------------------------

_DOC_HAS_LEASE = 0x01
_DOC_HAS_FRONTIER = 0x02


def encode_docs(listing: dict) -> bytes:
    """The ``/replicate/docs`` JSON listing (``{"docs": {...},
    "self": id}``) as a frame payload. Lease holders are interned in a
    table (in a steady mesh a handful of hosts hold every lease), TTLs
    ride as integer milliseconds."""
    docs = listing.get("docs") or {}
    holders: List[str] = []
    hidx: Dict[str, int] = {}
    for info in docs.values():
        lease = (info or {}).get("lease")
        if lease and lease["holder"] not in hidx:
            hidx[lease["holder"]] = len(holders)
            holders.append(lease["holder"])
    out = bytearray()
    _put_str(out, listing.get("self") or "")
    out += encode_leb(len(holders))
    for h in holders:
        _put_str(out, h)
    out += encode_leb(len(docs))
    for doc_id in sorted(docs):
        info = docs[doc_id] or {}
        lease = info.get("lease")
        frontier = info.get("frontier")
        _put_str(out, doc_id)
        flags = (_DOC_HAS_LEASE if lease else 0) \
            | (_DOC_HAS_FRONTIER if frontier is not None else 0)
        out.append(flags)
        if lease:
            out += encode_leb(hidx[lease["holder"]])
            out += encode_leb(int(lease["epoch"]))
            _put_str(out, lease.get("state", "active"))
            out += encode_leb(max(int(round(
                float(lease.get("ttl_s", 0.0)) * 1000)), 0))
        if frontier is not None:
            _put_frontier(out, frontier)
    return bytes(out)


def decode_docs(payload: bytes) -> dict:
    pos = 0
    self_id, pos = _get_str(payload, pos)
    n_holders, pos = _decode_leb_checked(payload, pos)
    holders = []
    for _ in range(n_holders):
        h, pos = _get_str(payload, pos)
        holders.append(h)
    n_docs, pos = _decode_leb_checked(payload, pos)
    docs: Dict[str, dict] = {}
    for _ in range(n_docs):
        doc_id, pos = _get_str(payload, pos)
        if pos >= len(payload):
            raise WireError("truncated doc entry")
        flags = payload[pos]
        pos += 1
        if flags & ~(_DOC_HAS_LEASE | _DOC_HAS_FRONTIER):
            raise WireError(f"unknown doc flags 0x{flags:02x}")
        info: dict = {"lease": None}
        if flags & _DOC_HAS_LEASE:
            hi, pos = _decode_leb_checked(payload, pos)
            if hi >= len(holders):
                raise WireError("bad holder index")
            epoch, pos = _decode_leb_checked(payload, pos)
            state, pos = _get_str(payload, pos)
            ttl_ms, pos = _decode_leb_checked(payload, pos)
            info["lease"] = {"holder": holders[hi], "epoch": epoch,
                             "state": state, "ttl_s": ttl_ms / 1000.0}
        if flags & _DOC_HAS_FRONTIER:
            frontier, pos = _get_frontier(payload, pos)
            info["frontier"] = frontier
        docs[doc_id] = info
    if pos != len(payload):
        raise WireError("trailing bytes in docs listing")
    return {"docs": docs, "self": self_id}


# ---- SNAPSHOT (record chain) -----------------------------------------------

def encode_records(records: List[bytes]) -> bytes:
    """Snapshot payload: a length-prefixed chain of ``DMNDTYPS`` blobs
    (a PagedDocFile baseline + its patch WAL, or one full encode)."""
    out = bytearray()
    out += encode_leb(len(records))
    for rec in records:
        out += encode_leb(len(rec))
        out += rec
    return bytes(out)


def decode_records(payload: bytes) -> List[bytes]:
    pos = 0
    n, pos = _decode_leb_checked(payload, pos)
    records = []
    for _ in range(n):
        rlen, pos = _decode_leb_checked(payload, pos)
        end = pos + rlen
        if end > len(payload):
            raise WireError("truncated record")
        records.append(payload[pos:end])
        pos = end
    if pos != len(payload):
        raise WireError("trailing bytes in snapshot")
    return records
