"""Crash-safe incremental persistence.

Capability mirror of the reference's L6 storage stack:
  * write-ahead log with per-record checksums and corrupt-tail recovery
    (reference: src/wal.rs:40-90 — "each chunk has a checksum, so
    inopportune crashes don't corrupt any data"; WAL records here are
    self-contained v1 patches: option 1 of the reference's design note)
  * page-based incremental store: fixed 4 KiB blocks, atomic whole-block
    writes, double "blit" header slots with monotonic generation counters so
    a torn header write never destroys the previous good header
    (reference: src/storage/README.md, src/storage/mod.rs:103-137,
    src/causalgraph/storage.rs:1-16 blitting buffers)

`DocFile` ties it together: a persistent OpLog = baseline snapshot +
incremental WAL of binary patches; reopening replays the WAL (idempotent —
decode dedups already-known ops) and `compact()` folds the WAL back into the
baseline.

The JAX package's `storage/store.py`, copied: the WAL and snapshot
layouts are byte-identical, so each package reads the other's files.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional

from ..encoding.crc32c import crc32c
from ..encoding.decode import decode_into, load_oplog
from ..encoding.encode import ENCODE_FULL, ENCODE_PATCH, encode_oplog
from ..text.oplog import OpLog

PAGE_SIZE = 4096
WAL_MAGIC = b"DTTPUWAL"
STORE_MAGIC = b"DTTPUSTR"


class StorageError(Exception):
    pass


# --------------------------------------------------------------------- WAL

class Wal:
    """Append-only record log. Record frame: u32 len | u32 crc32c | bytes.
    A torn tail (partial frame or bad CRC) is truncated on open."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = None
        self._open()

    def _open(self) -> None:
        exists = os.path.exists(self.path)
        self._f = open(self.path, "a+b")
        if not exists or os.path.getsize(self.path) == 0:
            self._f.write(WAL_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
            return
        # Validate + find the end of good data.
        self._f.seek(0)
        head = self._f.read(len(WAL_MAGIC))
        if head != WAL_MAGIC:
            raise StorageError("bad WAL magic")
        good_end = self._scan_good_end()
        if good_end < os.path.getsize(self.path):
            self._f.truncate(good_end)
            self._f.flush()
            os.fsync(self._f.fileno())

    def _scan_good_end(self) -> int:
        self._f.seek(len(WAL_MAGIC))
        pos = len(WAL_MAGIC)
        while True:
            hdr = self._f.read(8)
            if len(hdr) < 8:
                return pos
            n, crc = struct.unpack("<II", hdr)
            data = self._f.read(n)
            if len(data) < n or crc32c(data) != crc:
                return pos
            pos += 8 + n

    def append(self, record: bytes, sync: bool = True) -> None:
        self._f.seek(0, os.SEEK_END)
        self._f.write(struct.pack("<II", len(record), crc32c(record)))
        self._f.write(record)
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())

    def records(self) -> Iterator[bytes]:
        self._f.seek(len(WAL_MAGIC))
        while True:
            hdr = self._f.read(8)
            if len(hdr) < 8:
                return
            n, crc = struct.unpack("<II", hdr)
            data = self._f.read(n)
            if len(data) < n or crc32c(data) != crc:
                return
            yield data

    def reset(self) -> None:
        self._f.truncate(len(WAL_MAGIC))
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


# -------------------------------------------------------------- page store

class PageStore:
    """Fixed-size-block store with double-blit header.

    Layout: page 0 and page 1 are alternating header slots
      (magic | u64 generation | u64 data_offset | u64 data_len |
       u32 crc-of-header | u32 crc-of-data). Data blobs live at page-aligned
    extents; a new generation is written to a FRESH extent (past every live
    extent), fsynced, and only then does the *older* header slot get
    rewritten with generation+1 — so a crash at any point leaves at least
    one valid (header, data) pair. `compact()` (via DocFile) keeps growth
    bounded.
    """

    _HDR = struct.Struct("<8sQQQII")

    def __init__(self, path: str) -> None:
        self.path = path
        new = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "r+b" if not new else "w+b")
        if new:
            self._gen = 0
            self._data = b""
            self._off = 2 * PAGE_SIZE
            self._extents = []
            self._write_header(slot=0)
        else:
            self._recover()

    def _read_header(self, slot: int):
        self._f.seek(slot * PAGE_SIZE)
        raw = self._f.read(self._HDR.size)
        if len(raw) < self._HDR.size:
            return None
        magic, gen, doff, dlen, hcrc, dcrc = self._HDR.unpack(raw)
        if magic != STORE_MAGIC:
            return None
        if crc32c(raw[:self._HDR.size - 8]) != hcrc:
            return None
        return (gen, doff, dlen, dcrc)

    def _recover(self) -> None:
        best = None
        self._extents = []
        for slot in (0, 1):
            h = self._read_header(slot)
            if h is None:
                continue
            gen, doff, dlen, dcrc = h
            self._f.seek(doff)
            data = self._f.read(dlen)
            if len(data) < dlen or crc32c(data) != dcrc:
                continue  # data for this header torn; try the other slot
            self._extents.append((doff, dlen))
            if best is None or gen > best[0]:
                best = (gen, data, doff)
        if best is None:
            raise StorageError("no valid header slot")
        self._gen, self._data, self._off = best[0], best[1], best[2]

    def _write_header(self, slot: int) -> None:
        body = self._HDR.pack(STORE_MAGIC, self._gen, self._off,
                              len(self._data), 0, crc32c(self._data))
        hcrc = crc32c(body[:self._HDR.size - 8])
        body = self._HDR.pack(STORE_MAGIC, self._gen, self._off,
                              len(self._data), hcrc, crc32c(self._data))
        self._f.seek(slot * PAGE_SIZE)
        self._f.write(body.ljust(PAGE_SIZE, b"\0"))
        self._f.flush()
        os.fsync(self._f.fileno())

    def write(self, data: bytes) -> None:
        # Fresh page-aligned extent past every live extent.
        end = 2 * PAGE_SIZE
        for (doff, dlen) in getattr(self, "_extents", []):
            end = max(end, doff + dlen)
        off = end + (-end % PAGE_SIZE)
        self._f.seek(off)
        self._f.write(data)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._gen += 1
        self._data = data
        self._off = off
        # Keep only the two most recent extents alive.
        self._extents = (getattr(self, "_extents", [])[-1:]) + [(off, len(data))]
        self._write_header(slot=self._gen % 2)

    def read(self) -> bytes:
        return self._data

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------------ DocFile

class DocFile:
    """A persistent OpLog: PageStore baseline + WAL of incremental patches
    (the reference's oplog file + WAL + CG-storage roles combined)."""

    def __init__(self, path: str) -> None:
        self.base = PageStore(path)
        self.wal = Wal(path + ".wal")
        self.oplog = OpLog()
        baseline = self.base.read()
        if baseline:
            decode_into(self.oplog, baseline)
        for rec in self.wal.records():
            decode_into(self.oplog, rec)  # idempotent: dedup via causal graph
        self._saved_version = self.oplog.version

    def append_from(self, src_oplog: OpLog) -> None:
        """Persist everything `src_oplog` has that we haven't saved."""
        patch = encode_oplog(src_oplog, ENCODE_PATCH,
                             from_version=self._intersect(src_oplog))
        self.wal.append(patch)
        decode_into(self.oplog, patch)
        self._saved_version = self.oplog.version

    def _intersect(self, src: OpLog) -> List[int]:
        from ..causalgraph.summary import (intersect_with_summary,
                                           summarize_versions)
        common, _ = intersect_with_summary(src.cg,
                                           summarize_versions(self.oplog.cg))
        return common

    def compact(self, _crash=None) -> None:
        """Fold the WAL into the baseline (reference: dt-cli repack
        role). fsync ordering: PageStore.write makes the new baseline
        extent + header durable BEFORE the WAL truncates — a crash
        between the two steps replays the stale WAL onto the new
        baseline, which the idempotent decode dedups to the same
        oplog. `_crash(point)` is a fault-injection hook fired after
        each durable step ("baseline_written", "wal_reset")."""
        self.base.write(encode_oplog(self.oplog, ENCODE_FULL))
        if _crash is not None:
            _crash("baseline_written")
        self.wal.reset()
        if _crash is not None:
            _crash("wal_reset")

    def close(self) -> None:
        self.base.close()
        self.wal.close()
