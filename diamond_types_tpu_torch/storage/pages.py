"""Page-granular incremental storage engine.

Capability mirror of the reference's page store (reference:
src/storage/README.md; src/storage/mod.rs:103-505 — fixed 4 KiB pages,
whole-page atomic writes, per-page checksums, blit pages so updating the
tail of a chain never overwrites its only valid copy; and
src/causalgraph/storage.rs:1-40 — incremental append format). The design
here is NOT a translation: instead of a header page + per-chunk next-page
pointers, every page is fully self-describing

    u32 crc | u8 stream | u8 is_blit | u16 used | u32 chain_idx |
    u32 chain_gen | u32 write_seq | payload

and recovery is one linear scan grouping pages by (stream, chain_gen,
chain_idx), picking the highest write_seq among a page's main and blit
images. No pointers to maintain means a tail update is exactly ONE page
write + fsync, and a torn write at any byte leaves the previous image
intact: the writer alternates between the tail's main slot and the
stream's blit slot, so the only valid copy is never the one being
overwritten.

Streams: small integers naming independent record chains in one file.
`PagedDocFile` uses stream 0 for baseline snapshots (a fresh chain_gen
per compact) and stream 1 for incremental binary patches — the roles the
reference splits across its oplog file, CG file and WAL. Records are
length-framed and may span pages; a record torn by a crash is rolled
back on recovery (the chain truncates to the last complete record).

Write amplification: appending a record rewrites the tail page and
allocates follow-on pages only for bytes that spill, so a 1-char edit to
a megabyte document persists O(1) pages — pinned down by
tests/test_storage.py::test_paged_write_amplification.

The JAX package's `storage/pages.py`, copied: the page layout is
byte-identical, so each package reads the other's files.
"""

from __future__ import annotations

import os
import struct
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..encoding.crc32c import crc32c


def _fsync_dir(dirpath: str) -> None:
    """fsync a directory so a just-completed rename survives power
    loss (an os.replace is atomic but not durable until the directory
    entry itself is flushed)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:     # pragma: no cover - platform without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)

PAGE_SIZE = 4096
_HDR = struct.Struct("<IBBHIII")        # crc, stream, blit, used, idx, gen, seq
PAYLOAD = PAGE_SIZE - _HDR.size
_REC = struct.Struct("<I")               # record length frame
_DEAD = 255      # reserved stream id: page invalidated by a rollback


class PageStoreError(Exception):
    pass


class _Chain:
    __slots__ = ("gen", "pages", "tail_main", "tail_seq", "tail_data",
                 "blit_slot")

    def __init__(self, gen: int):
        self.gen = gen
        self.pages: List[int] = []          # slots of FINALIZED (full) pages
        self.tail_main: Optional[int] = None   # tail's main slot (lazy)
        self.tail_seq = 0
        self.tail_data = b""
        self.blit_slot: Optional[int] = None


class PagedStore:
    """Multi-stream page-chain store in one file (see module docstring)."""

    def __init__(self, path: str) -> None:
        self.path = path
        new = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "w+b" if new else "r+b")
        self.bytes_written = 0           # observability: write amplification
        self.page_writes = 0
        self._chains: Dict[int, _Chain] = {}
        self._full: Dict[Tuple[int, int], bytes] = {}  # (stream, idx) -> data
        self._max_gen: Dict[int, int] = {}
        self._next_free = 0
        if not new:
            self._recover()

    # ---- low-level page IO ----------------------------------------------

    def _write_page(self, slot: int, stream: int, is_blit: int, used: int,
                    idx: int, gen: int, seq: int, payload: bytes,
                    sync: bool = True) -> None:
        assert len(payload) <= PAYLOAD and slot is not None
        body = _HDR.pack(0, stream, is_blit, used, idx, gen, seq) + \
            payload.ljust(PAYLOAD, b"\0")
        page = struct.pack("<I", crc32c(body[4:])) + body[4:]
        self._f.seek(slot * PAGE_SIZE)
        self._f.write(page)
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())
        self.bytes_written += PAGE_SIZE
        self.page_writes += 1

    def _read_page(self, slot: int):
        self._f.seek(slot * PAGE_SIZE)
        raw = self._f.read(PAGE_SIZE)
        if len(raw) < PAGE_SIZE:
            return None
        crc, stream, is_blit, used, idx, gen, seq = _HDR.unpack(
            raw[:_HDR.size])
        if crc32c(raw[4:]) != crc or used > PAYLOAD:
            return None
        return stream, is_blit, used, idx, gen, seq, raw[_HDR.size:
                                                         _HDR.size + used]

    # ---- recovery --------------------------------------------------------

    def _recover(self) -> None:
        n_pages = (os.path.getsize(self.path) + PAGE_SIZE - 1) // PAGE_SIZE
        self._next_free = n_pages
        # (stream, idx) -> best image (gen, seq, payload, is_blit) and best
        # MAIN slot per key; blit slot per stream (the newest blit wins)
        best: Dict[Tuple[int, int], Tuple[int, int, bytes, int]] = {}
        main_slot: Dict[Tuple[int, int, int], int] = {}  # (stream,gen,idx)
        blit: Dict[int, Tuple[int, int, int, int]] = {}  # s->(seq,slot,idx,gen)
        max_seq: Dict[Tuple[int, int], int] = {}         # (stream,gen)
        for slot in range(n_pages):
            p = self._read_page(slot)
            if p is None:
                continue
            stream, is_blit, used, idx, gen, seq, payload = p
            if stream == _DEAD:
                continue   # invalidated by an earlier rollback
            k = (stream, gen)
            max_seq[k] = max(max_seq.get(k, 0), seq)
            if is_blit:
                cur = blit.get(stream)
                if cur is None or seq >= cur[0]:
                    blit[stream] = (seq, slot, idx, gen)
            else:
                key = (stream, gen, idx)
                cur = main_slot.get(key)
                if cur is None or seq > cur[0]:
                    main_slot[key] = (seq, slot)
            key2 = (stream, idx)
            cur2 = best.get(key2)
            if cur2 is None or (gen, seq) > (cur2[0], cur2[1]):
                best[key2] = (gen, seq, payload, is_blit)
        # live chain per stream = highest gen seen at idx 0; ALSO track
        # the max gen seen anywhere so a stream recreated after losing
        # its idx-0 page can never splice stale same-gen pages back in
        live_gen: Dict[int, int] = {}
        for (stream, idx), (gen, _s, _p, _b) in best.items():
            if idx == 0:
                live_gen[stream] = max(live_gen.get(stream, -1), gen)
            self._max_gen[stream] = max(self._max_gen.get(stream, 0), gen)
        for stream, gen in live_gen.items():
            ch = _Chain(gen)
            ch.blit_slot = blit.get(stream, (0, None, 0, 0))[1]
            payloads: List[bytes] = []
            idx = 0
            while True:
                cur = best.get((stream, idx))
                if cur is None or cur[0] != gen:
                    break
                payloads.append(cur[2])
                ch.tail_seq = cur[1]
                idx += 1
            if not payloads:
                continue
            # roll back any torn trailing record: keep only bytes up to
            # the end of the last COMPLETE record
            buf = b"".join(payloads)
            good = 0
            off = 0
            while off + _REC.size <= len(buf):
                (ln,) = _REC.unpack_from(buf, off)
                nxt = off + _REC.size + ln
                if nxt > len(buf):
                    break
                off = nxt
                good = off
            buf = buf[:good]
            n_full = len(buf) // PAYLOAD
            ch.pages = []
            seal_seq = max_seq.get((stream, gen), 0) + 1
            for i in range(n_full):
                entry = main_slot.get((stream, gen, i))
                content = buf[i * PAYLOAD:(i + 1) * PAYLOAD]
                bseq = best[(stream, i)][1]
                if entry is None or entry[0] < bseq:
                    # the newest image of this finalized page lives on the
                    # blit slot (tail filled on an odd write) — re-seal it
                    # at a main slot NOW, or the next blit reuse would
                    # leave only the stale main image to a later recovery
                    slot = entry[1] if entry is not None else self._alloc()
                    self._write_page(slot, stream, 0, PAYLOAD, i, gen,
                                     seal_seq, content)
                else:
                    slot = entry[1]
                ch.pages.append(slot)
                self._full[(stream, i)] = content
            ch.tail_data = buf[n_full * PAYLOAD:]
            tm = main_slot.get((stream, gen, n_full))
            ch.tail_main = None if tm is None else tm[1]
            # Invalidate the rolled-back suffix: a torn-record rollback can
            # shrink the chain, leaving VALID same-gen pages past the new
            # tail on disk. Without killing them, a later recovery's chain
            # walk splices their bytes back into the record stream (after a
            # clean intervening close), yielding phantom/garbage records.
            # Deferred-fsync batch: losing these writes to a crash is safe
            # (the next recovery deterministically redoes the identical
            # rollback), so one trailing fsync covers the whole suffix
            # instead of one per page.
            killed = False
            for key in [k for k in main_slot
                        if k[0] == stream and k[1] == gen and k[2] > n_full]:
                self._write_page(main_slot[key][1], _DEAD, 0, 0, 0, 0, 0,
                                 b"", sync=False)
                del main_slot[key]
                killed = True
            bl = blit.get(stream)
            if bl is not None and bl[3] == gen and bl[2] > n_full:
                # Stale high-idx tail image on the blit slot: overwrite it
                # with a valid EMPTY blit image at the new tail idx (not a
                # _DEAD page — the next recovery must still recognize the
                # slot as this stream's blit, or it would be leaked and a
                # fresh slot allocated per rollback+reopen). seq 0 loses to
                # any real tail image at this idx.
                self._write_page(bl[1], stream, 1, 0, n_full, gen, 0, b"",
                                 sync=False)
                killed = True
            if killed:
                os.fsync(self._f.fileno())
            # New tail writes must outrank ANY stale image of this chain
            # (rollback can re-point the tail at a page whose on-disk image
            # carries a higher seq; ditto re-sealed pages above). Parity
            # matters too: tail writes alternate main/blit by seq, and the
            # FIRST post-recovery write must target the slot NOT holding
            # the newest tail image, or a torn write there could destroy
            # the only valid copy of committed records.
            tb = best.get((stream, n_full))
            tail_on_blit = bool(tb is not None and tb[0] == gen and tb[3])
            want = 1 if tail_on_blit else 0   # next write flips parity
            ch.tail_seq = seal_seq if seal_seq % 2 == want else seal_seq + 1
            self._chains[stream] = ch

    # ---- write path ------------------------------------------------------

    def _alloc(self) -> int:
        slot = self._next_free
        self._next_free += 1
        return slot

    def _chain(self, stream: int) -> _Chain:
        ch = self._chains.get(stream)
        if ch is None:
            # a stream being (re)created starts ABOVE any gen ever seen on
            # disk — stale pages of a dropped chain must never win
            gen = self._max_gen.get(stream, -1) + 1
            self._max_gen[stream] = gen
            ch = _Chain(gen)
            ch.blit_slot = self._alloc()
            self._chains[stream] = ch
        return ch

    def _write_tail(self, stream: int, ch: _Chain) -> None:
        """Atomic tail update: alternate between the tail's main slot and
        the stream's blit slot; the image not being written always holds
        the previous state (reference: the blit protocol)."""
        ch.tail_seq += 1
        idx = len(ch.pages)
        if ch.tail_seq % 2 == 1:
            if ch.blit_slot is None:    # blit page lost to corruption
                ch.blit_slot = self._alloc()
            self._write_page(ch.blit_slot, stream, 1, len(ch.tail_data),
                             idx, ch.gen, ch.tail_seq, ch.tail_data)
        else:
            if ch.tail_main is None:
                ch.tail_main = self._alloc()
            self._write_page(ch.tail_main, stream, 0, len(ch.tail_data),
                             idx, ch.gen, ch.tail_seq, ch.tail_data)

    def _finalize_tail(self, stream: int, ch: _Chain) -> None:
        """Seal a full tail page at its main slot and start a new tail."""
        assert len(ch.tail_data) == PAYLOAD
        idx = len(ch.pages)
        if ch.tail_main is None:
            ch.tail_main = self._alloc()
        self._write_page(ch.tail_main, stream, 0, PAYLOAD, idx, ch.gen,
                         ch.tail_seq + 1, ch.tail_data)
        self._full[(stream, idx)] = ch.tail_data
        ch.pages.append(ch.tail_main)
        ch.tail_main = None
        ch.tail_data = b""
        ch.tail_seq = 0

    def append(self, stream: int, record: bytes) -> None:
        """Append one length-framed record (may span pages). Each touched
        page costs exactly one page write + fsync."""
        if stream == _DEAD:   # recovery would skip its pages as garbage
            raise PageStoreError("stream id 255 is reserved")
        ch = self._chain(stream)
        data = _REC.pack(len(record)) + record
        while True:
            space = PAYLOAD - len(ch.tail_data)
            take, data = data[:space], data[space:]
            ch.tail_data += take
            if not data:
                break
            self._finalize_tail(stream, ch)
        self._write_tail(stream, ch)

    def reset_stream(self, stream: int) -> None:
        """Start a fresh (empty) chain generation for the stream; prior
        pages become garbage until the file is compacted."""
        if stream == _DEAD:
            raise PageStoreError("stream id 255 is reserved")
        old = self._chains.get(stream)
        gen = self._max_gen.get(stream, -1) + 1
        self._max_gen[stream] = gen
        ch = _Chain(gen)
        ch.blit_slot = old.blit_slot if old and \
            old.blit_slot is not None else self._alloc()
        for key in [k for k in self._full if k[0] == stream]:
            del self._full[key]
        self._chains[stream] = ch
        self._write_tail(stream, ch)

    def records(self, stream: int) -> Iterator[bytes]:
        """Iterate the stream's complete records."""
        ch = self._chains.get(stream)
        if ch is None:
            return
        buf = b"".join(self._full[(stream, i)]
                       for i in range(len(ch.pages))) + ch.tail_data
        off = 0
        while off + _REC.size <= len(buf):
            (ln,) = _REC.unpack_from(buf, off)
            if off + _REC.size + ln > len(buf):
                return   # torn tail record (rolled back on next open)
            yield buf[off + _REC.size: off + _REC.size + ln]
            off += _REC.size + ln

    def close(self) -> None:
        self._f.close()


class PagedDocFile:
    """A persistent OpLog on the page engine: stream 0 = baseline
    snapshot, stream 1 = incremental patches. A 1-char edit persists one
    patch record (O(1) page writes); compact() folds the patch chain into
    a fresh baseline and rewrites the file packed (dt-cli repack role)."""

    BASELINE, PATCHES = 0, 1

    def __init__(self, path: str) -> None:
        from ..encoding.decode import decode_into
        from ..text.oplog import OpLog
        self.path = path
        stale = path + ".compact"
        if os.path.exists(stale):
            # a crash mid-compaction left a half-built rewrite behind;
            # `path` is authoritative either way (the swap is atomic),
            # and compact() must never append onto a stale rewrite
            os.remove(stale)
        self.store = PagedStore(path)
        self.oplog = OpLog()
        for rec in self.store.records(self.BASELINE):
            decode_into(self.oplog, rec)
        for rec in self.store.records(self.PATCHES):
            decode_into(self.oplog, rec)   # idempotent causal dedup

    def append_from(self, src_oplog) -> None:
        """Persist everything `src_oplog` has that this file hasn't."""
        from ..causalgraph.summary import (intersect_with_summary,
                                           summarize_versions)
        from ..encoding.decode import decode_into
        from ..encoding.encode import ENCODE_PATCH, encode_oplog
        common, _ = intersect_with_summary(
            src_oplog.cg, summarize_versions(self.oplog.cg))
        patch = encode_oplog(src_oplog, ENCODE_PATCH, from_version=common)
        self.store.append(self.PATCHES, patch)
        decode_into(self.oplog, patch)

    def compact(self,
                _crash: Optional[Callable[[str], None]] = None) -> None:
        """Fold both streams into a fresh single-baseline file.

        Crash protocol — each step is individually durable, so a kill
        at any point recovers to either the old or the new snapshot,
        never a torn mix:

          1. the full snapshot is built at `<path>.compact` (every
             page fsynced as written)           crash -> old file wins
          2. `os.replace` swaps it in atomically crash -> old OR new
          3. the directory entry is fsynced so the rename itself
             survives power loss                crash -> new file wins

        A stale `.compact` from an earlier crash is removed before
        rebuilding (and on open), so step 1 never appends onto a
        half-built rewrite. `_crash(point)` is a fault-injection hook
        fired after each step ("snapshot_written", "replaced",
        "dir_synced"); whatever it raises propagates only AFTER the
        store has been reopened on whichever image the crash left, so
        the object stays usable and matches what a real restart would
        recover."""
        from ..encoding.encode import ENCODE_FULL, encode_oplog
        crash = _crash if _crash is not None else (lambda point: None)
        blob = encode_oplog(self.oplog, ENCODE_FULL)
        tmp = self.path + ".compact"
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
            fresh = PagedStore(tmp)
            fresh.append(self.BASELINE, blob)
            fresh.close()
            crash("snapshot_written")
            self.store.close()
            os.replace(tmp, self.path)
            crash("replaced")
            _fsync_dir(os.path.dirname(os.path.abspath(self.path)))
            crash("dir_synced")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
            # reopen even when a step (or the hook) raised: recovery
            # picks up whichever complete image is at `path`
            self.store.close()
            self.store = PagedStore(self.path)

    def close(self) -> None:
        self.store.close()
