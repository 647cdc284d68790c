"""ctypes bindings over the port's build of the C++ merge core.

The part of the JAX package's `native/core.py` that the device transform,
the device checkout, the zone engine and `Branch.merge` use:
`NativeContext` (a C++ mirror of an OpLog's graph, agent runs and op runs)
with the tracker transform and its dumps, the full native merge, the entry
composer (`compose_plan`, `compose_cache_only`, `compose_linear`), the zone
insert-run table (`zone_ins_runs`) and the collision count of the last
transform; `content_columns`, `get_native_ctx`, `merge_native`,
`transform_native`, `native_available` and the engine's event counters
(`native_counters`, `reset_native_counters`). The zone tape packer (`dt_zone_pack`) is bound here
too and called from `gpu/zone_kernel.py`, its tape fetched by
`fetch_zone_tape`; `MicroTapeContext`, a zone session's scratch context,
composes and packs a continued sync's micro-tape with it. The codec half
(slice 10):
`crc32c_native`, `lz4_compress_native`, the fresh-load decoder
`decode_file_native` (raising `NativeParseError` on corrupt input), the
batched graph rebuild `graph_rebuild_native` and the writer
`NativeContext.encode_full` / `encode_patch`, byte-identical to the
Python codec in `encoding/`. The library comes from `native/build.py` at
first use, never at import.
"""

from __future__ import annotations

import ctypes as ct
import threading
from typing import Optional, Sequence

import numpy as np

from ..core.span import UNDERWATER_START as UNDERWATER
from ..text.op import INS
from .build import build

_lib = None
_lib_lock = threading.Lock()
_unavailable = None     # why the library could not be built, once known


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _secs = build()
            lib = ct.CDLL(str(path))
            _configure(lib)
            _lib = lib
        return _lib


def _configure(lib) -> None:
    i64, vp = ct.c_int64, ct.c_void_p
    a64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    a32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    au8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.dt_ctx_new.restype = vp
    lib.dt_ctx_free.argtypes = [vp]
    lib.dt_add_agent.argtypes = [vp, ct.c_char_p]
    lib.dt_load_graph.argtypes = [vp, i64] + [a64] * 5
    lib.dt_load_agent_runs.argtypes = [vp, i64] + [a64] * 4
    # dt_load_ops, dt_compose_plan, dt_zone_pack and dt_zone_pack_fetch
    # take their arrays as raw addresses (`addr`): a zone session calls
    # them on every continued sync with some fifty arrays, and numpy's
    # ndpointer check costs microseconds an array
    lib.dt_load_ops.argtypes = [vp, i64] + [vp] * 6
    lib.dt_load_ins_arena.argtypes = [vp, i64, a32]
    lib.dt_merge_into_doc.argtypes = [vp, a32, i64, a64, i64, a64, i64]
    lib.dt_merge_into_doc.restype = i64
    lib.dt_get_doc.argtypes = [vp, a32]
    lib.dt_transform.argtypes = [vp, a64, i64, a64, i64]
    lib.dt_transform.restype = i64
    lib.dt_get_out.argtypes = [vp, a64, a64, au8, au8, a64]
    lib.dt_get_out_frontier.argtypes = [vp, a64, i64]
    lib.dt_get_out_frontier.restype = i64
    lib.dt_dump_tracker.argtypes = [vp, i64, a64, a64, a64, a64, a64, au8]
    lib.dt_dump_tracker.restype = i64
    lib.dt_dump_del_rows.argtypes = [vp, i64, a64, a64, a64, a64, au8]
    lib.dt_dump_del_rows.restype = i64
    lib.dt_get_zone_common.argtypes = [vp, a64, i64]
    lib.dt_get_zone_common.restype = i64
    lib.dt_release_tracker.argtypes = [vp]
    lib.dt_last_collisions.argtypes = [vp]
    lib.dt_last_collisions.restype = i64
    lib.dt_get_counters.argtypes = [
        np.ctypeslib.ndpointer(np.uint64, flags="C"), i64]
    lib.dt_get_counters.restype = i64
    lib.dt_reset_counters.argtypes = []
    lib.dt_compose_plan.argtypes = [vp, i64, vp, vp]
    lib.dt_compose_plan.restype = i64
    lib.dt_compose_counts.argtypes = [vp, a64]
    lib.dt_compose_serial.argtypes = [vp]
    lib.dt_compose_serial.restype = i64
    lib.dt_compose_fetch.argtypes = [
        vp, a64, a64, a32, au8, au8, a64, a32, a64, a64, a32, a64, a32, a32,
        a64, a64, a64, a64]
    lib.dt_compose_linear.argtypes = [vp, i64, a64, a64]
    lib.dt_compose_linear.restype = i64
    lib.dt_fetch_linear.argtypes = [vp, a64, a64]
    lib.dt_zone_ins_runs.argtypes = [vp, i64, a64, a64, a64, a64, a64]
    lib.dt_zone_ins_runs.restype = i64
    lib.dt_zone_pack.argtypes = [
        vp, i64, vp, vp, vp,                 # actions
        i64, vp,                             # counts
        vp, vp, vp, vp, vp, vp,              # queries and char columns
        vp, vp, vp, vp,                      # block columns
        vp, vp, vp, vp,                      # delete columns
        i64, vp, vp, i64,                    # slot map
        vp, vp,                              # keys
        i64, i64, i64, i64]                  # MB MC MD compose serial
    lib.dt_zone_pack.restype = i64
    lib.dt_zone_pack_fetch.argtypes = [vp] + [vp] * 19 + [i64, i64, i64]
    # the codec: checksum, compressor, fresh-load decoder, graph rebuild
    # and writer
    lib.dt_crc32c.argtypes = [au8, i64, i64]
    lib.dt_crc32c.restype = i64
    lib.dt_lz4_compress.argtypes = [au8, i64, au8, i64]
    lib.dt_lz4_compress.restype = i64
    lib.dt_decode_new.argtypes = [au8, i64]
    lib.dt_decode_new.restype = vp
    lib.dt_decode_free.argtypes = [vp]
    lib.dt_dec_status.argtypes = [vp]
    lib.dt_dec_status.restype = i64
    lib.dt_dec_err.argtypes = [vp, ct.c_char_p, i64]
    lib.dt_dec_err.restype = i64
    lib.dt_dec_counts.argtypes = [vp, a64]
    lib.dt_dec_strings.argtypes = [vp, au8, a64, au8, au8, au8]
    lib.dt_dec_agent_runs.argtypes = [vp, a64, a64, a64]
    lib.dt_dec_ops.argtypes = [vp, a64, au8, a64, a64, au8, au8, a64]
    lib.dt_dec_graph.argtypes = [vp, a64, a64, a64, a64]
    lib.dt_graph_rebuild.argtypes = [i64] + [a64] * 15
    lib.dt_graph_rebuild.restype = i64
    lib.dt_encode_full.argtypes = [vp, ct.c_char_p, i64, ct.c_char_p, i64,
                                   i64, i64]
    lib.dt_encode_full.restype = i64
    lib.dt_encode_patch.argtypes = [vp, ct.c_char_p, i64, ct.c_char_p, i64,
                                    i64, i64, a64, i64]
    lib.dt_encode_patch.restype = i64
    lib.dt_encode_fetch.argtypes = [vp, au8]


def native_available() -> bool:
    """True when the library builds (or is built) and loads here. A
    failed build is remembered: it is not retried in this process."""
    global _unavailable
    if _lib is not None:
        return True
    if _unavailable is not None:
        return False
    try:
        _load()
    except (RuntimeError, OSError) as e:
        _unavailable = str(e)
        return False
    return True


def addr(a: np.ndarray, dtype) -> int:
    """The address of `a`'s data, for an argument bound as a raw address
    (`_configure`). `a` is C-contiguous `dtype`, and the caller keeps it
    alive through the call."""
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise TypeError(f"want a C-contiguous {np.dtype(dtype)} array, "
                        f"got {a.dtype}")
    return a.ctypes.data


def _span_cols(spans):
    s0 = np.ascontiguousarray([s for s, _ in spans] or [0], dtype=np.int64)
    s1 = np.ascontiguousarray([e for _, e in spans] or [0], dtype=np.int64)
    return s0, s1


def _read_frontier(fn, ptr, first: int = 16):
    buf = np.empty(first, dtype=np.int64)
    k = fn(ptr, buf, first)
    if k > first:
        buf = np.empty(k, dtype=np.int64)
        fn(ptr, buf, k)
    return [int(x) for x in buf[:k]]


class NativeContext:
    """A C++ mirror of an OpLog's merge-relevant state (graph, agent runs,
    op runs). Rebuilt lazily when the oplog grows."""

    def __init__(self, oplog) -> None:
        self._lib = _load()
        self._ptr = self._lib.dt_ctx_new()
        self._built_len = -1
        self._oplog = oplog

    def __del__(self):
        try:
            self._lib.dt_ctx_free(self._ptr)
        except Exception:
            pass

    def sync(self) -> None:
        ol = self._oplog
        if self._built_len == len(ol):
            return
        lib = self._lib
        # rebuild from scratch (bulk load is cheap: O(n) columnar copies)
        lib.dt_ctx_free(self._ptr)
        self._ptr = lib.dt_ctx_new()
        for name in ol.cg.agent_assignment.agent_names:
            lib.dt_add_agent(self._ptr, name.encode("utf8"))
        starts, ends, shadows, indptr, flat = ol.cg.graph.as_arrays()
        if flat.size == 0:
            flat = np.zeros(1, dtype=np.int64)
        lib.dt_load_graph(self._ptr, len(starts),
                          np.ascontiguousarray(starts),
                          np.ascontiguousarray(ends),
                          np.ascontiguousarray(shadows),
                          np.ascontiguousarray(indptr),
                          np.ascontiguousarray(flat))
        gr = ol.cg.agent_assignment.global_runs
        cols = [np.asarray([r[k] for r in gr], dtype=np.int64)
                for k in range(4)]
        lib.dt_load_agent_runs(self._ptr, len(gr), *cols)
        runs = ol.ops.runs
        lv = np.asarray([r.lv for r in runs], dtype=np.int64)
        kind = np.asarray([r.kind for r in runs], dtype=np.uint8)
        fwd = np.asarray([1 if r.fwd else 0 for r in runs], dtype=np.uint8)
        st = np.asarray([r.start for r in runs], dtype=np.int64)
        en = np.asarray([r.end for r in runs], dtype=np.int64)
        cp, arena, arena_chars = content_columns(ol)
        lib.dt_load_ops(self._ptr, len(runs), addr(lv, np.int64),
                        addr(kind, np.uint8), addr(fwd, np.uint8),
                        addr(st, np.int64), addr(en, np.int64),
                        addr(cp, np.int64))
        lib.dt_load_ins_arena(self._ptr, arena_chars,
                              np.ascontiguousarray(arena))
        self._built_len = len(ol)

    def transform(self, from_frontier: Sequence[int],
                  merge_frontier: Sequence[int]):
        """Returns (lv, len, kind, fwd, pos arrays, final_frontier)."""
        self.sync()
        lib = self._lib
        f = np.asarray(sorted(from_frontier), dtype=np.int64)
        m = np.asarray(sorted(merge_frontier), dtype=np.int64)
        n = lib.dt_transform(self._ptr, f, len(f), m, len(m))
        lv = np.empty(n, dtype=np.int64)
        ln = np.empty(n, dtype=np.int64)
        kind = np.empty(n, dtype=np.uint8)
        fwd = np.empty(n, dtype=np.uint8)
        pos = np.empty(n, dtype=np.int64)
        if n:
            lib.dt_get_out(self._ptr, lv, ln, kind, fwd, pos)
        frontier = _read_frontier(lib.dt_get_out_frontier, self._ptr)
        return lv, ln, kind, fwd, pos, frontier

    def release_tracker(self) -> None:
        """Free the tracker tables retained for dump_tracker/zone_common."""
        self._lib.dt_release_tracker(self._ptr)

    def zone_common(self):
        """Common-ancestor frontier of the last transform's conflict zone
        (the version whose document the underwater id space tiles)."""
        return _read_frontier(self._lib.dt_get_zone_common, self._ptr, 64)

    def dump_tracker(self, keep_underwater: bool = False):
        """Item table of the last transform's tracker, in DOCUMENT order:
        (ids, len, origin_left, origin_right, state, ever) arrays.
        Underwater sentinel rows (ids >= 1<<62) are the pre-zone document
        text (anchor targets for zone items); filtered unless requested."""
        lib = self._lib
        z = np.zeros(0, dtype=np.int64)
        zu = np.zeros(0, dtype=np.uint8)
        n = lib.dt_dump_tracker(self._ptr, 0, z, z, z, z, z, zu)
        ids, ln, ol, orr, st = (np.empty(n, dtype=np.int64)
                                for _ in range(5))
        ev = np.empty(n, dtype=np.uint8)
        if n:
            lib.dt_dump_tracker(self._ptr, n, ids, ln, ol, orr, st, ev)
        if not keep_underwater:
            keep = ids < UNDERWATER
            return (ids[keep], ln[keep], ol[keep], orr[keep], st[keep],
                    ev[keep])
        return (ids, ln, ol, orr, st, ev)

    def dump_del_rows(self):
        """Delete-target rows of the last transform's tracker, sorted by
        op LV: (lv0, lv1, t0, t1, fwd) arrays — op lv0+k deletes item
        t0+k (fwd) or t1-1-k (reversed)."""
        lib = self._lib
        z = np.zeros(0, dtype=np.int64)
        zu = np.zeros(0, dtype=np.uint8)
        n = lib.dt_dump_del_rows(self._ptr, 0, z, z, z, z, zu)
        lv0, lv1, t0, t1 = (np.empty(n, dtype=np.int64) for _ in range(4))
        fwd = np.empty(n, dtype=np.uint8)
        if n:
            lib.dt_dump_del_rows(self._ptr, n, lv0, lv1, t0, t1, fwd)
        o = np.argsort(lv0, kind="stable")
        return lv0[o], lv1[o], t0[o], t1[o], fwd[o]

    def last_collisions(self) -> int:
        """Colliding concurrent inserts during the last transform
        (reference: has_conflicts_when_merging, src/list/merge.rs:51)."""
        return int(self._lib.dt_last_collisions(self._ptr))

    def compose_serial(self) -> int:
        """Identity of the current native compose cache (bumped by every
        dt_compose_plan): the zone packer checks it before packing from
        the cache."""
        return int(self._lib.dt_compose_serial(self._ptr))

    def zone_ins_runs(self, spans):
        """INS sub-runs of the given spans as (lv0, len, cp) int64
        arrays, or None on unsupported input (an insert without stored
        content)."""
        self.sync()
        s0, s1 = _span_cols(spans)
        # bounded by the zone's own extent, not the whole history: a span
        # of L LVs overlaps at most L runs
        span_lvs = sum(e - s for s, e in spans)
        cap = min(len(self._oplog.ops.runs), span_lvs) + len(spans) + 1
        lv0, ln, cp = (np.empty(cap, dtype=np.int64) for _ in range(3))
        k = self._lib.dt_zone_ins_runs(self._ptr, len(spans), s0, s1, lv0,
                                       ln, cp)
        if k < 0:
            return None
        return lv0[:k], ln[:k], cp[:k]

    def compose_cache_only(self, spans) -> bool:
        """Run the native composer, leaving its results only in the ctx
        cache (the zone packer reads them there). False on unsupported
        input."""
        self.sync()
        s0, s1 = _span_cols(spans)
        return self._lib.dt_compose_plan(
            self._ptr, len(spans), addr(s0, np.int64),
            addr(s1, np.int64)) == 0

    def compose_plan(self, spans):
        """The native entry composer (`listmerge/compose.py` in C++):
        per-entry column dicts for `ComposedEntry`, or None on
        unsupported input (reverse insert runs)."""
        self.sync()
        lib = self._lib
        n = len(spans)
        if n == 0:
            return []
        s0, s1 = _span_cols(spans)
        if lib.dt_compose_plan(self._ptr, n, addr(s0, np.int64),
                               addr(s1, np.int64)) != 0:
            return None
        counts = np.empty(n * 5, dtype=np.int64)
        lib.dt_compose_counts(self._ptr, counts)
        counts = counts.reshape(n, 5)
        tq, tc, tb, tdb, tdo = (int(x) for x in counts.sum(axis=0))
        q = np.empty(tq, dtype=np.int64)
        ch_lv = np.empty(tc, dtype=np.int64)
        ch_block = np.empty(tc, dtype=np.int32)
        ch_head = np.empty(tc, dtype=np.uint8)
        ch_kind = np.empty(tc, dtype=np.uint8)
        ch_anchor = np.empty(tc, dtype=np.int64)
        ch_q = np.empty(tc, dtype=np.int32)
        ch_headlv = np.empty(tc, dtype=np.int64)
        ch_orrown = np.empty(tc, dtype=np.int64)
        blk_root_q = np.empty(tb, dtype=np.int32)
        blk_root_lv = np.empty(tb, dtype=np.int64)
        blk_start = np.empty(tb, dtype=np.int32)
        blk_len = np.empty(tb, dtype=np.int32)
        db0, db1 = np.empty(tdb, dtype=np.int64), np.empty(tdb, np.int64)
        do0, do1 = np.empty(tdo, dtype=np.int64), np.empty(tdo, np.int64)
        lib.dt_compose_fetch(self._ptr, q, ch_lv, ch_block, ch_head,
                             ch_kind, ch_anchor, ch_q, ch_headlv, ch_orrown,
                             blk_root_q, blk_root_lv, blk_start, blk_len,
                             db0, db1, do0, do1)
        out = []
        oq = oc = ob = odb = odo = 0
        for k in range(n):
            nq, nc, nb, ndb, ndo = (int(x) for x in counts[k])
            out.append({
                "q_cursor": q[oq:oq + nq].tolist(),
                "ch_lv": ch_lv[oc:oc + nc],
                "ch_block": ch_block[oc:oc + nc],
                "ch_head": ch_head[oc:oc + nc].astype(np.int8),
                "ch_kind": ch_kind[oc:oc + nc].astype(np.int8),
                "ch_anchor": ch_anchor[oc:oc + nc],
                "ch_q": ch_q[oc:oc + nc],
                "ch_headlv": ch_headlv[oc:oc + nc],
                "ch_orrown": ch_orrown[oc:oc + nc],
                "blk_root_q": blk_root_q[ob:ob + nb],
                "blk_root_lv": blk_root_lv[ob:ob + nb],
                "blk_start": blk_start[ob:ob + nb],
                "blk_len": blk_len[ob:ob + nb],
                "del_base": list(zip(db0[odb:odb + ndb].tolist(),
                                     db1[odb:odb + ndb].tolist())),
                "del_own": list(zip(do0[odo:odo + ndo].tolist(),
                                    do1[odo:odo + ndo].tolist())),
            })
            oq += nq
            oc += nc
            ob += nb
            odb += ndb
            odo += ndo
        return out

    def compose_linear(self, spans):
        """Alive own pieces (lv, len arrays) of a linear-history
        composition over an empty base (assemble_prefix's hot loop), or
        None on unsupported input."""
        self.sync()
        lib = self._lib
        s0 = np.ascontiguousarray([s for s, _ in spans], dtype=np.int64)
        s1 = np.ascontiguousarray([e for _, e in spans], dtype=np.int64)
        n = lib.dt_compose_linear(self._ptr, len(spans), s0, s1)
        if n < 0:
            return None
        lv = np.empty(n, dtype=np.int64)
        ln = np.empty(n, dtype=np.int64)
        if n:
            lib.dt_fetch_linear(self._ptr, lv, ln)
        return lv, ln

    def encode_full(self, doc_id, user_data, store_ins: bool,
                    compress: bool):
        """The native v1 full-snapshot writer (from_version=[]),
        byte-identical to `encoding.encode`'s Python writer; None when
        the C++ writer refuses the input (the caller writes in Python)."""
        self.sync()
        lib = self._lib
        did = doc_id.encode("utf8") if doc_id is not None else None
        n = lib.dt_encode_full(
            self._ptr, did, len(did) if did is not None else -1,
            user_data, len(user_data) if user_data is not None else -1,
            1 if store_ins else 0, 1 if compress else 0)
        if n < 0:
            return None
        out = np.empty(n, dtype=np.uint8)
        lib.dt_encode_fetch(self._ptr, out)
        return out.tobytes()

    def encode_patch(self, doc_id, user_data, store_ins: bool,
                     compress: bool, from_version):
        """The native v1 patch writer (ops since `from_version`),
        byte-identical to the Python writer; None when it refuses."""
        self.sync()
        lib = self._lib
        did = doc_id.encode("utf8") if doc_id is not None else None
        f = np.ascontiguousarray(sorted(from_version), dtype=np.int64)
        n = lib.dt_encode_patch(
            self._ptr, did, len(did) if did is not None else -1,
            user_data, len(user_data) if user_data is not None else -1,
            1 if store_ins else 0, 1 if compress else 0, f, len(f))
        if n < 0:
            return None
        out = np.empty(n, dtype=np.uint8)
        lib.dt_encode_fetch(self._ptr, out)
        return out.tobytes()

    def merge_to_string(self, init: str, from_frontier: Sequence[int],
                        merge_frontier: Sequence[int]):
        """Full native merge: returns (final_doc_str, final_frontier)."""
        self.sync()
        lib = self._lib
        init_arr = np.frombuffer(init.encode("utf-32-le"), dtype=np.int32)
        if init_arr.size == 0:
            init_arr = np.zeros(1, dtype=np.int32)
        f = np.asarray(sorted(from_frontier), dtype=np.int64)
        m = np.asarray(sorted(merge_frontier), dtype=np.int64)
        n = lib.dt_merge_into_doc(self._ptr, np.ascontiguousarray(init_arr),
                                  len(init), f, len(f), m, len(m))
        out = np.empty(max(int(n), 1), dtype=np.int32)
        lib.dt_get_doc(self._ptr, out)
        doc = out[:n].tobytes().decode("utf-32-le")
        return doc, _read_frontier(lib.dt_get_out_frontier, self._ptr, 64)


# a zone tape's columns in `dt_zone_pack_fetch`'s order, with each one's
# width in steps' units: 0 = one a step, else MB, MC or MD
TAPE_COLUMNS = (("op", 0), ("arg_a", 0), ("arg_b", 0), ("snap_flag", 0),
                ("blk_cursor", "MB"), ("blk_prev", "MB"), ("blk_root", "MB"),
                ("blk_start", "MB"), ("blk_len", "MB"), ("ch_slot", "MC"),
                ("ch_ol_static", "MC"), ("ch_ol_coord", "MC"),
                ("ch_orr_own", "MC"), ("ch_blk", "MC"), ("ch_agent", "MC"),
                ("ch_seq", "MC"), ("del_kind", "MD"), ("del_a", "MD"),
                ("del_b", "MD"))


class MicroTapeContext:
    """A scratch C++ context of a zone session's own (gpu/zone_session.py)
    that composes and packs a continued sync's micro-tape: loaded with only
    the sync's op runs, their LVs rebased to the sync's first, so the
    composer's dense run index is the size of the sync, not of the
    history. Freed with its owner."""

    def __init__(self) -> None:
        self._lib = _load()
        self._ptr = self._lib.dt_ctx_new()
        self._keys = (None, None, 0, 0)          # agent_k, seq_k, addresses

    def __del__(self):
        try:
            self._lib.dt_ctx_free(self._ptr)
        except Exception:
            pass

    def pack(self, runs, spans, actions, ins_lv0, ins_cum, plen: int,
             agent_k: np.ndarray, seq_k: np.ndarray, MB: int, MC: int,
             MD: int) -> Optional[dict]:
        """Load the op `runs` ((lv, kind, fwd, start, end) each), compose
        the entry `spans` ((start, end) each) with `dt_compose_plan`, pack
        `actions` ((plan2 kind, a, b) each) over them with `dt_zone_pack`
        from the compose cache, and fetch the tape: its columns by name
        (`TAPE_COLUMNS`, int32, [T] or [T, M], T at least 1) and
        `total_steps`. None on input the C++ refuses (a reverse insert
        run, a negative pack). Every LV given (runs, spans, `ins_lv0`) is
        on the same rebased scale: the slot formula is invariant under
        that shift. `agent_k` and `seq_k` are the slots' int64 keys."""
        lib = self._lib
        ptr = self._ptr
        rc = np.array(runs, dtype=np.int64).reshape(-1, 5)
        n, k, a, r = len(rc), len(spans), len(actions), len(ins_lv0)
        # every int64 input in one block, one address: lv, start, end and
        # cp of the runs (cp zeros: the composer reads no content), span
        # starts and ends, action columns, the slot map
        blk = np.concatenate([
            rc[:, [0, 3, 4]].T.ravel(), np.zeros(n, np.int64),
            np.array(spans, dtype=np.int64).reshape(-1, 2).T.ravel(),
            np.array(actions, dtype=np.int64).reshape(-1, 3).T.ravel(),
            np.asarray(ins_lv0, dtype=np.int64),
            np.asarray(ins_cum, dtype=np.int64)])
        u8 = np.ascontiguousarray(rc[:, 1:3].T, dtype=np.uint8)
        at, at8 = blk.ctypes.data, u8.ctypes.data
        off = (np.cumsum([0, n, n, n, n, k, k, a, a, a, r]) * 8
               + at).tolist()
        lib.dt_load_ops(ptr, n, off[0], at8, at8 + n, off[1], off[2],
                        off[3])
        if lib.dt_compose_plan(ptr, k, off[4], off[5]) != 0:
            return None
        serial = lib.dt_compose_serial(ptr)      # the cache just composed
        if self._keys[0] is not agent_k or self._keys[1] is not seq_k:
            self._keys = (agent_k, seq_k, addr(agent_k, np.int64),
                          addr(seq_k, np.int64))
        # from the compose cache: the composed columns' pointers unread
        T = lib.dt_zone_pack(
            ptr, a, off[6], off[7], off[8], k, *[None] * 15, r, off[9],
            off[10], plen, self._keys[2], self._keys[3], MB, MC, MD, serial)
        if T < 0:
            return None
        return fetch_zone_tape(ptr, int(T), MB, MC, MD)


def fetch_zone_tape(ptr, T: int, MB: int, MC: int, MD: int) -> dict:
    """The `T` steps `dt_zone_pack` left on the context `ptr`: the tape's
    columns by name (`TAPE_COLUMNS`, int32, [Tp] or [Tp, M], Tp = max(1,
    T)), views into one block, and `total_steps`."""
    Tp = max(1, T)
    width = {0: 1, "MB": MB, "MC": MC, "MD": MD}
    sizes = [Tp * width[w] for _name, w in TAPE_COLUMNS]
    # np.empty: dt_zone_pack_fetch writes every cell, pads included
    # (pad-initializing a whole document's ~100 MB tape in numpy was a
    # measurable share of its pack)
    out = np.empty(sum(sizes), dtype=np.int32)
    starts = np.cumsum([0] + sizes[:-1]).tolist()
    base = out.ctypes.data
    _load().dt_zone_pack_fetch(ptr, *(base + 4 * s for s in starts), MB,
                               MC, MD)
    cols = {}
    for (name, w), size, s in zip(TAPE_COLUMNS, sizes, starts):
        col = out[s:s + size]
        cols[name] = col if w == 0 else col.reshape(Tp, width[w])
    cols["total_steps"] = T
    return cols


def get_native_ctx(oplog) -> NativeContext:
    """The oplog's cached NativeContext (created on first use)."""
    ctx = oplog._native_ctx
    if ctx is None:
        ctx = NativeContext(oplog)
        oplog._native_ctx = ctx
    return ctx


def content_columns(oplog):
    """(cp, arena, arena_chars) in the layout dt_load_ops /
    dt_load_ins_arena expect: per-run insert-arena offset (-1 = no
    content) and the whole INS arena as utf-32 code points."""
    runs = oplog.ops.runs
    cp = np.asarray(
        [r.content_pos[0] if r.content_pos is not None else -1
         for r in runs], dtype=np.int64)
    arena_str = oplog.ops._arenas[INS].get((0, oplog.ops.arena_len(INS)))
    arena = np.frombuffer(arena_str.encode("utf-32-le"), dtype=np.int32)
    if arena.size == 0:
        arena = np.zeros(1, dtype=np.int32)
    return cp, arena, len(arena_str)


def merge_native(oplog, init: str, from_frontier, merge_frontier):
    """The C++ tracker merge of `merge_frontier` into the document `init`
    at `from_frontier`: (text, frontier)."""
    return get_native_ctx(oplog).merge_to_string(init, from_frontier,
                                                 merge_frontier)


def transform_native(oplog, from_frontier, merge_frontier):
    """The C++ tracker transform of `merge_frontier` from `from_frontier`:
    (lv, len, kind, fwd, pos arrays, final_frontier)."""
    return get_native_ctx(oplog).transform(from_frontier, merge_frontier)


# Order mirrors dt_core.cpp's EventCounters / dt_get_counters.
EVENT_COUNTER_NAMES = (
    "integrate_calls", "integrate_scan_iters", "apply_ins_runs",
    "apply_del_runs", "advance_calls", "retreat_calls", "walk_steps",
    "diff_calls")


def native_counters() -> Optional[dict]:
    """Process-global merge-kernel event counters from the C++ engine
    (always on), or None when the library cannot be built here."""
    if not native_available():
        return None
    buf = np.zeros(len(EVENT_COUNTER_NAMES), dtype=np.uint64)
    k = _lib.dt_get_counters(buf, len(buf))
    return {n: int(buf[i])
            for i, n in enumerate(EVENT_COUNTER_NAMES[:int(k)])}


def reset_native_counters() -> None:
    if native_available():
        _lib.dt_reset_counters()


# ---- the codec --------------------------------------------------------------
#
# Each entry returns None when the library cannot be built here, so its
# caller runs the Python codec (byte-identical output); any other failure
# propagates.


def crc32c_native(data: bytes, seed: int = 0) -> Optional[int]:
    """CRC-32C of `data` continuing from `seed`, in C++."""
    if not native_available():
        return None
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    return int(_lib.dt_crc32c(buf, len(data), seed))


def lz4_compress_native(data: bytes) -> Optional[bytes]:
    """The LZ4 block compressor in C++, byte-identical to
    `encoding.lz4.lz4_compress_block`'s Python loop."""
    if not native_available():
        return None
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    cap = len(data) + len(data) // 255 + 16
    out = np.zeros(max(1, cap), dtype=np.uint8)
    n = int(_lib.dt_lz4_compress(buf, len(data), out, cap))
    if n < 0:       # the output outgrew the estimate: -n is what it needs
        out = np.zeros(-n, dtype=np.uint8)
        n = int(_lib.dt_lz4_compress(buf, len(data), out, -n))
    return out[:n].tobytes()


class NativeParseError(Exception):
    """Corrupt input, as the C++ decoder reports it."""


def decode_file_native(data: bytes) -> Optional[dict]:
    """Parse a v1 .dt file with the C++ decoder (fresh loads only).

    Returns the file's columns, or None when the file needs the Python
    decoder (a patch with a non-empty start version) or the library
    cannot be built here. Raises NativeParseError on corrupt input (what
    the Python decoder raises ParseError for)."""
    if not native_available():
        return None
    lib = _lib
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    h = lib.dt_decode_new(buf, len(data))
    try:
        status = lib.dt_dec_status(h)
        if status != 0:
            if status == 1:
                return None
            n = lib.dt_dec_err(h, None, 0)
            msg = ct.create_string_buffer(int(n) + 1)
            lib.dt_dec_err(h, msg, n)
            raise NativeParseError(msg.value.decode("utf8", "replace"))
        counts = np.zeros(10, dtype=np.int64)
        lib.dt_dec_counts(h, counts)
        (n_agents, names_bytes, n_aruns, n_ops, n_graph, n_par,
         ins_bytes, del_bytes, has_doc_id, doc_bytes) = (int(x)
                                                         for x in counts)

        def cols(n, dtype, k):
            return [np.zeros(max(1, n), dtype=dtype) for _ in range(k)]

        names, ins_blob, del_blob, doc_id = (
            np.zeros(max(1, k), dtype=np.uint8)
            for k in (names_bytes, ins_bytes, del_bytes, doc_bytes))
        name_lens = np.zeros(max(1, n_agents), dtype=np.int64)
        lib.dt_dec_strings(h, names, name_lens, ins_blob, del_blob, doc_id)
        ar_agent, ar_seq0, ar_n = cols(n_aruns, np.int64, 3)
        lib.dt_dec_agent_runs(h, ar_agent, ar_seq0, ar_n)
        op_lv, op_start, op_end, op_clen = cols(n_ops, np.int64, 4)
        op_kind, op_fwd, op_known = cols(n_ops, np.uint8, 3)
        lib.dt_dec_ops(h, op_lv, op_kind, op_start, op_end, op_fwd,
                       op_known, op_clen)
        g_start, g_end = cols(n_graph, np.int64, 2)
        g_off = np.zeros(n_graph + 1, dtype=np.int64)
        g_par = np.zeros(max(1, n_par), dtype=np.int64)
        lib.dt_dec_graph(h, g_start, g_end, g_off, g_par)

        names_b = names.tobytes()[:names_bytes]
        agent_names = []
        k = 0
        for i in range(n_agents):
            ln = int(name_lens[i])
            agent_names.append(names_b[k:k + ln].decode("utf8"))
            k += ln
        return {
            "doc_id": (doc_id.tobytes()[:doc_bytes].decode("utf8")
                       if has_doc_id else None),
            "agent_names": agent_names,
            "agent_runs": (ar_agent[:n_aruns], ar_seq0[:n_aruns],
                           ar_n[:n_aruns]),
            "ops": (op_lv[:n_ops], op_kind[:n_ops], op_start[:n_ops],
                    op_end[:n_ops], op_fwd[:n_ops], op_known[:n_ops],
                    op_clen[:n_ops]),
            "ins_blob": ins_blob.tobytes()[:ins_bytes].decode("utf8"),
            "del_blob": del_blob.tobytes()[:del_bytes].decode("utf8"),
            "graph": (g_start[:n_graph], g_end[:n_graph], g_off,
                      g_par[:n_par]),
        }
    finally:
        lib.dt_decode_free(h)


def graph_rebuild_native(g_start, g_end, g_off, g_par):
    """The decoder's graph rows pushed in C++ with `Graph.push` and
    `_advance_known_run` semantics: (starts, ends, shadows, parents CSR,
    children CSR, roots, version), or None when the library cannot be
    built here or the rows are malformed (the caller pushes row by row)."""
    if not native_available():
        return None
    n = len(g_start)
    npar = len(g_par)

    def a(x):
        return np.ascontiguousarray(x, dtype=np.int64)

    one = np.zeros(1, np.int64)
    ms, me, msh, croot, ver = (np.empty(max(n, 1), np.int64)
                               for _ in range(5))
    pind = np.empty(n + 1, np.int64)
    cind = np.empty(n + 1, np.int64)
    pflat = np.empty(max(npar, 1), np.int64)
    cflat = np.empty(max(npar, 1), np.int64)
    crn = np.zeros(1, np.int64)
    vern = np.zeros(1, np.int64)
    m = _lib.dt_graph_rebuild(
        n, a(g_start), a(g_end), a(g_off), a(g_par) if npar else one,
        ms, me, msh, pind, pflat, cind, cflat, croot, crn, ver, vern)
    if m < 0:
        return None
    k = int(m)
    return (ms[:k], me[:k], msh[:k], pind[:k + 1], pflat[:int(pind[k])],
            cind[:k + 1], cflat[:int(cind[k])], croot[:int(crn[0])],
            ver[:int(vern[0])])
