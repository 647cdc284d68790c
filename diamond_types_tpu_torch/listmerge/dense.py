"""Dense fork/join merge executor: flat span table + state matrix.

Capability mirror of the reference's listmerge2 dense executor (reference:
src/listmerge2/index_gap_buffer.rs:20-31 — a flat buffer of YjsSpans with a
2-D `[index * len + item] -> SpanState` state matrix), executing the
fork/join plans compiled by plan2.py.

Representation:
  * `slots`   — flat table of RLE item spans (id range, origins, ever-deleted
                flag), indexed by creation-order slot id; never moved.
  * `S`       — the dense state matrix, shape [n_slots, n_indexes] uint8,
                values from the 3-point lattice NIY(0) < Inserted(1) <
                Deleted(2). Fork/Max/Begin are whole-column numpy ops.
  * `order`   — slot ids in document (CRDT) order; the only structure that
                shifts on insert (the reference uses a gap buffer for the
                same purpose; a Python list's memmove plays that role here).

Per-index visibility is S[:, idx] == 1; the upstream (output-frame) metric
is `not ever_deleted`, exactly the dual metric of the M1 tracker
(reference: src/listmerge/metrics.rs:18-66). Because this engine never
retreats, delete counts are unnecessary — see plan2.py.

Integration of concurrent inserts is the same YjsMod scan as the M1 engine
(reference: merge.rs:154-278) — run over the flat order list with states
read from the active index's matrix column, so the differential tests can
demand byte-identical documents, not just equivalent ones.
"""

from __future__ import annotations

from bisect import bisect_right, insort
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.span import UNDERWATER_START
from ..text.op import INS, OpRun
from .plan2 import APPLY, BEGIN, DROP, FORK, MAX, MergePlan2, compile_plan2

ROOT = -1
NIY = 0
INSERTED = 1
DELETED = 2


class _Slot:
    __slots__ = ("ids", "ide", "ol", "orr", "ever")

    def __init__(self, ids: int, ide: int, ol: int, orr: int,
                 ever: bool) -> None:
        self.ids = ids
        self.ide = ide
        self.ol = ol
        self.orr = orr
        self.ever = ever

    def __len__(self) -> int:
        return self.ide - self.ids

    def origin_left_at(self, offset: int) -> int:
        return self.ol if offset == 0 else self.ids + offset - 1


@dataclass
class _Cur:
    """Cursor = gap before item `off` of slot order[oi]; (raw, cur, up) are
    the metric totals of FULL slots strictly before oi (partial offsets are
    added on demand — slot states are uniform so partials are linear)."""
    oi: int
    off: int
    raw: int
    cur: int
    up: int

    def copy(self) -> "_Cur":
        return _Cur(self.oi, self.off, self.raw, self.cur, self.up)


class DenseExecutor:
    def __init__(self, plan: MergePlan2, aa, ops,
                 journal: bool = False) -> None:
        self.plan = plan
        self.aa = aa
        self.ops = ops
        self.n_idx = max(1, plan.indexes_used)
        # Optional effect journal for the device tier: per entry, the list
        # of (id_lo, id_hi, state) writes its Apply performed, in item-id
        # space AT WRITE TIME — the data the device plan executor replays
        # (see gpu/plan_kernels.py). Ranges subsume split inheritance: a later
        # split only refines slots WITHIN an already-journaled range, and
        # states are monotone, so replaying ranges over the final slot
        # table reproduces every snapshot exactly.
        self.journal = [] if journal else None
        self._cur_writes = None
        cap = 64
        self.S = np.zeros((cap, self.n_idx), dtype=np.uint8)
        self.is_base = np.zeros(cap, dtype=bool)
        self.slots: List[_Slot] = []
        self.order: List[int] = []
        self.total_raw = 0
        # item-LV -> slot id lookup (mirrors the M1 tracker's SpaceIndex).
        self._ins_starts: List[int] = []
        self._ins_slots = {}
        self._row = -1            # active index during Apply
        self._cur: Optional[_Cur] = None

        under = self._new_slot(UNDERWATER_START, UNDERWATER_START * 2 - 1,
                               ROOT, ROOT, False, base=True)
        self.order.append(under)

    # ---- slot table ------------------------------------------------------

    def _new_slot(self, ids: int, ide: int, ol: int, orr: int, ever: bool,
                  base: bool = False) -> int:
        sid = len(self.slots)
        if sid == len(self.S):
            self.S = np.vstack([self.S, np.zeros_like(self.S)])
            self.is_base = np.concatenate(
                [self.is_base, np.zeros_like(self.is_base)])
        self.slots.append(_Slot(ids, ide, ol, orr, ever))
        self.is_base[sid] = base
        self.total_raw += ide - ids
        insort(self._ins_starts, ids)
        self._ins_slots[ids] = sid
        return sid

    def _split(self, sid: int, offset: int) -> int:
        """Split slot after `offset` items; returns the new right slot id.
        Does NOT touch `order` — callers place the new slot."""
        s = self.slots[sid]
        assert 0 < offset < len(s)
        mid = s.ids + offset
        rid = self._new_slot(mid, s.ide, mid - 1, s.orr, s.ever,
                             base=bool(self.is_base[sid]))
        self.total_raw -= s.ide - mid  # _new_slot double-counted the tail
        self.S[rid] = self.S[sid]
        s.ide = mid
        return rid

    def _ins_lookup(self, lv: int) -> int:
        i = bisect_right(self._ins_starts, lv) - 1
        sid = self._ins_slots[self._ins_starts[i]]
        s = self.slots[sid]
        assert s.ids <= lv < s.ide, f"item LV {lv} not tracked"
        return sid

    # ---- cursors ---------------------------------------------------------

    def _slot_metrics(self, sid: int, row: int) -> Tuple[int, int, int]:
        s = self.slots[sid]
        n = len(s)
        return (n, n if self.S[sid, row] == INSERTED else 0,
                0 if s.ever else n)

    def _step_fwd(self, c: _Cur, row: int) -> None:
        n, cu, up = self._slot_metrics(self.order[c.oi], row)
        c.raw += n
        c.cur += cu
        c.up += up
        c.oi += 1
        c.off = 0

    def _step_back(self, c: _Cur, row: int) -> None:
        assert c.oi > 0, "cursor walked past document start"
        c.oi -= 1
        n, cu, up = self._slot_metrics(self.order[c.oi], row)
        c.raw -= n
        c.cur -= cu
        c.up -= up
        c.off = 0

    def _roll(self, c: _Cur, row: int) -> Optional[_Cur]:
        """Normalize so off < len(slot); None at end of document."""
        while c.oi < len(self.order):
            sid = self.order[c.oi]
            n = len(self.slots[sid])
            if c.off < n:
                return c
            assert c.off == n
            self._step_fwd(c, row)
        return None

    def _raw_pos(self, c: Optional[_Cur]) -> int:
        if c is None:
            return self.total_raw
        return c.raw + c.off

    def _up_pos(self, c: Optional[_Cur]) -> int:
        if c is None:
            return sum(0 if s.ever else len(s) for s in self.slots)
        if c.oi >= len(self.order):
            return c.up
        s = self.slots[self.order[c.oi]]
        return c.up + (0 if s.ever else c.off)

    def _seek_cur(self, row: int, pos: int) -> _Cur:
        """Cursor at the `pos`-th item visible in `row` (inside the slot).
        Walks from the cached cursor when possible (gap-buffer locality)."""
        c = self._cur if self._cur is not None else _Cur(0, 0, 0, 0, 0)
        c = c.copy()
        c.off = 0
        while c.cur > pos:
            self._step_back(c, row)
        while True:
            assert c.oi < len(self.order), f"content pos {pos} out of range"
            sid = self.order[c.oi]
            n, cu, up = self._slot_metrics(sid, row)
            if pos < c.cur + cu:
                c.off = pos - c.cur
                return c
            c.raw += n
            c.cur += cu
            c.up += up
            c.oi += 1

    def _locate_slot(self, sid: int) -> _Cur:
        """Cursor at the start of slot `sid` (O(order) scan)."""
        c = _Cur(0, 0, 0, 0, 0)
        for oi, s in enumerate(self.order):
            if s == sid:
                c.oi = oi
                return c
            n, cu, up = self._slot_metrics(s, self._row)
            c.raw += n
            c.cur += cu
            c.up += up
        raise AssertionError(f"slot {sid} not in order")

    def _cursor_before_item(self, lv: int) -> Optional[_Cur]:
        if lv == ROOT:
            return None  # end-of-document sentinel
        sid = self._ins_lookup(lv)
        c = self._locate_slot(sid)
        c.off = lv - self.slots[sid].ids
        return c

    def _cursor_after_item(self, lv: int, stick_end: bool) -> _Cur:
        if lv == ROOT:
            return _Cur(0, 0, 0, 0, 0)  # start of document
        sid = self._ins_lookup(lv)
        c = self._locate_slot(sid)
        c.off = lv - self.slots[sid].ids + 1
        if not stick_end:
            rolled = self._roll(c, self._row)
            if rolled is not None:
                return rolled
        return c

    def _cmp(self, a: Optional[_Cur], b: Optional[_Cur]) -> int:
        pa, pb = self._raw_pos(a), self._raw_pos(b)
        return (pa > pb) - (pa < pb)

    # ---- integrate (YjsMod) ---------------------------------------------

    def _insert_at(self, c: Optional[_Cur], sid: int) -> Optional[_Cur]:
        """Place slot `sid` at cursor `c`; returns a cursor just after it
        (None when prefixes would need a rescan — callers drop the cache)."""
        if c is None:
            self.order.append(sid)
            return None
        out = c.copy()
        if c.oi >= len(self.order):
            self.order.append(sid)
        else:
            tgt = self.order[c.oi]
            n = len(self.slots[tgt])
            if c.off == 0:
                self.order.insert(c.oi, sid)
            elif c.off == n:
                self.order.insert(c.oi + 1, sid)
                self._step_fwd(out, self._row)
            else:
                rid = self._split(tgt, c.off)
                self.order.insert(c.oi + 1, rid)
                self.order.insert(c.oi + 1, sid)
                self._step_fwd(out, self._row)  # past the (now split) left
        # `out` sits just before the new slot at out.oi; advance past it.
        assert self.order[out.oi] == sid
        self._step_fwd(out, self._row)
        return out

    def _integrate(self, agent: int, sid: int,
                   cursor: Optional[_Cur]) -> Tuple[int, _Cur]:
        """YjsMod / FugueMax concurrent-insert resolution over the flat
        table (reference: merge.rs:154-278; mirrors tracker.integrate).
        Returns (upstream insert position, cursor after the new item)."""
        row = self._row
        item = self.slots[sid]
        cursor = self._roll(cursor, row) if cursor is not None else None
        left_cursor = cursor.copy() if cursor is not None else None
        scan_start = cursor.copy() if cursor is not None else None
        scanning = False

        while True:
            if cursor is None:
                break
            rolled = self._roll(cursor, row)
            if rolled is None:
                cursor = None
                break
            cursor = rolled
            other_sid = self.order[cursor.oi]
            other = self.slots[other_sid]
            other_lv = other.ids + cursor.off
            if other_lv == item.orr:
                break

            assert self.S[other_sid, row] == NIY, \
                "concurrent scan hit a non-NIY item"

            other_left_lv = other.origin_left_at(cursor.off)
            other_left_cursor = self._cursor_after_item(other_left_lv, False)

            c = self._cmp(other_left_cursor, left_cursor)
            if left_cursor is None:
                c = -1
            if c < 0:
                break
            elif c == 0:
                if item.orr == other.orr:
                    my_name = self.aa.get_agent_name(agent)
                    other_agent, other_seq = \
                        self.aa.local_to_agent_version(other_lv)
                    other_name = self.aa.get_agent_name(other_agent)
                    if my_name < other_name:
                        ins_here = True
                    elif my_name == other_name:
                        my_seq = self.aa.local_to_agent_version(item.ids)[1]
                        ins_here = my_seq < other_seq
                    else:
                        ins_here = False
                    if ins_here:
                        break
                    scanning = False
                else:
                    my_right = self._cursor_before_item(item.orr)
                    other_right = self._cursor_before_item(other.orr)
                    if self._cmp(other_right, my_right) < 0:
                        if not scanning:
                            scanning = True
                            scan_start = cursor.copy()
                    else:
                        scanning = False

            # Advance past `other` wholesale.
            cursor.off = len(other)
            nxt = self._roll(cursor, row)
            if nxt is None:
                break
            cursor = nxt

        if scanning:
            cursor = scan_start

        pos = self._up_pos(cursor)
        after = self._insert_at(cursor, sid)
        return pos, after

    # ---- op application --------------------------------------------------

    def _apply_one(self, agent: int, op: OpRun, max_len: int):
        """Advance the active row by (a prefix of) one op run; returns
        (len_consumed, xf_pos | None). Mirrors tracker.apply semantics."""
        row = self._row
        length = min(max_len, len(op))
        if op.kind == INS:
            if not op.fwd:
                raise NotImplementedError("reverse insert runs")
            if op.start == 0:
                origin_left = ROOT
                cursor: Optional[_Cur] = _Cur(0, 0, 0, 0, 0)
            else:
                c = self._seek_cur(row, op.start - 1)
                sid = self.order[c.oi]
                origin_left = self.slots[sid].ids + c.off
                cursor = c.copy()
                cursor.off += 1

            # origin_right: next item not in the NIY state in this row.
            c2 = self._roll(cursor.copy(), row)
            if c2 is None:
                origin_right = ROOT
            else:
                while True:
                    sid2 = self.order[c2.oi]
                    if self.S[sid2, row] == NIY:
                        c2.off = len(self.slots[sid2])
                        c2 = self._roll(c2, row)
                        if c2 is None:
                            origin_right = ROOT
                            break
                    else:
                        origin_right = self.slots[sid2].ids + c2.off
                        break

            new_sid = self._new_slot(op.lv, op.lv + length,
                                     origin_left, origin_right, False)
            self.S[new_sid, row] = INSERTED
            if self._cur_writes is not None:
                self._cur_writes.append((op.lv, op.lv + length, INSERTED))
            ins_pos, after = self._integrate(agent, new_sid, cursor)
            self._cur = after  # sequential typing lands right here next
            return length, ins_pos

        else:  # DEL
            fwd = op.fwd
            if fwd:
                c = self._seek_cur(row, op.start)
                take_req = length
            else:
                last_pos = op.end - 1
                c = self._seek_cur(row, last_pos)
                entry_start_pos = last_pos - c.off
                edit_start = max(entry_start_pos, op.end - length)
                take_req = op.end - edit_start
                c.off -= take_req - 1

            sid = self.order[c.oi]
            s = self.slots[sid]
            assert self.S[sid, row] == INSERTED
            ever_deleted = s.ever
            del_start_xf = self._up_pos(c)

            take = min(take_req, len(s) - c.off)
            if c.off > 0:
                rid = self._split(sid, c.off)
                self.order.insert(c.oi + 1, rid)
                self._step_fwd(c, row)  # move past the left remainder
                sid, s = rid, self.slots[rid]
            if take < len(s):
                rid = self._split(sid, take)
                self.order.insert(c.oi + 1, rid)
            self.S[sid, row] = DELETED
            if self._cur_writes is not None:
                self._cur_writes.append((s.ids, s.ide, DELETED))
            s.ever = True
            if not fwd:
                assert take == take_req
            self._cur = c.copy()
            self._cur.off = 0
            return take, (del_start_xf if not ever_deleted else None)

    # ---- plan execution --------------------------------------------------

    def run(self) -> Iterator[Tuple[int, OpRun, Optional[int]]]:
        plan, aa, ops = self.plan, self.aa, self.ops
        for act in plan.actions:
            kind = act[0]
            if kind == BEGIN:
                n = len(self.slots)
                self.S[:n, act[1]] = self.is_base[:n].astype(np.uint8)
                self._cur = None  # row states changed under the cache
            elif kind == FORK:
                self.S[:, act[2]] = self.S[:, act[1]]
                self._cur = None
            elif kind == MAX:
                np.maximum(self.S[:, act[1]], self.S[:, act[2]],
                           out=self.S[:, act[1]])
                self._cur = None
            elif kind == DROP:
                pass
            elif kind == APPLY:
                entry = plan.entries[act[1]]
                if self.journal is not None:
                    self._cur_writes = []
                    self.journal.append(self._cur_writes)
                if act[2] != self._row:
                    self._row = act[2]
                    self._cur = None  # cached prefixes are per-row
                for piece in ops.iter_range(entry.span):
                    pair = piece
                    while True:
                        agent, _seq, alen = aa.local_span_to_agent_span(
                            pair.lv, len(pair))
                        consumed, xf = self._apply_one(agent, pair, alen)
                        head = pair if consumed == len(pair) else \
                            ops._slice_run(pair, 0, consumed)
                        if entry.emit:
                            yield (head.lv, head, xf)
                        if consumed == len(pair):
                            break
                        pair = ops._slice_run(pair, consumed, len(pair))


def merge_via_plan2(oplog, from_frontier, merge_frontier,
                    validate: bool = False):
    """Compile + execute a fork/join plan; returns (xf rows, final frontier).
    The stream is a valid transform of the `from` document (positions are in
    the evolving output frame) but emission ORDER is the plan's topological
    order, not the M1 walker's — differential tests compare applied text."""
    plan = compile_plan2(oplog.cg.graph, list(from_frontier),
                         list(merge_frontier))
    if validate:
        from .plan2 import validate_plan2
        validate_plan2(plan)
    out = []
    for span in plan.ff_spans:
        for piece in oplog.ops.iter_range(span):
            out.append((piece.lv, piece, piece.start))
    if plan.entries:
        ex = DenseExecutor(plan, oplog.cg.agent_assignment, oplog.ops)
        out.extend(ex.run())
    return out, plan.final_frontier


def apply_xf_stream(oplog, content, rows) -> str:
    """Apply an xf stream to a str/Rope-like `content`; returns the new
    text (delegates to Branch's shared application loop)."""
    from ..text.branch import Branch
    from ..utils.rope import Rope
    b = Branch()
    b.content = Rope(str(content))
    b._apply_xf(oplog, rows)
    return b.snapshot()
