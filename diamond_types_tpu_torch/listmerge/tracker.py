"""The merge tracker: a CRDT-order span store used to transform concurrent
positional edits onto a common document frame.

Capability mirror of the reference M2Tracker (reference: src/listmerge/mod.rs:40-55,
merge.rs:89-558, advance_retreat.rs) with a different data-structure design:
instead of an unsafe B-tree with leaf back-pointers (content-tree) plus a
second range tree for the LV index, this uses

  * an order-statistic **treap** over RLE item spans, each node carrying three
    subtree aggregates: raw length, current length (items in INSERTED state)
    and upstream length (items never deleted) — the dual metric of the
    reference's MarkerMetrics (reference: src/listmerge/metrics.rs:18-66);
  * bisect-indexed maps from LV -> tree node (inserts) and LV -> delete target
    (deletes), replacing the SpaceIndex (reference: src/listmerge/markers.rs).

Item states follow the reference YjsSpan state machine (yjsspan.rs:47-91):
0 = not-inserted-yet, 1 = inserted, n>=2 = deleted (n-1) times.
"""

from __future__ import annotations

import random
from bisect import bisect_right, insort
from typing import List, Optional, Tuple

from ..core.span import UNDERWATER_START
from ..text.op import DEL, INS, OpRun
from ..utils.stats import GLOBAL_COUNTERS as COUNTERS

ROOT = -1

NOT_INSERTED_YET = 0
INSERTED = 1

_rng = random.Random(0x5EED)


class _Node:
    __slots__ = ("ids", "ide", "ol", "orr", "state", "ever",
                 "prio", "l", "r", "p", "s_len", "s_cur", "s_up")

    def __init__(self, ids: int, ide: int, ol: int, orr: int,
                 state: int, ever: bool) -> None:
        self.ids = ids      # id span [ids, ide): LVs of the inserted items
        self.ide = ide
        self.ol = ol        # origin_left of the FIRST item (later items: id-1)
        self.orr = orr      # origin_right, shared by all items in the span
        self.state = state
        self.ever = ever    # ever deleted?
        self.prio = _rng.random()
        self.l: Optional[_Node] = None
        self.r: Optional[_Node] = None
        self.p: Optional[_Node] = None
        self.s_len = ide - ids
        self.s_cur = 0
        self.s_up = 0
        _update(self)

    # metric contributions of this node alone
    def n_len(self) -> int:
        return self.ide - self.ids

    def n_cur(self) -> int:
        return self.ide - self.ids if self.state == INSERTED else 0

    def n_up(self) -> int:
        return 0 if self.ever else self.ide - self.ids

    def origin_left_at(self, offset: int) -> int:
        return self.ol if offset == 0 else self.ids + offset - 1


def _update(n: _Node) -> None:
    ln, lc, lu = (n.l.s_len, n.l.s_cur, n.l.s_up) if n.l else (0, 0, 0)
    rn, rc, ru = (n.r.s_len, n.r.s_cur, n.r.s_up) if n.r else (0, 0, 0)
    n.s_len = ln + rn + n.n_len()
    n.s_cur = lc + rc + n.n_cur()
    n.s_up = lu + ru + n.n_up()


def _fix_path(n: Optional[_Node]) -> None:
    while n is not None:
        _update(n)
        n = n.p


def _leftmost(n: _Node) -> _Node:
    while n.l is not None:
        n = n.l
    return n


def _succ(n: _Node) -> Optional[_Node]:
    if n.r is not None:
        return _leftmost(n.r)
    while n.p is not None and n is n.p.r:
        n = n.p
    return n.p


def _pred(n: _Node) -> Optional[_Node]:
    if n.l is not None:
        x = n.l
        while x.r is not None:
            x = x.r
        return x
    while n.p is not None and n is n.p.l:
        n = n.p
    return n.p


# A cursor is a (node, offset) pair with 0 <= offset <= node.n_len(), meaning
# "the gap just before item `offset` of `node`". (None, 0) = empty tree.
Cursor = Tuple[Optional[_Node], int]


class Tracker:
    def __init__(self) -> None:
        under = _Node(UNDERWATER_START, UNDERWATER_START * 2 - 1,
                      ROOT, ROOT, INSERTED, False)
        self.root: _Node = under
        # LV -> node index for inserted items (covers underwater ids too).
        self._ins_starts: List[int] = [under.ids]
        self._ins_nodes = {under.ids: under}
        # Delete-op LV -> target items: rows (lv0, lv1, t0, t1, fwd), disjoint.
        self._del_rows: List[Tuple[int, int, int, int, bool]] = []
        # Genuinely colliding concurrent inserts seen by integrate
        # (reference: merge_conflict_checks, listmerge/mod.rs:50-51 —
        # set whenever the scan meets another item that is not simply our
        # origin-right).
        self.collisions = 0

    # ---- treap plumbing --------------------------------------------------

    def _rot_up(self, x: _Node) -> None:
        p = x.p
        g = p.p
        if x is p.l:
            p.l = x.r
            if x.r is not None:
                x.r.p = p
            x.r = p
        else:
            p.r = x.l
            if x.l is not None:
                x.l.p = p
            x.l = p
        p.p = x
        x.p = g
        if g is not None:
            if g.l is p:
                g.l = x
            else:
                g.r = x
        else:
            self.root = x
        _update(p)
        _update(x)

    def _insert_leaf(self, x: _Node) -> None:
        _fix_path(x.p)
        while x.p is not None and x.prio < x.p.prio:
            self._rot_up(x)

    def _insert_after(self, a: _Node, x: _Node) -> None:
        if a.r is None:
            a.r = x
            x.p = a
        else:
            b = _leftmost(a.r)
            b.l = x
            x.p = b
        self._insert_leaf(x)

    def _insert_first(self, x: _Node) -> None:
        b = _leftmost(self.root)
        b.l = x
        x.p = b
        self._insert_leaf(x)

    def _register(self, n: _Node) -> None:
        insort(self._ins_starts, n.ids)
        self._ins_nodes[n.ids] = n

    def _split(self, n: _Node, offset: int) -> _Node:
        """Split node after `offset` items; returns the new right node."""
        assert 0 < offset < n.n_len()
        rn = _Node(n.ids + offset, n.ide, n.ids + offset - 1, n.orr,
                   n.state, n.ever)
        n.ide = n.ids + offset
        _fix_path(n)
        self._insert_after(n, rn)
        self._register(rn)
        return rn

    def _ins_lookup(self, lv: int) -> _Node:
        i = bisect_right(self._ins_starts, lv) - 1
        n = self._ins_nodes[self._ins_starts[i]]
        assert n.ids <= lv < n.ide, f"item LV {lv} not tracked"
        return n

    # ---- cursors ---------------------------------------------------------

    def _prefix(self, n: _Node, which: int) -> int:
        """Sum of metric `which` (0=len,1=cur,2=up) strictly before node n."""
        def sub(x: Optional[_Node]) -> int:
            if x is None:
                return 0
            return (x.s_len, x.s_cur, x.s_up)[which]

        def own(x: _Node) -> int:
            return (x.n_len(), x.n_cur(), x.n_up())[which]

        acc = sub(n.l)
        x = n
        while x.p is not None:
            if x is x.p.r:
                acc += sub(x.p.l) + own(x.p)
            x = x.p
        return acc

    def _raw_pos(self, c: Cursor) -> int:
        n, off = c
        if n is None:
            return self.root.s_len
        return self._prefix(n, 0) + off

    def _upstream_pos(self, c: Cursor) -> int:
        n, off = c
        if n is None:
            return self.root.s_up
        return self._prefix(n, 2) + (0 if n.ever else off)

    def _find_by_cur(self, pos: int) -> Cursor:
        """Cursor at the `pos`-th currently-INSERTED item."""
        n = self.root
        assert pos < n.s_cur, f"content pos {pos} out of range"
        while True:
            lc = n.l.s_cur if n.l else 0
            if pos < lc:
                n = n.l
                continue
            pos -= lc
            here = n.n_cur()
            if pos < here:
                return (n, pos)
            pos -= here
            n = n.r

    def _roll(self, c: Cursor) -> Cursor | None:
        """Normalize cursor so offset < node len; None at end of document."""
        n, off = c
        if n is None:
            return None
        while off >= n.n_len():
            nxt = _succ(n)
            if nxt is None:
                return None
            n, off = nxt, 0
        return (n, off)

    def _cursor_before_item(self, lv: int) -> Cursor:
        if lv == ROOT:
            return (None, 0)  # end-of-document sentinel
        n = self._ins_lookup(lv)
        return (n, lv - n.ids)

    def _cursor_after_item(self, lv: int, stick_end: bool) -> Cursor:
        if lv == ROOT:
            n = _leftmost(self.root)
            return (n, 0)  # start of document
        n = self._ins_lookup(lv)
        c = (n, lv - n.ids + 1)
        if not stick_end:
            rolled = self._roll(c)
            if rolled is not None:
                return rolled
        return c

    def _cmp_cursors(self, a: Cursor, b: Cursor) -> int:
        pa, pb = self._raw_pos(a), self._raw_pos(b)
        return (pa > pb) - (pa < pb)

    # ---- insertion (integrate) ------------------------------------------

    def _insert_at(self, c: Cursor, node: _Node) -> None:
        n, off = c
        if n is None:
            # end of document
            x = self.root
            while x.r is not None:
                x = x.r
            self._insert_after(x, node)
        elif off == 0:
            prev = _pred(n)
            if prev is None:
                self._insert_first(node)
            else:
                self._insert_after(prev, node)
        elif off == n.n_len():
            self._insert_after(n, node)
        else:
            self._split(n, off)
            self._insert_after(n, node)
        self._register(node)

    def integrate(self, aa, agent: int, item: _Node, cursor: Cursor | None) -> int:
        """YjsMod / FugueMax concurrent-insert resolution (reference:
        merge.rs:154-278). Returns the item's transformed (upstream) insert
        position. `cursor` sits immediately after the item's origin_left.
        """
        COUNTERS.bump("integrate_calls")
        cursor = self._roll(cursor) if cursor is not None else None
        left_cursor = cursor
        scan_start = cursor
        scanning = False

        while True:
            if cursor is None:
                break  # end of document
            rolled = self._roll(cursor)
            if rolled is None:
                cursor = None
                break
            cursor = rolled
            other, off = cursor
            other_lv = other.ids + off
            if other_lv == item.orr:
                break
            self.collisions += 1   # a genuinely concurrent insert here

            # Only not-yet-inserted items can be concurrent with us here.
            assert other.state == NOT_INSERTED_YET

            other_left_lv = other.origin_left_at(off)
            other_left_cursor = self._cursor_after_item(other_left_lv, False)

            c = self._cmp_cursors(other_left_cursor,
                                  left_cursor if left_cursor is not None else (None, 0))
            if left_cursor is None:
                # our origin-left is end-of-doc sentinel: nothing sorts after it
                c = -1
            if c < 0:
                break
            elif c == 0:
                if item.orr == other.orr:
                    # Fully concurrent siblings: order by agent name, then seq
                    # (reference: merge.rs:193-241).
                    my_name = aa.get_agent_name(agent)
                    other_agent, other_seq = aa.local_to_agent_version(other_lv)
                    other_name = aa.get_agent_name(other_agent)
                    if my_name < other_name:
                        ins_here = True
                    elif my_name == other_name:
                        my_seq = aa.local_to_agent_version(item.ids)[1]
                        ins_here = my_seq < other_seq
                    else:
                        ins_here = False
                    if ins_here:
                        break
                    scanning = False
                else:
                    my_right = self._cursor_before_item(item.orr)
                    other_right = self._cursor_before_item(other.orr)
                    if self._cmp_cursors(other_right, my_right) < 0:
                        if not scanning:
                            scanning = True
                            scan_start = cursor
                    else:
                        scanning = False

            # Advance to the next entry wholesale.
            nxt = _succ(other)
            if nxt is None:
                cursor = (other, other.n_len())
                break
            cursor = (nxt, 0)

        if scanning:
            cursor = scan_start

        at = cursor if cursor is not None else (None, 0)
        pos = self._upstream_pos(at)
        self._insert_at(at, item)
        return pos

    # ---- op application --------------------------------------------------

    def apply(self, aa, agent: int, op: OpRun, max_len: int):
        """Advance the tracker by (a prefix of) one op run; returns
        (len_consumed, xf) where xf is the transformed position (int) or None
        when the delete already happened (reference: merge.rs:375-558).
        """
        length = min(max_len, len(op))
        COUNTERS.bump("apply_ins_runs" if op.kind == INS else "apply_del_runs")
        if op.kind == INS:
            if not op.fwd:
                raise NotImplementedError("reverse insert runs")
            if op.start == 0:
                origin_left = ROOT
                cursor: Cursor | None = (_leftmost(self.root), 0)
            else:
                n, off = self._find_by_cur(op.start - 1)
                origin_left = n.ids + off
                cursor = (n, off + 1)

            # origin_right: next item that is not in the NIY state.
            rolled = self._roll(cursor)
            if rolled is None:
                origin_right = ROOT
            else:
                c2 = rolled
                while True:
                    n2, off2 = c2
                    if n2.state == NOT_INSERTED_YET:
                        nxt = _succ(n2)
                        if nxt is None:
                            origin_right = ROOT
                            break
                        c2 = (nxt, 0)
                    else:
                        origin_right = n2.ids + off2
                        break

            item = _Node(op.lv, op.lv + length, origin_left, origin_right,
                         INSERTED, False)
            ins_pos = self.integrate(aa, agent, item, cursor)
            return length, ins_pos

        else:  # DEL
            fwd = op.fwd
            if fwd:
                cursor = self._find_by_cur(op.start)
                take_req = length
            else:
                last_pos = op.end - 1
                n, off = self._find_by_cur(last_pos)
                entry_start_pos = last_pos - off
                edit_start = max(entry_start_pos, op.end - length)
                take_req = op.end - edit_start
                cursor = (n, off - (take_req - 1))

            n, off = cursor
            assert n.state == INSERTED
            ever_deleted = n.ever
            del_start_xf = self._upstream_pos(cursor)

            # Delete as much as fits within this node.
            take = min(take_req, n.n_len() - off)
            if off > 0:
                n = self._split(n, off)
            if take < n.n_len():
                self._split(n, take)
            target = (n.ids, n.ide)
            n.state += 1
            n.ever = True
            _fix_path(n)
            if not fwd:
                assert take == take_req

            insort(self._del_rows, (op.lv, op.lv + take, target[0], target[1], fwd))

            if not ever_deleted:
                return take, del_start_xf
            else:
                return take, None

    # ---- time travel (advance / retreat) ---------------------------------

    def _index_query(self, lv: int):
        """(kind, target_rangerev, offset, total_len) for op LV `lv`
        (reference: advance_retreat.rs:28-56)."""
        i = bisect_right(self._del_rows, (lv, (1 << 63),)) - 1
        if i >= 0:
            lv0, lv1, t0, t1, fwd = self._del_rows[i]
            if lv0 <= lv < lv1:
                return DEL, (t0, t1, fwd), lv - lv0, lv1 - lv0
        n = self._ins_lookup(lv)
        return INS, (n.ids, n.ide, True), lv - n.ids, n.n_len()

    def _toggle_items(self, s: int, e: int, mode: str) -> None:
        """Apply a state transition to items with ids in [s, e)."""
        lv = s
        while lv < e:
            n = self._ins_lookup(lv)
            if lv > n.ids:
                n = self._split(n, lv - n.ids)
            if e < n.ide:
                self._split(n, e - n.ids)
            if mode == "ins":
                assert n.state == NOT_INSERTED_YET
                n.state = INSERTED
            elif mode == "unins":
                assert n.state == INSERTED
                n.state = NOT_INSERTED_YET
            elif mode == "del":
                assert n.state >= INSERTED
                n.state += 1
                n.ever = True
            elif mode == "undel":
                assert n.state >= 2
                n.state -= 1
            _fix_path(n)
            lv = n.ide

    def advance_by_range(self, rng: Tuple[int, int]) -> None:
        """Re-apply op effects for LVs in `rng` (reference: advance_retreat.rs:58-97)."""
        COUNTERS.bump("advance_calls")
        start, end = rng
        while start < end:
            kind, target, offset, total = self._index_query(start)
            take = min(total - offset, end - start)
            lo, hi = _rr_sub(target, offset, offset + take)
            self._toggle_items(lo, hi, "ins" if kind == INS else "del")
            start += take

    def retreat_by_range(self, rng: Tuple[int, int]) -> None:
        """Un-apply op effects for LVs in `rng`, back to front so un-deletes
        precede un-inserts of the same item (reference: advance_retreat.rs:100-153)."""
        COUNTERS.bump("retreat_calls")
        start, end = rng
        while start < end:
            req = end - 1
            kind, target, offset, total = self._index_query(req)
            chunk_start = req - offset
            s = max(start, chunk_start)
            e = min(end, chunk_start + total)
            o0 = s - chunk_start
            lo, hi = _rr_sub(target, o0, o0 + (e - s))
            self._toggle_items(lo, hi, "unins" if kind == INS else "undel")
            end -= e - s

    # ---- debug -----------------------------------------------------------

    def dbg_iter(self):
        out = []
        n = _leftmost(self.root)
        while n is not None:
            out.append((n.ids, n.ide, n.ol, n.orr, n.state, n.ever))
            n = _succ(n)
        return out

    def check_invariants(self) -> None:
        n = _leftmost(self.root)
        while n is not None:
            assert n.ide > n.ids
            if n.p is None:
                assert n is self.root
            n = _succ(n)

        def rec(x: Optional[_Node]):
            if x is None:
                return 0, 0, 0
            ll = rec(x.l)
            rr = rec(x.r)
            if x.l:
                assert x.l.p is x and x.l.prio >= x.prio
            if x.r:
                assert x.r.p is x and x.r.prio >= x.prio
            tot = (ll[0] + rr[0] + x.n_len(), ll[1] + rr[1] + x.n_cur(),
                   ll[2] + rr[2] + x.n_up())
            assert tot == (x.s_len, x.s_cur, x.s_up)
            return tot

        rec(self.root)


def _rr_sub(target: Tuple[int, int, bool], o0: int, o1: int) -> Tuple[int, int]:
    """Sub-range [o0, o1) of a reversible target range, in item-id space
    (reference: src/rev_range.rs range())."""
    t0, t1, fwd = target
    if fwd:
        return (t0 + o0, t0 + o1)
    return (t1 - o1, t1 - o0)
