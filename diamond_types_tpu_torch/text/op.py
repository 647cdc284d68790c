"""Columnar operation storage (struct-of-arrays).

Capability mirror of the reference's op table (reference:
src/list/op_metrics.rs:24-78): each run is `(loc_start, loc_end, fwd, kind,
content span)`, contents live in shared per-kind character arenas. Runs are
keyed by their starting LV; the key column is ascending and dense.

Positions are unicode-char indexes. Contents are stored in append-only arenas
with lazily-consolidated string views (content_pos indexes are in *chars*,
unlike the reference's byte offsets — chars keep all device math uniform,
SURVEY.md §7 hard-part 5).
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import List, Optional, Tuple

INS = 0
DEL = 1


@dataclass(slots=True)
class OpRun:
    lv: int              # starting LV of this run
    kind: int            # INS / DEL
    start: int           # loc span start (doc position, chars)
    end: int             # loc span end
    fwd: bool
    content_pos: Optional[Tuple[int, int]]  # char span into the arena, or None

    def __len__(self) -> int:
        return self.end - self.start


class _Arena:
    """Append-only char arena with a lazily consolidated string view."""

    __slots__ = ("_parts", "_str", "_len")

    def __init__(self) -> None:
        self._parts: List[str] = []
        self._str = ""
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, s: str) -> Tuple[int, int]:
        start = self._len
        self._parts.append(s)
        self._len += len(s)
        return (start, self._len)

    def get(self, span: Tuple[int, int]) -> str:
        if len(self._str) != self._len:
            self._str = self._str + "".join(self._parts)
            self._parts.clear()
        return self._str[span[0]:span[1]]


class OpStore:
    """Append-mostly RLE vector of op runs + content arenas."""

    __slots__ = ("runs", "_arenas")

    def __init__(self) -> None:
        self.runs: List[OpRun] = []
        self._arenas = (_Arena(), _Arena())  # INS, DEL

    def arena_len(self, kind: int) -> int:
        return len(self._arenas[kind])

    def push_content(self, kind: int, s: str) -> Tuple[int, int]:
        return self._arenas[kind].push(s)

    def get_content(self, kind: int, span: Tuple[int, int]) -> str:
        return self._arenas[kind].get(span)

    def get_run_content(self, run: OpRun) -> Optional[str]:
        if run.content_pos is None:
            return None
        return self._arenas[run.kind].get(run.content_pos)

    def find_idx(self, lv: int) -> int:
        i = bisect_right(self.runs, lv, key=lambda r: r.lv) - 1
        if i < 0:
            raise KeyError(lv)
        return i

    def content_slice(self, lv: int, n: int) -> Optional[str]:
        """Content chars for items [lv, lv+n) of the run containing lv."""
        run = self.runs[self.find_idx(lv)]
        if run.content_pos is None:
            return None
        off = lv - run.lv
        assert off + n <= len(run)
        base = run.content_pos[0]
        return self._arenas[run.kind].get((base + off, base + off + n))

    def end_lv(self) -> int:
        if not self.runs:
            return 0
        last = self.runs[-1]
        return last.lv + len(last)

    def push_op(self, lv: int, kind: int, start: int, end: int, fwd: bool,
                content: Optional[str]) -> None:
        """Append one op run, RLE-merging with the previous run when possible
        (reference: src/list/oplog.rs:159-175 + RleVec append)."""
        content_pos = self.push_content(kind, content) if content is not None else None
        run = OpRun(lv, kind, start, end, fwd, content_pos)
        if self.runs:
            prev = self.runs[-1]
            if (prev.lv + len(prev) == lv and prev.kind == kind
                    and (prev.content_pos is None) == (content_pos is None)
                    and can_append_ops(kind, prev, run)):
                append_ops(kind, prev, run)
                return
        self.runs.append(run)

    def iter_range(self, span: Tuple[int, int]):
        """Yield (lv, kind, loc_start, loc_end, fwd, content_pos) sub-runs
        covering LV span `span` (reference: src/list/op_iter.rs)."""
        lo, hi = span
        if hi <= lo:
            return
        i = self.find_idx(lo)
        pos = lo
        while pos < hi:
            run = self.runs[i]
            run_end_lv = run.lv + len(run)
            off0 = pos - run.lv
            off1 = min(hi, run_end_lv) - run.lv
            yield self._slice_run(run, off0, off1)
            pos = run.lv + off1
            i += 1

    @staticmethod
    def _slice_run(run: OpRun, off0: int, off1: int) -> OpRun:
        """Sub-run covering item offsets [off0, off1) of `run`."""
        n = len(run)
        assert 0 <= off0 < off1 <= n
        if off0 == 0 and off1 == n:
            return run
        loc = sub_op_loc(run.kind, run.start, run.end, run.fwd, off0, off1)
        cp = None
        if run.content_pos is not None:
            cp = (run.content_pos[0] + off0, run.content_pos[0] + off1)
        return OpRun(run.lv + off0, run.kind, loc[0], loc[1], run.fwd, cp)


def can_append_ops(kind: int, a: OpRun, b: OpRun) -> bool:
    """RLE append rule for positional runs (reference: op_metrics.rs:235-256).

    Ins forward: b continues at a's end position. Del forward: b deletes at
    a's *start* (delete-key runs). Del reverse: b ends at a's start
    (backspace runs).
    """
    a_len, b_len = len(a), len(b)
    if (a_len == 1 or a.fwd) and (b_len == 1 or b.fwd):
        if kind == INS and b.start == a.end:
            return True
        if kind == DEL and b.start == a.start:
            return True
    if kind == DEL and (a_len == 1 or not a.fwd) and (b_len == 1 or not b.fwd):
        if b.end == a.start:
            return True
    return False


def append_ops(kind: int, a: OpRun, b: OpRun) -> None:
    """Merge run `b` into `a` in place (reference: op_metrics.rs:258-271)."""
    fwd = b.start >= a.start and (b.start != a.start or kind == DEL)
    a.fwd = fwd
    if kind == DEL and not fwd:
        a.start = b.start
    else:
        a.end += len(b)
    if a.content_pos is not None and b.content_pos is not None:
        assert a.content_pos[1] == b.content_pos[0]
        a.content_pos = (a.content_pos[0], b.content_pos[1])


def split_op_loc(kind: int, start: int, end: int, fwd: bool, at: int):
    """Split a run's loc after `at` items -> (first_loc, rest_loc).

    Del-fwd remainders re-target `start`; Del-rev runs consume from the tail
    first (reference: op_metrics.rs truncate_tagged_span).
    """
    length = end - start
    assert 0 < at < length
    if kind == INS:
        if fwd:
            return (start, start + at), (start + at, end)
        raise NotImplementedError("reverse inserts")
    else:
        if fwd:
            return (start, start + at), (start, start + (length - at))
        else:
            return (end - at, end), (start, end - at)


def sub_op_loc(kind: int, start: int, end: int, fwd: bool,
               off0: int, off1: int) -> Tuple[int, int]:
    """Loc of the sub-run covering item offsets [off0, off1)."""
    loc = (start, end)
    if off0 > 0:
        _, loc = split_op_loc(kind, loc[0], loc[1], fwd, off0)
    n = loc[1] - loc[0]
    take = off1 - off0
    if take < n:
        loc, _ = split_op_loc(kind, loc[0], loc[1], fwd, take)
    return loc
