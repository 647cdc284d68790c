"""Operational-transform bridge.

Capability mirror of the reference's OT layer (reference:
crates/diamond-types-old/src/list/ot/ot.rs — `transform`, `compose`, apply —
and positionmap.rs which maps CRDT ops onto positional traversal ops;
README.md:31-33: "interoperable with positional updates ... via operational
transform"). This lets plain centralized clients interoperate with CRDT
peers: a traversal op is a list of components over unicode chars:

    int n     -> retain n
    "text"    -> insert text
    {"d": n}  -> delete n

Validated against the reference's golden conformance vectors
(test_data/ot/{apply,compose,transform}.json).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Union

Component = Union[int, str, dict]
TraversalOp = List[Component]


def _is_retain(c: Component) -> bool:
    return isinstance(c, int)


def _is_insert(c: Component) -> bool:
    return isinstance(c, str)


def _is_delete(c: Component) -> bool:
    return isinstance(c, dict)


def _clen(c: Component) -> int:
    if isinstance(c, int):
        return c
    if isinstance(c, str):
        return len(c)
    return c["d"]


class _Appender:
    """Append components, merging adjacent same-kind ones."""

    def __init__(self) -> None:
        self.out: TraversalOp = []

    def append(self, c: Component) -> None:
        if c == 0 or c == "" or (isinstance(c, dict) and c["d"] == 0):
            return
        out = self.out
        if out:
            last = out[-1]
            if _is_retain(last) and _is_retain(c):
                out[-1] = last + c
                return
            if _is_insert(last) and _is_insert(c):
                out[-1] = last + c
                return
            if _is_delete(last) and _is_delete(c):
                out[-1] = {"d": last["d"] + c["d"]}
                return
        out.append(c)

    def result(self) -> TraversalOp:
        # Trim a trailing retain.
        if self.out and _is_retain(self.out[-1]):
            self.out.pop()
        return self.out


class _Taker:
    """Consume an op component-stream in arbitrary-size chunks."""

    def __init__(self, op: TraversalOp) -> None:
        self.op = op
        self.idx = 0
        self.offset = 0

    def take(self, n: int, indivisible: str = "") -> Component | None:
        """Take up to n of the current component (-1 = the whole thing).
        When the current component's kind matches `indivisible` ("i" insert /
        "d" delete), take it whole regardless of n."""
        if self.idx == len(self.op):
            return None if n == -1 else (n if n > 0 else None)
        c = self.op[self.idx]
        if _is_retain(c):
            if n == -1 or c - self.offset <= n:
                part: Component = c - self.offset
                self.idx += 1
                self.offset = 0
            else:
                part = n
                self.offset += n
        elif _is_insert(c):
            if n == -1 or indivisible == "i" or len(c) - self.offset <= n:
                part = c[self.offset:]
                self.idx += 1
                self.offset = 0
            else:
                part = c[self.offset:self.offset + n]
                self.offset += n
        else:
            if n == -1 or indivisible == "d" or c["d"] - self.offset <= n:
                part = {"d": c["d"] - self.offset}
                self.idx += 1
                self.offset = 0
            else:
                part = {"d": n}
                self.offset += n
        return part

    def peek(self) -> Component | None:
        return self.op[self.idx] if self.idx < len(self.op) else None


def normalize(op: TraversalOp) -> TraversalOp:
    a = _Appender()
    for c in op:
        a.append(c)
    return a.result()


def apply(doc: str, op: TraversalOp) -> str:
    """Apply a traversal op to a string (reference: ot.rs apply)."""
    out: List[str] = []
    pos = 0
    for c in op:
        if _is_retain(c):
            assert pos + c <= len(doc), "retain past end"
            out.append(doc[pos:pos + c])
            pos += c
        elif _is_insert(c):
            out.append(c)
        else:
            assert pos + c["d"] <= len(doc), "delete past end"
            pos += c["d"]
    out.append(doc[pos:])
    return "".join(out)


def compose(op1: TraversalOp, op2: TraversalOp) -> TraversalOp:
    """Compose two sequential ops into one (reference: ot.rs compose)."""
    t = _Taker(op1)
    a = _Appender()
    for c in op2:
        if _is_retain(c):
            n = c
            while n > 0:
                chunk = t.take(n, "d")
                if chunk is None:
                    a.append(n)
                    n = 0
                    break
                a.append(chunk)
                if not _is_delete(chunk):
                    n -= _clen(chunk)
        elif _is_insert(c):
            a.append(c)
        else:
            n = c["d"]
            while n > 0:
                chunk = t.take(n, "d")
                if chunk is None:
                    a.append({"d": n})
                    n = 0
                    break
                if _is_retain(chunk):
                    a.append({"d": chunk})
                    n -= chunk
                elif _is_insert(chunk):
                    n -= len(chunk)  # inserted then deleted: cancels out
                else:
                    a.append(chunk)  # op1's delete happens first
    while True:
        chunk = t.take(-1)
        if chunk is None:
            break
        a.append(chunk)
    return a.result()


def transform(op: TraversalOp, other: TraversalOp, side: str) -> TraversalOp:
    """Transform `op` so it applies after `other` (reference: ot.rs transform).
    `side` breaks insert ties: "left" inserts before the other's inserts."""
    assert side in ("left", "right")
    t = _Taker(op)
    a = _Appender()
    for c in other:
        if _is_retain(c):
            n = c
            while n > 0:
                chunk = t.take(n, "i")
                if chunk is None:
                    a.append(n)
                    n = 0
                    break
                a.append(chunk)
                if not _is_insert(chunk):
                    n -= _clen(chunk)
        elif _is_insert(c):
            if side == "left" and _is_insert(t.peek()):
                a.append(t.take(-1))
            a.append(len(c))  # retain over the other's insert
        else:
            n = c["d"]
            while n > 0:
                chunk = t.take(n, "i")
                if chunk is None:
                    n = 0
                    break
                if _is_retain(chunk):
                    n -= chunk
                elif _is_insert(chunk):
                    a.append(chunk)
                else:
                    n -= chunk["d"]  # deleted by both: drop
    while True:
        chunk = t.take(-1)
        if chunk is None:
            break
        a.append(chunk)
    return a.result()


def xf_stream_to_traversal(xf_iter, final_len_hint: int | None = None
                           ) -> TraversalOp:
    """Convert a transformed-op stream (lv_span, OpRun|None, content) from
    OpLog.iter_xf_operations_from into a single traversal op by composition
    (capability mirror of reference positionmap.rs: CRDT ops -> positional
    OT ops)."""
    from .op import INS
    result: TraversalOp = []
    for (_span, op, content) in xf_iter:
        if op is None:
            continue
        if op.kind == INS:
            assert content is not None
            if not op.fwd:
                content = content[::-1]
            step: TraversalOp = [op.start, content]
        else:
            step = [op.start, {"d": len(op)}]
        result = compose(result, normalize(step))
    return result
