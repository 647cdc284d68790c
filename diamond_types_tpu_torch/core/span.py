"""Half-open integer spans — the universal currency of local versions (LVs).

The reference models these as `DTRange` (reference: src/dtrange.rs:19) and
reversible ranges as `RangeRev` (reference: src/rev_range.rs:20). Here spans
are plain `(start, end)` tuples so they vectorize directly into numpy / JAX
arrays; helpers are free functions instead of trait impls.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

Span = Tuple[int, int]  # half-open [start, end)

#: Sentinel id base for tracker placeholder ("underwater") items: content that
#: existed before the conflict zone being merged. Mirrors UNDERWATER_START
#: (reference: src/dtrange.rs:199) but any value far above real LVs works.
UNDERWATER_START = 1 << 62


def span_len(s: Span) -> int:
    return s[1] - s[0]


def span_is_empty(s: Span) -> bool:
    return s[1] <= s[0]


def span_contains(s: Span, v: int) -> bool:
    return s[0] <= v < s[1]


def span_last(s: Span) -> int:
    return s[1] - 1


def spans_overlap(a: Span, b: Span) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def span_intersect(a: Span, b: Span) -> Span | None:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def push_rle(out: List[Span], s: Span) -> None:
    """Append `s`, merging with the trailing span when contiguous (ascending)."""
    if out and out[-1][1] == s[0]:
        out[-1] = (out[-1][0], s[1])
    else:
        out.append(s)


def push_reversed_rle(out: List[Span], s: Span) -> None:
    """Append `s` to a descending-ordered list, merging when contiguous.

    Mirrors AppendRle::push_reversed_rle (reference: crates/rle/src/append_rle.rs):
    the list holds spans from highest to lowest; a new span glues onto the
    *front* of the last pushed span.
    """
    if out and s[1] == out[-1][0]:
        out[-1] = (s[0], out[-1][1])
    else:
        out.append(s)


def merge_spans(spans: Iterable[Span]) -> List[Span]:
    """Normalize: sort ascending and coalesce overlapping/adjacent spans."""
    out: List[Span] = []
    for s in sorted(spans):
        if out and s[0] <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], s[1]))
        else:
            out.append(s)
    return out


# --- Reversible ranges -------------------------------------------------------
# A RangeRev is (start, end, fwd). `fwd=False` encodes runs produced by e.g.
# backspacing, where successive LVs target successively *earlier* positions.

RangeRev = Tuple[int, int, bool]


def rr_len(r: RangeRev) -> int:
    return r[1] - r[0]


def rr_sub(r: RangeRev, offset: int, end_offset: int) -> Span:
    """Sub-span [offset, end_offset) of a RangeRev, in target-id space.

    For a forward run, offsets count from `start` upward; for a reversed run
    they count from the *end* downward (reference: src/rev_range.rs `range()`).
    """
    start, end, fwd = r
    if fwd:
        return (start + offset, start + end_offset)
    else:
        return (end - end_offset, end - offset)
