"""Columnar export of plan/tracker state for the device transform.

The host tracker walk (`get_xf_operations_full`) resolves one op at a
time; the device transform (`gpu/xform.py`) instead consumes the whole
conflict zone as dense columns at RLE-run granularity:

  * the tracker's item table (ids / lengths / origin-left / origin-right
    / ever-deleted), exactly as `dump_tracker(keep_underwater=True)`
    returns it — one native transform extracts the origins, nothing
    walks the zone in Python;
  * the delete-target rows (`dump_del_rows`): op LV range -> target item
    range, the column that lets old-vs-new delete visibility be decided
    by an LV threshold instead of a per-op walk;
  * the fast-forward prefix text at the zone's common ancestor (the
    underwater spine's real text), plus the merge's union frontier.

This module also owns the agent-rank and insert-arena offset columns that
the device checkout (`gpu/merge_kernel.py`) and the device transform share:
they are plain oplog column extractions, not device code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.span import UNDERWATER_START as UNDERWATER
from ..text.op import INS


class UnsupportedTail(Exception):
    """The tail's shape is outside the device transform's contract; the
    caller falls back to the host tracker walk (`plan_tail`)."""


def agent_key_columns(oplog, lvs: np.ndarray):
    """(name-rank, seq) per LV, vectorized over the agent-assignment runs.

    Reference tie-break: agent NAME order then seq
    (causalgraph/agent_assignment/mod.rs:163)."""
    aa = oplog.cg.agent_assignment
    gr = aa.global_runs
    lv0 = np.asarray([r[0] for r in gr], dtype=np.int64)
    ag = np.asarray([r[2] for r in gr], dtype=np.int64)
    sq0 = np.asarray([r[3] for r in gr], dtype=np.int64)
    o = np.argsort(lv0)
    lv0, ag, sq0 = lv0[o], ag[o], sq0[o]
    name_rank = np.asarray(np.argsort(np.argsort(aa.agent_names)))
    j = np.clip(np.searchsorted(lv0, lvs, side="right") - 1, 0, len(lv0) - 1)
    agent = np.where(lvs >= UNDERWATER, 0, name_rank[ag[j]])
    seq = np.where(lvs >= UNDERWATER, 0, sq0[j] + (lvs - lv0[j]))
    return agent, seq


def arena_offset_columns(oplog, lvs: np.ndarray) -> np.ndarray:
    """Insert-arena char offset of each LV (must be insert LVs)."""
    runs = oplog.ops.runs
    lv0 = np.asarray([r.lv for r in runs], dtype=np.int64)
    cp0 = np.asarray(
        [r.content_pos[0] if (r.kind == INS and r.content_pos is not None)
         else -1 for r in runs], dtype=np.int64)
    j = np.clip(np.searchsorted(lv0, lvs, side="right") - 1, 0, len(lv0) - 1)
    return cp0[j] + (lvs - lv0[j])


@dataclass
class TailColumns:
    """One document's conflict zone as dense columns (host-extracted)."""
    ids: np.ndarray       # [r] int64 item-run first LVs (doc order as dumped)
    ln: np.ndarray        # [r] int64 run lengths
    ol: np.ndarray        # [r] int64 origin-left LVs (-1 = ROOT)
    orr: np.ndarray       # [r] int64 origin-right LVs (-1 = ROOT)
    ev: np.ndarray        # [r] int64 ever-deleted flags
    del_lv0: np.ndarray   # [d] int64 delete-op LV range starts
    del_lv1: np.ndarray   # [d] int64 delete-op LV range ends (exclusive)
    del_t0: np.ndarray    # [d] int64 target item range starts
    del_t1: np.ndarray    # [d] int64 target item range ends (exclusive)
    del_fwd: np.ndarray   # [d] int64 1 = op lv0+k targets t0+k, 0 = t1-1-k
    prefix: str           # doc text at the zone's common ancestor
    union: Tuple[int, ...]   # version_union(from, merge) — the plan frontier
    arena: np.ndarray     # int32 char codes of the whole insert arena


def export_tail_columns(oplog, from_frontier: Sequence[int],
                        merge_frontier: Optional[Sequence[int]] = None
                        ) -> TailColumns:
    """One native transform -> the tail's columnar DAG tables.

    Raises UnsupportedTail for shapes the device transform does not
    model: an empty conflict zone (pure fast-forward — the host plan is
    already O(tail) with no concurrency to resolve) and reversed insert
    runs (their arena content order is not affine in LV, so the run-
    granular char columns cannot describe them)."""
    from ..native.core import get_native_ctx

    ctx = get_native_ctx(oplog)
    frm = [int(x) for x in from_frontier]
    merge = ([int(x) for x in oplog.version] if merge_frontier is None
             else [int(x) for x in merge_frontier])
    lv, ln_ops, kind, fwd, _pos, union = ctx.transform(frm, merge)
    if (np.asarray(ln_ops) > 0).any() and \
            ((np.asarray(kind) == INS) & (np.asarray(fwd) == 0)).any():
        ctx.release_tracker()
        raise UnsupportedTail("reversed insert run in zone")
    ids, ln, ol, orr, _st, ev = ctx.dump_tracker(keep_underwater=True)
    if len(ids) == 0:
        ctx.release_tracker()
        raise UnsupportedTail("empty conflict zone (pure fast-forward)")
    dl0, dl1, dt0, dt1, dfw = ctx.dump_del_rows()
    common = ctx.zone_common()
    prefix = ctx.merge_to_string("", [], common)[0] if common else ""
    ctx.release_tracker()
    arena_str = oplog.ops._arenas[INS].get((0, oplog.ops.arena_len(INS)))
    arena = np.frombuffer(arena_str.encode("utf-32-le"), dtype=np.int32)
    return TailColumns(
        ids=ids, ln=ln, ol=ol, orr=orr, ev=ev,
        del_lv0=dl0, del_lv1=dl1, del_t0=dt0, del_t1=dt1, del_fwd=dfw,
        prefix=prefix, union=tuple(int(x) for x in union), arena=arena)


def old_delete_intervals(cols: TailColumns, synced_to: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Target item intervals deleted by zone ops with LV < synced_to.

    The zone covers BOTH branches past the common ancestor, so its
    delete rows mix ops the session already applied (LV < synced_to —
    the log-prefix-frontier threshold, see gpu/xform.py) with
    concurrent/new ones. A straddling row [lv0, lv1) contributes only
    its old portion, direction-resolved per `del_fwd`. Returns
    (starts, ends) — possibly overlapping (double deletes)."""
    lv0, lv1 = cols.del_lv0, cols.del_lv1
    t0, t1, fw = cols.del_t0, cols.del_t1, cols.del_fwd
    m = np.minimum(lv1, synced_to)
    old = m > lv0
    k = (m - lv0)[old]
    starts = np.where(fw[old] != 0, t0[old], t1[old] - k)
    ends = np.where(fw[old] != 0, t0[old] + k, t1[old])
    return starts.astype(np.int64), ends.astype(np.int64)


def visibility_cuts(cols: TailColumns, synced_to: int) -> np.ndarray:
    """Extra item-run cut points that make per-run visibility
    all-or-nothing: the old/new insert threshold (synced_to), every
    delete-target boundary, and the old/new split point inside each
    straddling delete row."""
    cuts: List[np.ndarray] = [
        np.asarray([synced_to], dtype=np.int64),
        cols.del_t0.astype(np.int64), cols.del_t1.astype(np.int64)]
    lv0, lv1 = cols.del_lv0, cols.del_lv1
    straddle = (lv0 < synced_to) & (synced_to < lv1)
    if straddle.any():
        k = synced_to - lv0[straddle]
        cuts.append(np.where(cols.del_fwd[straddle] != 0,
                             cols.del_t0[straddle] + k,
                             cols.del_t1[straddle] - k).astype(np.int64))
    return np.unique(np.concatenate(cuts))
