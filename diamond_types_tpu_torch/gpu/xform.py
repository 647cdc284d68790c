"""Device tail transform: `plan_tail` for a bucket of sessions, with the
concurrent-order resolution on the device.

Port of the JAX package's `tpu/xform.py`. `FusedDocSession.plan_tail()`
resolves every pending op's merge position with the host tracker walk, one
Python step per op. Here the bucket's op tails become columnar DAG arrays
(`listmerge/columnar.py`) and the order and positions are resolved on the
device, batched over the bucket:

  host   extract_tail(sess)        [under the oplog guard]
           one native transform -> tracker item runs + delete-target rows
           -> visibility-granular splits -> Fugue tree arrays
           (parent/side/keys) + old/new visible-length columns
  device resolve_positions(...)    [outside the oplog guard]
           `fugue_linearize` over the bucket's [b, n] rows, then the
           position scans of kernel K2 (`kernels.xform_positions`) in one
           launch for the whole bucket

Old visibility is a pure LV threshold: a fused session's frontier is always
the oplog version at log length `synced_to`, so `lv < synced_to` iff the
op is causally at or before the frontier. With `DT_XFORM_VALIDATE` set,
`extract_tail` proves that on the session's device for every LV
(`validate_prefix_frontier`, over the graph kernels) and raises when it
fails.

The edit script is emitted in DOCUMENT order (delete old-only runs, insert
new-only runs, positions = exclusive prefix sum of new visible lengths),
which reaches the same text as the host's causal-order script;
`plan.new_len` / `max_len` describe THIS script, so the replay's length
fence applies unchanged. Four tail shapes are outside the device contract
and are host-planned on purpose: an empty tail, an `UnsupportedTail`
(reversed insert run, empty conflict zone), a Σold_vis != doc_len
disagreement, and an insert without stored content. The only other host
rung is a device/host new-length disagreement at assembly.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs.devprof import note_transfer
from ..listmerge.columnar import (UnsupportedTail, agent_key_columns,
                                  arena_offset_columns, export_tail_columns,
                                  old_delete_intervals, visibility_cuts)
from . import kernels, resolve_device
from .flush_fuse import TailPlan, _empty_plan, _pow2
from .linearize import (UNDERWATER, build_tree_np, fugue_linearize,
                        resolve_pos_keys, split_runs_at_anchors)

INT32_MAX = np.iinfo(np.int32).max


class LengthMismatch(Exception):
    """The device's projected length disagrees with the host visibility
    sum: the document is host-planned instead."""


@dataclass
class TailExtract:
    """Host half of one doc's device plan: Fugue tree arrays + visibility
    columns, self-contained (no oplog access needed after extraction, so
    the device half runs outside the oplog guard)."""
    parent: np.ndarray     # [k] int64, parent == k -> virtual root
    side: np.ndarray       # [k] int8
    key_pos: np.ndarray    # [k] int64
    key_agent: np.ndarray  # [k] int64
    key_seq: np.ndarray    # [k] int64
    old_vis: np.ndarray    # [k] int32 chars visible at the session frontier
    new_vis: np.ndarray    # [k] int32 chars visible after the merge
    aoff: np.ndarray       # [k] int64 insert-arena char offsets
    arena: np.ndarray      # int32 char codes (whole insert arena)
    doc_len: int
    max_ins: int
    frontier: Tuple[int, ...]
    synced_to: int

    @property
    def n(self) -> int:
        return len(self.parent)


def extract_tail(sess) -> Union[TailExtract, TailPlan]:
    """Host half of the device plan for one FusedDocSession. Must be
    called under the oplog guard (native transform + column reads).

    Returns a TailExtract for the device resolver, or, when the tail is
    outside the device contract, the host `plan_tail()` result."""
    ol = sess.oplog
    if sess.synced_to >= len(ol):
        return sess.plan_tail()          # empty tail: host fast path
    try:
        cols = export_tail_columns(ol, sess.frontier)
    except UnsupportedTail:
        return sess.plan_tail()
    synced_to = len(ol)
    plen = len(cols.prefix)

    cuts = visibility_cuts(cols, sess.synced_to)
    s_ids, s_len, s_ol, s_orr, s_ev = split_runs_at_anchors(
        cols.ids, cols.ln, cols.ol, cols.orr, (cols.ev,), extra_cuts=cuts)
    agent, seq = agent_key_columns(ol, s_ids)
    parent, side, ka, ks, orr_run = build_tree_np(s_ids, s_len, s_ol, s_orr,
                                                  agent, seq)
    kp = resolve_pos_keys(parent, side, ka, ks, orr_run)

    uw = s_ids >= UNDERWATER
    uw_text = np.maximum(
        0, np.minimum(s_ids + s_len, UNDERWATER + plen) - s_ids)
    text_len = np.where(uw, uw_text, s_len)
    # new visibility: merged-to-union rule, identical to prepare_doc
    new_vis = np.where(s_ev != 0, 0, text_len)
    # old visibility: inserted at-or-before the session frontier (uw
    # spine, or lv under the threshold) and not deleted by an op under
    # the threshold. Runs are cut at every delete-target boundary and at
    # each straddling row's old/new split point, so coverage at the run
    # START decides the whole run.
    d0, d1 = old_delete_intervals(cols, sess.synced_to)
    cov = (np.searchsorted(np.sort(d0), s_ids, side="right")
           - np.searchsorted(np.sort(d1), s_ids, side="right"))
    old_ins = uw | (s_ids < sess.synced_to)
    old_vis = np.where(old_ins & (cov == 0), text_len, 0)

    if int(old_vis.sum(dtype=np.int64)) != sess.doc_len:
        # our model of the resident text disagrees with the session:
        # never guess, host-plan instead
        return sess.plan_tail()
    aoff = arena_offset_columns(ol, np.where(uw, 0, s_ids))
    ins_run = (new_vis > 0) & (old_vis == 0)
    if (aoff[ins_run] < 0).any():
        return sess.plan_tail()          # insert without stored content
    if os.environ.get("DT_XFORM_VALIDATE") and not validate_prefix_frontier(
            ol, sess.frontier, sess.synced_to, device=sess.device):
        raise AssertionError("log-prefix-frontier contract violated "
                             "(device reachability)")
    return TailExtract(
        parent=parent, side=side, key_pos=kp, key_agent=ka, key_seq=ks,
        old_vis=old_vis.astype(np.int32), new_vis=new_vis.astype(np.int32),
        aoff=aoff, arena=cols.arena, doc_len=sess.doc_len,
        max_ins=sess.max_ins, frontier=cols.union, synced_to=synced_to)


# ---------------------------------------------------------------------------
# device half: batched order + position resolution
# ---------------------------------------------------------------------------

def xform_shape_class(extracts: Sequence[TailExtract]) -> Tuple[int, int]:
    """(b, n) a bucket of extracts pads to: powers of two."""
    b = len(extracts)
    return (_pow2(b) if b > 1 else 1,
            _pow2(max(max(ex.n for ex in extracts), 1)))


def resolve_positions(extracts: Sequence[TailExtract],
                      device: Optional[Union[str, torch.device]] = None
                      ) -> List[Optional[TailPlan]]:
    """Device half: every extract's document order and positions in one
    batched pass (`fugue_linearize`, then one K2 launch on CUDA, or K2's
    plain version on the CPU), then TailPlans assembled on the host. Runs
    outside the oplog guard: extracts are self-contained. `device=None`
    means CUDA and raises without it.

    A doc whose device length disagrees with its host visibility sum
    comes back as None; the caller host-plans it. Padding rows carry
    parent = root, side 1, INT32_MAX keys and zero visibility, so they
    linearize last and contribute no positions."""
    device = resolve_device(device)
    if not extracts:
        return []
    bp, n = xform_shape_class(extracts)
    parent = np.full((bp, n), n, np.int32)
    side = np.ones((bp, n), np.int32)
    kp = np.full((bp, n), INT32_MAX, np.int32)
    ka = np.full((bp, n), INT32_MAX, np.int32)
    ks = np.full((bp, n), INT32_MAX, np.int32)
    ov = np.zeros((bp, n), np.int32)
    nv = np.zeros((bp, n), np.int32)
    for i, ex in enumerate(extracts):
        k = ex.n
        parent[i, :k] = np.where(ex.parent == k, n, ex.parent)
        side[i, :k] = ex.side
        kp[i, :k] = ex.key_pos
        ka[i, :k] = ex.key_agent
        ks[i, :k] = ex.key_seq
        ov[i, :k] = ex.old_vis
        nv[i, :k] = ex.new_vis
    parent, side, kp, ka, ks, ov, nv = (
        torch.from_numpy(a).to(device)
        for a in (parent, side, kp, ka, ks, ov, nv))
    # untagged, as in the JAX package: the resolve's seven [bp, n] columns
    note_transfer(sum(a.nbytes for a in (parent, side, kp, ka, ks, ov,
                                          nv)))
    perm = fugue_linearize(parent, side, kp, ka, ks)
    pl = perm.long()
    pos, new_len, peak = kernels.xform_positions(nv.gather(1, pl),
                                                 ov.gather(1, pl))
    perm_d, pos_d, len_d, peak_d = (x.cpu().numpy()
                                    for x in (perm, pos, new_len, peak))

    plans: List[Optional[TailPlan]] = []
    for i, ex in enumerate(extracts):
        try:
            plans.append(_assemble_plan(ex, perm_d[i], pos_d[i],
                                        int(len_d[i]), int(peak_d[i])))
        except LengthMismatch:
            plans.append(None)
    return plans


def _assemble_plan(ex: TailExtract, perm: np.ndarray, pos: np.ndarray,
                   new_len: int, peak: int) -> TailPlan:
    """Pack one doc's device-resolved order into TailPlan rows (doc-order
    edit script, ops chunked to max_ins like the host packer)."""
    if new_len != int(ex.new_vis.sum(dtype=np.int64)):
        raise LengthMismatch(f"device new length {new_len}, host "
                             f"{int(ex.new_vis.sum(dtype=np.int64))}")
    mi = ex.max_ins
    rows: List[Tuple[int, int, int, Optional[np.ndarray]]] = []
    for j in range(ex.n):
        r = int(perm[j])
        ov_r = int(ex.old_vis[r])
        nv_r = int(ex.new_vis[r])
        if ov_r == nv_r:
            continue
        p = int(pos[j])
        if nv_r == 0:                      # delete the old-only run
            d = ov_r
            while d:
                step = min(d, mi)
                rows.append((p, step, 0, None))
                d -= step
        else:                              # insert the new-only run
            a = int(ex.aoff[r])
            off = 0
            while off < nv_r:
                step = min(nv_r - off, mi)
                rows.append((p + off, 0, step,
                             ex.arena[a + off:a + off + step]))
                off += step
    n_rows = len(rows)
    if n_rows == 0:
        return _empty_plan(ex.frontier, ex.synced_to, ex.doc_len, mi)
    pos_a = np.zeros(n_rows, np.int32)
    dl_a = np.zeros(n_rows, np.int32)
    il_a = np.zeros(n_rows, np.int32)
    ch_a = np.zeros((n_rows, mi), np.int32)
    for i, (p, d, il, ch) in enumerate(rows):
        pos_a[i] = p
        dl_a[i] = d
        il_a[i] = il
        if il:
            ch_a[i, :il] = ch
    return TailPlan(pos_a, dl_a, il_a, ch_a, n_rows, new_len,
                    ex.doc_len + peak, ex.frontier, ex.synced_to)


def plan_tails_device(sessions: Sequence, oplog_lock=None
                      ) -> Tuple[List[TailPlan], dict]:
    """The device plan over a bucket of sessions (all on one device): host
    extracts under the oplog guard, one device resolve outside it, per-doc
    host plans for the tails outside the device contract. Returns (plans,
    one per session, and stats: device_docs, host_docs, fallbacks, and
    batches, the number of resolves)."""
    guard = oplog_lock if oplog_lock is not None else contextlib.nullcontext()
    with guard:
        halves = [extract_tail(s) for s in sessions]
    extracts = [(i, h) for i, h in enumerate(halves)
                if isinstance(h, TailExtract)]
    stats = {"device_docs": 0, "host_docs": len(halves) - len(extracts),
             "fallbacks": 0, "batches": 1 if extracts else 0}
    plans: List[Optional[TailPlan]] = [
        h if isinstance(h, TailPlan) else None for h in halves]
    if extracts:
        resolved = resolve_positions([h for _, h in extracts],
                                     device=sessions[extracts[0][0]].device)
        for (i, _), plan in zip(extracts, resolved):
            plans[i] = plan
    for i, plan in enumerate(plans):
        if plan is None:
            stats["fallbacks"] += 1
            with guard:
                plans[i] = sessions[i].plan_tail()
        elif isinstance(halves[i], TailExtract):
            stats["device_docs"] += 1
    return plans, stats


def validate_prefix_frontier(oplog, frontier: Sequence[int], synced_to: int,
                             targets: Optional[np.ndarray] = None,
                             device: Optional[Union[str, torch.device]] = None
                             ) -> bool:
    """Prove the log-prefix-frontier threshold with the device DAG
    reachability kernel (`gpu/graph_kernels.py`) on `device` (None:
    CUDA): `lv < synced_to  <=>  frontier contains lv`, for every LV (or a
    caller-chosen sample). This is the property the transform's
    old-visibility column rests on."""
    from .graph_kernels import frontier_contains_lv, pack_graph

    n = len(oplog)
    if n == 0:
        return int(synced_to) == 0
    packed = pack_graph(oplog.cg.graph, device)
    if targets is None:
        targets = np.arange(n, dtype=np.int32)
    fr = sorted(int(x) for x in frontier)
    fr_a = torch.tensor(fr if fr else [-1], dtype=torch.int32)
    got = frontier_contains_lv(
        packed, fr_a, torch.from_numpy(np.asarray(targets, np.int32)))
    want = np.asarray(targets) < int(synced_to)
    return bool((got.cpu().numpy() == want).all())
