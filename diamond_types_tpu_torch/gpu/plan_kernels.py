"""Device execution of fork/join merge plans: the plan tape, batched time
travel and batched origin queries.

Port of the JAX package's `tpu/plan_kernels.py` (X7 and the history path).
The dense state-matrix executor (`listmerge/dense.py`) is lowered to a flat
step tape: the fork/join schedule's Begin/Fork/Max steps plus every Apply's
journaled state writes, run on the device over the dense
`[n_indexes, n_slots]` state matrix, with the requested version rows
snapshotted along the way (`execute_tape`).

Two capabilities fall out of the state rows:

  * **Batched time travel.** `texts_at_versions` builds the document at
    MANY historical versions at once (the reference can only
    `checkout(version)` one at a time, rebuilding a tracker per call;
    src/list/oplog.rs:32). A version's document is "final order, filtered
    to row == 1": CRDT convergence makes every historical document a mask
    over one shared linearization. The text assembly is ONE call of kernel
    K3 (`kernels.materialize_runs`) over `[versions, n_slots]` with the
    order, the arena offsets and the arena as shared rows, so the arena is
    never copied per version.
  * **Batched origin resolution.** `origin_query` answers the position ->
    (origin_left, origin_right) queries of YjsMod integrate (reference:
    merge.rs:395-423) for a batch of inserts against one version row, with
    a prefix sum, a search and a suffix minimum.

The step tape is int32-only: slots are addressed by their rank in id-sorted
order (underwater ids are >= 1<<62 and stay on the host). Journal writes are
item-id RANGES captured at write time, so a later split only refines slots
inside an already-written range; states are monotone (the engine never
retreats), so range-max replay over the FINAL slot table reproduces every
intermediate row exactly.

Where the JAX package scans the tape with `lax.scan` (one step per tape
entry), `execute_tape` applies each run of consecutive WRITEs between two
structural steps (BEGIN, FORK, MAX, SNAP) as ONE batched update: a WRITE
changes one state row under `max`, so WRITEs between structural steps
commute. The batched update is a difference array over `[values, n_idx,
n_slots + 1]`, a cumulative sum and a `maximum`, in int32; rows are
returned as uint8, equal to the JAX package's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.span import UNDERWATER_START
from ..listmerge.columnar import arena_offset_columns
from ..listmerge.dense import DenseExecutor
from ..listmerge.plan2 import (APPLY, BEGIN, DROP, FORK, MAX, MergePlan2,
                               compile_plan2)
from . import kernels, resolve_device
from .flush_fuse import _pow2

# Tape opcodes.
T_WRITE = 0   # a=slot_lo, b=slot_hi (id-sorted ranks), c=state, d=row
T_BEGIN = 1   # a=idx
T_FORK = 2    # a=src, b=dest
T_MAX = 3     # a=dest, b=src
T_SNAP = 4    # a=row, b=snapshot slot in the output buffer


@dataclass
class PackedTape:
    op: np.ndarray        # [T] int32
    a: np.ndarray         # [T] int32
    b: np.ndarray         # [T] int32
    c: np.ndarray         # [T] int32
    d: np.ndarray         # [T] int32
    n_slots: int
    n_idx: int
    n_snaps: int
    is_base: np.ndarray   # [n_slots] uint8, id-sorted
    sorted_ids: np.ndarray    # [n_slots] int64 slot id-range starts
    sorted_lens: np.ndarray   # [n_slots] int64 slot lengths
    perm: np.ndarray      # [n_slots] int32: document order -> sorted rank
    snap_entries: List[int]   # entry index per snapshot slot


@dataclass
class TapeSource:
    """Slot table + write journal a tape can be packed from. Two builders:
    `source_from_executor` (the Python dense executor's own tables) and
    `source_native` (C++ tracker dump + delete-target rows, no Python
    execution of the zone at all)."""
    ids: np.ndarray       # [n_slots] int64 item-id range starts
    lens: np.ndarray      # [n_slots] int64
    is_base: np.ndarray   # [n_slots] uint8 (pre-zone / underwater slots)
    order: np.ndarray     # [n_slots] doc-order permutation into the above
    n_idx: int
    journal: list         # per-APPLY list of (id_lo, id_hi, state) writes


def source_from_executor(ex: DenseExecutor) -> TapeSource:
    assert ex.journal is not None, "executor must be run with journal=True"
    n = len(ex.slots)
    return TapeSource(
        ids=np.array([s.ids for s in ex.slots], dtype=np.int64),
        lens=np.array([len(s) for s in ex.slots], dtype=np.int64),
        is_base=np.asarray(ex.is_base[:n], dtype=np.uint8),
        order=np.asarray(ex.order, dtype=np.int64),
        n_idx=ex.n_idx, journal=ex.journal)


def source_native(oplog, plan: MergePlan2, from_frontier,
                  merge_frontier) -> TapeSource:
    """Build the tape source from the C++ engine: one native transform
    gives the final item table (document order) and the delete-target rows;
    the journal is derived from the op table (inserts) and those rows
    (deletes). Delete targets are intrinsic to each op, so the M1-walk-
    recorded rows are valid for the fork/join schedule too. The native
    items are RLE-merged, so they are split at every journal-write
    boundary to restore the alignment pack_plan_tape asserts."""
    from ..listmerge.dense import DELETED, INSERTED
    from ..native.core import get_native_ctx
    from ..text.op import INS

    ctx = get_native_ctx(oplog)
    ctx.transform([int(x) for x in from_frontier],
                  [int(x) for x in merge_frontier])
    common = ctx.zone_common()
    assert sorted(common) == sorted(plan.common), \
        "native transform and plan disagree on the conflict zone"
    ids, lens, *_rest = ctx.dump_tracker(keep_underwater=True)
    lv0, lv1, t0, t1, fwd = ctx.dump_del_rows()
    ctx.release_tracker()

    journal = []
    bounds = set()
    for en in plan.entries:
        writes = []
        for piece in oplog.ops.iter_range(en.span):
            if piece.kind == INS:
                writes.append((piece.lv, piece.lv + len(piece), INSERTED))
            else:
                a, b = piece.lv, piece.lv + len(piece)
                j = int(np.searchsorted(lv0, a, side="right")) - 1
                while a < b:
                    assert 0 <= j < len(lv0) and lv0[j] <= a < lv1[j], \
                        "delete op not covered by native del rows"
                    e = min(b, int(lv1[j]))
                    if fwd[j]:
                        tr = (int(t0[j]) + (a - int(lv0[j])),
                              int(t0[j]) + (e - int(lv0[j])))
                    else:
                        tr = (int(t1[j]) - (e - int(lv0[j])),
                              int(t1[j]) - (a - int(lv0[j])))
                    writes.append((tr[0], tr[1], DELETED))
                    a = e
                    j += 1
        for (lo, hi, _s) in writes:
            bounds.add(lo)
            bounds.add(hi)
        journal.append(writes)

    # Split the RLE-merged native items at write boundaries (doc order is
    # preserved: splits are adjacent).
    bs = np.array(sorted(bounds), dtype=np.int64)
    out_ids, out_lens = [], []
    for i in range(len(ids)):
        s, e = int(ids[i]), int(ids[i] + lens[i])
        lo = int(np.searchsorted(bs, s, side="right"))
        hi = int(np.searchsorted(bs, e, side="left"))
        prev = s
        for cut in bs[lo:hi]:
            out_ids.append(prev)
            out_lens.append(int(cut) - prev)
            prev = int(cut)
        out_ids.append(prev)
        out_lens.append(e - prev)
    oids = np.array(out_ids, dtype=np.int64)
    olens = np.array(out_lens, dtype=np.int64)
    return TapeSource(
        ids=oids, lens=olens,
        is_base=(oids >= UNDERWATER_START).astype(np.uint8),
        order=np.arange(len(oids), dtype=np.int64),
        n_idx=max(1, plan.indexes_used), journal=journal)


def pack_plan_tape(plan: MergePlan2, src, snapshot_entries: Sequence[int]
                   ) -> PackedTape:
    """Flatten a fork/join plan + a write journal into a device step tape.
    `src` is a TapeSource or a journal=True DenseExecutor."""
    if isinstance(src, DenseExecutor):
        src = source_from_executor(src)
    for e in snapshot_entries:
        if not 0 <= int(e) < len(plan.entries):
            raise IndexError(
                f"snapshot entry {e} out of range: plan has "
                f"{len(plan.entries)} conflict entries (a pure fast-forward "
                f"history has none — use oplog.checkout for those versions)")
    n_slots = len(src.ids)
    ids = src.ids
    lens = src.lens
    rank_order = np.argsort(ids, kind="stable")
    sorted_ids = ids[rank_order]
    sorted_lens = lens[rank_order]
    rank_of = np.empty(n_slots, dtype=np.int64)
    rank_of[rank_order] = np.arange(n_slots)
    ends = sorted_ids + sorted_lens

    def rank_range(lo: int, hi: int) -> Tuple[int, int]:
        a = int(np.searchsorted(sorted_ids, lo))
        b = int(np.searchsorted(sorted_ids, hi))
        assert a < b and sorted_ids[a] == lo and ends[b - 1] == hi, \
            "journal range not aligned to final slot boundaries"
        return a, b

    want = {int(e): i for i, e in enumerate(snapshot_entries)}
    op, aa, bb, cc, dd = [], [], [], [], []

    def emit(o, a=0, b=0, c=0, d=0):
        op.append(o); aa.append(a); bb.append(b); cc.append(c); dd.append(d)

    apply_i = 0
    for act in plan.actions:
        kind = act[0]
        if kind == BEGIN:
            emit(T_BEGIN, act[1])
        elif kind == FORK:
            emit(T_FORK, act[1], act[2])
        elif kind == MAX:
            emit(T_MAX, act[1], act[2])
        elif kind == DROP:
            pass
        elif kind == APPLY:
            for (lo, hi, state) in src.journal[apply_i]:
                ra, rb = rank_range(lo, hi)
                emit(T_WRITE, ra, rb, state, act[2])
            if act[1] in want:
                emit(T_SNAP, act[2], want[act[1]])
            apply_i += 1

    is_base = np.asarray(src.is_base, dtype=np.uint8)[rank_order]
    perm = rank_of[np.asarray(src.order, dtype=np.int64)].astype(np.int32)
    return PackedTape(
        op=np.array(op, dtype=np.int32), a=np.array(aa, dtype=np.int32),
        b=np.array(bb, dtype=np.int32), c=np.array(cc, dtype=np.int32),
        d=np.array(dd, dtype=np.int32), n_slots=n_slots, n_idx=src.n_idx,
        n_snaps=len(snapshot_entries), is_base=is_base,
        sorted_ids=sorted_ids, sorted_lens=sorted_lens, perm=perm,
        snap_entries=[int(e) for e in snapshot_entries])


def _segments(op: np.ndarray) -> List[Tuple[int, int]]:
    """The tape cut into [s, e) segments: each maximal run of WRITEs is
    one segment, each structural step one of its own."""
    is_w = op == T_WRITE
    # a segment starts at every structural step, and at a WRITE that
    # follows a structural step (or starts the tape)
    prev_w = np.concatenate([[False], is_w[:-1]])
    starts = np.flatnonzero(~is_w | ~prev_w)
    ends = np.append(starts[1:], len(op))
    return list(zip(starts.tolist(), ends.tolist()))


def execute_tape(op, a, b, c, d, is_base, n_slots: int, n_idx: int,
                 n_snaps: int,
                 device: Optional[Union[str, torch.device]] = None,
                 stats: Optional[dict] = None) -> torch.Tensor:
    """Run the packed schedule on `device` (None: CUDA). Returns the
    snapshot rows [n_snaps, n_slots] uint8, equal to the JAX package's
    `execute_tape_jax`.

    Shapes pad to powers of two as in the JAX package: padding tape steps
    are WRITEs with an empty slot range, padding slots are never written,
    and padding snapshot rows are sliced off before returning. The host
    walks the tape's segments (`_segments`): each run of WRITEs is one
    batched range-max update, each structural step one row operation.
    `stats`, when given, gets `segments`, `write_runs`, `structural`,
    `torch_calls` (the device operations issued, one kernel each) and
    `host_ms` (the host's time to issue them)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ns, ni = _pow2(n_slots), _pow2(n_idx)
    nq = _pow2(max(n_snaps, 1))
    T = _pow2(max(len(op), 1))

    def pad(x, n, fill=0):
        x = np.asarray(x)
        out = np.full(n, fill, dtype=np.int64)
        out[:len(x)] = x
        return out

    op, a, b, c, d = (pad(x, T) for x in (op, a, b, c, d))
    if ((op < T_WRITE) | (op > T_SNAP)).any():
        raise ValueError("unknown tape opcode")
    w = op == T_WRITE
    if ((c[w] < 0) | (c[w] > 255)).any():
        raise ValueError("a WRITE state must fit uint8")
    n_vals = int(c[w].max(initial=0)) + 1
    # every WRITE as two difference-array entries, +1 at (c, d, lo) and -1
    # at (c, d, hi), flattened over [n_vals, ni, ns + 1]; uploaded once
    lo = np.clip(a, 0, ns)
    hi = np.clip(np.maximum(b, a), 0, ns)
    row = (c * ni + np.clip(d, 0, ni - 1)) * (ns + 1)
    flat = np.stack([row + lo, row + hi], axis=1).reshape(-1)
    sign = np.tile(np.array([1, -1], dtype=np.int32), T)
    flat_d = torch.from_numpy(flat).to(dev)
    sign_d = torch.from_numpy(sign).to(dev)
    base = torch.from_numpy(pad(is_base, ns)).to(device=dev,
                                                  dtype=torch.int32)
    vals = torch.arange(n_vals, dtype=torch.int32, device=dev)[:, None, None]
    S = torch.zeros((ni, ns), dtype=torch.int32, device=dev)
    rows = torch.zeros((nq, ns), dtype=torch.int32, device=dev)
    diff = torch.empty(n_vals * ni * (ns + 1), dtype=torch.int32, device=dev)
    calls = 7
    segs = _segments(op)
    n_write = 0
    for s, e in segs:
        o = int(op[s])
        if o == T_WRITE:
            n_write += 1
            diff.zero_()
            diff.index_add_(0, flat_d[2 * s:2 * e], sign_d[2 * s:2 * e])
            cov = torch.cumsum(diff.view(n_vals, ni, ns + 1), dim=2,
                               dtype=torch.int32)[:, :, :ns] > 0
            S = torch.maximum(S, (cov * vals).amax(dim=0))
            calls += 7
        elif o == T_BEGIN:
            S[int(a[s])] = base
            calls += 1
        elif o == T_FORK:
            S[int(b[s])] = S[int(a[s])]
            calls += 1
        elif o == T_MAX:
            S[int(a[s])] = torch.maximum(S[int(a[s])], S[int(b[s])])
            calls += 2
        else:
            rows[int(b[s])] = S[int(a[s])]
            calls += 1
    out = rows[:n_snaps, :n_slots].to(torch.uint8)
    if stats is not None:
        stats.update(segments=len(segs), write_runs=n_write,
                     structural=len(segs) - n_write, torch_calls=calls + 1,
                     host_ms=1e3 * (time.perf_counter() - t0))
    return out


def snapshot_rows(oplog, from_frontier: Sequence[int],
                  merge_frontier: Optional[Sequence[int]] = None,
                  entries: Optional[Sequence[int]] = None,
                  source: str = "python",
                  device: Optional[Union[str, torch.device]] = None,
                  stats: Optional[dict] = None):
    """Compile + journal (host) + device-replay a merge, returning
    (plan, source, tape, rows) where rows[i] (uint8, on `device`) is the
    state row at snapshot entry i's version.

    source="python" runs the dense executor for the journal (it also
    yields slot origins, which the origin-query tests use); source="native"
    gets the journal from one C++ transform + the delete-target rows, with
    no Python execution of the zone. `stats`, when given, gets the host
    milliseconds of each part (`compile_ms`, `source_ms`, `pack_ms`) and
    `execute_tape`'s under `tape`."""
    dev = resolve_device(device)
    merge = list(oplog.version) if merge_frontier is None \
        else list(merge_frontier)
    t = time.perf_counter()
    plan = compile_plan2(oplog.cg.graph, list(from_frontier), merge)
    t1 = time.perf_counter()
    if source == "native":
        ex = source_native(oplog, plan, list(from_frontier), merge)
    elif source == "python":
        ex = DenseExecutor(plan, oplog.cg.agent_assignment, oplog.ops,
                           journal=True)
        for _ in ex.run():
            pass
    else:
        raise ValueError(f"unknown source {source!r}: use 'python' or "
                         f"'native'")
    t2 = time.perf_counter()
    if entries is None:
        entries = range(len(plan.entries))
    tape = pack_plan_tape(plan, ex, list(entries))
    t3 = time.perf_counter()
    tape_stats: dict = {}
    rows = execute_tape(tape.op, tape.a, tape.b, tape.c, tape.d,
                        tape.is_base, n_slots=tape.n_slots,
                        n_idx=tape.n_idx, n_snaps=tape.n_snaps, device=dev,
                        stats=tape_stats)
    if stats is not None:
        stats.update(compile_ms=1e3 * (t1 - t), source_ms=1e3 * (t2 - t1),
                     pack_ms=1e3 * (t3 - t2), tape=tape_stats,
                     entries=len(plan.entries), steps=len(tape.op),
                     n_slots=tape.n_slots, n_idx=tape.n_idx)
    return plan, ex, tape, rows


def entry_frontier(graph, plan: MergePlan2, k: int) -> List[int]:
    """The version frontier reached by entry k: zone common ancestor plus
    every in-zone ancestor entry plus k itself."""
    tips = list(plan.common)
    seen = set()
    stack = [k]
    while stack:
        e = stack.pop()
        if e in seen:
            continue
        seen.add(e)
        tips.append(plan.entries[e].span[1] - 1)
        stack.extend(plan.entries[e].parents)
    return list(graph.find_dominators(tips))


# ---- batched time travel -------------------------------------------------

def version_tables(oplog, plan: MergePlan2, tape: PackedTape):
    """The shared rows of the history's text assembly: (perm [n_slots],
    text_len [n_slots] in id-sorted order, char_off [n_slots], arena
    [pool >= 1]), int32 numpy. Underwater slots are clipped to the text
    at the zone's common ancestor, whose chars lead the arena."""
    from ..text.op import INS
    base_text = oplog.checkout(plan.common).snapshot()
    plen = len(base_text)
    sid, slen = tape.sorted_ids, tape.sorted_lens
    uw = sid >= UNDERWATER_START
    uw_off = np.where(uw, sid - UNDERWATER_START, 0)
    text_len = np.where(
        uw, np.maximum(0, np.minimum(uw_off + slen, plen) - uw_off),
        slen).astype(np.int32)
    arena_str = oplog.ops._arenas[INS].get((0, oplog.ops.arena_len(INS)))
    arena = np.frombuffer((base_text + arena_str).encode("utf-32-le"),
                          dtype=np.int32).copy()
    char_off = np.where(uw, uw_off,
                        plen + arena_offset_columns(
                            oplog, np.where(uw, 0, sid))).astype(np.int32)
    return (tape.perm.astype(np.int32), text_len, char_off,
            arena if len(arena) else np.zeros(1, np.int32))


def texts_at_versions(oplog, entries: Sequence[int],
                      from_frontier: Sequence[int] = (),
                      source: str = "python",
                      merge_frontier: Optional[Sequence[int]] = None,
                      devices: Optional[Sequence] = None,
                      device: Optional[Union[str, torch.device]] = None,
                      stats: Optional[dict] = None) -> List[str]:
    """The document at many historical versions (one per snapshot entry):
    one tape replay (`snapshot_rows`) gives every version's state row, and
    ONE call of K3 (`kernels.materialize_runs`) lays out every version as
    a visibility mask over the shared final-order linearization: the
    version axis is K3's batch, and the order, the arena offsets and the
    arena are shared rows.

    Reference equivalent: N separate `oplog.checkout(version)` calls, each
    a full tracker replay (src/list/oplog.rs:32). `devices` (the JAX
    package's `version_sharding`) splits the version axis over several
    devices, one K3 call on each; the tape runs on the first. `stats`, when
    given, gets `snapshot_rows`' parts, `tables_ms` (host), `k3_calls`,
    `k3_ms` (host time from the rows to the texts on the host: the K3
    calls, the copies and the decode), `cap` and `versions`."""
    devs = [resolve_device(d) for d in devices] if devices else \
        [resolve_device(device)]
    plan, _ex, tape, rows = snapshot_rows(oplog, from_frontier,
                                          merge_frontier=merge_frontier,
                                          entries=entries, source=source,
                                          device=devs[0], stats=stats)
    t = time.perf_counter()
    perm, text_len, char_off, arena = version_tables(oplog, plan, tape)
    t1 = time.perf_counter()
    n_real = rows.shape[0]
    if n_real == 0:
        return []
    tl = torch.from_numpy(text_len).to(devs[0])
    vis = torch.where(rows == 1, tl[None, :], 0).to(torch.int32)
    cap = _pow2(max(1, int(vis.sum(dim=1, dtype=torch.int64).max())))
    per = -(-n_real // len(devs))
    texts, totals = [], []
    for k, dev in enumerate(devs):
        part = vis[k * per:(k + 1) * per]
        if part.shape[0] == 0:
            continue
        shared = [torch.from_numpy(x).to(dev)[None]
                  for x in (perm, char_off, arena)]
        txt, tot = kernels.materialize_runs(shared[0], part.to(dev),
                                            shared[1], shared[2], cap)
        texts.append(txt.cpu().numpy())
        totals.append(tot.cpu().numpy())
    texts_h, totals_h = np.concatenate(texts), np.concatenate(totals)
    out = [texts_h[i, :totals_h[i]].tobytes().decode("utf-32-le")
           for i in range(n_real)]
    if stats is not None:
        stats.update(tables_ms=1e3 * (t1 - t), k3_calls=len(texts),
                     k3_ms=1e3 * (time.perf_counter() - t1), cap=cap,
                     versions=n_real)
    return out


# ---- batched origin resolution ------------------------------------------

def origin_query(row_ord: torch.Tensor, len_ord: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Batched YjsMod origin queries against one version row, int32
    throughout (the JAX package's `origin_query_jax`).

    row_ord [n]: the version's slot states in DOCUMENT order (0/1/2).
    len_ord [n]: slot char lengths in document order (underwater clipped
                 to real text so int32 prefix sums cannot overflow).
    positions [q]: insert positions (chars) in the version's visible doc.

    Returns (ol_j, ol_off, orr_j, orr_off): document-order slot index and
    in-slot offset of origin_left (the pos-1'th visible char; ol_j == -1
    for pos == 0 / ROOT) and origin_right (the next char at or after the
    cursor whose slot is NOT NotInsertedYet; orr_j == -1 for end-of-doc),
    the neighbour pair the M1 tracker extracts per insert with a tree
    descent + rightward scan (reference: merge.rs:395-423)."""
    row_ord = row_ord.to(torch.int32)
    len_ord = len_ord.to(torch.int32)
    positions = positions.to(device=row_ord.device, dtype=torch.int32)
    n = row_ord.shape[0]
    vis_len = torch.where(row_ord == 1, len_ord, 0)
    cvis = torch.cumsum(vis_len, dim=0, dtype=torch.int32)

    # origin_left: slot containing visible char pos-1.
    p = positions - 1
    j = torch.searchsorted(cvis, p, right=True, out_int32=True)
    jc = j.clamp(0, n - 1).long()
    ol_off = p - (cvis[jc] - vis_len[jc])
    ol_j = torch.where(positions == 0, -1, jc.to(torch.int32))

    # origin_right: the cursor sits after origin_left; the next non-NIY
    # char. Within a visible slot the next char is right there; otherwise
    # scan forward to the next slot with state != NIY (a suffix min).
    idx = torch.arange(n, dtype=torch.int32, device=row_ord.device)
    nxt = lazy_cummin(torch.where(row_ord != 0, idx, n).flip(0)).flip(0)
    in_slot = (positions != 0) & (ol_off + 1 < len_ord[jc])
    scan_from = torch.where(positions == 0, 0, jc.to(torch.int32) + 1
                            ).clamp(0, n).long()
    nxt_pad = torch.cat([nxt, torch.full((1,), n, dtype=torch.int32,
                                         device=row_ord.device)])
    far_j = nxt_pad[scan_from]
    orr_j = torch.where(in_slot, jc.to(torch.int32), far_j)
    orr_off = torch.where(in_slot, ol_off + 1, 0).to(torch.int32)
    orr_j = torch.where(orr_j >= n, -1, orr_j)
    return ol_j, ol_off.to(torch.int32), orr_j, orr_off


def lazy_cummin(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running minimum along the first axis (the JAX package's
    `jax_lazy_cummin`, an associative scan)."""
    return torch.cummin(x, dim=0).values
