"""Host-reference executor for device origin extraction (NumPy).

Copy of the JAX package's `listmerge/zone_np.py`. This is the
sequential-entry, batched-within-entry merge algorithm that
gpu/zone_kernel.py packs into one step tape (run on the card by
csrc/zone_tape.cu). Everything here is the exact computation the device
runs — kept in NumPy as (a) the correctness oracle for the kernel and (b)
the documentation of the algorithm.

The merge engine family it joins (all byte-identical on the corpora):
  M1 Python/C++ (tracker walk), fork/join dense (plan2 + state matrix),
  device tape (plan_kernels) — and this: a per-CHAR engine where the
  host does only plan compilation + entry composition (compose.py) and the
  whole conflict zone resolves origins against state rows.

Per-char state (W = prefix chars + zone insert chars):
  state [n_idx, W] u8   0 NotInsertedYet / 1 Inserted / 2 Deleted lattice
  rank  [W]             current document-order rank; unplaced = sentinel
  ord   [m]             rank -> char slot (prefix chars pre-placed)
  ever  [W] u8          ever-deleted flag (final visibility = ever == 0)
  p_id/sd/ol_id/orr_id  fugue-tree metadata per placed char, used by the
                        YjsMod sibling window scan of later entries

Per entry (one plan APPLY): resolve the composed queries against the
entry's state row with two prefix sums (origin_left = c'th visible char,
origin_right = next non-NIY — reference: merge.rs:395-423), place each
block with the vectorized sibling stop-scan (reference: integrate,
merge.rs:154-278 — the stop conditions mirror the Fugue-tree sibling sort
of gpu/linearize.py, validated against it by fuzz), bump ranks, write
Inserted/Deleted states into the row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..text.op import INS
from .compose import (K_LEFTJOIN, K_OWN, K_ROOT, ComposedEntry,
                      assemble_prefix, compose_plan)
from .plan2 import APPLY, BEGIN, DROP, FORK, MAX, MergePlan2, compile_plan2

BIG = np.int64(1) << 40


@dataclass
class ZonePrep:
    """Everything the host prepares for a zone execution (pure control
    flow + text-pool assembly; no merge engine anywhere)."""
    plan: MergePlan2
    composed: List[ComposedEntry]
    prefix: str
    plen: int
    W: int                    # total char slots
    ins_lv0: np.ndarray       # zone insert-run starts (sorted)
    ins_cum: np.ndarray       # cumulative insert chars before each run
    pool: np.ndarray          # int32 [W] char codes by slot
    agent_k: np.ndarray       # int64 [W] agent name rank (-1 prefix)
    seq_k: np.ndarray         # int64 [W] agent-local seq
    # native handle for the C++ tape packer (None = Python pack); set by
    # prepare_zone when the oplog has a native context
    native_ctx: object = None
    # compose-cache identity at prepare time (0 = no native compose);
    # the packer only reads the ctx cache when this still matches
    compose_serial: int = 0
    # back-reference for lazy composed-entry fetch (get_composed)
    oplog: object = None

    def get_composed(self):
        """The per-entry composition results, fetched lazily: the
        flagship device path (prepare -> native pack -> execute) never
        needs them Python-side, so prepare_zone(fetch_composed=False)
        skips the column round-trip; consumers that DO need them
        (ZoneExec, the Python packer, sessions) land here."""
        if self.composed is None:
            self.composed = compose_plan(self.oplog, self.plan)
        return self.composed


def _slot_of(prep: ZonePrep, lvs: np.ndarray) -> np.ndarray:
    """Map zone insert LVs to char slots (prefix chars are slots
    0..plen-1; insert chars follow in LV order)."""
    lvs = np.asarray(lvs, dtype=np.int64)
    j = np.searchsorted(prep.ins_lv0, lvs, side="right") - 1
    return prep.plen + prep.ins_cum[j] + (lvs - prep.ins_lv0[j])


def prepare_zone(oplog, from_frontier: Sequence[int] = (),
                 merge_frontier: Optional[Sequence[int]] = None,
                 prefix: Optional[str] = None,
                 pin_lvs: Sequence[int] = (),
                 fetch_composed: bool = True) -> ZonePrep:
    """Host pass: plan + composition + slot/pool/key tables.

    `prefix` overrides the doc at the zone's common ancestor (an
    incremental caller that already holds it skips the replay).
    `pin_lvs` threads through to compile_plan2 (state rows kept alive at
    those versions — device sessions resume from them)."""
    from .columnar import agent_key_columns as _agent_keys

    merge = list(oplog.version) if merge_frontier is None \
        else list(merge_frontier)
    plan = compile_plan2(oplog.cg.graph, list(from_frontier), merge,
                         pin_lvs=tuple(pin_lvs))

    if prefix is None:
        if not plan.entries:
            # pure linear fast-forward: the prefix IS the document
            prefix = assemble_prefix(oplog, plan.ff_spans)
        elif not plan.common:
            prefix = ""   # fully concurrent from the dawn of time
        else:
            # The zone's base is the doc at its common ancestor — NOT the
            # fast-forward end: when history forks below the ff tip, the
            # recomputed zone re-covers the ops between common and the tip
            # (compile_plan2 visit2), so the prefix must stop at common.
            # Computed with this same engine, recursively (the recursion
            # bottoms out in pure-ff or empty-common plans).
            prefix, _ = zone_checkout_np(oplog, (), list(plan.common))
    # compose LAST: the prefix recursion above may run compose_plan for
    # its own zone, and the native packer reads the ctx's compose cache —
    # composing here leaves THIS plan's entries as the cached set. With
    # fetch_composed=False only the native cache is populated (the
    # column round-trip to Python is deferred to get_composed).
    from ..native import native_ctx_or_none
    nctx = native_ctx_or_none(oplog)
    composed = None
    serial = 0
    if not fetch_composed and nctx is not None:
        spans = [en.span for en in plan.entries]
        if nctx.compose_cache_only(spans):
            serial = nctx.compose_serial()
    if serial == 0:
        composed = compose_plan(oplog, plan)
        if nctx is not None:
            serial = nctx.compose_serial()
    plen = len(prefix)

    # zone insert runs -> slot map + pool (C++ when available: this was
    # a ~50k-piece Python loop on node_nodecc)
    cols = nctx.zone_ins_runs([en.span for en in plan.entries]) \
        if nctx is not None and plan.entries else None
    if not plan.entries:
        cols = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    if cols is not None:
        ins_lv0, ins_len, ins_cp = cols
    else:
        lv0: List[int] = []
        lens: List[int] = []
        cps: List[int] = []
        for en in plan.entries:
            for piece in oplog.ops.iter_range(en.span):
                if piece.kind == INS:
                    assert piece.content_pos is not None, \
                        "zone insert without stored content"
                    lv0.append(piece.lv)
                    lens.append(len(piece))
                    cps.append(piece.content_pos[0])
        ins_lv0 = np.asarray(lv0, dtype=np.int64)
        ins_len = np.asarray(lens, dtype=np.int64)
        ins_cp = np.asarray(cps, dtype=np.int64)
    order = np.argsort(ins_lv0, kind="stable")
    ins_lv0, ins_len, ins_cp = ins_lv0[order], ins_len[order], ins_cp[order]
    ins_cum = np.concatenate([[0], np.cumsum(ins_len)])[:-1]
    n_ins = int(ins_len.sum())
    W = plen + n_ins

    prefix_arr = np.frombuffer(prefix.encode("utf-32-le"), dtype=np.int32)
    arena_str = oplog.ops._arenas[INS].get((0, oplog.ops.arena_len(INS)))
    arena = np.frombuffer(arena_str.encode("utf-32-le"), dtype=np.int32)
    pool = np.empty(W, dtype=np.int32)
    pool[:plen] = prefix_arr
    if n_ins:
        run_of = np.repeat(np.arange(len(ins_len)), ins_len)
        off_in_run = np.arange(n_ins) - ins_cum[run_of]
        pool[plen:] = arena[ins_cp[run_of] + off_in_run]

    agent_k = np.full(W, -1, dtype=np.int64)
    seq_k = np.zeros(W, dtype=np.int64)
    if n_ins:
        lvs = ins_lv0[run_of] + off_in_run
        a, s = _agent_keys(oplog, lvs)
        agent_k[plen:] = a
        seq_k[plen:] = s
    seq_k[:plen] = np.arange(plen)   # prefix spine order key (unused)

    return ZonePrep(plan=plan, composed=composed, prefix=prefix, plen=plen,
                    W=W, ins_lv0=ins_lv0, ins_cum=ins_cum, pool=pool,
                    agent_k=agent_k, seq_k=seq_k, native_ctx=nctx,
                    compose_serial=serial, oplog=oplog)


class ZoneExec:
    """Sequential NumPy execution of a prepared zone."""

    def __init__(self, prep: ZonePrep):
        self.prep = prep
        W, plen = prep.W, prep.plen
        n_idx = max(1, prep.plan.indexes_used)
        self.state = np.zeros((n_idx, W), dtype=np.uint8)
        self.base_row = np.zeros(W, dtype=np.uint8)
        self.base_row[:plen] = 1
        self.rank = np.full(W, BIG, dtype=np.int64)
        self.rank[:plen] = np.arange(plen)
        self.ord = np.arange(plen, dtype=np.int64)
        self.ever = np.zeros(W, dtype=np.uint8)
        # per-placed-char origins: everything the YjsMod comparisons need
        # (prefix chars never appear inside scan windows — they are
        # non-NIY in every row — so only zone chars' values are read)
        self.ol_id = np.full(W, -2, dtype=np.int64)
        self.ol_id[:plen] = np.arange(plen) - 1   # prefix spine chain
        self.orr_id = np.full(W, -1, dtype=np.int64)

    # ---- per-entry resolution -------------------------------------------

    def _resolve_queries(self, snap: np.ndarray, cursors: List[int]):
        """(a_rank, ol_char, b_rank, orr_char) per cursor coord."""
        ordv = self.ord
        m = len(ordv)
        s_r = snap[ordv]
        vis_r = s_r == 1
        cum = np.cumsum(vis_r)
        nonniy_pos = np.flatnonzero(s_r != 0)
        out = []
        for c in cursors:
            if c == 0:
                a_rank, ol_char = -1, -1
            else:
                j = int(np.searchsorted(cum, c, side="left"))
                assert j < m and vis_r[j] and cum[j] == c, \
                    "cursor beyond entry document"
                a_rank, ol_char = j, int(ordv[j])
            k = int(np.searchsorted(nonniy_pos, a_rank, side="right"))
            if k < len(nonniy_pos):
                b_rank = int(nonniy_pos[k])
                orr_char = int(ordv[b_rank])
            else:
                b_rank, orr_char = m, -1
            out.append((a_rank, ol_char, b_rank, orr_char))
        return out

    def _place_block(self, q: Tuple[int, int, int, int], root_slot: int
                     ) -> Tuple[int, int]:
        """YjsMod integrate in rank space (reference: merge.rs:154-278),
        vectorized. Every window char is NotInsertedYet in the entry's row
        (origin-right is the first non-NIY, so the window holds only
        concurrent items — the reference debug-asserts exactly this).
        Per other item o, comparing origin-left positions (= ranks):
          * rank(o.ol) < rank(our ol): break — insert here ("top row")
          * rank(o.ol) > rank(our ol): skip ("bottom row")
          * equal gap: same origin-right char -> order by agent name rank
            then seq (break if we sort first, else scanning=false);
            different -> scanning = rank(o.orr) < rank(our orr),
            remembering where the current scanning streak began.
        Final position: the break point, rolled back to the streak start
        if `scanning` was still set (merge.rs:258 `if scanning { cursor =
        scan_start }`). Document end (orr == -1) compares as +infinity on
        BOTH sides, so end-vs-end falls to the agent tie-break.
        Returns (target_rank, orr_char)."""
        a_rank, ol_char, b_rank, orr_char = q
        ordv, rank = self.ord, self.rank
        agent_c = self.prep.agent_k[root_slot]
        seq_c = self.prep.seq_k[root_slot]

        w = ordv[a_rank + 1:b_rank]
        n = len(w)
        if n == 0:
            return b_rank, orr_char

        olw = self.ol_id[w]
        olr = np.where(olw >= 0, rank[np.clip(olw, 0, None)], -1)
        orw = self.orr_id[w]
        orr_r = np.where(orw >= 0, rank[np.clip(orw, 0, None)], BIG)
        b_eff = BIG if orr_char < 0 else b_rank

        top_row = olr < a_rank
        eq = olr == a_rank
        same = eq & (orw == orr_char)
        ka, ks = self.prep.agent_k[w], self.prep.seq_k[w]
        ins_here = same & ((agent_c < ka) | ((agent_c == ka) & (seq_c < ks)))
        brk = top_row | ins_here
        hits = np.flatnonzero(brk)
        jstar = int(hits[0]) if len(hits) else n

        set_ev = eq & ~same & (orr_r < b_eff)
        reset_ev = (eq & ~same & (orr_r >= b_eff)) | (same & ~ins_here)
        set_ev[jstar:] = False
        reset_ev[jstar:] = False
        set_idx = np.flatnonzero(set_ev)
        reset_idx = np.flatnonzero(reset_ev)
        last_reset = int(reset_idx[-1]) if len(reset_idx) else -1
        streak = set_idx[set_idx > last_reset]
        if len(streak):
            t = a_rank + 1 + int(streak[0])   # scanning rollback
        else:
            t = a_rank + 1 + jstar            # break point (or window end)
        return t, orr_char

    def apply_entry(self, row: int, ce: ComposedEntry) -> None:
        prep = self.prep
        snap = self.state[row].copy()
        queries = self._resolve_queries(snap, ce.q_cursor)

        # resolve base-coord delete targets against the snapshot BEFORE
        # ranks move (results are char lists; states write at the end)
        del_chars: List[np.ndarray] = []
        if ce.del_base:
            ordv = self.ord
            s_r = snap[ordv]
            vis_r = s_r == 1
            cum = np.cumsum(vis_r)
            for (c0, c1) in ce.del_base:
                mask = vis_r & (cum > c0) & (cum <= c1)
                del_chars.append(ordv[mask])

        nc = ce.num_chars()
        if nc:
            slots = _slot_of(prep, ce.ch_lv)
            # block placement (windows are disjoint: see compose.py)
            nb = len(ce.blk_start)
            t_arr = np.empty(nb, dtype=np.int64)
            orr_b = np.empty(nb, dtype=np.int64)
            for b in range(nb):
                root_slot = int(_slot_of(
                    prep, np.asarray([ce.blk_root_lv[b]]))[0])
                t, orr = self._place_block(
                    queries[ce.blk_root_q[b]], root_slot)
                t_arr[b] = t
                orr_b[b] = orr

            # combined rank bump (block targets are distinct & disjoint)
            border = np.argsort(t_arr, kind="stable")
            t_sorted = t_arr[border]
            len_sorted = ce.blk_len.astype(np.int64)[border]
            cum_before = np.concatenate([[0], np.cumsum(len_sorted)])[:-1]
            # existing placed chars shift by total block chars at <= rank
            bump = np.searchsorted(t_sorted, self.rank[self.ord],
                                   side="right")
            add = np.concatenate([[0], np.cumsum(len_sorted)])[bump]
            new_rank_existing = self.rank[self.ord] + add
            # new chars: block b starts at t_b + chars of blocks before it
            blk_new_start = np.empty(nb, dtype=np.int64)
            blk_new_start[border] = t_sorted + cum_before
            intra = np.arange(nc, dtype=np.int64) - \
                ce.blk_start.astype(np.int64)[ce.ch_block]
            new_char_rank = blk_new_start[ce.ch_block] + intra

            self.rank[self.ord] = new_rank_existing
            self.rank[slots] = new_char_rank
            m_new = len(self.ord) + nc
            new_ord = np.empty(m_new, dtype=np.int64)
            new_ord[new_rank_existing] = self.ord
            new_ord[new_char_rank] = slots
            self.ord = new_ord

            # origin metadata for the new chars: interiors chain off their
            # predecessor; K_OWN heads anchor an own char; query-anchored
            # heads take the device-resolved origin-left. origin_right is
            # the own char the run saw on its right at insert time, else
            # the block's resolved B (merge.rs:407-424 via compose.py).
            q_ol = np.asarray([queries[q][1] if q >= 0 else -2
                               for q in ce.ch_q], dtype=np.int64)
            prev_slot = slots - 1
            anchor_slot = np.where(
                ce.ch_anchor >= 0,
                _slot_of(prep, np.maximum(ce.ch_anchor, 0)), -1)
            kind = ce.ch_kind
            ol_new = np.where(
                kind == 0, prev_slot,
                np.where(kind == K_OWN, anchor_slot, q_ol))
            orr_new = np.where(
                ce.ch_orrown >= 0,
                _slot_of(prep, np.maximum(ce.ch_orrown, 0)),
                orr_b[ce.ch_block])
            self.ol_id[slots] = ol_new
            self.orr_id[slots] = orr_new
            self.state[row, slots] = np.maximum(self.state[row, slots], 1)

        # deletes last (an entry's deletes follow its inserts in LV order
        # only when they do — but all targets were resolved against the
        # snapshot, and states are monotone, so write order is free)
        for chars in del_chars:
            self.state[row, chars] = 2
            self.ever[chars] = 1
        for (lv0, lv1) in ce.del_own:
            sl = _slot_of(prep, np.arange(lv0, lv1))
            self.state[row, sl] = 2
            self.ever[sl] = 1

    # ---- plan execution --------------------------------------------------

    def run(self) -> None:
        for act in self.prep.plan.actions:
            op = act[0]
            if op == BEGIN:
                self.state[act[1]] = self.base_row
            elif op == FORK:
                self.state[act[2]] = self.state[act[1]]
            elif op == MAX:
                np.maximum(self.state[act[1]], self.state[act[2]],
                           out=self.state[act[1]])
            elif op == DROP:
                pass
            elif op == APPLY:
                self.apply_entry(act[2], self.prep.get_composed()[act[1]])

    def text(self) -> str:
        vis = self.ever[self.ord] == 0
        chars = self.prep.pool[self.ord[vis]]
        return chars.tobytes().decode("utf-32-le")


def zone_checkout_np(oplog, from_frontier: Sequence[int] = (),
                     merge_frontier: Optional[Sequence[int]] = None,
                     prefix: Optional[str] = None,
                     return_exec: bool = False):
    """Full checkout/merge via the zone engine. Returns (text, frontier)
    — the document at version_union(from, merge), like merge_device."""
    prep = prepare_zone(oplog, from_frontier, merge_frontier, prefix=prefix)
    if not prep.plan.entries:
        out = prep.prefix
        ex = None
    else:
        ex = ZoneExec(prep)
        ex.run()
        out = ex.text()
    frontier = list(prep.plan.final_frontier)
    if return_exec:
        return out, frontier, prep, ex
    return out, frontier
