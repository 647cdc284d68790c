"""Device zone execution: origin extraction on the card (X8).

Port of the JAX package's `tpu/zone_kernel.py`. The host prepares a zone
(`listmerge/zone_np.prepare_zone`: plan compilation, entry composition,
slot/pool/key tables) and packs it into a step tape (`pack_zone_tape`,
native `dt_zone_pack` or the Python packer below); the card runs the whole
tape and resolves every origin, places every concurrent block with the
YjsMod integrate rule, evolves the per-index state matrix and leaves the
final document order in `rank`.

Tape steps (per step: op, a, b, snap; per block [MB]; per char [MC]; per
delete atom [MD]):
  OP_BEGIN row        state[row] <- base visibility (prefix chars)
  OP_FORK  src dst    state[dst] <- state[src]
  OP_MAX   src dst    state[dst] <- max(state[dst], state[src])
  OP_APPLY row        one SUB-STEP of an entry: up to MB blocks, MC chars,
                      MD delete atoms; the first sub-step of each entry
                      snapshots the row.

The JAX package runs the tape as one `lax.scan` whose step is some 80-100
tensor operations. Here the tape is run by ONE kernel launch per tape (or
per slice of a tape) for B independent replicas: `kernels.zone_tape_run`
(`csrc/zone_tape.cu`), one thread block per replica stepping the tape. The
kernel's plain version is `run_zone_plain`, a Python loop of
`zone_step_plain`, which translates the JAX step (`make_zone_step`'s
`apply_step` / `row_step`) one to one over a batched carry; it runs for CPU
tensors only.

The carry (`ZoneCarry`) is batched: every plane has a leading replica
dimension B (`m` is [B]). The kernel updates it in place, so a session
(`gpu/zone_session.py`) continues it and a sliced run launches once per
slice on the resident carry. int32 throughout, `BIG32 = 1 << 30` for an
unplaced rank; out-of-range writes (pad chars aim at W) are dropped, and
out-of-range gathers are clamped and filled as `jnp.clip` gathers are.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..listmerge.compose import K_OWN
from ..listmerge.plan2 import APPLY, BEGIN, DROP, FORK, MAX
from ..listmerge.zone_np import ZonePrep, _slot_of, prepare_zone
from . import kernels, resolve_device
from .steer import _pow2

OP_BEGIN, OP_FORK, OP_MAX, OP_APPLY = 0, 1, 2, 3

BIG32 = np.int32(1 << 30)

# the tape's columns, in the order of `_pad_tape_xs` and of the kernel
XS_KEYS = ("op", "a", "b", "snap", "blk_cursor", "blk_prev", "blk_root",
           "blk_start", "blk_len", "ch_slot", "ch_ol_static", "ch_ol_coord",
           "ch_orr_own", "ch_blk", "ch_agent", "ch_seq", "del_kind",
           "del_a", "del_b")


@dataclass
class ZoneTape:
    """Packed device tape + host-prepared pools for one document."""
    # per step
    op: np.ndarray         # [T] i32
    arg_a: np.ndarray      # [T] i32 (row / src)
    arg_b: np.ndarray      # [T] i32 (dst)
    snap_flag: np.ndarray  # [T] i32 1 = copy row -> snapshot first
    # per step x block
    blk_cursor: np.ndarray  # [T,MB] i32 coord; -1 pad; -2 continuation
    blk_prev: np.ndarray    # [T,MB] i32 continuation: append after slot
    blk_root: np.ndarray    # [T,MB] i32 root char slot (keys)
    blk_start: np.ndarray   # [T,MB] i32 first char index in this step
    blk_len: np.ndarray     # [T,MB] i32 char count (0 pad)
    # per step x char
    ch_slot: np.ndarray     # [T,MC] i32 (-1 pad)
    ch_ol_static: np.ndarray   # [T,MC] i32 slot; -1 doc start; -2 coord
    ch_ol_coord: np.ndarray    # [T,MC] i32 entry-start coord
    ch_orr_own: np.ndarray     # [T,MC] i32 slot or -1 (block B)
    ch_blk: np.ndarray         # [T,MC] i32 block index in step
    ch_agent: np.ndarray       # [T,MC] i32 agent name rank
    ch_seq: np.ndarray         # [T,MC] i32 agent-local seq
    # per step x delete atom
    del_kind: np.ndarray    # [T,MD] i32 -1 pad / 0 coords / 1 slot range
    del_a: np.ndarray       # [T,MD] i32
    del_b: np.ndarray       # [T,MD] i32
    # doc-level
    W: int
    plen: int
    n_idx: int
    pool: np.ndarray        # [W] i32 char codes by slot
    total_steps: int


def _origin_encoding(ch_kind, slots, anchor, c_of):
    """The per-char origin-left encoding — the ONE statement of the rule
    shared by the per-entry and whole-corpus batched column builders:
    interior chars chain to their predecessor slot, K_OWN heads anchor on
    an own slot, query heads (K_LEFTJOIN / K_ROOT) carry a cursor coord
    (-1 = doc start, -2 = resolve the coord at runtime)."""
    is_q = ch_kind >= 2
    ol_static = np.where(
        ch_kind == 0, slots - 1,
        np.where(ch_kind == K_OWN, anchor,
                 np.where(c_of == 0, -1, -2)))
    ol_coord = np.where(is_q & (c_of > 0), c_of, 0)
    return ol_static, ol_coord


def entry_columns(ce, slot_fn, agent_k, seq_k):
    """Per-char tape columns for one composed entry: (slots, ol_static,
    ol_coord, orr_own, ag, sq, root_slots)."""
    slots = slot_fn(ce.ch_lv).astype(np.int64)
    anchor = np.where(ce.ch_anchor >= 0,
                      slot_fn(np.maximum(ce.ch_anchor, 0)), -1)
    orr_own = np.where(ce.ch_orrown >= 0,
                       slot_fn(np.maximum(ce.ch_orrown, 0)), -1)
    root_slots = slot_fn(ce.blk_root_lv)
    qc = np.asarray(ce.q_cursor, dtype=np.int64) \
        if ce.q_cursor else np.zeros(1, np.int64)
    c_of = qc[np.clip(ce.ch_q, 0, None)]
    ol_static, ol_coord = _origin_encoding(np.asarray(ce.ch_kind), slots,
                                           anchor, c_of)
    if callable(agent_k):   # one call yields both key planes
        ag, sq = agent_k(ce.ch_lv)
    else:
        ag = np.asarray(agent_k)[slots]
        sq = np.asarray(seq_k)[slots]
    return slots, ol_static, ol_coord, orr_own, ag, sq, root_slots


def entry_steps(ce, slot_fn, agent_k, seq_k, MB, MC, MD, cur, next_sub,
                cols=None):
    """Append one composed entry's APPLY sub-step contents (blocks, char
    slices, delete atoms) under the shared budgets. `slot_fn` maps insert
    LVs to char slots; `cur` is the current step dict; `next_sub()`
    returns a fresh sub-step. Shared by the whole-document packer below
    and the incremental session packer (zone_session.py). `cols` are
    precomputed entry_columns (the whole-document packer batches them
    across all entries — per-entry numpy-call overhead dominated the
    pack on many-entry corpora)."""
    nc = ce.num_chars()
    if nc:
        if cols is None:
            cols = entry_columns(ce, slot_fn, agent_k, seq_k)
        slots, ol_static, ol_coord, orr_own, ag, sq, root_slots = cols
    for b in range(len(ce.blk_start) if nc else 0):
        lo = int(ce.blk_start[b])
        hi = lo + int(ce.blk_len[b])
        first = True
        pos = lo
        while pos < hi:
            if len(cur["blocks"]) >= MB or cur["n_chars"] >= MC:
                cur = next_sub()
            take = min(hi - pos, MC - cur["n_chars"])
            assert take > 0
            cursor = int(ce.q_cursor[int(ce.blk_root_q[b])]) \
                if first else -2
            cur["blocks"].append((
                cursor, -1 if first else int(slots[pos - 1]),
                int(root_slots[b]), cur["n_chars"], take))
            cur["chars"].append((len(cur["blocks"]) - 1, pos, pos + take,
                                 slots, ol_static, ol_coord, orr_own,
                                 ag, sq))
            cur["n_chars"] += take
            pos += take
            first = False
    for (c0, c1) in ce.del_base:
        if len(cur["dels"]) >= MD:
            cur = next_sub()
        cur["dels"].append((0, int(c0), int(c1)))
    for (lv0, lv1) in ce.del_own:
        if len(cur["dels"]) >= MD:
            cur = next_sub()
        s0 = int(slot_fn(np.asarray([lv0]))[0])
        cur["dels"].append((1, s0, s0 + (lv1 - lv0)))


def _batched_columns(prep):
    """entry_columns for EVERY composed entry in a few whole-corpus numpy
    passes, returned as per-entry views. Equivalent to calling
    entry_columns per entry (pinned by test_zone_kernel's corpora parity)
    but ~an order of magnitude cheaper on many-entry plans."""
    ces = prep.get_composed()
    # Batching trades per-entry numpy-call overhead for whole-corpus
    # concatenation copies: a win on many-small-entry plans (git-style
    # DAGs), a loss on few-huge-entry plans (node_nodecc's 100 entries
    # of ~4k chars) where the copies dominate and the per-entry overhead
    # was negligible. 200 entries is comfortably past the crossover.
    if len(ces) < 200:
        return {}
    cat = np.concatenate
    ch_lv = cat([np.asarray(ce.ch_lv, dtype=np.int64) if ce.num_chars()
                 else np.zeros(0, np.int64) for ce in ces])
    if not len(ch_lv):
        return {}
    as_i64 = lambda a: np.asarray(a, dtype=np.int64)  # noqa: E731
    nchars = [ce.num_chars() for ce in ces]
    z = np.zeros(0, np.int64)
    ch_kind = cat([as_i64(ce.ch_kind) if n else z
                   for ce, n in zip(ces, nchars)])
    ch_anchor = cat([as_i64(ce.ch_anchor) if n else z
                     for ce, n in zip(ces, nchars)])
    ch_orrown = cat([as_i64(ce.ch_orrown) if n else z
                     for ce, n in zip(ces, nchars)])
    # entry-local query ids -> one flat query table via per-entry offsets
    q_lens = [len(ce.q_cursor) for ce in ces]
    q_off = np.cumsum([0] + q_lens[:-1])
    flat_q = cat([as_i64(ce.q_cursor) if q else z
                  for ce, q in zip(ces, q_lens)]) if sum(q_lens) \
        else np.zeros(1, np.int64)
    ch_q = cat([np.where(as_i64(ce.ch_q) >= 0, as_i64(ce.ch_q) + off, -1)
                if n else z
                for ce, n, off in zip(ces, nchars, q_off)])
    slots = _slot_of(prep, ch_lv).astype(np.int64)
    anchor = np.where(ch_anchor >= 0,
                      _slot_of(prep, np.maximum(ch_anchor, 0)), -1)
    orr_own = np.where(ch_orrown >= 0,
                       _slot_of(prep, np.maximum(ch_orrown, 0)), -1)
    c_of = flat_q[np.clip(ch_q, 0, None)]
    ol_static, ol_coord = _origin_encoding(ch_kind, slots, anchor, c_of)
    ag = np.asarray(prep.agent_k)[slots]
    sq = np.asarray(prep.seq_k)[slots]
    nb = [len(ce.blk_root_lv) if ce.num_chars() else 0 for ce in ces]
    root_slots = _slot_of(prep, cat(
        [as_i64(ce.blk_root_lv) if n else z for ce, n in zip(ces, nb)])) \
        if sum(nb) else z
    out = {}
    c0 = b0 = 0
    for i, (ce, n, bn) in enumerate(zip(ces, nchars, nb)):
        if n:
            sl = slice(c0, c0 + n)
            out[i] = (slots[sl], ol_static[sl], ol_coord[sl],
                      orr_own[sl], ag[sl], sq[sl],
                      root_slots[b0:b0 + bn])
        c0 += n
        b0 += bn
    return out


def _pack_native(prep: ZonePrep, MB: int, MC: int, MD: int):
    """The C++ tape packer (native/dt_core.cpp dt_zone_pack; VERDICT r4
    #6 — the pure-Python pack was ~280 ms of git-makefile zone prep).
    Array-identical to the Python packer below (pinned by
    tests/test_zone_kernel.py); None when the native library is absent."""
    ctx = prep.native_ctx
    if ctx is None:
        return None
    lib = ctx._lib
    if not hasattr(lib, "dt_zone_pack"):
        return None
    n = len(prep.plan.entries)

    acts = prep.plan.actions
    ak = np.zeros(len(acts), np.int64)
    aa = np.zeros(len(acts), np.int64)
    ab = np.zeros(len(acts), np.int64)
    for i, act in enumerate(acts):
        ak[i] = act[0]
        aa[i] = act[1]
        ab[i] = act[2] if len(act) > 2 else 0
    ins_lv0 = np.ascontiguousarray(prep.ins_lv0, dtype=np.int64)
    ins_cum = np.ascontiguousarray(prep.ins_cum, dtype=np.int64)
    agent_k = np.ascontiguousarray(prep.agent_k, dtype=np.int64)
    seq_k = np.ascontiguousarray(prep.seq_k, dtype=np.int64)

    # fast path: the composer's output is still cached on the ctx from
    # prepare_zone's compose_plan call — pack straight from it, no
    # column round-trip. -2 = cache stale/absent -> marshal below.
    if prep.compose_serial:
        d64 = np.zeros(1, np.int64)
        d32 = np.zeros(1, np.int32)
        du8 = np.zeros(1, np.uint8)
        T = lib.dt_zone_pack(
            ctx._ptr, len(acts), ak, aa, ab, n, d64, d64, d64, du8, d64,
            d32, d64, d32, d64, d32, d32, d64, d64, d64, d64,
            len(ins_lv0), ins_lv0, ins_cum, prep.plen, agent_k, seq_k,
            MB, MC, MD, prep.compose_serial)
        if T >= 0:
            return _pack_fetch(prep, lib, ctx, int(T), MB, MC, MD)
    ces = prep.get_composed()
    as_i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)  # noqa: E731
    counts = np.zeros(n * 5, dtype=np.int64)
    for k, ce in enumerate(ces):
        counts[k * 5 + 0] = len(ce.q_cursor)
        counts[k * 5 + 1] = ce.num_chars()
        counts[k * 5 + 2] = 0 if ce.blk_start is None else len(ce.blk_start)
        counts[k * 5 + 3] = len(ce.del_base)
        counts[k * 5 + 4] = len(ce.del_own)
    z64 = np.zeros(0, np.int64)
    z32 = np.zeros(0, np.int32)
    zu8 = np.zeros(0, np.uint8)

    def cat(parts, dtype):
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.zeros(1, dtype)
        return np.ascontiguousarray(np.concatenate(parts), dtype=dtype)

    flat_q = cat([as_i64(ce.q_cursor) if ce.q_cursor else z64
                  for ce in ces], np.int64)
    nc = [ce.num_chars() for ce in ces]
    ch_lv = cat([as_i64(ce.ch_lv) if m else z64
                 for ce, m in zip(ces, nc)], np.int64)
    ch_kind = cat([np.asarray(ce.ch_kind, np.uint8) if m else zu8
                   for ce, m in zip(ces, nc)], np.uint8)
    ch_anchor = cat([as_i64(ce.ch_anchor) if m else z64
                     for ce, m in zip(ces, nc)], np.int64)
    ch_q = cat([np.asarray(ce.ch_q, np.int32) if m else z32
                for ce, m in zip(ces, nc)], np.int32)
    ch_orrown = cat([as_i64(ce.ch_orrown) if m else z64
                     for ce, m in zip(ces, nc)], np.int64)
    nb = [int(counts[k * 5 + 2]) for k in range(n)]
    blk_root_q = cat([np.asarray(ce.blk_root_q, np.int32) if m else z32
                      for ce, m in zip(ces, nb)], np.int32)
    blk_root_lv = cat([as_i64(ce.blk_root_lv) if m else z64
                       for ce, m in zip(ces, nb)], np.int64)
    blk_start = cat([np.asarray(ce.blk_start, np.int32) if m else z32
                     for ce, m in zip(ces, nb)], np.int32)
    blk_len = cat([np.asarray(ce.blk_len, np.int32) if m else z32
                   for ce, m in zip(ces, nb)], np.int32)
    db0 = cat([as_i64([a for a, _ in ce.del_base]) for ce in ces], np.int64)
    db1 = cat([as_i64([b for _, b in ce.del_base]) for ce in ces], np.int64)
    do0 = cat([as_i64([a for a, _ in ce.del_own]) for ce in ces], np.int64)
    do1 = cat([as_i64([b for _, b in ce.del_own]) for ce in ces], np.int64)

    T = lib.dt_zone_pack(
        ctx._ptr, len(acts), ak, aa, ab, n, counts, flat_q, ch_lv, ch_kind,
        ch_anchor, ch_q, ch_orrown, blk_root_q, blk_root_lv, blk_start,
        blk_len, db0, db1, do0, do1, len(ins_lv0), ins_lv0, ins_cum,
        prep.plen, agent_k, seq_k, MB, MC, MD, 0)
    if T < 0:
        return None
    return _pack_fetch(prep, lib, ctx, int(T), MB, MC, MD)


def _pack_fetch(prep, lib, ctx, T: int, MB: int, MC: int, MD: int):
    Tp = max(1, int(T))
    # np.empty everywhere: dt_zone_pack_fetch writes every cell, pads
    # included (pad-initializing the ~100 MB tape in numpy was a
    # measurable share of the whole pack)
    out = ZoneTape(
        op=np.empty(Tp, np.int32), arg_a=np.empty(Tp, np.int32),
        arg_b=np.empty(Tp, np.int32), snap_flag=np.empty(Tp, np.int32),
        blk_cursor=np.empty((Tp, MB), np.int32),
        blk_prev=np.empty((Tp, MB), np.int32),
        blk_root=np.empty((Tp, MB), np.int32),
        blk_start=np.empty((Tp, MB), np.int32),
        blk_len=np.empty((Tp, MB), np.int32),
        ch_slot=np.empty((Tp, MC), np.int32),
        ch_ol_static=np.empty((Tp, MC), np.int32),
        ch_ol_coord=np.empty((Tp, MC), np.int32),
        ch_orr_own=np.empty((Tp, MC), np.int32),
        ch_blk=np.empty((Tp, MC), np.int32),
        ch_agent=np.empty((Tp, MC), np.int32),
        ch_seq=np.empty((Tp, MC), np.int32),
        del_kind=np.empty((Tp, MD), np.int32),
        del_a=np.empty((Tp, MD), np.int32),
        del_b=np.empty((Tp, MD), np.int32),
        W=prep.W, plen=prep.plen,
        n_idx=max(1, prep.plan.indexes_used),
        pool=prep.pool.astype(np.int32), total_steps=int(T))
    lib.dt_zone_pack_fetch(
        ctx._ptr, out.op, out.arg_a, out.arg_b, out.snap_flag,
        out.blk_cursor, out.blk_prev, out.blk_root, out.blk_start,
        out.blk_len, out.ch_slot, out.ch_ol_static, out.ch_ol_coord,
        out.ch_orr_own, out.ch_blk, out.ch_agent, out.ch_seq,
        out.del_kind, out.del_a, out.del_b, MB, MC, MD)
    return out


def pack_zone_tape(prep: ZonePrep, max_blocks: int = 8,
                   max_chars: int = 512, max_dels: int = 16) -> ZoneTape:
    """Flatten a prepared zone (plan + composed entries) into the tape."""
    MB, MC, MD = max_blocks, max_chars, max_dels
    if not os.environ.get("DT_TPU_NO_NATIVE"):
        native = _pack_native(prep, MB, MC, MD)
        if native is not None:
            return native
    steps: List[dict] = []
    all_cols = _batched_columns(prep)

    def new_step(op, a=0, b=0, snap=0):
        s = dict(op=op, a=a, b=b, snap=snap,
                 blocks=[], chars=[], dels=[], n_chars=0)
        steps.append(s)
        return s

    composed = prep.get_composed()
    for act in prep.plan.actions:
        kind = act[0]
        if kind == BEGIN:
            new_step(OP_BEGIN, act[1])
        elif kind == FORK:
            new_step(OP_FORK, act[1], act[2])
        elif kind == MAX:
            new_step(OP_MAX, act[2], act[1])   # a=src, b=dst
        elif kind == DROP:
            continue
        elif kind == APPLY:
            ce = composed[act[1]]
            row = act[2]
            cur = new_step(OP_APPLY, row, snap=1)

            def next_sub():
                return new_step(OP_APPLY, row, snap=0)

            def slot_fn(lvs):
                return _slot_of(prep, lvs)

            entry_steps(ce, slot_fn, prep.agent_k, prep.seq_k,
                        MB, MC, MD, cur, next_sub,
                        cols=all_cols.get(act[1]))

    return _fill_tape(steps, prep.W, prep.plen,
                      max(1, prep.plan.indexes_used),
                      prep.pool.astype(np.int32), MB, MC, MD)


def _fill_tape(steps: List[dict], W: int, plen: int, n_idx: int,
               pool: np.ndarray, MB: int, MC: int, MD: int) -> ZoneTape:
    """Materialize packed micro-step dicts into tape arrays (shared by
    the whole-document packer above and zone_session's incremental
    packer)."""
    T = max(1, len(steps))
    out = ZoneTape(
        op=np.zeros(T, np.int32), arg_a=np.zeros(T, np.int32),
        arg_b=np.zeros(T, np.int32), snap_flag=np.zeros(T, np.int32),
        blk_cursor=np.full((T, MB), -1, np.int32),
        blk_prev=np.full((T, MB), -1, np.int32),
        blk_root=np.zeros((T, MB), np.int32),
        blk_start=np.zeros((T, MB), np.int32),
        blk_len=np.zeros((T, MB), np.int32),
        ch_slot=np.full((T, MC), -1, np.int32),
        ch_ol_static=np.full((T, MC), -1, np.int32),
        ch_ol_coord=np.zeros((T, MC), np.int32),
        ch_orr_own=np.full((T, MC), -1, np.int32),
        ch_blk=np.zeros((T, MC), np.int32),
        ch_agent=np.zeros((T, MC), np.int32),
        ch_seq=np.zeros((T, MC), np.int32),
        del_kind=np.full((T, MD), -1, np.int32),
        del_a=np.zeros((T, MD), np.int32),
        del_b=np.zeros((T, MD), np.int32),
        W=W, plen=plen, n_idx=n_idx,
        pool=pool, total_steps=len(steps))
    for t, s in enumerate(steps):
        out.op[t] = s["op"]
        out.arg_a[t] = s["a"]
        out.arg_b[t] = s["b"]
        out.snap_flag[t] = s["snap"]
        for i, (cursor, prev, root, start, length) in \
                enumerate(s["blocks"]):
            out.blk_cursor[t, i] = cursor
            out.blk_prev[t, i] = prev
            out.blk_root[t, i] = root
            out.blk_start[t, i] = start
            out.blk_len[t, i] = length
        w = 0
        for (blk_i, lo, hi, slots, ol_static, ol_coord, orr_own,
             ag, sq) in s["chars"]:
            n = hi - lo
            out.ch_slot[t, w:w + n] = slots[lo:hi]
            out.ch_ol_static[t, w:w + n] = ol_static[lo:hi]
            out.ch_ol_coord[t, w:w + n] = ol_coord[lo:hi]
            out.ch_orr_own[t, w:w + n] = orr_own[lo:hi]
            out.ch_blk[t, w:w + n] = blk_i
            out.ch_agent[t, w:w + n] = ag[lo:hi]
            out.ch_seq[t, w:w + n] = sq[lo:hi]
            w += n
        for i, (k, a, b) in enumerate(s["dels"]):
            out.del_kind[t, i] = k
            out.del_a[t, i] = a
            out.del_b[t, i] = b
    return out


def _pad_tape_xs(tape: ZoneTape, target: Optional[int] = None) -> dict:
    T = tape.op.shape[0]
    Tp = _pow2(T) if target is None else int(target)
    assert Tp >= T

    def pad_t(a, fill=0):
        out = np.full((Tp,) + a.shape[1:], fill, a.dtype)
        out[:T] = a
        return out

    return dict(
        # pad steps are self-FORKs (state[0] <- state[0]): a padded
        # OP_BEGIN would reset row 0 to the base prefix and clobber any
        # pinned session row held there
        op=pad_t(tape.op, OP_FORK), a=pad_t(tape.arg_a),
        b=pad_t(tape.arg_b), snap=pad_t(tape.snap_flag),
        blk_cursor=pad_t(tape.blk_cursor, -1),
        blk_prev=pad_t(tape.blk_prev, -1), blk_root=pad_t(tape.blk_root),
        blk_start=pad_t(tape.blk_start), blk_len=pad_t(tape.blk_len),
        ch_slot=pad_t(tape.ch_slot, -1),
        ch_ol_static=pad_t(tape.ch_ol_static, -1),
        ch_ol_coord=pad_t(tape.ch_ol_coord),
        ch_orr_own=pad_t(tape.ch_orr_own, -1), ch_blk=pad_t(tape.ch_blk),
        ch_agent=pad_t(tape.ch_agent), ch_seq=pad_t(tape.ch_seq),
        del_kind=pad_t(tape.del_kind, -1), del_a=pad_t(tape.del_a),
        del_b=pad_t(tape.del_b))


# ---------------------------------------------------------------------------
# device execution
# ---------------------------------------------------------------------------


class ZoneCarry(NamedTuple):
    """The zone engine's state for B replicas, in the JAX carry's order.
    uint8: state [B, n_idx, W], snap [B, W], ever [B, W]; int32: rank,
    ord, ol_id, orr_id, agent_k, seq_k [B, W], m [B]."""
    state: torch.Tensor
    snap: torch.Tensor
    rank: torch.Tensor
    ord: torch.Tensor
    ol_id: torch.Tensor
    orr_id: torch.Tensor
    ever: torch.Tensor
    m: torch.Tensor
    agent_k: torch.Tensor
    seq_k: torch.Tensor


def init_zone_carry(W: int, plen: int, n_idx: int, agent_k, seq_k,
                    batch: int = 1, device=None) -> ZoneCarry:
    """Fresh carry for `batch` replicas (prefix chars pre-placed).
    `agent_k` and `seq_k` are [W] (every replica) or [batch, W]."""
    dev = resolve_device(device)
    idx = torch.arange(W, dtype=torch.int32, device=dev)
    pre = idx < plen

    def rows(x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x).astype(np.int32), device=dev)
        return t.expand(batch, W).contiguous() if t.dim() == 1 else \
            t.contiguous()

    def plane(x) -> torch.Tensor:
        return x.expand(batch, W).contiguous()

    return ZoneCarry(
        state=torch.zeros((batch, n_idx, W), dtype=torch.uint8, device=dev),
        snap=torch.zeros((batch, W), dtype=torch.uint8, device=dev),
        rank=plane(torch.where(pre, idx, int(BIG32))),
        ord=plane(idx),
        ol_id=plane(torch.where(pre, idx - 1, -2).to(torch.int32)),
        orr_id=torch.full((batch, W), -1, dtype=torch.int32, device=dev),
        ever=torch.zeros((batch, W), dtype=torch.uint8, device=dev),
        m=torch.full((batch,), plen, dtype=torch.int32, device=dev),
        agent_k=rows(agent_k), seq_k=rows(seq_k))


def tape_xs(tape: ZoneTape, device=None, target: Optional[int] = None
            ) -> dict:
    """The tape's columns as int32 tensors on `device` (CUDA unless
    "cpu"), unpadded, or padded to `target` steps with self-FORK no-ops
    (`_pad_tape_xs`)."""
    dev = resolve_device(device)
    if target is None:
        cols = dict(zip(XS_KEYS, (
            tape.op, tape.arg_a, tape.arg_b, tape.snap_flag, tape.blk_cursor,
            tape.blk_prev, tape.blk_root, tape.blk_start, tape.blk_len,
            tape.ch_slot, tape.ch_ol_static, tape.ch_ol_coord,
            tape.ch_orr_own, tape.ch_blk, tape.ch_agent, tape.ch_seq,
            tape.del_kind, tape.del_a, tape.del_b)))
    else:
        cols = _pad_tape_xs(tape, target=target)
    return {k: torch.as_tensor(np.ascontiguousarray(cols[k], np.int32),
                               device=dev) for k in XS_KEYS}


def _drop_ix(ix: torch.Tensor, W: int) -> torch.Tensor:
    """Scatter targets with every out-of-range index sent to the overflow
    column W (JAX's mode="drop")."""
    return torch.where((ix >= 0) & (ix < W), ix, W).long()


def _scatter_set(plane: torch.Tensor, ix: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """plane [B, W] with plane[b, ix[b, k]] = val[b, k], out-of-range
    indices dropped; a new tensor."""
    B, W = plane.shape
    ext = torch.cat([plane, plane.new_zeros((B, 1))], dim=1)
    ix = _drop_ix(ix, W).expand(B, -1)
    ext.scatter_(1, ix, val.to(plane.dtype).expand(B, -1))
    return ext[:, :W]


def _gather(plane: torch.Tensor, ix: torch.Tensor, fill: int
            ) -> torch.Tensor:
    """JAX's gather_i32: plane[b, clip(ix, 0, W-1)] where ix >= 0, else
    `fill`. plane [B, W], ix [B, k] or [k]; returns [B, k]."""
    B, W = plane.shape
    ixb = ix.expand(B, -1) if ix.dim() == 1 else ix
    got = torch.gather(plane, 1, ixb.clamp(0, W - 1).long())
    return torch.where(ixb >= 0, got, fill).to(plane.dtype)


def _searchsorted_left(cum: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """jnp.searchsorted(cum[b], v[b], side="left") per replica, int32 in
    [0, W]. cum [B, W] int32 nondecreasing, v [B, k]."""
    return torch.searchsorted(cum, v.to(cum.dtype).contiguous(),
                              side="left").to(torch.int32)


def zone_step_plain(carry: ZoneCarry, x: dict, plen: int) -> ZoneCarry:
    """One tape step over a batched carry: the JAX `make_zone_step` step
    (`apply_step` for OP_APPLY, else `row_step`), one to one. `x` holds
    the step's scalars (op, a, b, snap) as Python ints and its block, char
    and delete columns as [MB], [MC], [MD] int32 tensors. Returns a new
    carry; the input is not written."""
    state = carry.state
    B, n_idx, W = state.shape
    dev = state.device
    i32 = torch.int32
    idx_w = torch.arange(W, dtype=i32, device=dev)
    op = int(x["op"])
    if op != OP_APPLY:
        src = state[:, min(max(int(x["a"]), 0), n_idx - 1)]
        if op == OP_BEGIN:
            new = (idx_w < plen).to(torch.uint8).expand(B, W)
        elif op == OP_FORK:
            new = src
        else:
            new = torch.maximum(
                state[:, min(max(int(x["b"]), 0), n_idx - 1)], src)
        target = int(x["a"]) if op == OP_BEGIN else int(x["b"])
        state = state.clone()
        state[:, min(max(target, 0), n_idx - 1)] = new
        return carry._replace(state=state)

    (snap, rank, ordv, ol_id, orr_id, ever, m, agent_k, seq_k) = carry[1:]
    big = int(BIG32)
    ch_slot = x["ch_slot"]
    # key planes first: the chars placed THIS step are roots/anchors whose
    # keys the integrate reads
    key_ix = torch.where(ch_slot >= 0, ch_slot, W)[None, :]
    agent_k = _scatter_set(agent_k, key_ix, x["ch_agent"][None, :])
    seq_k = _scatter_set(seq_k, key_ix, x["ch_seq"][None, :])
    row = min(max(int(x["a"]), 0), n_idx - 1)
    st_row = state[:, row]
    if int(x["snap"]) == 1:
        snap = st_row.clone()

    placed_r = idx_w[None, :] < m[:, None]                  # [B, W]
    ch_at = ordv                                            # old order
    s_r = torch.where(placed_r,
                      torch.gather(snap, 1, ch_at.clamp(0, W - 1).long()),
                      0)
    vis_r = (s_r == 1) & placed_r
    cum = torch.cumsum(vis_r.to(i32), dim=1, dtype=i32)
    nonniy_r = (s_r != 0) & placed_r

    # ---- block anchor resolution (reference: merge.rs:395-423) ----
    cursor = x["blk_cursor"][None, :]                       # [1, MB]
    is_cont = cursor == -2
    j = _searchsorted_left(cum, torch.maximum(cursor, torch.ones_like(
        cursor)).expand(B, -1))
    a_from = torch.where(cursor <= 0, -1, j)
    a_rank = torch.where(is_cont, _gather(rank, x["blk_prev"], big),
                         a_from)                            # [B, MB]
    cand = torch.where(nonniy_r[:, None, :]
                       & (idx_w[None, None, :] > a_rank[:, :, None]),
                       idx_w[None, None, :], W)
    b0 = cand.amin(dim=2)                                   # [B, MB]
    orr_b = torch.where(b0 < m[:, None],
                        torch.gather(ch_at, 1, b0.clamp(0, W - 1).long()),
                        -1)
    b_rank = torch.minimum(b0, m[:, None])

    # ---- YjsMod integrate (reference: merge.rs:154-278) ----
    olw = _gather(ol_id, ch_at, -3)
    olr_w = torch.where(olw == -1, -1, _gather(rank, olw, big))
    orw = _gather(orr_id, ch_at, -3)
    orr_r_w = torch.where(orw == -1, big, _gather(rank, orw, big))
    agent_w = _gather(agent_k, ch_at, 0)
    seq_w = _gather(seq_k, ch_at, 0)
    agent_c = _gather(agent_k, x["blk_root"], 0)[:, :, None]
    seq_c = _gather(seq_k, x["blk_root"], 0)[:, :, None]
    a3, b3 = a_rank[:, :, None], b_rank[:, :, None]
    iw = idx_w[None, None, :]
    in_win = (iw > a3) & (iw < b3) & placed_r[:, None, :]
    b_eff = torch.where(orr_b < 0, big, b_rank)[:, :, None]
    olr3, orw3, orr_r3 = olr_w[:, None, :], orw[:, None, :], \
        orr_r_w[:, None, :]
    ag3, sq3 = agent_w[:, None, :], seq_w[:, None, :]
    top_row = in_win & (olr3 < a3)
    eq = in_win & (olr3 == a3)
    same = eq & (orw3 == orr_b[:, :, None])
    ins_here = same & ((agent_c < ag3) | ((agent_c == ag3) & (seq_c < sq3)))
    brk = top_row | ins_here
    jstar = torch.where(brk, iw, b3).amin(dim=2)
    before = iw < jstar[:, :, None]
    set_ev = eq & ~same & (orr_r3 < b_eff) & before
    reset_ev = ((eq & ~same & (orr_r3 >= b_eff)) | (same & ~ins_here)) \
        & before
    last_reset = torch.where(reset_ev, iw, -1).amax(dim=2)
    streak = torch.where(set_ev & (iw > last_reset[:, :, None]), iw,
                         W).amin(dim=2)
    t_b = torch.where(streak < W, streak, jstar)
    t_b = torch.where(is_cont, a_rank + 1, t_b).to(i32)
    blk_valid = (x["blk_len"] > 0)[None, :]
    t_b = torch.where(blk_valid, t_b, big)                  # [B, MB]
    L_b = torch.where(blk_valid, x["blk_len"][None, :], 0)  # [1, MB]

    # ---- delete resolution against the snapshot, in rank space ----
    dk = x["del_kind"][None, :, None]
    da = x["del_a"][None, :, None]
    db = x["del_b"][None, :, None]
    c3 = cum[:, None, :]
    dmask_r = (vis_r[:, None, :] & (c3 > da) & (c3 <= db)
               & (dk == 0)).any(dim=1)                      # [B, W]

    # ---- rank bump + placement (disjoint windows commute) ----
    bump = torch.where(t_b[:, :, None] <= rank[:, None, :],
                       L_b[:, :, None], 0).sum(dim=1, dtype=i32)
    rank = torch.where(rank < big, rank + bump, rank)
    off_b = torch.where(t_b[:, None, :] < t_b[:, :, None],
                        L_b[:, None, :], 0).sum(dim=2, dtype=i32)
    start_b = t_b + off_b                                   # [B, MB]
    MB = start_b.shape[1]
    MC = ch_slot.shape[0]
    ch_valid = ch_slot >= 0
    ch_blk = x["ch_blk"].clamp(0, MB - 1).long()
    intra = torch.arange(MC, dtype=i32, device=dev) - x["blk_start"][ch_blk]
    new_rank_ch = start_b[:, ch_blk] + intra[None, :]       # [B, MC]
    # scatter targets: pad chars aim out of bounds and are dropped
    slot_ix = torch.where(ch_valid, ch_slot, W)[None, :]
    rank = _scatter_set(rank, slot_ix, new_rank_ch)
    m = m + ch_valid.sum(dtype=i32)
    live = rank < big
    ordv = _scatter_set(torch.zeros_like(rank), torch.where(live, rank, W),
                        idx_w[None, :].expand(B, W))

    # ---- origin metadata for the new chars (old order, old cum) ----
    coordq = torch.maximum(x["ch_ol_coord"], torch.ones_like(
        x["ch_ol_coord"]))[None, :].expand(B, -1)
    jq = _searchsorted_left(cum, coordq)
    ol_from_coord = torch.where(
        x["ch_ol_coord"][None, :] <= 0, -1,
        torch.gather(ch_at, 1, jq.clamp(0, W - 1).long()))
    ol_ch = torch.where(x["ch_ol_static"][None, :] == -2, ol_from_coord,
                        x["ch_ol_static"][None, :])
    orr_ch = torch.where(x["ch_orr_own"][None, :] >= 0,
                         x["ch_orr_own"][None, :], orr_b[:, ch_blk])
    ol_id = _scatter_set(ol_id, slot_ix, ol_ch)
    orr_id = _scatter_set(orr_id, slot_ix, orr_ch)

    # ---- state writes: inserts + deletes (monotone lattice) ----
    u8 = torch.uint8
    ins_w = _scatter_set(torch.zeros_like(ever), slot_ix,
                         torch.ones((1, MC), dtype=u8, device=dev))
    del_w = _scatter_set(torch.zeros_like(ever),
                         torch.where(dmask_r, ch_at, W),
                         torch.full((B, W), 2, dtype=u8, device=dev))
    own_del = ((x["del_kind"][:, None] == 1)
               & (idx_w[None, :] >= x["del_a"][:, None])
               & (idx_w[None, :] < x["del_b"][:, None])).any(dim=0)
    del_w = torch.maximum(del_w, torch.where(own_del, 2, 0).to(u8))
    new_row = torch.maximum(torch.maximum(st_row, ins_w), del_w)
    state = state.clone()
    state[:, row] = new_row
    ever = torch.maximum(ever, (del_w >= 2).to(u8))
    return ZoneCarry(state, snap, rank, ordv, ol_id, orr_id, ever, m,
                     agent_k, seq_k)


def run_zone_plain(carry: ZoneCarry, xs: dict, plen: int) -> ZoneCarry:
    """The kernel's plain version: `zone_step_plain` over every step of
    `xs` (the tape's columns, `tape_xs`), in order. Returns a new carry."""
    scal = {k: xs[k].tolist() for k in ("op", "a", "b", "snap")}
    for t in range(len(scal["op"])):
        x = {k: v[t] for k, v in scal.items()}
        if x["op"] == OP_APPLY:
            x.update({k: xs[k][t] for k in XS_KEYS[4:]})
        carry = zone_step_plain(carry, x, plen)
    return carry


def execute_zone_batch(tape: ZoneTape, agent_k: np.ndarray,
                       seq_k: np.ndarray, batch: int, device=None,
                       xs: Optional[dict] = None):
    """Run one shared tape for `batch` independent replicas (BASELINE
    config 4's many-documents-per-card shape): ONE `zone_tape_run` launch
    on a fresh [batch, ...] carry. seq keys are materialized per replica,
    as the JAX package does. Returns (rank [B, W], ever [B, W]) on the
    device."""
    dev = resolve_device(device)
    if xs is None:
        xs = tape_xs(tape, dev)
    carry = init_zone_carry(tape.W, tape.plen, tape.n_idx, agent_k,
                            seq_k, batch=batch, device=dev)
    carry = kernels.zone_tape_run(carry, xs, tape.plen)
    return carry.rank, carry.ever


def execute_zone(tape: ZoneTape, agent_k: np.ndarray, seq_k: np.ndarray,
                 device=None):
    """Run the tape for one replica; returns (rank [W], ever [W]) on the
    device."""
    rank, ever = execute_zone_batch(tape, agent_k, seq_k, 1, device=device)
    return rank[0], ever[0]


def slice_tape_xs(tape: ZoneTape, slice_steps: int, device=None):
    """Cut the tape into slices of `slice_steps` steps on the device (pad
    steps are self-FORK no-ops, so over-padding the last slice is safe).
    Returns (S, [xs dicts])."""
    if int(slice_steps) <= 0:
        raise ValueError(f"slice_steps must be positive, got {slice_steps}"
                         " (use the whole-tape executor to disable slicing)")
    T = tape.op.shape[0]
    S = min(int(slice_steps), _pow2(T))
    n_sl = max(1, -(-T // S))
    xs = tape_xs(tape, device, target=n_sl * S)
    return S, [{k: v[i * S:(i + 1) * S] for k, v in xs.items()}
               for i in range(n_sl)]


def execute_zone_batch_sliced(tape: ZoneTape, agent_k: np.ndarray,
                              seq_k: np.ndarray, batch: int,
                              slice_steps: int = 32768, xs_slices=None,
                              device=None):
    """`execute_zone_batch` with the tape cut into slices: one
    `zone_tape_run` launch per slice, each continuing the resident carry
    in place. Returns (rank [B, W], ever [B, W]) on the device.

    The card has no per-launch time limit (the JAX package slices for its
    TPU runtime's), so nothing here slices by default. A caller slices to
    bound one launch's length: a git-makefile-sized tape (~524k steps) is
    seconds in one launch, during which the stream runs nothing else, such
    as other documents' flushes."""
    dev = resolve_device(device)
    if xs_slices is None:
        _S, xs_slices = slice_tape_xs(tape, slice_steps, dev)
    carry = init_zone_carry(tape.W, tape.plen, tape.n_idx, agent_k,
                            seq_k, batch=batch, device=dev)
    for xs in xs_slices:
        carry = kernels.zone_tape_run(carry, xs, tape.plen)
    return carry.rank, carry.ever


def assemble_text(rank: torch.Tensor, ever: torch.Tensor,
                  pool: np.ndarray) -> str:
    """The document from a final (rank, ever) pair: slots in rank order,
    the never-deleted ones, as text (JAX `zone_checkout_device`'s
    assembly: a stable argsort of rank cut at the live count)."""
    live = int((rank < int(BIG32)).sum())
    order = torch.sort(rank, stable=True).indices[:live]
    keep = order[ever[order] == 0].cpu().numpy()
    return np.asarray(pool, dtype=np.int32)[keep].tobytes() \
        .decode("utf-32-le")


def zone_checkout_device(oplog, from_frontier: Sequence[int] = (),
                         merge_frontier: Optional[Sequence[int]] = None,
                         prep: Optional[ZonePrep] = None,
                         tape: Optional[ZoneTape] = None, device=None):
    """Full checkout/merge via the zone engine on `device` (CUDA unless
    "cpu"). Returns (text, frontier). FULL runs (prep and tape computed
    here) record their throughput into the engine policy
    (`listmerge/policy.py`); callers passing precomputed prep/tape are not
    recorded, as in the JAX package."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    full_run = prep is None and tape is None
    if prep is None:
        # fetch_composed=False: the native pack reads the composer's
        # output in the ctx cache
        prep = prepare_zone(oplog, from_frontier, merge_frontier,
                            fetch_composed=False)
    if not prep.plan.entries:
        txt = prep.prefix
    else:
        if tape is None:
            tape = pack_zone_tape(prep)
        rank, ever = execute_zone(tape, prep.agent_k, prep.seq_k,
                                  device=dev)
        txt = assemble_text(rank, ever, prep.pool)
    if full_run:
        from ..listmerge import policy as _policy
        n_before = max((int(x) for x in from_frontier), default=-1) + 1
        n_after = max((int(x) for x in prep.plan.final_frontier),
                      default=-1) + 1
        _policy.GLOBAL.record(_policy.ZONE, n_after - n_before,
                              time.perf_counter() - t0)
    return txt, list(prep.plan.final_frontier)
