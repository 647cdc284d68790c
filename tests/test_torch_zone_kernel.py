"""The zone engine's tape (X8) in the port against the JAX package's.

Seeded concurrent histories (`torch_parity.zone_history`) go through both
packages: `pack_zone_tape` (native and Python) must be array-equal to the
JAX package's; the kernel's plain version `run_zone_plain` must leave all
ten carry planes equal to the final carry of the JAX scan (`make_zone_step`
under `lax.scan`, jitted on the CPU as `tests/test_zone_kernel.py` runs
it), over fuzz seeds and tiny budgets; the batch and sliced executors must
equal the JAX package's; and `zone_checkout_device(device="cpu")` must equal
the tracker and the JAX engine. Equality is exact everywhere.

`_kernel_model` is a NumPy model of `csrc/zone_tape.cu`'s phases (a window
scan in place of the masked reductions, the order and the snapshot states
in rank order shifted into second buffers that swap, the ranks bumped slot
by slot, searches and deletes by binary search in the block holding the
coordinate, the order written back with its tail zeroed), by a cluster of
1, 2, 4 or 16 blocks: per-slice planes, slice totals and the counts carried
by the shift, the rank planes cut by the placed ranks; it must equal the
plain version launch by launch, so the kernel's restructuring of the JAX
step is held here, where the kernel itself cannot run.
`cluster_size` (the wrapper's pick of the cluster and the memory form) is
a pure function, tested here too.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_types_tpu.listmerge import zone_np as jzone
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import zone_kernel as jk
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu import zone_kernel as tk
from diamond_types_tpu_torch.listmerge import policy as tpolicy
from diamond_types_tpu_torch.listmerge import zone_np as tzone

from torch_parity import zone_history

TAPE_FIELDS = ("op", "arg_a", "arg_b", "snap_flag", "blk_cursor", "blk_prev",
               "blk_root", "blk_start", "blk_len", "ch_slot", "ch_ol_static",
               "ch_ol_coord", "ch_orr_own", "ch_blk", "ch_agent", "ch_seq",
               "del_kind", "del_a", "del_b")
BUDGETS = [(8, 512, 16), (2, 4, 1), (4, 256, 8)]
BIG = 1 << 30


@pytest.fixture(autouse=True)
def _fresh_port_policy(monkeypatch):
    monkeypatch.setattr(tpolicy, "GLOBAL", tpolicy.EnginePolicy())


def _twins(seed, n_edits=40, agents=("alice", "bob", "git")):
    return zone_history([JaxOpLog, OpLog], 5300 + seed, n_edits=n_edits,
                        agents=agents)


def _preps(seed, **kw):
    jol, tol = _twins(seed, **kw)
    return jol, tol, jzone.prepare_zone(jol), tzone.prepare_zone(tol)


def _jax_final_carry(tape, prep):
    """The JAX scan's whole final carry over the (padded) tape."""
    W, plen, n_idx = tape.W, tape.plen, tape.n_idx
    MB, MC, MD = (tape.blk_cursor.shape[1], tape.ch_slot.shape[1],
                  tape.del_kind.shape[1])
    carry = jk.init_zone_carry(W, plen, n_idx, prep.agent_k, prep.seq_k)
    xs = {k: jnp.asarray(v) for k, v in jk._pad_tape_xs(tape).items()}
    run = jax.jit(partial(jk._run_zone_slice, W=W, plen=plen, n_idx=n_idx,
                          MB=MB, MC=MC, MD=MD))
    return [np.asarray(c) for c in run(carry, xs)]


def _plain_final_carry(tape, prep, batch=1):
    carry = tk.init_zone_carry(tape.W, tape.plen, tape.n_idx, prep.agent_k,
                               prep.seq_k, batch=batch, device="cpu")
    return tk.run_zone_plain(carry, tk.tape_xs(tape, "cpu"), tape.plen)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("budgets", BUDGETS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_zone_tape_matches_jax(monkeypatch, seed, budgets, native):
    if not native:
        monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    _jol, _tol, jp, tp = _preps(seed)
    jt, tt = jk.pack_zone_tape(jp, *budgets), tk.pack_zone_tape(tp, *budgets)
    for f in TAPE_FIELDS:
        a, b = getattr(tt, f), getattr(jt, f)
        assert np.array_equal(a, b) and a.dtype == b.dtype, f
    assert (tt.W, tt.plen, tt.n_idx, tt.total_steps) == \
        (jt.W, jt.plen, jt.n_idx, jt.total_steps)
    assert np.array_equal(tt.pool, jt.pool)
    for a, b in zip(tk._pad_tape_xs(tt).values(),
                    jk._pad_tape_xs(jt).values()):
        assert np.array_equal(a, b)


def test_batched_pack_columns_match_per_entry(monkeypatch):
    """The whole-corpus column builder (taken at 200+ entries) packs the
    same tape as the per-entry one, as in the JAX package."""
    monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    ol = zone_history([OpLog], 77, n_edits=700, max_branches=8,
                      p_branch=0.45)[0]
    prep = tzone.prepare_zone(ol)
    tape = tk.pack_zone_tape(prep)
    monkeypatch.setattr(tk, "_batched_columns", lambda prep: {})
    tape2 = tk.pack_zone_tape(prep)
    for f in TAPE_FIELDS:
        assert np.array_equal(getattr(tape, f), getattr(tape2, f)), f


@pytest.mark.parametrize("budgets", BUDGETS[:2])
@pytest.mark.parametrize("seed", range(6))
def test_plain_carry_matches_jax_scan(seed, budgets):
    """All ten carry planes of the plain version equal the JAX scan's."""
    _jol, tol, jp, tp = _preps(seed)
    if not tp.plan.entries:
        pytest.skip("degenerate zone")
    jt, tt = jk.pack_zone_tape(jp, *budgets), tk.pack_zone_tape(tp, *budgets)
    want = _jax_final_carry(jt, jp)
    got = _plain_final_carry(tt, tp)
    for name, g, w in zip(tk.ZoneCarry._fields, got, want):
        assert np.array_equal(g.numpy()[0], w), name
        assert g.dtype == {"uint8": torch.uint8, "int32": torch.int32}[
            str(w.dtype)], name
    assert tk.assemble_text(got.rank[0], got.ever[0], tp.pool) == \
        tol.checkout_tip().snapshot()


# ---- a NumPy model of csrc/zone_tape.cu -------------------------------------

class _Plane:
    """A carry or scratch plane cut into `cs` slices of S = ceil(W / cs),
    one per block of a cluster (the last ones short, or empty past W): element
    idx lives in slice idx // S at idx - (idx // S) * S, which is how the
    kernel addresses another block's shared memory."""

    def __init__(self, arr, cs):
        self.S = -(-len(arr) // cs)
        self.parts = [np.array(arr[k * self.S:(k + 1) * self.S])
                      for k in range(cs)]

    def __getitem__(self, idx):
        k = idx // self.S
        return self.parts[k][idx - k * self.S]

    def __setitem__(self, idx, v):
        k = idx // self.S
        self.parts[k][idx - k * self.S] = v

    def whole(self):
        return np.concatenate(self.parts)


def _kernel_model(c, xs, plen, cs=1):
    """One launch of the kernel over ONE replica's carry `c` (a dict of
    NumPy planes, m an int) by a cluster of `cs` blocks, phase by phase as
    the CUDA source does it: each block loads its slices, works on its own
    slots and ranks, reads and writes other blocks' slices where the
    source does, and writes its slices back. The order and the snapshot
    states in rank order (sr) live in two buffers that swap every APPLY
    step, their tails stale (filled with junk here, so a read of one shows);
    sr is rebuilt from the slots on a snapshot step and on the launch's
    first APPLY, else carried by the shift. Returns what the launch
    exercised: the least m an APPLY step saw and the integrate windows
    that crossed a slice boundary."""
    n_idx, W = c["state"].shape
    P = {k: _Plane(c[k], cs) for k in ("snap", "rank", "ol_id", "orr_id",
                                        "ever", "agent_k", "seq_k")}
    rows = [_Plane(c["state"][q], cs) for q in range(n_idx)]
    snap, rank = P["snap"], P["rank"]
    ol_id, orr_id, ever = P["ol_id"], P["orr_id"], P["ever"]
    ak, sk = P["agent_k"], P["seq_k"]
    # the rank-indexed planes, cut by the placed ranks: with m placed,
    # block j holds the ranks [j * Sr, (j+1) * Sr), Sr = ceil(m / cs)
    cum = np.zeros(W, np.int64)
    ords = [np.array(c["ord"]), np.full(W, 7777, np.int32)]
    srs = [np.full(W, 7, np.uint8) for _ in range(2)]

    def rank_slice(mm):
        return max(1, -(-mm // cs))
    cur = 0
    S = snap.S
    own = [(j * S, min(j * S + S, W)) for j in range(cs)]
    m = c["m"]
    MB = xs["blk_cursor"].shape[1]
    applied = sr_valid = False
    hist_next = None      # the next step's counts, from this step's shift
    stats = {"min_m": None, "crossing_windows": 0}

    def cl(x, lo, hi):
        return min(max(int(x), lo), hi)

    for t in range(len(xs["op"])):
        op = int(xs["op"][t])
        if op != tk.OP_APPLY:
            a = cl(xs["a"][t], 0, n_idx - 1)
            tgt = cl(xs["a"][t] if op == 0 else xs["b"][t], 0, n_idx - 1)
            for j, (lo, hi) in enumerate(own):
                if op == tk.OP_BEGIN:
                    rows[tgt].parts[j][:] = np.arange(lo, hi) < plen
                elif op == tk.OP_FORK:
                    rows[tgt].parts[j][:] = rows[a].parts[j]
                else:
                    rows[tgt].parts[j][:] = np.maximum(rows[tgt].parts[j],
                                                       rows[a].parts[j])
            continue
        stats["min_m"] = m if stats["min_m"] is None else \
            min(stats["min_m"], m)
        x = {k: v[t] for k, v in xs.items()}
        st = rows[cl(x["a"], 0, n_idx - 1)]
        ordv, sr = ords[cur], srs[cur]
        ord2, sr2 = ords[1 - cur], srs[1 - cur]
        snap_now = int(x["snap"]) == 1
        fresh = snap_now or not sr_valid
        Sr = rank_slice(m)
        ranks = [(min(j * Sr, m), min(j * Sr + Sr, m)) for j in range(cs)]
        # phase 1, block by block: keys by the slot's owner, snapshot; on
        # a fresh step each own placed slot's snapshot state scattered to
        # its rank (sr[rank[s]] = snap[s]) and counted per rank slice, else
        # the counts the last step's shift made
        hist = np.zeros((cs, cs), np.int64) if fresh else hist_next
        for j, (lo, hi) in enumerate(own):
            for k in np.flatnonzero((x["ch_slot"] >= lo)
                                    & (x["ch_slot"] < hi)):
                ak[int(x["ch_slot"][k])] = x["ch_agent"][k]
                sk[int(x["ch_slot"][k])] = x["ch_seq"][k]
            if snap_now:
                snap.parts[j][:] = st.parts[j]
            if fresh:
                for s_ in range(lo, hi):
                    rs = int(rank[s_])
                    if rs < m:
                        sr[rs] = snap[s_]
                        hist[j, rs // Sr] += snap[s_] == 1
        nvalid = int((x["ch_slot"] >= 0).sum())
        # phase 2: the slice totals from every block's bins, then each
        # block's scan of its own placed ranks (cum counts within the
        # block; its visible coordinates are (below, upto])
        part = hist.sum(axis=0)
        incl = np.cumsum(part)
        total = int(incl[-1])
        for j, (rlo, rhi) in enumerate(ranks):
            assert int((sr[rlo:rhi] == 1).sum()) == part[j]
            cum[rlo:rhi] = np.cumsum(sr[rlo:rhi] == 1)
        # then each block finds the coordinates (below, upto] it holds in
        # its own cum: the cursors of the step's blocks, and the origins
        # of chars placed by coordinate (written into the char's slot)
        arank = [None] * MB
        for j, (rlo, rhi) in enumerate(ranks):
            below, upto = int(incl[j] - part[j]), int(incl[j])

            def local(v):
                return rlo + int(np.searchsorted(cum[rlo:rhi], v - below,
                                                 side="left"))
            for k in range(MB):
                cur_k = int(x["blk_cursor"][k])
                if x["blk_len"][k] > 0 and below < cur_k <= upto:
                    assert arank[k] is None
                    arank[k] = local(cur_k)
            for k in range(len(x["ch_slot"])):
                coord, slot = int(x["ch_ol_coord"][k]), int(x["ch_slot"][k])
                if x["ch_ol_static"][k] == -2 and below < coord <= upto \
                        and 0 <= slot < W:
                    ol_id[slot] = ordv[local(coord)]
        # phase 3: block k's anchors, then the window scan
        s_t, s_L, s_orr = [BIG] * MB, [0] * MB, [-1] * MB
        for k in range(MB):
            if x["blk_len"][k] <= 0:
                continue
            cursor, prev = int(x["blk_cursor"][k]), int(x["blk_prev"][k])
            root = int(x["blk_root"][k])
            if cursor == -2:
                a_rank = int(rank[min(prev, W - 1)]) if prev >= 0 else BIG
            elif cursor <= 0:
                a_rank = -1
            else:
                a_rank = arank[k] if cursor <= total else W
            b0 = next((i for i in range(max(a_rank + 1, 0), m)
                       if sr[i] != 0), W)
            orr_char = int(ordv[b0]) if b0 < m else -1
            b_rank = min(b0, m)
            if max(a_rank + 1, 0) < b_rank and \
                    max(a_rank + 1, 0) // Sr != (b_rank - 1) // Sr:
                stats["crossing_windows"] += 1
            if cursor == -2:
                tk_ = a_rank + 1
            else:
                ag_c = int(ak[min(root, W - 1)]) if root >= 0 else 0
                sq_c = int(sk[min(root, W - 1)]) if root >= 0 else 0
                b_eff = BIG if orr_char < 0 else b_rank
                jstar, streak = b_rank, -1
                for i in range(max(a_rank + 1, 0), b_rank):
                    s = int(ordv[i])
                    sc = cl(s, 0, W - 1)
                    olw = int(ol_id[sc]) if s >= 0 else -3
                    olr = -1 if olw == -1 else (
                        int(rank[min(olw, W - 1)]) if olw >= 0 else BIG)
                    orw = int(orr_id[sc]) if s >= 0 else -3
                    orr_r = BIG if orw == -1 else (
                        int(rank[min(orw, W - 1)]) if orw >= 0 else BIG)
                    ag, sq = int(ak[sc]), int(sk[sc])
                    eq = olr == a_rank
                    same = eq and orw == orr_char
                    ins = same and (ag_c < ag or (ag_c == ag and sq_c < sq))
                    if olr < a_rank or ins:
                        jstar = i
                        break
                    if (eq and not same and orr_r >= b_eff) or same:
                        streak = -1
                    elif eq and not same and streak < 0:
                        streak = i
                tk_ = streak if streak >= 0 else jstar
            s_t[k], s_L[k], s_orr[k] = tk_, int(x["blk_len"][k]), orr_char

        def bumped(r_):
            return r_ + sum(L for tb, L in zip(s_t, s_L) if tb <= r_)

        def char_rank(k):
            bk = cl(x["ch_blk"][k], 0, MB - 1)
            return s_t[bk] + sum(L for tb, L in zip(s_t, s_L)
                                 if tb < s_t[bk]) \
                + (k - int(x["blk_start"][bk]))

        # phase 4, block by block: its own ranks shifted into the next
        # order and sr (written into any slice; the visible ones counted
        # per slice for the next step), the chars whose slot it owns,
        # deletes by coordinate over its own ranks; no rank written
        hist_next = np.zeros((cs, cs), np.int64)
        Srn = rank_slice(m + nvalid)          # the next step's slicing
        for j, (lo, hi) in enumerate(own):
            rlo, rhi = ranks[j]
            for i in range(rlo, rhi):
                if bumped(i) < W:
                    ord2[bumped(i)], sr2[bumped(i)] = ordv[i], sr[i]
                    hist_next[j, bumped(i) // Srn] += sr[i] == 1
            for k in np.flatnonzero((x["ch_slot"] >= lo)
                                    & (x["ch_slot"] < hi)):
                slot = int(x["ch_slot"][k])
                nr = char_rank(k)
                if 0 <= nr < W:
                    ord2[nr], sr2[nr] = slot, snap[slot]
                    hist_next[j, nr // Srn] += snap[slot] == 1
                ol = int(x["ch_ol_static"][k])
                coord = int(x["ch_ol_coord"][k])
                # by a coordinate within the visible text: written in
                # phase 2; past it the search ends at W
                if ol != -2:
                    ol_id[slot] = ol
                elif coord <= 0:
                    ol_id[slot] = -1
                elif coord > total:
                    ol_id[slot] = int(ordv[W - 1]) \
                        if W - 1 < m or not applied else 0
                own_r = int(x["ch_orr_own"][k])
                orr_id[slot] = own_r if own_r >= 0 else \
                    s_orr[cl(x["ch_blk"][k], 0, MB - 1)]
                st[slot] = max(st[slot], 1)
            mine = cum[rlo:rhi]
            below = int(incl[j] - part[j])
            for kind, a, b in zip(x["del_kind"], x["del_a"], x["del_b"]):
                if kind != 0:
                    continue
                r0 = rlo + int(np.searchsorted(mine, a + 1 - below, "left"))
                r1 = rlo + int(np.searchsorted(mine, b + 1 - below, "left"))
                for i in range(r0, r1):
                    if sr[i] == 1:
                        st[int(ordv[i])], ever[int(ordv[i])] = 2, 1
        # phase 5, block by block: deletes by own slot range, the own
        # slots' rank bump; then the new chars' ranks; the buffers swap
        for j, (lo, hi) in enumerate(own):
            for kind, a, b in zip(x["del_kind"], x["del_a"], x["del_b"]):
                if kind == 1:
                    for s_ in range(max(a, lo), min(b, hi)):
                        st[s_], ever[s_] = 2, 1
            for s_ in range(lo, hi):
                if int(rank[s_]) < BIG:
                    rank[s_] = bumped(int(rank[s_]))
        for j, (lo, hi) in enumerate(own):
            for k in np.flatnonzero((x["ch_slot"] >= lo)
                                    & (x["ch_slot"] < hi)):
                rank[int(x["ch_slot"][k])] = char_rank(k)
        cur = 1 - cur
        m += nvalid
        applied = sr_valid = True
    for k, pl in P.items():
        c[k][:] = pl.whole()
    for q in range(n_idx):
        c["state"][q] = rows[q].whole()
    if applied:
        c["ord"][:m] = ords[cur][:m]
        c["ord"][m:] = 0
    c["m"] = m
    return stats


def _model_run(seed, budgets, slice_steps, cs):
    """The model over the seed's tape, a launch per slice, from a fresh
    carry; returns (carry, the plain version's carry, W, stats)."""
    _jol, _tol, _jp, tp = _preps(seed, n_edits=50,
                                 agents=("a", "b", "c"))
    tape = tk.pack_zone_tape(tp, *budgets)
    want = _plain_final_carry(tape, tp)
    c0 = tk.init_zone_carry(tape.W, tape.plen, tape.n_idx, tp.agent_k,
                            tp.seq_k, device="cpu")
    c = {k: v.numpy()[0].copy() for k, v in c0._asdict().items()}
    c["m"] = int(c["m"])
    xs = {k: v.numpy() for k, v in tk.tape_xs(tape, "cpu").items()}
    stats = []
    for i in range(0, len(xs["op"]), slice_steps):
        stats.append(_kernel_model(
            c, {k: v[i:i + slice_steps] for k, v in xs.items()},
            tape.plen, cs))
    return c, want, tape.W, stats


@pytest.mark.parametrize("cs", [1, 2, 4, 16])
@pytest.mark.parametrize("slice_steps", [1, 5, 1 << 20])
@pytest.mark.parametrize("budgets", BUDGETS)
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_kernel_model_matches_plain(seed, budgets, slice_steps, cs):
    """The kernel's phases, launch by launch (a launch per slice), by a
    cluster of `cs` blocks, give the plain version's carry bit for bit."""
    c, want, _W, _stats = _model_run(seed, budgets, slice_steps, cs)
    for name in tk.ZoneCarry._fields:
        assert np.array_equal(np.asarray(c[name]),
                              getattr(want, name).numpy()[0]), name


@pytest.mark.parametrize("cs", [2, 4, 16])
def test_kernel_model_reaches_slice_edges(cs):
    """The model's tapes reach the cluster's edges: a W that is no
    multiple of the cluster, APPLY steps at m < cs, integrate windows that
    cross a slice boundary; and there the model still equals the plain
    version."""
    seen = {"W_ragged": False, "m_below_c": False, "crossing": 0}
    for seed in (0, 2, 3, 9):
        c, want, W, stats = _model_run(seed, BUDGETS[0], 1 << 20, cs)
        for name in tk.ZoneCarry._fields:
            assert np.array_equal(np.asarray(c[name]),
                                  getattr(want, name).numpy()[0]), name
        seen["W_ragged"] |= W % cs != 0
        seen["m_below_c"] |= any(s["min_m"] is not None and s["min_m"] < cs
                                 for s in stats)
        seen["crossing"] += sum(s["crossing_windows"] for s in stats)
    assert seen["W_ragged"] and seen["m_below_c"] and seen["crossing"] > 0, \
        seen


# ---- executors ----------------------------------------------------------------

@pytest.mark.parametrize("slice_steps", [7, 64, 1 << 20])
def test_batch_and_sliced_executors_match_jax(slice_steps):
    """execute_zone_batch / execute_zone_batch_sliced at B 2 equal the
    JAX package's batched and sliced executors, every replica; the
    prebuilt-slices path agrees too."""
    jol, tol = zone_history([JaxOpLog, OpLog], 7100, n_edits=60,
                            agents=("alice", "bob"), max_branches=4)
    jp, tp = jzone.prepare_zone(jol), tzone.prepare_zone(tol)
    jt, tt = jk.pack_zone_tape(jp), tk.pack_zone_tape(tp)
    jr, je = jk.execute_zone_batch_jax(jt, jp.agent_k, jp.seq_k, 2)
    r1, e1 = tk.execute_zone_batch(tt, tp.agent_k, tp.seq_k, 2,
                                   device="cpu")
    assert np.array_equal(r1.numpy(), np.asarray(jr))
    assert np.array_equal(e1.numpy(), np.asarray(je))
    jr2, je2 = jk.execute_zone_batch_sliced_jax(
        jt, jp.agent_k, jp.seq_k, 2, slice_steps=slice_steps)
    r2, e2 = tk.execute_zone_batch_sliced(tt, tp.agent_k, tp.seq_k, 2,
                                          slice_steps=slice_steps,
                                          device="cpu")
    assert np.array_equal(r2.numpy(), np.asarray(jr2))
    assert np.array_equal(e2.numpy(), np.asarray(je2))
    S, xs = tk.slice_tape_xs(tt, slice_steps, "cpu")
    jS, jxs = jk.slice_tape_xs(jt, slice_steps)
    assert S == jS and len(xs) == len(jxs)
    r3, e3 = tk.execute_zone_batch_sliced(tt, tp.agent_k, tp.seq_k, 2,
                                          xs_slices=xs, device="cpu")
    assert torch.equal(r3, r1) and torch.equal(e3, e1)
    r0, e0 = tk.execute_zone(tt, tp.agent_k, tp.seq_k, device="cpu")
    jr0, je0 = jk.execute_zone_jax(jt, jp.agent_k, jp.seq_k)
    assert np.array_equal(r0.numpy(), jr0) and np.array_equal(e0.numpy(),
                                                              je0)
    with pytest.raises(ValueError, match="positive"):
        tk.slice_tape_xs(tt, 0, "cpu")


@pytest.mark.parametrize("seed", range(8))
def test_zone_checkout_device_cpu_matches_tracker_and_jax(seed):
    jol, tol = _twins(seed)
    got = tk.zone_checkout_device(tol, device="cpu")
    want = jk.zone_checkout_device(jol)
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    b = tol.checkout_tip()
    assert got[0] == b.snapshot() and sorted(got[1]) == sorted(b.version)
    # from a mid version, and with the tiny budgets
    mid = [len(tol) // 2]
    assert tk.zone_checkout_device(tol, mid, device="cpu") == \
        jk.zone_checkout_device(jol, mid)
    prep = tzone.prepare_zone(tol)
    if prep.plan.entries:
        tape = tk.pack_zone_tape(prep, max_blocks=2, max_chars=4,
                                 max_dels=1)
        assert tk.zone_checkout_device(tol, prep=prep, tape=tape,
                                       device="cpu")[0] == b.snapshot()


def test_zone_checkout_device_records_full_runs_only():
    _jol, tol = _twins(2)
    tk.zone_checkout_device(tol, device="cpu")
    assert tpolicy.GLOBAL.rate(tpolicy.ZONE) is not None
    tpolicy.GLOBAL = tpolicy.EnginePolicy()
    prep = tzone.prepare_zone(tol)
    tk.zone_checkout_device(tol, prep=prep, device="cpu")
    assert tpolicy.GLOBAL.rate(tpolicy.ZONE) is None


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _jol, tol = _twins(1)
    prep = tzone.prepare_zone(tol)
    tape = tk.pack_zone_tape(prep)
    for call in (lambda: tk.zone_checkout_device(tol),
                 lambda: tk.execute_zone(tape, prep.agent_k, prep.seq_k),
                 lambda: tk.execute_zone_batch(tape, prep.agent_k,
                                               prep.seq_k, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_zone_tape_run_checks_its_inputs():
    """The wrapper refuses a wrong dtype, shape or device before anything
    runs; on CPU tensors it runs the plain version in place."""
    _jol, _tol, _jp, tp = _preps(4)
    tape = tk.pack_zone_tape(tp)
    xs = tk.tape_xs(tape, "cpu")
    fresh = lambda: tk.init_zone_carry(  # noqa: E731
        tape.W, tape.plen, tape.n_idx, tp.agent_k, tp.seq_k, device="cpu")
    with pytest.raises(TypeError, match="rank"):
        kernels.zone_tape_run(fresh()._replace(
            rank=fresh().rank.long()), xs, tape.plen)
    with pytest.raises(ValueError, match="ever"):
        kernels.zone_tape_run(fresh()._replace(
            ever=torch.zeros((1, tape.W + 1), dtype=torch.uint8)), xs,
            tape.plen)
    with pytest.raises(TypeError, match="ch_slot"):
        kernels.zone_tape_run(fresh(), dict(xs, ch_slot=xs["ch_slot"].long()),
                              tape.plen)
    with pytest.raises(ValueError, match="lacks"):
        kernels.zone_tape_run(fresh(), {"op": xs["op"]}, tape.plen)
    with pytest.raises(ValueError, match="meta"):
        kernels.zone_tape_run(fresh()._replace(
            seq_k=fresh().seq_k.to("meta")), xs, tape.plen)
    carry = fresh()
    launches = kernels.zone_tape_run.launches
    out = kernels.zone_tape_run(carry, xs, tape.plen)
    assert out is carry and kernels.zone_tape_run.launches == launches
    want = _plain_final_carry(tape, tp)
    assert all(torch.equal(a, b) for a, b in zip(carry, want))


# ---- the launch shape ---------------------------------------------------------

def test_cluster_size_fit_limits():
    """A block's slice takes (n_idx + 36) bytes a slot, padded to 16
    slots, within 232,448 bytes less 3,072 for the kernel's static arrays;
    c 16 holds 87,296 slots at n_idx 6 (5,456 a block) and not one more,
    55,552 at n_idx 30; past that the rule takes the global-memory form."""
    budget = kernels.ZONE_SMEM_BUDGET
    assert budget == 232448 - 3072
    assert kernels.zone_smem_bytes(87_296, 6, 16) == 42 * 5456 <= budget
    assert kernels.zone_smem_bytes(87_297, 6, 16) > budget
    assert kernels.zone_smem_bytes(55_552, 30, 16) <= budget < \
        kernels.zone_smem_bytes(55_553, 30, 16)
    assert kernels.zone_smem_bytes(38_029, 6, 8) == 42 * 4768 <= budget
    assert kernels.zone_smem_bytes(38_029, 6, 4) > budget
    assert kernels.cluster_size(1, 87_296, 6) == (16, True)
    assert kernels.cluster_size(1, 87_297, 6) == (16, False)
    assert kernels.cluster_size(1, 55_553, 30) == (16, False)
    assert kernels.cluster_size(1, 55_552, 30) == (16, True)


@pytest.mark.parametrize("B,W,n_idx,want", [
    # the history zone of the smoke: c 8 is the smallest that fits, raised
    # to 16 for one replica; many replicas take c 1 in global memory once
    # the clusters would need more than three times its waves
    (1, 38_029, 6, (16, True)),
    (16, 38_029, 6, (8, True)),
    (49, 38_029, 6, (8, True)),
    (50, 38_029, 6, (2, False)),
    (132, 38_029, 6, (1, False)),
    (1_024, 38_029, 6, (1, False)),
    # a larger n_idx needs c 16 to fit at all
    (1, 38_029, 30, (16, True)),
    (24, 38_029, 30, (16, True)),
    (1_024, 38_029, 30, (1, False)),
    # small zones fit one block, at any B; c grows while a block keeps
    # >= 1,024 slots and B * c stays within the card's 132 SMs
    (1, 300, 6, (1, True)),
    (1, 5_000, 6, (4, True)),
    (33, 5_000, 6, (4, True)),
    (34, 5_000, 6, (2, True)),
    (132, 5_000, 6, (1, True)),
    (1_024, 5_000, 6, (1, True)),
    # past the fit limit: the global form, raised by the same rule
    (1, 200_000, 6, (16, False)),
    (16, 200_000, 6, (8, False)),
    (132, 200_000, 6, (1, False)),
    (1_024, 200_000, 6, (1, False)),
])
def test_cluster_size_rule(B, W, n_idx, want):
    got = kernels.cluster_size(B, W, n_idx)
    assert got == want and isinstance(got, kernels.ClusterPick)
    c, smem = got
    assert c in kernels.CLUSTER_SIZES
    assert not smem or kernels.zone_smem_bytes(W, n_idx, c) <= \
        kernels.ZONE_SMEM_BUDGET


def test_zone_tape_run_checks_its_cluster():
    """A forced shape is checked before anything runs, on the CPU too:
    an unknown cluster size, or a shared-memory form whose slice does not
    fit, raises; a valid one runs the plain version."""
    W = 100_000
    zeros = np.zeros(W, np.int32)
    carry = tk.init_zone_carry(W, 0, 6, zeros, zeros, device="cpu")
    xs = {k: torch.zeros((1,) if k in tk.XS_KEYS[:4] else (1, 1),
                         dtype=torch.int32) for k in tk.XS_KEYS}
    xs["op"].fill_(tk.OP_FORK)
    with pytest.raises(ValueError, match="does not fit"):
        kernels.zone_tape_run(carry, xs, 0, cluster=(16, True))
    with pytest.raises(ValueError, match="cluster size"):
        kernels.zone_tape_run(carry, xs, 0, cluster=(32, False))
    assert kernels.zone_tape_run(carry, xs, 0, cluster=(16, False)) is carry
