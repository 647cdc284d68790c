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
scan in place of the masked reductions, the bump in rank space, deletes
by binary search, the order copied back with its tail zeroed once per
launch); it must equal the plain version launch by launch, so the
kernel's restructuring of the JAX step is held here, where the kernel
itself cannot run.
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

def _lower_bound(cum, m, v):
    """First i in [0, m) with cum[i] >= v, or m."""
    return int(np.searchsorted(cum[:m], v, side="left"))


def _search_full(cum, m, W, v, total):
    lb = _lower_bound(cum, m, v)
    if lb < m:
        return lb
    return m if (v <= total and m < W) else W


def _kernel_model(c, xs, plen):
    """One launch of the kernel over ONE replica's carry `c` (a dict of
    NumPy planes, m an int), phase by phase as the CUDA source does it."""
    state, snap, rank, ordv = c["state"], c["snap"], c["rank"], c["ord"]
    ol_id, orr_id, ever = c["ol_id"], c["orr_id"], c["ever"]
    ak, sk = c["agent_k"], c["seq_k"]
    n_idx, W = state.shape
    m = c["m"]
    MB, MC = xs["blk_cursor"].shape[1], xs["ch_slot"].shape[1]
    tail_zeroed = False

    def cl(x, lo, hi):
        return min(max(int(x), lo), hi)

    for t in range(len(xs["op"])):
        op = int(xs["op"][t])
        if op != tk.OP_APPLY:
            a = cl(xs["a"][t], 0, n_idx - 1)
            tgt = cl(xs["a"][t] if op == 0 else xs["b"][t], 0, n_idx - 1)
            if op == tk.OP_BEGIN:
                state[tgt] = np.arange(W) < plen
            elif op == tk.OP_FORK:
                state[tgt] = state[a]
            else:
                state[tgt] = np.maximum(state[tgt], state[a])
            continue
        x = {k: v[t] for k, v in xs.items()}
        st = state[cl(x["a"], 0, n_idx - 1)]
        # phase 1: keys, snapshot, char count
        ok = (x["ch_slot"] >= 0) & (x["ch_slot"] < W)
        ak[x["ch_slot"][ok]] = x["ch_agent"][ok]
        sk[x["ch_slot"][ok]] = x["ch_seq"][ok]
        nvalid = int((x["ch_slot"] >= 0).sum())
        if int(x["snap"]) == 1:
            snap[:] = st
        # phase 2: sr and its visible scan over the m placed ranks
        sr = snap[np.clip(ordv[:m], 0, W - 1)]
        cum = np.cumsum(sr == 1)
        total = int(cum[-1]) if m else 0
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
                a_rank = _search_full(cum, m, W, cursor, total)
            nn = np.flatnonzero(sr[max(a_rank + 1, 0):m] != 0)
            b0 = max(a_rank + 1, 0) + int(nn[0]) if len(nn) else W
            orr_char = int(ordv[b0]) if b0 < m else -1
            b_rank = min(b0, m)
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
        # phase 4: bump + next order, new chars, deletes by coordinate
        ord2 = np.zeros(W, np.int32)
        for i in range(m):
            nr = i + sum(L for tb, L in zip(s_t, s_L) if tb <= i)
            rank[ordv[i]] = nr
            ord2[nr] = ordv[i]
        for k in np.flatnonzero(ok):
            slot = int(x["ch_slot"][k])
            bk = cl(x["ch_blk"][k], 0, MB - 1)
            nr = s_t[bk] + sum(L for tb, L in zip(s_t, s_L)
                               if tb < s_t[bk]) + (k - int(x["blk_start"][bk]))
            rank[slot] = nr
            if 0 <= nr < W:
                ord2[nr] = slot
            ol = int(x["ch_ol_static"][k])
            if ol == -2:
                coord = int(x["ch_ol_coord"][k])
                ol = -1 if coord <= 0 else int(ordv[cl(_search_full(
                    cum, m, W, coord, total), 0, W - 1)])
            own = int(x["ch_orr_own"][k])
            ol_id[slot], orr_id[slot] = ol, own if own >= 0 else s_orr[bk]
            st[slot] = max(st[slot], 1)
        for kind, a, b in zip(x["del_kind"], x["del_a"], x["del_b"]):
            if kind == 0:
                for i in range(_lower_bound(cum, m, a + 1),
                               _lower_bound(cum, m, b + 1)):
                    if sr[i] == 1:
                        st[ordv[i]], ever[ordv[i]] = 2, 1
        # phase 5: deletes by own slot range, the order, m
        for kind, a, b in zip(x["del_kind"], x["del_a"], x["del_b"]):
            if kind == 1:
                st[max(a, 0):min(b, W)] = 2
                ever[max(a, 0):min(b, W)] = 1
        m_new = m + nvalid
        ordv[:m_new] = ord2[:m_new]
        if not tail_zeroed:
            ordv[m_new:] = 0
            tail_zeroed = True
        m = m_new
    c["m"] = m


@pytest.mark.parametrize("slice_steps", [1, 5, 1 << 20])
@pytest.mark.parametrize("budgets", BUDGETS)
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_kernel_model_matches_plain(seed, budgets, slice_steps):
    """The kernel's phases, launch by launch (a launch per slice), give
    the plain version's carry bit for bit."""
    _jol, _tol, _jp, tp = _preps(seed, n_edits=50,
                                 agents=("a", "b", "c"))
    tape = tk.pack_zone_tape(tp, *budgets)
    want = _plain_final_carry(tape, tp)
    c0 = tk.init_zone_carry(tape.W, tape.plen, tape.n_idx, tp.agent_k,
                            tp.seq_k, device="cpu")
    c = {k: v.numpy()[0].copy() for k, v in c0._asdict().items()}
    c["m"] = int(c["m"])
    xs = {k: v.numpy() for k, v in tk.tape_xs(tape, "cpu").items()}
    for i in range(0, len(xs["op"]), slice_steps):
        _kernel_model(c, {k: v[i:i + slice_steps] for k, v in xs.items()},
                      tape.plen)
    for name in tk.ZoneCarry._fields:
        assert np.array_equal(np.asarray(c[name]),
                              getattr(want, name).numpy()[0]), name


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
