"""The port's plan-tape executor and history path (`gpu/plan_kernels.py`,
X7) against the JAX package's (`tpu/plan_kernels.py`) and host checkouts.

Histories are `tests/test_encode.py::build_random_oplog` seeds and
`torch_parity.TwinDocs` histories, built in the JAX package and carried
into the port with `oplog_from_columns`. The port runs on the CPU
(`device="cpu"`), where K3 runs its plain version; the JAX functions as
the JAX package's own tests run them. Every output is an integer, a byte
or a string: all comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import plan_kernels as jpk
from diamond_types_tpu_torch import OpLog, oplog_from_columns
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu import plan_kernels as tpk
from diamond_types_tpu_torch.gpu.linearize import materialize

from test_encode import build_random_oplog
from torch_parity import TwinDocs, export_columns

TAPE_FIELDS = ("op", "a", "b", "c", "d", "is_base", "sorted_ids",
               "sorted_lens", "perm")


def random_history(seed, steps=40):
    jol = build_random_oplog(seed, steps=steps)
    return jol, oplog_from_columns(export_columns(jol))


def twin_history(seed, rounds=5):
    tw = TwinDocs([JaxOpLog(), OpLog()], seed)
    tw.type_base("alice", 40)
    tw.fork(("alice", "bob", "carol"))
    for _ in range(rounds):
        tw.concurrent_round(("alice", "bob", "carol"), 3)
    return tw.oplogs


def histories():
    return [("random", s) for s in range(5)] + [("twin", s) for s in (1, 2)]


def history(kind, seed):
    return random_history(seed) if kind == "random" else twin_history(seed)


@pytest.mark.parametrize("source", ["python", "native"])
@pytest.mark.parametrize("kind,seed", histories())
def test_pack_and_execute_tape_match_jax(kind, seed, source):
    jol, tol = history(kind, seed)
    jplan, _jex, jtape, jrows = jpk.snapshot_rows(jol, [], source=source)
    stats = {}
    tplan, _tex, ttape, trows = tpk.snapshot_rows(tol, [], source=source,
                                                  device="cpu", stats=stats)
    assert len(tplan.entries) == len(jplan.entries) > 1
    for f in TAPE_FIELDS:
        a, b = getattr(jtape, f), getattr(ttape, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    for f in ("n_slots", "n_idx", "n_snaps", "snap_entries"):
        assert getattr(jtape, f) == getattr(ttape, f), f
    assert trows.dtype == torch.uint8
    assert np.array_equal(trows.numpy(), np.asarray(jrows))
    t = stats["tape"]
    assert t["write_runs"] + t["structural"] == t["segments"]
    assert t["structural"] >= len(tplan.entries)       # one SNAP each


def random_tape(rng, T, n_slots, n_idx, n_snaps, write_share):
    """A tape of random steps: WRITE runs of random length (ranges, states
    0-3, rows) between BEGIN, FORK, MAX and SNAP steps."""
    op = np.where(rng.random(T) < write_share, jpk.T_WRITE,
                  rng.integers(1, 5, T)).astype(np.int32)
    a = np.zeros(T, np.int32)
    b = np.zeros(T, np.int32)
    c = np.zeros(T, np.int32)
    d = np.zeros(T, np.int32)
    for t in range(T):
        if op[t] == jpk.T_WRITE:
            lo = int(rng.integers(0, n_slots))
            a[t], b[t] = lo, int(rng.integers(lo, n_slots + 1))
            c[t] = int(rng.integers(0, 4))
            d[t] = int(rng.integers(0, n_idx))
        elif op[t] == jpk.T_SNAP:
            a[t], b[t] = rng.integers(0, n_idx), rng.integers(0, n_snaps)
        else:
            a[t], b[t] = rng.integers(0, n_idx, 2)
    is_base = (rng.random(n_slots) < 0.3).astype(np.uint8)
    return op, a, b, c, d, is_base


@pytest.mark.parametrize("seed,T,write_share", [
    (0, 7, 0.5), (1, 200, 0.97), (2, 513, 0.9), (3, 64, 0.0),
    (4, 300, 1.0), (5, 1000, 0.995)])
def test_execute_tape_matches_jax_on_random_tapes(seed, T, write_share):
    """Long WRITE runs between structural steps, tapes of no power-of-two
    length (padding steps), tapes without WRITEs and without structural
    steps."""
    rng = np.random.default_rng(seed)
    n_slots, n_idx, n_snaps = int(rng.integers(1, 70)), 5, 6
    op, a, b, c, d, is_base = random_tape(rng, T, n_slots, n_idx, n_snaps,
                                          write_share)
    want = np.asarray(jpk.execute_tape_jax(op, a, b, c, d, is_base,
                                           n_slots, n_idx, n_snaps))
    stats = {}
    got = tpk.execute_tape(op, a, b, c, d, is_base, n_slots, n_idx, n_snaps,
                           device="cpu", stats=stats)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert stats["structural"] == int((op != tpk.T_WRITE).sum())
    assert stats["write_runs"] + stats["structural"] == stats["segments"]


def test_execute_tape_refuses_states_past_uint8():
    op = np.array([tpk.T_WRITE], np.int32)
    with pytest.raises(ValueError, match="uint8"):
        tpk.execute_tape(op, op * 0, op * 0 + 1, op * 0 + 256, op * 0,
                         np.zeros(1, np.uint8), 1, 1, 1, device="cpu")


def test_segments_cut_write_runs_at_structural_steps():
    W, B, S = tpk.T_WRITE, tpk.T_BEGIN, tpk.T_SNAP
    op = np.array([W, W, B, S, W, W, W, S, S, W], np.int32)
    assert tpk._segments(op) == [(0, 2), (2, 3), (3, 4), (4, 7), (7, 8),
                                 (8, 9), (9, 10)]
    assert tpk._segments(np.array([B], np.int32)) == [(0, 1)]


@pytest.mark.parametrize("source", ["python", "native"])
@pytest.mark.parametrize("kind,seed", histories())
def test_texts_at_versions_match_jax_and_host(kind, seed, source):
    jol, tol = history(kind, seed)
    plan = tpk.compile_plan2(tol.cg.graph, [], list(tol.version))
    ks = list(range(len(plan.entries)))
    want = jpk.texts_at_versions(jol, ks, source=source)
    stats = {}
    got = tpk.texts_at_versions(tol, ks, source=source, device="cpu",
                                stats=stats)
    assert got == want
    assert stats["k3_calls"] == 1 and stats["versions"] == len(ks)
    for k in ks:
        f = tpk.entry_frontier(tol.cg.graph, plan, k)
        assert f == jpk.entry_frontier(jol.cg.graph, plan, k)
        assert got[k] == tol.checkout(f).snapshot(), k


def test_texts_at_versions_split_over_devices_and_from_a_mid_version():
    jol, tol = random_history(4)
    mid = list(tol.cg.graph.find_dominators([len(tol) // 2]))
    plan = tpk.compile_plan2(tol.cg.graph, mid, list(tol.version))
    ks = list(range(0, len(plan.entries), 2))
    want = jpk.texts_at_versions(jol, ks, from_frontier=mid,
                                 source="native")
    for devices in ([torch.device("cpu")], ["cpu"] * 3):
        stats = {}
        got = tpk.texts_at_versions(tol, ks, from_frontier=mid,
                                    source="native", devices=devices,
                                    stats=stats)
        assert got == want
        assert stats["k3_calls"] == min(len(devices), len(ks))


def test_texts_at_versions_use_k3_with_shared_rows(monkeypatch):
    """One K3 call whose order, offsets and arena are single shared rows
    (no copy per version), over [versions, n_slots] visibility."""
    _jol, tol = random_history(2)
    seen = []
    real = kernels.materialize_runs

    def spy(perm, vis, off, arena, cap):
        seen.append((tuple(perm.shape), tuple(vis.shape), tuple(off.shape),
                     tuple(arena.shape), cap))
        return real(perm, vis, off, arena, cap)

    monkeypatch.setattr(kernels, "materialize_runs", spy)
    plan = tpk.compile_plan2(tol.cg.graph, [], list(tol.version))
    ks = list(range(len(plan.entries)))
    tpk.texts_at_versions(tol, ks, device="cpu")
    [(perm, vis, off, arena, cap)] = seen
    assert perm[0] == off[0] == arena[0] == 1
    assert vis[0] == len(ks) and vis[1] == perm[1] == off[1]
    assert cap & (cap - 1) == 0


def test_shared_row_materialize_equals_expanded_rows():
    rng = np.random.default_rng(5)
    b, n, pool, cap = 6, 50, 300, 128
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))[None]
    vis = torch.from_numpy(rng.integers(0, 9, (b, n)).astype(np.int32))
    vis[:, ::3] = 0
    off = torch.from_numpy(rng.integers(0, pool, n).astype(np.int32))[None]
    arena = torch.from_numpy(rng.integers(1, 999, pool).astype(np.int32))[None]
    got = materialize(perm, vis, off, arena, cap)
    want = materialize(perm.expand(b, n).contiguous(), vis,
                       off.expand(b, n).contiguous(),
                       arena.expand(b, pool).contiguous(), cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[1].max()) > cap                 # some rows truncated
    via = kernels.materialize_runs(perm, vis, off, arena, cap)
    assert all(torch.equal(g, w) for g, w in zip(via, want))
    with pytest.raises(ValueError):
        kernels.materialize_runs(perm[:, :-1], vis, off, arena, cap)
    with pytest.raises(ValueError):
        kernels.materialize_runs(perm.expand(2, n), vis, off, arena, cap)


@pytest.mark.parametrize("seed", range(4))
def test_origin_query_matches_jax(seed):
    jol, tol = random_history(10 + seed)
    _plan, _ex, tape, rows = tpk.snapshot_rows(tol, [], device="cpu")
    sid, slen = tape.sorted_ids, tape.sorted_lens
    len_ord = np.where(sid >= tpk.UNDERWATER_START, 0, slen)[tape.perm]
    rng = np.random.default_rng(seed)
    for r in range(rows.shape[0]):
        row_ord = rows[r].numpy()[tape.perm].astype(np.int32)
        vis_total = int((len_ord * (row_ord == 1)).sum())
        pos = rng.integers(0, vis_total + 1, 12).astype(np.int32)
        pos[:2] = (0, vis_total)
        want = jpk.origin_query_jax(jnp.asarray(row_ord),
                                    jnp.asarray(len_ord.astype(np.int32)),
                                    jnp.asarray(pos))
        got = tpk.origin_query(torch.from_numpy(row_ord),
                               torch.from_numpy(len_ord.astype(np.int32)),
                               torch.from_numpy(pos))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_lazy_cummin_matches_jax():
    x = np.random.default_rng(3).integers(-50, 50, 333).astype(np.int32)
    assert np.array_equal(tpk.lazy_cummin(torch.from_numpy(x)).numpy(),
                          np.asarray(jpk.jax_lazy_cummin(jnp.asarray(x))))


def test_snapshot_entry_out_of_range_raises():
    _jol, tol = random_history(1)
    plan = tpk.compile_plan2(tol.cg.graph, [], list(tol.version))
    with pytest.raises(IndexError):
        tpk.snapshot_rows(tol, [], entries=[len(plan.entries)],
                          device="cpu")
    with pytest.raises(ValueError, match="source"):
        tpk.snapshot_rows(tol, [], source="zone", device="cpu")
