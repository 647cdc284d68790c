"""The port's hand-written kernels on a CUDA card.

K1, K2 and K3 have no CPU mode, so these tests skip without a card (each
decides inside the test). They import nothing of JAX: run them on a card
host with `python -m pytest tests/test_torch_cuda.py -m cuda -q`.
`chip_smoke.py` covers the same ground at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import flush_fuse as ff
from diamond_types_tpu_torch.gpu import (kernels, linearize, merge_kernel,
                                         xform)
from diamond_types_tpu_torch.native.core import merge_native

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no "
                    "interpret mode")


def _window(seed, b, n, cap, mi):
    rng = np.random.default_rng(seed)
    docs = rng.integers(1, 0x10FFFF, (b, cap))
    lens = rng.integers(0, cap, b)
    pos = np.where(rng.random((b, n)) < 0.3,
                   cap - rng.integers(1, mi + 2, (b, n)),
                   rng.integers(0, cap + 3, (b, n)))
    kind = rng.integers(0, 4, (b, n))
    dlen = np.where(kind % 3 != 0, rng.integers(1, mi + 1, (b, n)), 0)
    ilen = np.where(kind % 2 == 0, rng.integers(1, mi + 1, (b, n)), 0)
    ilen[kind == 3] = 0
    chars = rng.integers(1, 0x10FFFF, (b, n, mi))
    dlen[0, n // 2] = mi + 1                       # poisons row 0
    lens[-1] = -1                                  # inert padding row
    pos[-1] = dlen[-1] = ilen[-1] = 0
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
            for a in (docs, lens, pos, dlen, ilen, chars)]


@pytest.mark.parametrize("b,n,cap", [(3, 8, 256), (8, 64, 4096),
                                     (4, 16, 32768), (4, 16, 65536)])
def test_kernel_matches_plain_on_card(b, n, cap):
    _need_card()
    mi = 16
    args = _window(cap + n, b, n, cap, mi)
    before = [a.clone() for a in args]
    launches = kernels.apply_ops_window.launches
    got_d, got_l = kernels.apply_ops_window(*args, mi)
    torch.cuda.synchronize()
    assert kernels.apply_ops_window.launches == launches + 1
    want_d, want_l = kernels.apply_ops_window_plain(*args, mi)
    assert torch.equal(got_d, want_d) and torch.equal(got_l, want_l)
    assert int(got_l[0]) == -1 and int(got_l[-1]) == -1
    for a, a0 in zip(args, before):                # inputs never written
        assert torch.equal(a, a0)


@pytest.mark.parametrize("b,n,cap,mi", [(8, 256, 32768, 16),
                                        (8, 256, 4100, 16),
                                        (5, 64, 16, 16), (4, 40, 64, 64),
                                        (3, 1, 4100, 16),
                                        (2, 1500, 8192, 16)])
def test_k1_tiled_gather_hazards_on_card(b, n, cap, mi):
    """K1's tiled gather at the main path's bucket (b 8, cap 32,768), at a
    cap that is no multiple of the tile, at cap == max_ins, with one op,
    and with a tape past one staging tile of op scalars."""
    _need_card()
    args = _window(cap * 7 + n, b, n, cap, mi)
    before = [a.clone() for a in args]
    launches = kernels.apply_ops_window.launches
    got_d, got_l = kernels.apply_ops_window(*args, mi)
    torch.cuda.synchronize()
    assert kernels.apply_ops_window.launches == launches + 1
    want_d, want_l = kernels.apply_ops_window_plain(*args, mi)
    assert torch.equal(got_d, want_d) and torch.equal(got_l, want_l)
    for a, a0 in zip(args, before):
        assert torch.equal(a, a0)


@pytest.mark.parametrize("b,n,cap", [(8, 256, 32768), (4, 1300, 8192)])
def test_k1_jumps_past_the_edits_on_card(b, n, cap):
    """Edits in the first quarter of each row, so the warps past them jump
    every staged tile of ops (one tile, and a tape of three)."""
    _need_card()
    mi = 16
    args = _window(cap + 3 * n, b, n, cap, mi)
    args[2] = args[2] // 4
    before = [a.clone() for a in args]
    launches = kernels.apply_ops_window.launches
    got_d, got_l = kernels.apply_ops_window(*args, mi)
    torch.cuda.synchronize()
    assert kernels.apply_ops_window.launches == launches + 1
    want_d, want_l = kernels.apply_ops_window_plain(*args, mi)
    assert torch.equal(got_d, want_d) and torch.equal(got_l, want_l)
    for a, a0 in zip(args, before):
        assert torch.equal(a, a0)


def test_kernel_rung_on_card_matches_cpu_sessions():
    """The same oplogs flushed through CUDA sessions (K1) and CPU
    sessions (K1's plain version): equal fences, texts and buffers; a
    poisoned row keeps its pre-window state on the card."""
    _need_card()
    rng = np.random.default_rng(1)
    ols = []
    for d in range(5):
        ol = OpLog()
        a = ol.get_or_create_agent_id("a")
        ol.add_insert(a, 0, "x" * int(rng.integers(50, 400)))
        ols.append(ol)
    gpu = [ff.FusedDocSession(ol, max_ins=4, device="cuda") for ol in ols]
    cpu = [ff.FusedDocSession(ol, max_ins=4, device="cpu") for ol in ols]
    for w in range(3):
        for ol in ols:
            b = ol.get_or_create_agent_id(f"b{w}")
            ol.add_insert_at(b, [int(rng.integers(3, 40))], 3, "concurrent!")
            ol.add_delete_without_content(
                ol.get_or_create_agent_id("a"), 1, 9)
        gplans = [s.plan_tail() for s in gpu]
        cplans = [s.plan_tail() for s in cpu]
        if w == 1:
            gplans[2].dlen[0] = cplans[2].dlen[0] = 5     # > max_ins
        kept = gpu[2].docs.clone()
        by_cap = {}
        for i, s in enumerate(gpu):
            by_cap.setdefault(s.cap, []).append(i)
        for idx in by_cap.values():
            gok, _ = ff.kernel_fused_replay([gpu[i] for i in idx],
                                            [gplans[i] for i in idx])
            cok, _ = ff.kernel_fused_replay([cpu[i] for i in idx],
                                            [cplans[i] for i in idx])
            assert gok == cok
        if w == 1:
            assert torch.equal(gpu[2].docs, kept)
            gpu[2] = ff.FusedDocSession(ols[2], max_ins=4, device="cuda")
            cpu[2] = ff.FusedDocSession(ols[2], max_ins=4, device="cpu")
        for g, c, ol in zip(gpu, cpu, ols):
            assert g.text() == c.text() == ol.checkout_tip().snapshot()
            assert torch.equal(g.docs.cpu(), c.docs)


@pytest.mark.parametrize("b,n", [(1, 2), (3, 511), (8, 513), (4, 4096)])
def test_k2_matches_plain_on_card(b, n):
    _need_card()
    rng = np.random.default_rng(b * n)
    nv = rng.integers(0, 9, (b, n))
    ov = rng.integers(0, 9, (b, n))
    ov[-1] = nv[-1] + 1                  # prefix sum negative throughout
    nv, ov = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
              for a in (nv, ov))
    launches = kernels.xform_positions.launches
    got = kernels.xform_positions(nv, ov)
    torch.cuda.synchronize()
    assert kernels.xform_positions.launches == launches + 1
    want = kernels.xform_positions_plain(nv, ov)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2][-1]) == 0


@pytest.mark.parametrize("b", [1, 7, 256, 257])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 256, 257, 2047, 2048,
                               2049, 4096])
def test_k2_row_path_edges_on_card(b, n):
    """K2 at the edges of its warp's 128-element chunks and past 2,048
    elements, with a row whose prefix sum of nv - ov is negative
    throughout and a row that wraps int32."""
    _need_card()
    rng = np.random.default_rng(b * 10007 + n)
    nv = rng.integers(0, 49, (b, n))
    ov = rng.integers(0, 49, (b, n))
    ov[-1] = nv[-1] + 1
    if b > 1:
        nv[0] = rng.integers(1 << 29, 1 << 30, n)     # wraps past 2**31
    nv, ov = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
              for a in (nv, ov))
    before = (nv.clone(), ov.clone())
    launches = kernels.xform_positions.launches
    got = kernels.xform_positions(nv, ov)
    torch.cuda.synchronize()
    assert kernels.xform_positions.launches == launches + 1
    want = kernels.xform_positions_plain(nv, ov)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2][-1]) == 0
    assert torch.equal(nv, before[0]) and torch.equal(ov, before[1])


K3_TILE = 512     # outputs per CTA of K3's gather


def _k3_table(kind, b, n, cap, seed):
    """A run table [b, n] for K3 at one hazard of its tiled gather, its
    runs' lengths and arena offsets set in document (perm) order. "random":
    lengths 0-5 with 30% empty runs, so cap < total truncates and runs
    start past cap when n is large; the hazards are named for what they
    hold."""
    rng = np.random.default_rng(seed)
    pool = 3 * n + 16
    vl = rng.integers(0, 6, (b, n)) * (rng.random((b, n)) < 0.7)
    off = rng.integers(0, pool, (b, n))
    if kind == "total_zero":
        vl[:] = 0
    elif kind == "one_run_spans_every_tile":
        pool = cap + 200
        vl[:] = 0
        vl[:, 0] = cap + 100
        vl[-1, 0], vl[-1, 1] = 0, cap + 3      # behind a zero-length run
        off = rng.integers(0, 50, (b, n))
    elif kind == "zero_length_runs_then_live_run":
        # a live run, then 3 tiles' worth of zero-length runs that start
        # where it ends (the next tile's first output; in the last row
        # inside a thread's 4 outputs), then live runs
        vl[:, :3 * K3_TILE + 2] = 0
        vl[:, 0] = K3_TILE
        vl[-1, 0] = K3_TILE - 2
        vl[:, 3 * K3_TILE + 1] = 5
    elif kind == "arena_off_past_pool":
        off[0] = rng.integers(pool, pool + 5000, n)
        off[-1, ::2] = -rng.integers(1, 5000, (n + 1) // 2)
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    vis = np.zeros((b, n), np.int64)
    offs = np.zeros((b, n), np.int64)
    for r in range(b):
        vis[r, perm[r]] = vl[r]
        offs[r, perm[r]] = off[r]
    arena = rng.integers(1, 0x10FFFF, (b, pool))
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
            for a in (perm, vis, offs, arena)]


@pytest.mark.parametrize("kind,b,n,cap", [
    ("random", 2, 1, 8), ("random", 3, 100, 64), ("random", 4, 16384, 8192),
    ("random", 2, 70000, 4096), ("random", 3, 900, 4100),
    ("random", 2, 100, 387), ("random", 1, 2048, 65536),
    ("random", 1, 30000, 65536), ("random", 163, 2048, 16384),
    ("total_zero", 2, 50, 300), ("random", 2, 0, 64),
    ("one_run_spans_every_tile", 2, 6, 16384),
    ("zero_length_runs_then_live_run", 2, 3 * K3_TILE + 64, 4 * K3_TILE),
    ("arena_off_past_pool", 3, 64, 512)])
def test_k3_matches_plain_on_card(kind, b, n, cap):
    """K3's two kernels against its plain version: truncation (cap <
    total), empty runs, runs past cap, 70,000 runs; a cap that is no
    multiple of the gather's tile, an odd cap (scalar stores), b 1 at cap
    65,536 (zero-filled and truncated), the main path's widest call; and
    the hazards of the tiled gather by name. One call counts one launch,
    and the inputs are never written."""
    _need_card()
    args = _k3_table(kind, b, n, cap, b + n + cap)
    before = [a.clone() for a in args]
    launches = kernels.materialize_runs.launches
    got_t, got_n = kernels.materialize_runs(*args, cap)
    torch.cuda.synchronize()
    assert kernels.materialize_runs.launches == launches + 1
    want_t, want_n = linearize.materialize(*args, cap)
    assert torch.equal(got_t, want_t) and torch.equal(got_n, want_n)
    for a, a0 in zip(args, before):
        assert torch.equal(a, a0)
    if kind == "total_zero":
        assert not got_t.any()


def test_device_transform_and_checkout_on_card_match_cpu():
    """plan_tails_device and checkout_batch_device on CUDA sessions (K2,
    K3) give the CPU plain path's plans and texts."""
    _need_card()
    from torch_parity import TwinDocs
    twins = []
    for i in range(4):
        tw = TwinDocs([OpLog()], 20 + i)
        tw.type_base("a", 80 + 40 * i)
        tw.fork(["a", "b", "c"])
        tw.concurrent_round(["a", "b", "c"], 5)
        twins.append(tw)
    ols = [tw.oplogs[0] for tw in twins]
    for tw in twins:
        tw.concurrent_round(["a", "b", "c"], 5)
    gpu = [ff.FusedDocSession(ol, max_ins=4, device="cuda") for ol in ols]
    cpu = [ff.FusedDocSession(ol, max_ins=4, device="cpu") for ol in ols]
    for tw in twins:
        tw.concurrent_round(["a", "b", "c"], 5)
    launches = kernels.xform_positions.launches
    gplans, gstats = xform.plan_tails_device(gpu)
    cplans, cstats = xform.plan_tails_device(cpu)
    assert gstats == cstats and gstats["device_docs"] > 0
    assert kernels.xform_positions.launches == launches + 1
    for g, c in zip(gplans, cplans):
        assert g.frontier == c.frontier and g.new_len == c.new_len
        assert np.array_equal(g.pos, c.pos) and np.array_equal(g.chars,
                                                               c.chars)
    docs = [merge_kernel.prepare_doc(ol) for ol in ols]
    launches = kernels.materialize_runs.launches
    got = merge_kernel.checkout_batch_device(docs)
    assert kernels.materialize_runs.launches == launches + 1
    assert got == merge_kernel.checkout_batch_device(docs, device="cpu") \
        == [ol.checkout_tip().snapshot() for ol in ols]


@pytest.mark.parametrize("workers", [False, True])
def test_scheduler_on_card_launches_k1_and_k2(workers):
    """16 documents through MergeScheduler on CUDA sessions with device
    planning: every text equals the host's, no host fallback, K1 launched
    once per fused group and per replayed per-doc sync, K2 once per
    resolve."""
    _need_card()
    import threading
    from diamond_types_tpu_torch.serve import MergeScheduler
    from torch_parity import serve_docs, serve_round
    docs = serve_docs([OpLog], 16, 30, base_min=200, base_max=3000)
    ols = {d: tw.oplogs[0] for d, tw in docs.items()}
    sched = MergeScheduler(4, resolve=ols.__getitem__, engine="device",
                           fused_opts={"max_ins": 16}, device_plan=True,
                           flush_docs=8, flush_deadline_s=10.0,
                           flush_workers=workers,
                           max_sessions_per_shard=16,
                           sync_lock=threading.Lock())
    assert sched.banks[0].device.type == "cuda"
    for d in docs:
        sched.submit(d, 1)
    sched.drain()                       # build every session
    syncs = []
    real = ff.FusedDocSession.sync

    def counted(self):
        n = real(self)
        syncs.append(n)
        return n
    ff.FusedDocSession.sync = counted
    k1, k2 = kernels.apply_ops_window, kernels.xform_positions
    k1.launches = k2.launches = 0
    try:
        for rnd in range(3):
            for d, n in serve_round(docs, 30, rnd, share=0.9):
                assert sched.submit(d, n)["accepted"]
            sched.pump()
            sched.drain()
    finally:
        ff.FusedDocSession.sync = real
    torch.cuda.synchronize()
    m = sched.metrics_json()
    replayed = sum(1 for n in syncs if n > 0)
    assert k1.launches == m["fused"]["device_calls"] + replayed > 0
    assert k2.launches == m["transform"]["batches"] > 0
    assert m["totals"]["host_fallbacks"] == 0
    assert m["transform"]["device_docs"] > 0
    for d, ol in ols.items():
        assert sched.text(d) == ol.checkout_tip().snapshot()
    sched.stop_workers()


def test_window_scheduler_on_card_launches_k1_once_per_class():
    """16 documents through MergeScheduler(mesh_window=True) on CUDA
    sessions with device planning: every text equals the host's, no host
    fallback, K1 launched once per (cap, max_ins) class per window (one
    card: one device slice) plus the per-doc replays, and K2 once per
    window that had device-planned tails."""
    _need_card()
    import threading
    from diamond_types_tpu_torch.gpu import flush_fuse as ffm
    from diamond_types_tpu_torch.serve import MergeScheduler
    from torch_parity import serve_docs, serve_round
    docs = serve_docs([OpLog], 16, 31, base_min=200, base_max=3000)
    ols = {d: tw.oplogs[0] for d, tw in docs.items()}
    sched = MergeScheduler(4, resolve=ols.__getitem__, engine="device",
                           fused_opts={"max_ins": 16}, device_plan=True,
                           flush_docs=8, flush_deadline_s=10.0,
                           mesh_window=True, max_sessions_per_shard=16,
                           sync_lock=threading.Lock())
    assert sched.banks[0].device.type == "cuda"
    for d in docs:
        sched.submit(d, 1)
    sched.drain()                       # build every session
    syncs, per_window = [], []
    real_sync, real_window = ff.FusedDocSession.sync, sched._flush_window

    def counted(self):
        n = real_sync(self)
        syncs.append(n)
        return n

    def window(taken):
        k1 = kernels.apply_ops_window.launches
        d0 = sched.metrics_json()["window"]["dispatches"]
        s0 = len(syncs)
        out = real_window(taken)
        classes = sched.metrics_json()["window"]["dispatches"] - d0
        replays = sum(1 for n in syncs[s0:] if n > 0)
        per_window.append((kernels.apply_ops_window.launches - k1,
                           classes + replays))
        return out
    ff.FusedDocSession.sync = counted
    sched._flush_window = window
    k1, k2 = kernels.apply_ops_window, kernels.xform_positions
    k1.launches = k2.launches = 0
    try:
        for rnd in range(3):
            for d, n in serve_round(docs, 31, rnd, share=0.9):
                assert sched.submit(d, n)["accepted"]
            sched.pump()
            sched.drain()
    finally:
        ff.FusedDocSession.sync = real_sync
    torch.cuda.synchronize()
    m = sched.metrics_json()
    assert per_window and all(got == want for got, want in per_window)
    assert m["window"]["dispatches"] > 0 and m["fused"]["device_calls"] == 0
    assert k2.launches == m["transform"]["batches"] > 0
    assert k2.launches <= len(per_window)
    assert m["totals"]["host_fallbacks"] == 0
    assert ffm.apply_ops_window is kernels.apply_ops_window
    for d, ol in ols.items():
        assert sched.text(d) == ol.checkout_tip().snapshot()


@pytest.mark.parametrize("b,n,cap", [(1, 300, 512), (256, 2048, 8192),
                                     (33, 5000, 1000)])
def test_k3_shared_rows_match_plain_on_card(b, n, cap):
    """The history path's form: perm, arena_off and arena are one shared
    row (stride 0); cap < total on some rows, zero-length runs."""
    _need_card()
    rng = np.random.default_rng(b + n)
    pool = 4 * n
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))[None]
    vis = rng.integers(0, 7, (b, n)) * (rng.random((b, n)) < 0.6)
    off = rng.integers(0, pool - 7, n)
    arena = rng.integers(1, 0x10FFFF, pool)
    vis_t, off_t, arena_t = (torch.from_numpy(np.ascontiguousarray(
        a, np.int32)) for a in (vis, off[None], arena[None]))
    args = [t.cuda() for t in (perm, vis_t, off_t, arena_t)]
    launches = kernels.materialize_runs.launches
    got = kernels.materialize_runs(*args, cap)
    torch.cuda.synchronize()
    assert kernels.materialize_runs.launches == launches + 1
    want = linearize.materialize(perm, vis_t, off_t, arena_t, cap)
    expanded = kernels.materialize_runs(
        args[0].expand(b, n).contiguous(), args[1],
        args[2].expand(b, n).contiguous(),
        args[3].expand(b, pool).contiguous(), cap)
    for g, w, e in zip(got, want, expanded):
        assert torch.equal(g.cpu(), w) and torch.equal(e, g)


def test_graph_kernels_on_card_match_cpu(monkeypatch):
    _need_card()
    from diamond_types_tpu_torch import Graph
    from diamond_types_tpu_torch.gpu import graph_kernels as gk
    g = Graph()
    for i in range(300):
        g.push([], 8 * i, 8 * i + 8)
    lv = 2400
    g.push([8 * i + 7 for i in range(300)], lv, lv + 8)
    for _ in range(40):
        g.push([lv + 6], lv + 8, lv + 16)
        lv += 8
    n_lv = lv + 8
    rng = np.random.default_rng(1)
    fr = gk.frontier_matrix([sorted(set(rng.integers(0, n_lv, 2).tolist()))
                             for _ in range(64)])
    targets = rng.integers(-1, n_lv, 64).astype(np.int32)
    for k in (1, 16):
        monkeypatch.setattr(gk, "CHECK_EVERY", k)
        got = gk.make_contains_fn(g, "cuda")(fr, targets)
        want = gk.make_contains_fn(g, "cpu")(fr, targets)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    a, b = np.array([n_lv - 1], np.int32), np.array([2399, 17], np.int32)
    ra, rb = gk.make_diff_fn(g, "cuda")(a, b)
    assert gk.diff_to_spans(g, ra, rb) == tuple(g.diff([n_lv - 1],
                                                       [17, 2399]))


# ---- X8: the zone engine's tape --------------------------------------------

def _zone_doc(seed, base=120, rounds=3):
    """A concurrent history of three agents (`torch_parity.TwinDocs`)."""
    from torch_parity import TwinDocs
    agents = ("alice", "bob", "carol")
    tw = TwinDocs([OpLog()], seed)
    tw.type_base(agents[0], base)
    tw.fork(agents)
    for _ in range(rounds):
        tw.concurrent_round(agents, 4)
    return tw.oplogs[0]


# X8's launch shapes: every cluster size in both memory forms
CLUSTERS = [(c, smem) for smem in (True, False) for c in (1, 2, 4, 8, 16)]


def _zone_case(seed, budgets, batch):
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    from diamond_types_tpu_torch.listmerge.zone_np import prepare_zone
    key = (seed, budgets, batch)
    if key not in _ZONE_CASES:
        ol = _zone_doc(seed)
        prep = prepare_zone(ol)
        tape = zk.pack_zone_tape(prep, *budgets)
        want = zk.run_zone_plain(_zone_carry(tape, prep, batch, "cpu"),
                                 zk.tape_xs(tape, "cpu"), tape.plen)
        _ZONE_CASES[key] = (ol, prep, tape, want)
    return _ZONE_CASES[key]


_ZONE_CASES = {}


def _zone_carry(tape, prep, batch, dev):
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    return zk.init_zone_carry(tape.W, tape.plen, tape.n_idx, prep.agent_k,
                              prep.seq_k, batch=batch, device=dev)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("budgets", [(8, 512, 16), (2, 8, 2)])
@pytest.mark.parametrize("seed", [1, 2])
def test_zone_tape_matches_plain_on_card(seed, budgets, batch, cluster):
    """X8 at every forced cluster size and form equals the plain version
    on all ten planes; sliced launches continue it in place."""
    _need_card()
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    ol, prep, tape, want = _zone_case(seed, budgets, batch)
    got = _zone_carry(tape, prep, batch, "cuda")
    launches = kernels.zone_tape_run.launches
    assert kernels.zone_tape_run(got, zk.tape_xs(tape, "cuda"), tape.plen,
                                 cluster=cluster) is got
    torch.cuda.synchronize()
    assert kernels.zone_tape_run.launches == launches + 1
    for name, g, w in zip(zk.ZoneCarry._fields, got, want):
        assert torch.equal(g.cpu(), w), name
    # sliced: one launch per slice on the resident carry
    _s, parts = zk.slice_tape_xs(tape, 5, "cuda")
    sliced = _zone_carry(tape, prep, batch, "cuda")
    for xs in parts:
        kernels.zone_tape_run(sliced, xs, tape.plen, cluster=cluster)
    for name, g, w in zip(zk.ZoneCarry._fields, sliced, got):
        assert torch.equal(g, w), name
    if cluster == (1, True):
        assert zk.zone_checkout_device(ol, prep=prep, tape=tape)[0] == \
            merge_native(ol, "", [], ol.version)[0]


@pytest.mark.parametrize("cluster", [(2, True), (16, True), (4, False),
                                     (16, False)])
def test_zone_tape_halves_continue_on_card(cluster):
    """Two launches over the two halves of a tape equal one launch over
    the whole tape: the carry continues in place at c > 1."""
    _need_card()
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    _ol, prep, tape, want = _zone_case(2, (8, 512, 16), 2)
    xs = zk.tape_xs(tape, "cuda")
    half = len(tape.op) // 2
    whole = _zone_carry(tape, prep, 2, "cuda")
    kernels.zone_tape_run(whole, xs, tape.plen, cluster=cluster)
    halves = _zone_carry(tape, prep, 2, "cuda")
    for part in ({k: v[:half] for k, v in xs.items()},
                 {k: v[half:] for k, v in xs.items()}):
        kernels.zone_tape_run(halves, part, tape.plen, cluster=cluster)
    torch.cuda.synchronize()
    for name, a, b, w in zip(zk.ZoneCarry._fields, halves, whole, want):
        assert torch.equal(a, b), name
        assert torch.equal(b.cpu(), w), name


def _fork_tape(W):
    """A carry of W slots and n_idx 6, and a tape of one self-FORK."""
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    c = zk.init_zone_carry(W, 0, 6, np.zeros(W, np.int32),
                           np.zeros(W, np.int32), device="cuda")
    xs = {k: torch.zeros((1,) if k in zk.XS_KEYS[:4] else (1, 1),
                         dtype=torch.int32, device="cuda")
          for k in zk.XS_KEYS}
    xs["op"].fill_(zk.OP_FORK)
    return c, xs


def test_zone_tape_cluster_limits_on_card():
    """The library's shared-memory sizes and budget equal the wrapper's
    mirror; the card launches clusters of 8 and 16 at the history zone's
    shape (a launch whose cluster the card cannot hold raises); a forced
    shape whose slice does not fit raises, with no launch."""
    _need_card()
    lib = kernels._lib("zone_tape")
    assert lib.dt_zone_tape_smem_budget() == kernels.ZONE_SMEM_BUDGET
    for W, n_idx in ((38029, 6), (87296, 6), (300, 20), (17, 1)):
        for c in kernels.CLUSTER_SIZES:
            assert lib.dt_zone_tape_smem_bytes(W, n_idx, c) == \
                kernels.zone_smem_bytes(W, n_idx, c)
    assert kernels.cluster_size(1, 38029, 6) == (16, True)
    for shape in ((16, True), (8, True)):
        c, xs = _fork_tape(38029)
        kernels.zone_tape_run(c, xs, 0, cluster=shape)
        torch.cuda.synchronize()
    W = 100_000
    c, xs = _fork_tape(W)
    launches = kernels.zone_tape_run.launches
    with pytest.raises(ValueError, match="does not fit"):
        kernels.zone_tape_run(c, xs, 0, cluster=(16, True))
    with pytest.raises(ValueError, match="cluster size"):
        kernels.zone_tape_run(c, xs, 0, cluster=(3, False))
    assert kernels.zone_tape_run.launches == launches
    assert kernels.cluster_size(1, W, 6) == (16, False)


def test_zone_session_on_card_matches_tracker():
    _need_card()
    from torch_parity import TwinDocs
    from diamond_types_tpu_torch.gpu.zone_session import DeviceZoneSession
    agents = ("alice", "bob", "carol")
    tw = TwinDocs([OpLog()], 9)
    tw.type_base(agents[0], 80)
    tw.fork(agents)
    ol = tw.oplogs[0]
    sess = DeviceZoneSession(ol, max_chars=32)
    assert sess.carry.rank.device.type == "cuda"
    launches = kernels.zone_tape_run.launches
    for _ in range(6):
        tw.concurrent_round(agents, 2)
        sess.sync()
        assert sess.text() == merge_native(ol, "", [], ol.version)[0]
    assert kernels.zone_tape_run.launches > launches


def test_zone_tape_run_refuses_bad_inputs_on_card():
    _need_card()
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    from diamond_types_tpu_torch.listmerge.zone_np import prepare_zone
    ol = _zone_doc(3, rounds=1)
    prep = prepare_zone(ol)
    tape = zk.pack_zone_tape(prep)
    xs = zk.tape_xs(tape, "cuda")
    c = zk.init_zone_carry(tape.W, tape.plen, tape.n_idx, prep.agent_k,
                           prep.seq_k, device="cuda")
    with pytest.raises(TypeError, match="state"):
        kernels.zone_tape_run(c._replace(state=c.state.int()), xs, tape.plen)
    with pytest.raises(ValueError, match="cpu"):
        kernels.zone_tape_run(c._replace(m=c.m.cpu()), xs, tape.plen)
    with pytest.raises(ValueError, match="cpu"):
        kernels.zone_tape_run(c, dict(xs, op=xs["op"].cpu()), tape.plen)
    wide = {k: (v.repeat(1, 5) if k.startswith("blk_") else v)
            for k, v in xs.items()}
    with pytest.raises(RuntimeError, match="invalid argument"):
        kernels.zone_tape_run(c, wide, tape.plen)      # MB 40 > 32


def test_hydrated_scheduler_on_card_at_the_smokes_shape():
    """The smoke's hydrated scheduler phase at its document shape (256
    documents of 2,048-12,288 chars, 4 shards, a Hydrator with 64 warm
    slots over `TieredStore` homes, waves of 32), 2 rounds on per-shard
    workers and 1 with the flush window: every text equal to the mirror's
    merge after its wave and after re-hydration from disk, 0 flush leaks,
    quarantines and host fallbacks, K1/K2 launch counts matching the
    fused calls, replays and resolves, and every K1 and K2 call captured
    on the path held exactly against its plain version (all checked
    inside `run_scheduler_hydrated`)."""
    _need_card()
    import chip_smoke as cs
    out = cs.run_scheduler_hydrated(
        np.random.default_rng([0, 5]), torch.device("cuda"),
        cs.ServeConfig(), cs.SchedulerConfig(profile_round=-1),
        cs.HydratedConfig(rounds=2, window_rounds=1, profile_round=-1))
    assert out["launches"] > 0 and out["k2_launches"] > 0
    assert out["k1_max_abs_err"] == 0 and out["k2_max_abs_err"] == 0
    assert out["k1_calls_checked"] == out["launches"]
    assert out["summary"]["flush_leaks"] == 0
    assert out["summary"]["stale_oplog_rebuilds"] > 0
    assert out["lock_witness"]["acyclic"]


def test_qos_scheduler_phase_on_card():
    """The smoke's scheduler_qos phase at a quarter of its documents and
    three rounds (free, warning, burning): the controller steps every
    round, texts equal the host mirror, no sheddable admit while burning,
    every K1 and K2 call equal to its plain version (all checked inside
    `run_scheduler_qos`)."""
    _need_card()
    import chip_smoke as cs
    out = cs.run_scheduler_qos(
        np.random.default_rng([0, 16]), torch.device("cuda"),
        cs.ServeConfig(n_docs=64), cs.SchedulerConfig(),
        cs.QosConfig(interactive=32, bulk=20, catchup=12, rounds=3,
                     warning_round=1, burning_round=2, arrival_s=0.3,
                     profile_round=-1))
    assert out["launches"] > 0 and out["k2_launches"] > 0
    assert out["k1_max_abs_err"] == 0 and out["k2_max_abs_err"] == 0
    assert out["k1_calls_checked"] == out["launches"]
    assert all(r["controller_steps"] > 0 for r in out["rounds"])
    burning = out["rounds"][2]["classes"]
    assert burning["bulk"]["shed"] == 20 and burning["catchup"]["shed"] == 12
    assert out["rounds"][1]["classes"]["bulk"]["deferred"] == 20
    assert out["lock_witness"]["acyclic"]


@pytest.mark.parametrize("b,n,cap,mi", [(4, 8, 64, 16), (128, 64, 4096, 16),
                                        (3, 300, 1024, 4)])
def test_replay_batch_kernel_matches_plain_on_card(b, n, cap, mi):
    """`replay_batch_kernel` (one K1 launch from empty rows) against its
    plain version, rows poisoned by an op out of contract included."""
    _need_card()
    rng = np.random.default_rng(b + n + cap)
    pos = rng.integers(0, cap // 2, (b, n))
    kind = rng.integers(0, 3, (b, n))
    dlen = np.where(kind == 1, rng.integers(1, mi + 1, (b, n)), 0)
    ilen = np.where(kind != 1, rng.integers(1, mi + 1, (b, n)), 0)
    ilen[0, n // 2] = mi + 1                       # poisons row 0
    chars = rng.integers(1, 0x10FFFF, (b, n, mi))
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
            for a in (pos, dlen, ilen, chars)]
    kernels.apply_ops_window.launches = 0
    got_d, got_l = kernels.replay_batch_kernel(*args, cap=cap)
    torch.cuda.synchronize()
    assert kernels.apply_ops_window.launches == 1
    want_d, want_l = kernels.replay_batch_plain(*args, cap=cap)
    assert torch.equal(got_d, want_d) and torch.equal(got_l, want_l)
    assert int(got_l[0]) == -1
