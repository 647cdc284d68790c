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


@pytest.mark.parametrize("b,n,cap", [(2, 1, 8), (3, 100, 64),
                                     (4, 16384, 8192), (2, 70000, 4096)])
def test_k3_matches_plain_on_card(b, n, cap):
    """Truncation (cap < total), empty runs, runs past cap; the last shape
    keeps the run starts in device memory instead of shared memory."""
    _need_card()
    rng = np.random.default_rng(b + n + cap)
    pool = 3 * n + 16
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    vis = rng.integers(0, 6, (b, n)) * (rng.random((b, n)) < 0.7)
    off = rng.integers(0, pool, (b, n))
    arena = rng.integers(1, 0x10FFFF, (b, pool))
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
            for a in (perm, vis, off, arena)]
    launches = kernels.materialize_runs.launches
    got_t, got_n = kernels.materialize_runs(*args, cap)
    torch.cuda.synchronize()
    assert kernels.materialize_runs.launches == launches + 1
    want_t, want_n = linearize.materialize(*args, cap)
    assert torch.equal(got_t, want_t) and torch.equal(got_n, want_n)


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
