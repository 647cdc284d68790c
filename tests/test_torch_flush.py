"""The slice as a whole: the port's fused serve flush against the JAX one.

Both packages get the same oplog edits (three agents forking and merging,
inserts and deletes longer than `max_ins`). Each document has a
`FusedDocSession` on each side (JAX on its CPU backend, the port with
`device="cpu"`). Over several windows and buckets of mixed capacity the
tail plans, the fence results of the port's one replay rung
(`kernel_fused_replay`, K1's plain version on CPU sessions) against both
JAX rungs (`pallas_fused_replay` and the fused XLA rung `fused_replay`),
and the texts, lengths and capacities must be exactly equal, and equal to
the host checkout.
"""

import numpy as np
import pytest

from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import flush_fuse as jff
from diamond_types_tpu.tpu.merge_kernel import _pow2 as jax_pow2
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import flush_fuse as tff
from diamond_types_tpu_torch.gpu import kernels

from torch_parity import ASCII, UNICODE, TwinDocs

pytestmark = pytest.mark.fused

AGENTS = ("alice", "bob", "carol")
OPTS = {"cap": 256, "max_ins": 4}
PLAN_FIELDS = ("pos", "dlen", "ilen", "chars", "n_ops", "new_len",
               "max_len", "frontier", "synced_to")


def _assert_plans_equal(jp, tp):
    for f in PLAN_FIELDS:
        a, b = getattr(jp, f), getattr(tp, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert b == a, f


def _assert_sessions_equal(js, ts, ol):
    assert (ts.cap, ts.doc_len, ts.resyncs, ts.synced_to, ts.frontier) == \
        (js.cap, js.doc_len, js.resyncs, js.synced_to, js.frontier)
    assert ts.text() == js.text() == ol.checkout_tip().snapshot()
    assert int(ts.lens) == ts.doc_len


def _docs(bases, seed, alphabet):
    twins = []
    for i, n in enumerate(bases):
        tw = TwinDocs([JaxOpLog(), OpLog()], seed * 100 + i, alphabet)
        tw.type_base("alice", n)
        twins.append(tw)
    return twins


def _sessions(twins):
    js = [jff.FusedDocSession(tw.oplogs[0], **OPTS) for tw in twins]
    ts = [tff.FusedDocSession(tw.oplogs[1], device="cpu", **OPTS)
          for tw in twins]
    return js, ts


def _buckets(sessions, idx, flush_docs):
    """Group doc indices by cap (as the bank does), then cut each group
    into buckets of `flush_docs`."""
    by_cap = {}
    for i in idx:
        by_cap.setdefault(sessions[i].cap, []).append(i)
    out = []
    for cap in sorted(by_cap):
        g = by_cap[cap]
        out += [g[k:k + flush_docs] for k in range(0, len(g), flush_docs)]
    return out


def _flush(js, ts, twins, rung, flush_docs, poison=None):
    """One window on both sides; returns the per-bucket ok lists and the
    port's plans."""
    jplans = [s.plan_tail() for s in js]
    tplans = [s.plan_tail() for s in ts]
    for jp, tp in zip(jplans, tplans):
        _assert_plans_equal(jp, tp)
    if poison is not None:       # a delete past max_ins reaching the device
        for plans in (jplans, tplans):
            plans[poison].dlen[0] = OPTS["max_ins"] + 1
    replay = []
    for i, (jp, tp) in enumerate(zip(jplans, tplans)):
        if not jp.fits(js[i].cap):
            assert not tp.fits(ts[i].cap)
            js[i]._materialize(
                min_cap=jax_pow2(int(jp.max_len * js[i].headroom)))
            ts[i].resync_for(tp)
        elif jp.n_ops == 0:
            js[i].commit_host(jp)
            ts[i].commit_host(tp)
        else:
            replay.append(i)
    oks = []
    for bucket in _buckets(ts, replay, flush_docs):
        assert [js[i].cap for i in bucket] == [ts[i].cap for i in bucket]
        jsb, tsb = [js[i] for i in bucket], [ts[i] for i in bucket]
        jpb, tpb = [jplans[i] for i in bucket], [tplans[i] for i in bucket]
        before = [s.text() for s in tsb]
        jrung = jff.pallas_fused_replay if rung == "kernel" \
            else jff.fused_replay
        jok, _ = jrung(jsb, jpb)
        tok, _ = tff.kernel_fused_replay(tsb, tpb)
        assert tok == jok
        for s, ok, text in zip(tsb, tok, before):
            if not ok:           # a failed row keeps its pre-window text
                assert s.text() == text
        oks.append(tok)
    return oks, tplans


@pytest.mark.parametrize("seed,alphabet,flush_docs",
                         [(1, ASCII, 2), (2, UNICODE, 3)])
def test_flush_windows_match_jax(seed, alphabet, flush_docs):
    twins = _docs([20, 70, 150, 300], seed, alphabet)
    js, ts = _sessions(twins)
    caps = sorted({s.cap for s in ts})
    assert len(caps) >= 3, caps       # buckets of mixed capacity
    launches = kernels.apply_ops_window.launches
    for w, rung in enumerate(("kernel", "fused", "kernel", "fused")):
        for tw in twins:
            tw.concurrent_round(AGENTS, 2 + w, max_ins=11, max_del=9)
        oks, plans = _flush(js, ts, twins, rung, flush_docs)
        assert len(oks) > len(caps) // 2 and all(all(ok) for ok in oks)
        # long inserts and deletes arrive split to max_ins pieces
        mi = OPTS["max_ins"]
        assert any((p.ilen == mi).any() for p in plans)
        assert any((p.dlen == mi).any() for p in plans)
        for j, t, tw in zip(js, ts, twins):
            _assert_sessions_equal(j, t, tw.oplogs[1])
    # CPU sessions: the wrapper ran K1's plain version, never the kernel
    assert kernels.apply_ops_window.launches == launches


@pytest.mark.parametrize("rung", ["kernel", "fused"])
def test_poisoned_row_fails_fence_on_both_sides(rung):
    twins = _docs([30, 40, 50], 3, ASCII)
    js, ts = _sessions(twins)
    for tw in twins:
        tw.concurrent_round(AGENTS, 3, max_ins=9)
    oks, _ = _flush(js, ts, twins, rung, flush_docs=4, poison=1)
    assert oks == [[True, False, True]]
    # the caller evicts the poisoned doc and rebuilds from the host
    js[1] = jff.FusedDocSession(twins[1].oplogs[0], **OPTS)
    ts[1] = tff.FusedDocSession(twins[1].oplogs[1], device="cpu", **OPTS)
    for j, t, tw in zip(js, ts, twins):
        _assert_sessions_equal(j, t, tw.oplogs[1])


def test_capacity_overflow_resyncs_on_both_sides():
    twins = _docs([10], 4, UNICODE)
    js, ts = _sessions(twins)
    tw = twins[0]
    tw.insert("alice", 3, "y" * 600)          # the tail overflows cap 256
    tw.concurrent_round(AGENTS, 2, max_ins=9)
    oks, _ = _flush(js, ts, twins, "kernel", flush_docs=8)
    assert oks == []                          # resynced, nothing replayed
    assert ts[0].resyncs == js[0].resyncs == 1
    assert ts[0].cap == js[0].cap > 256
    _assert_sessions_equal(js[0], ts[0], tw.oplogs[1])
    tw.concurrent_round(AGENTS, 2, max_ins=9)
    assert _flush(js, ts, twins, "kernel", flush_docs=8)[0] == [[True]]
    _assert_sessions_equal(js[0], ts[0], tw.oplogs[1])


def test_sync_per_doc_path_matches():
    twins = _docs([25], 5, ASCII)
    js, ts = _sessions(twins)
    tw = twins[0]
    for _ in range(2):
        tw.concurrent_round(AGENTS, 3, max_ins=9)
        assert ts[0].sync() == js[0].sync()
        _assert_sessions_equal(js[0], ts[0], tw.oplogs[1])


def test_session_needs_cuda_or_explicit_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    ol = OpLog()
    ol.add_insert(ol.get_or_create_agent_id("a"), 0, "x")
    with pytest.raises(RuntimeError, match="CUDA"):
        tff.FusedDocSession(ol)
    with pytest.raises(RuntimeError, match="CUDA"):
        tff.FusedDocSession(ol, device="cuda")
