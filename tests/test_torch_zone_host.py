"""The zone engine's host layer in the port against the JAX package's.

The same seeded histories (`torch_parity.zone_history`, driven by
`test_zone.random_edit`) go into a JAX-package OpLog and a port OpLog. The
port's native bindings (composer, zone insert runs, linear composition,
collision count, tracker merge) must return exactly what the JAX package's
ctx returns; `compose_plan` (native and Python), `prepare_zone` and the
NumPy executor `zone_checkout_np` must be equal field for field; and the
engine policy must answer the same choose/record/forget sequences.
"""

import numpy as np
import pytest

from diamond_types_tpu.listmerge import compose as jcompose
from diamond_types_tpu.listmerge import policy as jpolicy
from diamond_types_tpu.listmerge import zone_np as jzone
from diamond_types_tpu.native import native_ctx_or_none as jctx_of
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.listmerge import compose as tcompose
from diamond_types_tpu_torch.listmerge import policy as tpolicy
from diamond_types_tpu_torch.listmerge import zone_np as tzone
from diamond_types_tpu_torch.native import native_ctx_or_none as tctx_of
from diamond_types_tpu_torch.native.core import merge_native

from torch_parity import zone_history

SEEDS = [5300, 5301, 5302, 7004, 7011]
CE_FIELDS = ("ch_lv", "ch_block", "ch_head", "ch_kind", "ch_anchor", "ch_q",
             "ch_headlv", "ch_orrown", "blk_root_q", "blk_root_lv",
             "blk_start", "blk_len")


@pytest.fixture(autouse=True)
def _fresh_port_policy(monkeypatch):
    """The port's process-wide policy, fresh for each test (the JAX one
    is reset by conftest)."""
    monkeypatch.setattr(tpolicy, "GLOBAL", tpolicy.EnginePolicy())


def _twins(seed, **kw):
    return zone_history([JaxOpLog, OpLog], seed, **kw)


def _spans(ol):
    return [en.span for en in jzone.compile_plan2(
        ol.cg.graph, [], list(ol.version)).entries]


def _assert_entries_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.q_cursor) == list(w.q_cursor)
        assert [tuple(x) for x in g.del_base] == \
            [tuple(x) for x in w.del_base]
        assert [tuple(x) for x in g.del_own] == [tuple(x) for x in w.del_own]
        assert g.num_chars() == w.num_chars()
        if w.num_chars():
            for f in CE_FIELDS:
                assert np.array_equal(np.asarray(getattr(g, f)),
                                      np.asarray(getattr(w, f))), f


@pytest.mark.parametrize("seed", SEEDS)
def test_native_bindings_match_jax_ctx(seed):
    jol, tol = _twins(seed)
    jctx, tctx = jctx_of(jol), tctx_of(tol)
    assert jctx is not None and tctx is not None
    spans = _spans(jol)
    assert spans == _spans(tol)
    # the zone insert-run table
    for a, b in zip(tctx.zone_ins_runs(spans), jctx.zone_ins_runs(spans)):
        assert np.array_equal(a, b)
    # the composer, as columns and through the cache
    got, want = tctx.compose_plan(spans), jctx.compose_plan(spans)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert np.array_equal(g[k], w[k]) and g[k].dtype == \
                    w[k].dtype, k
            else:
                assert g[k] == w[k], k
    assert tctx.compose_cache_only(spans) == jctx.compose_cache_only(spans)
    assert tctx.compose_serial() == jctx.compose_serial()
    # the linear composer: over the plan's fast-forward spans, over a
    # linear prefix, and over concurrent spans (unsupported: None)
    ff = jzone.compile_plan2(jol.cg.graph, [], list(jol.version)).ff_spans
    for lin in (sorted(ff), [(0, 3)], sorted(spans)):
        got, want = tctx.compose_linear(lin), jctx.compose_linear(lin)
        assert (got is None) == (want is None)
        for a, b in zip(got or (), want or ()):
            assert np.array_equal(a, b)
    # a transform's collision count, and the tracker merge
    for frm in ([], [len(tol) // 3]):
        tctx.transform(frm, list(tol.version))
        jctx.transform(frm, list(jol.version))
        assert tctx.last_collisions() == jctx.last_collisions()
        init = tol.checkout(frm).snapshot()
        from diamond_types_tpu.native import merge_native as jmerge
        assert merge_native(tol, init, frm, list(tol.version)) == \
            jmerge(jol, init, frm, list(jol.version))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_compose_plan_matches_jax(monkeypatch, seed, native):
    if not native:
        monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    jol, tol = _twins(seed)
    jplan = jzone.compile_plan2(jol.cg.graph, [], list(jol.version))
    tplan = tzone.compile_plan2(tol.cg.graph, [], list(tol.version))
    want = jcompose.compose_plan(jol, jplan)
    _assert_entries_equal(tcompose.compose_plan(tol, tplan), want)
    # the Python composer entry by entry, whatever the switch says
    _assert_entries_equal([tcompose.compose_entry(tol, en.span)
                           for en in tplan.entries], want)
    assert tcompose.assemble_prefix(tol, tplan.ff_spans) == \
        jcompose.assemble_prefix(jol, jplan.ff_spans)


def _assert_prep_equal(tp, jp):
    assert tp.prefix == jp.prefix
    assert (tp.plen, tp.W) == (jp.plen, jp.W)
    for f in ("ins_lv0", "ins_cum", "pool", "agent_k", "seq_k"):
        assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
        assert getattr(tp, f).dtype == getattr(jp, f).dtype, f
    assert tp.plan.actions == jp.plan.actions
    assert tp.plan.indexes_used == jp.plan.indexes_used
    assert tp.plan.final_frontier == jp.plan.final_frontier
    assert tp.plan.pinned_rows == jp.plan.pinned_rows
    assert (tp.native_ctx is None) == (jp.native_ctx is None)
    _assert_entries_equal(tp.get_composed(), jp.get_composed())


@pytest.mark.parametrize("fetch", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_prepare_zone_matches_jax(seed, fetch):
    jol, tol = _twins(seed)
    heads = [len(tol) - 1, len(tol) // 2]
    for kw in ({}, {"pin_lvs": heads},
               {"from_frontier": [len(tol) // 3]}):
        _assert_prep_equal(tzone.prepare_zone(tol, fetch_composed=fetch,
                                              **kw),
                           jzone.prepare_zone(jol, fetch_composed=fetch,
                                              **kw))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("seed", SEEDS + [9000, 9001])
def test_zone_checkout_np_matches_jax_and_tracker(monkeypatch, seed,
                                                  native):
    if not native:
        monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    jol, tol = _twins(seed, n_edits=60,
                      agents=("alice", "bob", "carol"))
    got = tzone.zone_checkout_np(tol)
    assert got == jzone.zone_checkout_np(jol)
    b = tol.checkout_tip()
    assert got[0] == b.snapshot()
    assert sorted(got[1]) == sorted(b.version)
    mid = [len(tol) // 2]
    assert tzone.zone_checkout_np(tol, mid) == \
        jzone.zone_checkout_np(jol, mid)


def test_zone_checkout_np_empty_and_linear():
    jol, tol = JaxOpLog(), OpLog()
    assert tzone.zone_checkout_np(tol) == jzone.zone_checkout_np(jol)
    for ol in (jol, tol):
        a = ol.get_or_create_agent_id("solo")
        v = [ol.add_insert_at(a, [], 0, "hello world")]
        ol.add_delete_at(a, v, 0, 6, "hello ")
    assert tzone.zone_checkout_np(tol) == jzone.zone_checkout_np(jol) == \
        ("world", [len(tol) - 1])


def _policy_tape(seed, n=400):
    rng = np.random.default_rng(seed)
    engines = (tpolicy.TRACKER, tpolicy.ZONE)
    tape = []
    for _ in range(n):
        r = rng.random()
        e = engines[int(rng.integers(2))]
        if r < 0.3:
            tape.append(("record", e, int(rng.integers(-5, 50_000)),
                         float(rng.choice([0.0, 1e-3, 0.5, 2.0]))))
        elif r < 0.75:
            hint = [None, -1, 0, 10, 20_000, 20_001, 10**6]
            tape.append(("choose", hint[int(rng.integers(len(hint)))]))
        elif r < 0.82:
            tape.append(("forget", e))
        elif r < 0.95:
            tape.append(("advance", float(rng.choice([0.5, 30.0, 61.0,
                                                      700.0]))))
        else:
            tape.append(("read", e))
    return tape


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_policy_sequences_match_jax(monkeypatch, seed):
    """choose/record/forget/decay/cooldown on one fake clock: the port's
    EnginePolicy answers every call as the JAX package's does (after
    tests/test_policy_flip.py)."""
    import time as _time
    now = [10_000.0]
    monkeypatch.setattr(_time, "monotonic", lambda: now[0])
    tp, jp = tpolicy.EnginePolicy(), jpolicy.EnginePolicy()
    tp.PROBE_EVERY = jp.PROBE_EVERY = 3 + seed % 3
    for step in _policy_tape(seed):
        kind = step[0]
        if kind == "advance":
            now[0] += step[1]
            continue
        if kind == "record":
            outs = [p.record(*step[1:]) for p in (tp, jp)]
        elif kind == "choose":
            outs = [p.choose(step[1]) for p in (tp, jp)]
        elif kind == "forget":
            outs = [p.forget(step[1]) for p in (tp, jp)]
        else:
            outs = [(p.rate(step[1]), p.snapshot()) for p in (tp, jp)]
        assert outs[0] == outs[1], step
    assert (tpolicy.TRACKER, tpolicy.ZONE) == (jpolicy.TRACKER, jpolicy.ZONE)
    for name in ("PROBE_EVERY", "HALF_LIFE_S", "DEMOTION_COOLDOWN_S",
                 "PROBE_MAX_OPS"):
        assert getattr(tpolicy.EnginePolicy, name) == \
            getattr(jpolicy.EnginePolicy, name)
