"""The flush-phase readers on synthetic scheduler snapshots, the reduction of
flush spans against the device's idle time on synthetic intervals, and the
traced tier rehearsed on the CPU."""

import pytest

from conftest import SEED, tiny
from dtbench import metrics, phases
from dtbench.run import run_cell
from dtbench.trace import idle_gaps, union
from dtbench.traffic.clients import Sync

MS = 1_000_000


def _hist(values):
    from diamond_types_tpu_torch.obs.hist import Histogram
    h = Histogram()
    for v in values:
        h.record(v)
    return h.snapshot()


def _snap(seconds, holds, admits):
    return {"flush_phases": {"seconds": dict(seconds), "count": {},
                             "oplog_wait_s": 0.0, "oplog_hold_s": 0.0,
                             "oplog_holds": 0},
            "latencies": {"oplog_hold": _hist(holds),
                          "admit_wait": _hist(admits)}}


def _ctx(before, after, ops=(10, 30)):
    syncs = []
    for i, n in enumerate(ops):
        s = Sync(f"doc{i}", 0.0, n)
        s.committed = 0.5
        syncs.append(s)
    late = Sync("doc9", 0.0, 1000)      # commits after the window: not counted
    late.committed = 5.0
    return {"syncs": syncs + [late], "t_end": 1.0, "window_s": 1.0,
            "sched_before": before, "sched_after": after, "trace": None}


PHASE_READERS = {"extract_us_per_op": "extract",
                 "resolve_us_per_op": "resolve",
                 "pack_us_per_op": "pack", "adopt_us_per_op": "adopt"}


@pytest.mark.parametrize("name,phase", sorted(PHASE_READERS.items()))
def test_phase_reader_is_the_windows_delta_per_op(name, phase):
    before = _snap({phase: 1.0}, [], [])
    after = _snap({phase: 1.004}, [], [])
    # 4 ms over the 40 ops committed in the window
    assert metrics.load(name)(_ctx(before, after)) == pytest.approx(100.0)
    assert metrics.load(name)(_ctx(before, after, ops=())) is None
    # a program with no phases (the parent of this change) gives nothing
    bare = {"latencies": {}}
    assert metrics.load(name)(_ctx(bare, bare)) is None


@pytest.mark.parametrize("name,family", [("oplog_hold_p95_ms", "oplog_hold"),
                                         ("admit_wait_p95_ms", "admit_wait")])
def test_hold_and_admit_tails_are_the_windows(name, family):
    from diamond_types_tpu_torch.obs.hist import Histogram
    warm = [5.0, 6.0]                   # before the window: left out
    window = [0.001 * (1 + i % 20) for i in range(400)]
    before = _snap({}, warm, warm)
    after = _snap({}, warm + window, warm + window)
    alone = Histogram()
    for v in window:
        alone.record(v)
    assert metrics.load(name)(_ctx(before, after)) == pytest.approx(
        1e3 * alone.quantile(0.95))
    assert metrics.load(name)(_ctx(before, before)) is None
    bare = {"latencies": {"flush": before["latencies"][family]}}
    assert metrics.load(name)(_ctx(bare, bare)) is None


def _span(name, s, t):
    return {"name": name, "t0_ns": s * MS, "t1_ns": t * MS}


def test_phase_idle_on_synthetic_intervals():
    """Two shards' flushes overlap; a gap has no flush open; a phase
    crosses the window's start and another its end."""
    t0, t1 = 0, 100 * MS
    busy = union(sorted([(10 * MS, 12 * MS), (40 * MS, 41 * MS),
                         (90 * MS, 91 * MS)]))
    idle = idle_gaps(busy, t0, t1)
    spans = [
        # shard 0: a flush from before the window to 30 ms
        _span("serve.flush", -5, 30), _span("bank.extract", -5, 8),
        _span("bank.resolve", 8, 20), _span("bank.adopt", 20, 28),
        # shard 1: a flush from 5 to 25 ms, its resolve overlapping
        _span("serve.flush", 5, 25), _span("bank.extract", 5, 15),
        _span("bank.resolve", 15, 25),
        # no flush from 30 to 60 ms; one from 60 ms past the window's end
        _span("serve.flush", 60, 120), _span("bank.pack", 60, 70),
        _span("bank.fence", 70, 110),
        _span("serve.admit", 30, 60),   # no phase, no flush
    ]
    gaps = sorted(idle, key=lambda g: g[0] - g[1])
    red = phases.phase_idle(idle, spans, t0, t1, gaps)
    by = red["idle_by_phase"]
    # extract: 0-8 and 5-15 -> 0-15 less the busy 10-12: 13 ms
    assert by["extract"] == pytest.approx(0.013)
    # resolve: 8-25 less 10-12: 15 ms, counted once for both shards
    assert by["resolve"] == pytest.approx(0.015)
    assert by["adopt"] == pytest.approx(0.008)
    assert by["pack"] == pytest.approx(0.010)
    # fence: 70-100 (the window ends at 100) less 90-91
    assert by["fence"] == pytest.approx(0.029)
    assert sum(by.values()) >= 0.0
    # idle with no flush open: 30-40 and 41-60
    assert red["no_flush_idle_s"] == pytest.approx(0.029)
    rows = dict((round(g, 6), parts) for g, parts
                in red["idle_gaps_by_phase"])
    assert [g for g, _p in red["idle_gaps_by_phase"]] == \
        [(t - s) / 1e9 for s, t in gaps]
    # the gap 41-90: 41-60 no flush, 60-70 pack, 70-90 fence
    assert rows[0.049] == [["fence", pytest.approx(0.020)],
                           ["pack", pytest.approx(0.010)],
                           ["no_flush", pytest.approx(0.019)]]
    # the gap 12-40: resolve 12-25, adopt 20-28, extract 12-15, no phase
    # 28-30, no flush 30-40
    assert rows[0.028] == [["resolve", pytest.approx(0.013)],
                           ["adopt", pytest.approx(0.008)],
                           ["extract", pytest.approx(0.003)],
                           ["no_phase", pytest.approx(0.002)],
                           ["no_flush", pytest.approx(0.010)]]
    # the gap 0-10 starts at the window's edge: extract throughout
    assert rows[0.010][0] == ["extract", pytest.approx(0.010)]


def test_interval_helpers():
    a = [(0, 10), (20, 30)]
    b = [(5, 25)]
    assert phases.intersect(a, b) == [(5, 10), (20, 25)]
    assert phases.subtract(a, b) == [(0, 5), (25, 30)]
    assert phases.subtract(a, []) == a
    assert phases.subtract([(0, 10)], [(2, 3), (5, 6)]) == \
        [(0, 2), (3, 5), (6, 10)]
    assert phases.clip([(-5, 5), (8, 20)], 0, 10) == [(0, 5), (8, 10)]
    assert phases.measure([(0, MS)]) == 0.001


def test_window_totals_cover_the_flush_sum():
    before = {"flush_phases": {"seconds": {"extract": 1.0, "fence": 0.5},
                               "oplog_wait_s": 0.1, "oplog_hold_s": 1.0,
                               "oplog_holds": 3},
              "latencies": {"flush": {"sum": 2.0}}}
    after = {"flush_phases": {"seconds": {"extract": 1.5, "fence": 0.75},
                              "oplog_wait_s": 0.15, "oplog_hold_s": 1.5,
                              "oplog_holds": 9},
             "latencies": {"flush": {"sum": 3.0}}}
    w = phases.window_totals(before, after)
    assert w["phase_s"] == {"extract": 0.5, "fence": 0.25}
    assert w["oplog_holds"] == 6 and w["flush_sum_s"] == 1.0
    assert w["coverage"] == pytest.approx(0.8)
    assert phases.window_totals({}, {"latencies": {}}) == {}


def test_traced_tier_rehearsal_on_the_cpu():
    """The traced tier in a cell's place: the run is correct, every flush
    is a forced root with its phase spans, and the ring holds them all."""
    cell, config, mix, specs = tiny("fused-concurrent", n_docs=6)
    config = dict(config, tier="traced_merge_tier", trace_spans=1,
                  span_ring=50_000)
    r = run_cell(cell, config, mix, specs, SEED, 1.0, False, "cpu")
    assert r["correct"], r["notes"]
    tier = phases.TIERS[-1]
    assert tier.sched.trace_flushes is True
    spans = tier.obs.tracer.spans()
    names = {sp["name"] for sp in spans}
    assert {"serve.flush", "serve.device_sync", "bank.extract",
            "bank.resolve", "bank.plan", "bank.adopt"} <= names
    stats = tier.obs.tracer.stats()
    assert stats["finished"] == stats["buffered"]
    assert all(sp["t0_ns"] <= sp["t1_ns"] for sp in spans)
