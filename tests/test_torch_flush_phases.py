"""The port's flush timing: the flush's phases (`serve.metrics.FLUSH_PHASES`,
timed by the bank's `FlushClock`), the oplog lock's wait and holds, the
admit-to-flush-start wait, and the phase spans of a traced flush.

The scheduler, the metrics' clock and the tracer run on a `FakeClock`
(`torch_parity.clock_modules`), and the flush's own work is costed: each
step a phase runs advances the clock by a fixed amount (extraction, the
device resolve, grouping, packing, the fence, the commits), and the oplog
lock's acquisition by a fixed wait. Everything else takes no time, so a
phase's seconds are exactly its steps' costs, and the phases plus the lock
waits are exactly the flush's duration. Sessions live on the CPU, where K1
and K2 run their plain versions.
"""

import threading
import tracemalloc

import pytest

from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import flush_fuse as tff
from diamond_types_tpu_torch.gpu import xform
from diamond_types_tpu_torch.obs import Observability
from diamond_types_tpu_torch.obs.trace import Tracer
from diamond_types_tpu_torch.serve import MergeScheduler
from diamond_types_tpu_torch.serve.metrics import FLUSH_PHASES, ServeMetrics

from torch_parity import (PORT_ONLY_SPANS, FakeClock, clock_modules,
                          serve_docs, serve_round)

pytestmark = pytest.mark.serve

ROOT = "diamond_types_tpu_torch"
FUSED = {"cap": 256, "max_ins": 4, "device": "cpu"}
# a step's cost on the fake clock, by the phase it runs in
EXTRACT_S = 0.001        # xform.extract_tail, a document
RESOLVE_S = 0.002        # xform.resolve_positions, a call
PLAN_S = 0.0005          # TailPlan.fits, a plan
PACK_S = 0.003           # pack_plans, a replay
FENCE_S = 0.004          # fetch_lengths, a replay
ADOPT_S = 0.0015         # adopt_results, a replay
WAIT_S = 0.0007          # taking the oplog lock, an acquisition
ABS = 1e-5               # the snapshot rounds seconds to 1 us


class SlowLock:
    """An oplog lock whose every acquisition waits `WAIT_S` on the fake
    clock, as a lock another thread holds would."""

    def __init__(self, clock: FakeClock) -> None:
        self.clock = clock
        self._lock = threading.Lock()
        self.acquired = 0

    def __enter__(self):
        self.clock.advance(WAIT_S)
        self._lock.acquire()
        self.acquired += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    clock_modules(monkeypatch, ROOT, c,
                  names=("serve.metrics", "serve.scheduler", "obs.trace"))

    def cost(owner, name, seconds):
        real = getattr(owner, name)

        def costed(*args, **kw):
            c.advance(seconds)
            return real(*args, **kw)
        monkeypatch.setattr(owner, name, costed)

    cost(xform, "extract_tail", EXTRACT_S)
    cost(xform, "resolve_positions", RESOLVE_S)
    cost(tff.TailPlan, "fits", PLAN_S)
    cost(tff, "pack_plans", PACK_S)
    cost(tff, "fetch_lengths", FENCE_S)
    cost(tff, "adopt_results", ADOPT_S)
    return c


def _sched(docs, clock, mode, flush_docs=4, obs=None):
    s = MergeScheduler(2, resolve=lambda d: docs[d].oplogs[0],
                       fused_opts=FUSED, flush_workers=False,
                       device_plan=True, flush_docs=flush_docs,
                       flush_deadline_s=0.05, max_sessions_per_shard=16,
                       mesh_window=mode == "window",
                       sync_lock=SlowLock(clock))
    if obs is not None:
        s.attach_obs(obs)
    return s


def _round(sched, docs, clock, seed, rnd, only=None, n_ops=None):
    """One round of the shared concurrent tape (or of the documents in
    `only`), submitted a millisecond apart (each as `n_ops` ops, so that
    they share a shape bucket, when given), then pumped past the deadline
    and drained."""
    for d, n in serve_round(docs, seed, rnd):
        if only is None or d in only:
            sched.submit(d, n_ops or n, now=clock())
            clock.advance(0.001)
    clock.advance(0.06)
    sched.pump(now=clock())
    sched.drain()


def _timed_windows(monkeypatch, sched, clock) -> list:
    """Each flush window's duration on the fake clock."""
    walls = []
    real = sched._flush_window

    def timed(taken):
        t = clock()
        n = real(taken)
        walls.append(clock() - t)
        return n
    monkeypatch.setattr(sched, "_flush_window", timed)
    return walls


def _phases(snap) -> dict:
    return snap["flush_phases"]["seconds"]


@pytest.mark.parametrize("mode", ["shard", "window"])
def test_phases_cover_the_flush(monkeypatch, clock, mode):
    """The phases and the oplog waits add up to the flush, on both flush
    paths: to the sum of `latencies.flush` on the per-shard path, to the
    windows' durations in the flush window. Each phase holds exactly its
    steps' costs, so the lock's wait is in none of them; `per_shard`'s
    times are the phases'."""
    docs = serve_docs([OpLog], 12, 41, base_max=150)
    s = _sched(docs, clock, mode)
    walls = _timed_windows(monkeypatch, s, clock) if mode == "window" \
        else None
    extracts = []
    real_extract = xform.extract_tail
    monkeypatch.setattr(xform, "extract_tail",
                        lambda sess: extracts.append(1) or
                        real_extract(sess))
    for rnd in range(3):
        _round(s, docs, clock, 41, rnd)
    snap = s.metrics_json()
    ph, fp = _phases(snap), snap["flush_phases"]
    assert set(ph) == set(FLUSH_PHASES)
    for p in ("extract", "resolve", "plan", "pack", "fence", "adopt"):
        assert ph[p] > 0 and fp["count"][p] > 0, p
    covered = sum(ph.values()) + fp["oplog_wait_s"]
    if mode == "shard":
        assert covered == pytest.approx(
            snap["latencies"]["flush"]["sum"], abs=ABS)
    else:
        assert covered == pytest.approx(sum(walls), abs=ABS)
    assert fp["oplog_wait_s"] == pytest.approx(
        WAIT_S * s._sync_lock.acquired, abs=ABS)
    assert ph["extract"] == pytest.approx(EXTRACT_S * len(extracts),
                                          abs=ABS)
    calls = snap["transform"]["batches"]
    assert ph["resolve"] == pytest.approx(RESOLVE_S * calls, abs=ABS)
    rows = snap["per_shard"]
    assert sum(r["flush_wall_s"] for r in rows) \
        == pytest.approx(sum(ph.values()), abs=ABS)
    assert sum(r["device_sync_s"] for r in rows) \
        == pytest.approx(ph["fence"], abs=ABS)


def test_serial_rung_counts_as_serial(monkeypatch, clock):
    """A lone document's bucket takes the per-doc rung, whose own pack,
    fence and commits count as `serial` only: `pack` and `fence` stay
    exactly one cost a fused group replay."""
    docs = serve_docs([OpLog], 12, 43, base_max=150)
    s = _sched(docs, clock, "shard")
    _round(s, docs, clock, 43, 0)           # builds every session
    syncs = []
    real_sync = tff.FusedDocSession.sync

    def counted(sess):
        n = real_sync(sess)
        syncs.append(n)
        return n
    monkeypatch.setattr(tff.FusedDocSession, "sync", counted)
    before = s.metrics_json()
    _round(s, docs, clock, 43, 1, n_ops=8)  # fused groups
    for i, d in enumerate(sorted(docs)):    # one document a flush
        _round(s, docs, clock, 43, 2 + i, only={d})
    after = s.metrics_json()
    ph = {p: _phases(after)[p] - _phases(before)[p] for p in FLUSH_PHASES}
    groups = after["totals"]["fused_calls"] - before["totals"]["fused_calls"]
    replays = sum(1 for n in syncs if n > 0)
    assert groups > 0 and replays > 0
    assert ph["pack"] == pytest.approx(PACK_S * groups, abs=ABS)
    assert ph["fence"] == pytest.approx(FENCE_S * groups, abs=ABS)
    assert ph["serial"] == pytest.approx(
        PLAN_S * len(syncs) + (PACK_S + FENCE_S + ADOPT_S) * replays,
        abs=ABS)
    assert after["flush_phases"]["count"]["serial"] \
        > before["flush_phases"]["count"]["serial"]


@pytest.mark.parametrize("mode", ["shard", "window"])
def test_each_oplog_hold_is_one_sample(clock, mode):
    """The fused bank takes the oplog lock three times a flush (extract,
    plan, adopt): each hold is one `latencies.oplog_hold` sample, and the
    holds' seconds are the histogram's sum."""
    docs = serve_docs([OpLog], 10, 47, base_max=150)
    s = _sched(docs, clock, mode)
    for rnd in range(2):
        _round(s, docs, clock, 47, rnd)
    snap = s.metrics_json()
    fp, hist = snap["flush_phases"], snap["latencies"]["oplog_hold"]
    assert fp["oplog_holds"] == hist["count"] == s._sync_lock.acquired \
        == 3 * snap["totals"]["flushes"] > 0
    assert fp["oplog_hold_s"] == pytest.approx(hist["sum"], abs=ABS)
    assert fp["oplog_hold_s"] > 0


def test_no_oplog_lock_times_no_hold(clock):
    """A scheduler with no oplog lock holds none: no hold, no wait."""
    docs = serve_docs([OpLog], 6, 53, base_max=150)
    s = MergeScheduler(2, resolve=lambda d: docs[d].oplogs[0],
                       fused_opts=FUSED, flush_workers=False,
                       device_plan=True, flush_docs=4)
    _round(s, docs, clock, 53, 0)
    snap = s.metrics_json()
    assert snap["totals"]["flushes"] > 0
    assert snap["flush_phases"]["oplog_holds"] == 0
    assert snap["latencies"]["oplog_hold"]["count"] == 0
    assert snap["flush_phases"]["oplog_wait_s"] == 0


@pytest.mark.parametrize("mode", ["shard", "window"])
def test_admit_wait_is_at_most_queue_wait(monkeypatch, clock, mode):
    """Per item, admit -> flush start is at most admit -> commit, which is
    what `latencies.queue_wait` measures; the difference is its flush."""
    pairs = {"admit": [], "queue": []}
    for key, name in (("admit", "observe_admit_wait"),
                      ("queue", "observe_queue_wait")):
        real = getattr(ServeMetrics, name)

        def spy(self, dur, _real=real, _key=key):
            pairs[_key].append(dur)
            return _real(self, dur)
        monkeypatch.setattr(ServeMetrics, name, spy)
    docs = serve_docs([OpLog], 10, 59, base_max=150)
    s = _sched(docs, clock, mode)
    for rnd in range(2):
        _round(s, docs, clock, 59, rnd)
    admit, queue = pairs["admit"], pairs["queue"]
    assert len(admit) == len(queue) > 0
    assert all(a <= q for a, q in zip(admit, queue))
    assert sum(q - a for a, q in zip(admit, queue)) > 0
    snap = s.metrics_json()
    assert snap["latencies"]["admit_wait"]["count"] == len(admit)
    assert snap["latencies"]["admit_wait"]["sum"] \
        < snap["latencies"]["queue_wait"]["sum"]


def _trace_module_growth(run) -> list:
    """Allocations attributed to obs/trace.py while `run()` runs."""
    import diamond_types_tpu_torch.obs.trace as trace_mod
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    run()
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    return [st for st in after.compare_to(before, "filename")
            if st.size_diff > 0
            and st.traceback[0].filename == trace_mod.__file__]


@pytest.mark.parametrize("mode", ["shard", "window"])
def test_trace_flushes_off_and_on(clock, mode):
    """With `trace_flushes` False and no sampled item a flush opens no
    span and allocates nothing in the tracer (tracemalloc). With it True
    every flush is a forced root, with one leaf span a phase stretch
    under its device sync (the window span on the window path), each
    carrying its shard (or shards) and document count."""
    docs = serve_docs([OpLog], 10, 61, base_max=150)
    obs = Observability(sample_rate=0.0)
    s = _sched(docs, clock, mode, obs=obs)
    assert s.trace_flushes is False
    _round(s, docs, clock, 61, 0)           # builds; touches every path
    for d, n in serve_round(docs, 61, 1):
        s.submit(d, n, now=clock())
    clock.advance(0.06)
    grew = _trace_module_growth(lambda: (s.pump(now=clock()), s.drain()))
    assert not grew, [str(g) for g in grew]
    assert obs.tracer.spans() == []
    assert s.metrics_json()["totals"]["flushes"] > 0

    s.trace_flushes = True
    _round(s, docs, clock, 61, 2)
    spans = obs.tracer.spans()
    by_id = {sp["span"]: sp for sp in spans}
    root = "serve.mesh_window" if mode == "window" else "serve.flush"
    roots = [sp for sp in spans if sp["name"] == root]
    assert roots and all(sp["parent"] is None for sp in roots)
    leaves = [sp for sp in spans if sp["name"] in PORT_ONLY_SPANS]
    assert {sp["name"] for sp in leaves} >= {
        "bank.extract", "bank.resolve", "bank.plan", "bank.pack",
        "bank.fence", "bank.adopt"}
    parent = "serve.mesh_window" if mode == "window" \
        else "serve.device_sync"
    for sp in leaves:
        assert by_id[sp["parent"]]["name"] == parent
        assert sp["attrs"]["docs"] > 0
        assert "shard" in sp["attrs"] or "shards" in sp["attrs"]
    # the leaves of each flush are its phases' time, lock waits aside
    snap = s.metrics_json()
    assert sum(sp["dur_s"] for sp in leaves) <= \
        sum(_phases(snap).values()) + ABS


def test_span_records_carry_wall_clock_ns(clock):
    """Finished spans carry `t0_ns` <= `t1_ns` on the wall clock in ns
    (torch.profiler's), beside the monotonic `t0` and `dur_s`; a flush's
    phase spans run in order inside their parent."""
    docs = serve_docs([OpLog], 8, 67, base_max=150)
    obs = Observability(sample_rate=0.0)
    s = _sched(docs, clock, "shard", obs=obs)
    s.trace_flushes = True
    for rnd in range(2):
        _round(s, docs, clock, 67, rnd)
    spans = obs.tracer.spans()
    assert spans
    by_id = {sp["span"]: sp for sp in spans}
    for sp in spans:
        assert isinstance(sp["t0_ns"], int) and isinstance(sp["t1_ns"], int)
        assert sp["t0_ns"] <= sp["t1_ns"]
        assert sp["t1_ns"] - sp["t0_ns"] == pytest.approx(
            sp["dur_s"] * 1e9, abs=1e3)
    for parent_id in {sp["parent"] for sp in spans
                      if sp["name"] in PORT_ONLY_SPANS}:
        kids = sorted((sp for sp in spans if sp["parent"] == parent_id),
                      key=lambda sp: sp["t0_ns"])
        p = by_id[parent_id]
        assert p["t0_ns"] <= kids[0]["t0_ns"]
        assert kids[-1]["t1_ns"] <= p["t1_ns"]
        for a, b in zip(kids, kids[1:]):
            assert a["t1_ns"] <= b["t0_ns"]


def test_tracer_resize_keeps_the_newest():
    tr = Tracer(sample_rate=1.0, capacity=4)
    for i in range(6):
        tr.start(f"s{i}").end()
    assert [sp["name"] for sp in tr.spans()] == ["s2", "s3", "s4", "s5"]
    tr.resize(2)
    assert [sp["name"] for sp in tr.spans()] == ["s4", "s5"]
    tr.resize(8)
    for i in range(6, 12):
        tr.start(f"s{i}").end()
    assert len(tr.spans()) == 8 and tr.spans()[-1]["name"] == "s11"
    assert tr.stats()["buffered"] == 8


def test_record_phases_counts_phases_that_ran():
    """`record_phases` counts a phase for a flush only when it took time,
    raises on a phase outside FLUSH_PHASES, and the snapshot sums the
    shards."""
    m = ServeMetrics(2, 4, 64)
    m.record_phases(0, {"extract": 0.25, "serial": 0.0}, 0.5, [0.125, 0.5])
    m.record_phases(1, {"extract": 0.5, "fence": 1.0})
    snap = m.snapshot()
    fp = snap["flush_phases"]
    assert fp["seconds"]["extract"] == 0.75 and fp["count"]["extract"] == 2
    assert fp["count"]["serial"] == 0 and fp["count"]["fence"] == 1
    assert (fp["oplog_wait_s"], fp["oplog_hold_s"], fp["oplog_holds"]) \
        == (0.5, 0.625, 2)
    assert snap["latencies"]["oplog_hold"]["count"] == 2
    assert [r["flush_wall_s"] for r in snap["per_shard"]] == [0.25, 1.5]
    assert [r["device_sync_s"] for r in snap["per_shard"]] == [0.0, 1.0]
    assert snap["version"] == ServeMetrics.SCHEMA_VERSION == 8
    with pytest.raises(KeyError):
        m.record_phases(0, {"replay": 0.1})
