"""The port's adaptive admission (`qos/`, `obs/timeseries.py` and the
scheduler's `attach_qos`) against the JAX package's.

Both packages run the same script on one `FakeClock`: the controller's
`step()` is called by hand (its thread is never started), and after every
step the decisions, the published per-(shard, class) deadline tables and
the `QosMetrics` snapshots must be equal. The tables hold floats computed
by the same arithmetic on the same inputs; they are held to 1e-12
relative, the one tolerance here, and everything else exactly. The
controller's law (stretch, shrink to the floor, hysteresis, the SLO guard,
interactive at or under the static deadline, warning pins to ceilings) is
asserted on the port while it is compared step for step. A device-engine
scheduler of each package (the port's sessions on the CPU, where K1 and
K2 run their plain versions) with a controller attached takes the same
tape: the same admits, queue fills, due lists and texts.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from diamond_types_tpu import OpLog as JOpLog
from diamond_types_tpu import qos as jqos
from diamond_types_tpu.analysis import witness as jwitness
from diamond_types_tpu.obs import timeseries as jts
from diamond_types_tpu.qos import metrics as jmetrics
from diamond_types_tpu.serve import admission as jadm
from diamond_types_tpu.serve.scheduler import MergeScheduler as JaxScheduler
from diamond_types_tpu_torch import OpLog as TOpLog
from diamond_types_tpu_torch import qos as tqos
from diamond_types_tpu_torch.analysis import witness as twitness
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.obs import timeseries as tts
from diamond_types_tpu_torch.qos import metrics as tmetrics
from diamond_types_tpu_torch.serve import admission as tadm
from diamond_types_tpu_torch.serve.scheduler import MergeScheduler

from torch_parity import TwinDocs

pytestmark = pytest.mark.qos

JAX = SimpleNamespace(name="jax", qos=jqos, ts=jts, adm=jadm,
                      metrics=jmetrics, witness=jwitness)
PORT = SimpleNamespace(name="port", qos=tqos, ts=tts, adm=tadm,
                       metrics=tmetrics, witness=twitness)
PKGS = (JAX, PORT)
REL = 1e-12          # the float deadline tables' tolerance (see above)


class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class FakeObs:
    """The seam the controller reads: any object with a `ts`."""

    def __init__(self, ts) -> None:
        self.ts = ts


def _tables_close(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        b[k] == pytest.approx(v, rel=REL, abs=0.0) for k, v in a.items())


class Twin:
    """A controller of each package over its own AdmissionQueue, on one
    clock; `step()` steps both and holds every output equal."""

    def __init__(self, clock, n_shards=1, flush_deadline_s=0.05,
                 flush_docs=8, **kw) -> None:
        self.clock = clock
        self.ctls, self.queues = [], []
        for pkg in PKGS:
            q = pkg.adm.AdmissionQueue(n_shards, max_pending=64,
                                       flush_docs=flush_docs,
                                       flush_deadline_s=flush_deadline_s)
            ctl = pkg.qos.QosController(clock=clock, **kw)
            ctl.bind(q)
            ctl.attach_obs(FakeObs(pkg.ts.TimeSeries(
                window_s=1.0, n_windows=600, clock=clock)))
            self.ctls.append(ctl)
            self.queues.append(q)
        self.port = self.ctls[1]
        self.steps = 0

    def each(self, fn) -> list:
        return [fn(ctl, q) for ctl, q in zip(self.ctls, self.queues)]

    def inc(self, name: str, n: float) -> None:
        self.each(lambda ctl, _q: ctl.metrics.ts.inc(name, n))

    def step(self) -> dict:
        decisions = self.each(lambda ctl, _q: ctl.step())
        assert decisions[0] == decisions[1], self.steps
        assert _tables_close(self.ctls[0]._table, self.ctls[1]._table), \
            self.steps
        snaps = self.each(lambda ctl, _q: ctl.metrics.snapshot())
        assert snaps[0] == snaps[1], self.steps
        # interactive is never published above the static deadline
        static = self.port.classes["interactive"].ceiling_s
        assert all(v <= static + 1e-12 for (s, c), v in
                   self.port._table.items() if c == "interactive")
        self.steps += 1
        return decisions[1]

    def ctl_counts(self) -> dict:
        return self.port.metrics.snapshot()["controller"]


# ---- classes, time series, metrics ------------------------------------------

def test_class_taxonomy_matches_jax():
    assert tqos.QOS_CLASSES == jqos.QOS_CLASSES
    assert tqos.QOS_PRIORITY == jqos.QOS_PRIORITY
    assert tqos.QOS_HEADER == jqos.QOS_HEADER
    assert tqos.__all__ == jqos.__all__
    for b in (0.05, 0.01, 1.0):
        tc, jc = tqos.default_classes(b), jqos.default_classes(b)
        assert {k: dataclasses.asdict(v) for k, v in tc.items()} == \
            {k: dataclasses.asdict(v) for k, v in jc.items()}
        for base in (b, 0.2, 0.003):
            tw = tqos.classes.with_base(tc, base)
            jw = jqos.classes.with_base(jc, base)
            assert {k: dataclasses.asdict(v) for k, v in tw.items()} == \
                {k: dataclasses.asdict(v) for k, v in jw.items()}
        for cls in tc.values():
            for d in (0.0, b / 20, b, 3 * b, 1e3):
                assert cls.clamp(d) == jc[cls.name].clamp(d)
    headers = [{}, {"X-DT-QoS": "bulk"}, {"X-DT-QoS": " Catchup "},
               {"X-DT-QoS": "speedy"}, {"X-DT-Replication": "1"},
               {"X-DT-QoS": "bulk", "X-DT-Replication": "1"}]
    assert [tqos.classify_headers(h) for h in headers] == \
        [jqos.classify_headers(h) for h in headers]
    ids = ["t0-doc001", "t17-bulk000", "bank0000007", "tx-doc", None, "",
           "t-doc", "t3", "t3-"]
    assert [tqos.tenant_of(d) for d in ids] == \
        [jqos.tenant_of(d) for d in ids]


def test_timeseries_matches_jax():
    clock = FakeClock()
    tss = [pkg.ts.TimeSeries(window_s=1.0, n_windows=8, clock=clock)
           for pkg in PKGS]
    rng = np.random.default_rng(4)
    for i in range(60):
        name = ["qos.admitted.bulk", "serve.flush", "x"][i % 3]
        v = float(rng.random())
        for ts in tss:
            if name == "serve.flush":
                ts.observe(name, v / 10)
            else:
                ts.inc(name, v)
        clock.advance(float(rng.random()) * 0.6)
        got = [(ts.rate("qos.admitted.bulk", window_s=3.0),
                ts.quantile("serve.flush", 0.99, window_s=5.0),
                ts.quantile("serve.flush", 0.5, window_s=2.0),
                ts.count_over("serve.flush", 0.05, window_s=4.0),
                ts.sum_over("x", window_s=5.0), ts.names(),
                ts.snapshot(windows=(2.0, 6.0)), ts.recorded)
               for ts in tss]
        assert got[0] == got[1], i
    assert tts.BOUNDS == jts.BOUNDS
    assert [tts.bucket_index(s) for s in (0, 1e-7, 3e-3, 200.0)] == \
        [jts.bucket_index(s) for s in (0, 1e-7, 3e-3, 200.0)]
    lk = tss[1]._ts_lock
    jl = tss[0]._ts_lock
    assert (lk.name, lk.order_class, lk.rank) == \
        (jl.name, jl.order_class, jl.rank) == ("obs.timeseries", "leaf", None)
    off = tts.TimeSeries(enabled=False)
    off.inc("a")
    off.observe("b", 1.0)
    assert off.recorded == 0 and off.names() == []


def test_qos_metrics_and_merge_snapshots_match_jax():
    ms = [pkg.metrics.QosMetrics() for pkg in PKGS]
    rng = np.random.default_rng(8)
    for _ in range(50):
        cls = tqos.QOS_CLASSES[int(rng.integers(3))]
        key = tmetrics.QOS_CLASS_KEYS[int(rng.integers(3))]
        ctl = tmetrics.QOS_CTL_KEYS[int(rng.integers(6))]
        d = float(rng.random())
        for m in ms:
            m.bump_class(cls, key, 2)
            m.bump_ctl(ctl)
            m.set_deadline(cls, d)
    snaps = [m.snapshot() for m in ms]
    assert snaps[0] == snaps[1]
    assert tmetrics.QOS_CLASS_KEYS == jmetrics.QOS_CLASS_KEYS
    assert tmetrics.QOS_CTL_KEYS == jmetrics.QOS_CTL_KEYS
    other = {"schema_version": 1,
             "classes": {"bulk": {"admitted": 3, "shed": 1, "deferred": 0,
                                  "deadline_s": 9.0}},
             "controller": {"steps": 4}}
    for arg in ([snaps[1], None, other], [None, None], []):
        assert tmetrics.merge_snapshots(arg) == jmetrics.merge_snapshots(arg)


# ---- shed policy and token buckets --------------------------------------------

def _burning(burn=14.4, state="burning"):
    return [{"name": "visibility_p99", "state": state,
             "fast": {"burn": burn, "bad": 10, "total": 20}}]


def test_shed_policy_and_token_buckets_match_jax():
    clock = FakeClock()
    pols = [pkg.qos.ShedPolicy(metrics=pkg.metrics.QosMetrics(),
                               tenant_rate=20.0, tenant_burst=6.0,
                               isolation_factor=0.25, clock=clock)
            for pkg in PKGS]
    rng = np.random.default_rng(11)
    refreshes = [([], None, None), (_burning(2.0), None, None),
                 (_burning(1000.0), None, {"t1"}),
                 (_burning(0.0, "warning"), None, {"t1", "t2"}),
                 ([], {"peer-b": {"mean_s": 30.0}}, set()),
                 ([{"name": "flush_p99", "state": "burning"}], None, None)]
    for rnd, (rows, lag, hot) in enumerate(refreshes):
        for p in pols:
            p.refresh(rows, lag=lag, hot_tenants=hot)
        for _ in range(30):
            cls = tqos.QOS_CLASSES[int(rng.integers(3))]
            ten = [None, "t0", "t1", "t2"][int(rng.integers(4))]
            got = [p.admit(cls, tenant=ten) for p in pols]
            assert got[0] == got[1], rnd
            clock.advance(float(rng.random()) * 0.1)
        assert pols[0].snapshot() == pols[1].snapshot(), rnd
    assert pols[0].metrics.snapshot() == pols[1].metrics.snapshot()
    snap = pols[1].metrics.snapshot()["classes"]
    assert snap["interactive"]["shed"] > 0          # the tenant gate
    assert snap["bulk"]["deferred"] + snap["catchup"]["deferred"] > 0

    class Attrib:
        def top(self, dim, kind, n):
            return [("t9-doc000", 80.0, 0), ("t1-doc000", 10.0, 0),
                    ("bank0001", 10.0, 0)]

    assert pols[1].hot_tenants_from_attrib(Attrib()) == \
        pols[0].hot_tenants_from_attrib(Attrib()) == frozenset({"t9"})
    buckets = [pkg.qos.TokenBucket(rate=10.0, burst=2.0, now=0.0)
               for pkg in PKGS]
    for t in (0.0, 0.0, 0.0, 0.1, 0.1, 0.35, 0.35, 0.35, 2.0, 2.0, 2.0):
        assert buckets[0].take(t) == buckets[1].take(t)
        assert buckets[0].tokens == buckets[1].tokens


# ---- the controller's law, step for step ----------------------------------------

def test_controller_stretches_then_shrinks_to_floor():
    clock = FakeClock()
    tw = Twin(clock)
    spec = tw.port.classes["bulk"]
    for _ in range(40):
        tw.inc("qos.admitted.bulk", 5.0)       # ~20/s on the fake clock
        clock.advance(0.25)
        tw.step()
    stretched = tw.port.effective_deadline(0, "bulk")
    # gap 8 docs at 20/s: ~0.4 s to fill, past the 0.25 s base deadline
    assert spec.deadline_s * 1.2 < stretched <= spec.ceiling_s
    assert tw.ctl_counts()["stretched"] >= 1
    for _ in range(60):                         # arrivals stop
        clock.advance(0.25)
        tw.step()
    got = tw.port.effective_deadline(0, "bulk")
    assert got < stretched
    assert got == pytest.approx(spec.floor_s, rel=0.25)
    assert tw.ctl_counts()["shrunk"] >= 1


def test_controller_hysteresis_holds_on_noise():
    clock = FakeClock()
    tw = Twin(clock, deadband=0.1)
    for _ in range(40):
        tw.inc("qos.admitted.bulk", 5.0)
        clock.advance(0.25)
        tw.step()
    before = tw.ctl_counts()
    for i in range(40):                # +/-5%, inside the 10% deadband
        tw.inc("qos.admitted.bulk", 5.25 if i % 2 else 4.75)
        clock.advance(0.25)
        tw.step()
    after = tw.ctl_counts()
    held = after["held"] - before["held"]
    moved = after["stretched"] - before["stretched"] \
        + after["shrunk"] - before["shrunk"]
    assert held > moved * 3


def test_controller_slo_guard_pins_to_floor():
    clock = FakeClock()
    tw = Twin(clock)

    class BurnSlo:
        def evaluate(self):
            return [{"name": "queue_wait_p99", "state": "burning",
                     "fast": {"burn": 20.0}}]

    for ctl in tw.ctls:
        ctl.obs.slo = BurnSlo()
    for _ in range(40):
        tw.inc("qos.admitted.bulk", 5.0)       # load that would stretch
        clock.advance(0.25)
        tw.step()
    assert tw.port.effective_deadline(0, "bulk") == pytest.approx(
        tw.port.classes["bulk"].floor_s, rel=0.25)
    assert tw.ctl_counts()["floors"] > 0


def test_controller_interactive_never_exceeds_static_deadline():
    clock = FakeClock()
    tw = Twin(clock, flush_deadline_s=0.05)
    for ctl in tw.ctls:
        # a slow flush p99 in the telemetry caps interactive further
        ctl.metrics.ts.observe("serve.flush", 0.02)
    for _ in range(60):
        # a slow trickle: the fill time says "wait seconds"; the ceiling
        # holds interactive at the static deadline
        tw.inc("qos.admitted.interactive", 0.5)
        clock.advance(0.25)
        tw.step()
    assert tw.port.effective_deadline(0, "interactive") <= 0.05 + 1e-12


def test_controller_warning_pins_sheddable_to_ceilings():
    clock = FakeClock()
    tw = Twin(clock)
    tw.each(lambda ctl, _q: ctl.force_mesh_state("warning",
                                                 retry_after=0.0))
    for _ in range(40):
        clock.advance(0.25)
        tw.step()
    for cls in ("bulk", "catchup"):
        assert tw.port.effective_deadline(0, cls) == pytest.approx(
            tw.port.classes[cls].ceiling_s, rel=0.2)
    assert tw.port.effective_deadline(0, "interactive") <= 0.05 + 1e-12
    assert tw.ctl_counts()["ceilings"] > 0
    got = tw.each(lambda ctl, _q: [ctl.admit(c, tenant="t0")
                                   for c in tqos.QOS_CLASSES])
    assert got[0] == got[1]
    assert [r for _ok, _ra, r in got[1]] == ["", "deferred", "deferred"]
    exports = tw.each(lambda ctl, _q: ctl.export())
    assert exports[0] == exports[1]


def test_per_shard_tables_and_snapshots_match_jax():
    """Four shards, every class arriving, bucket fills that differ per
    shard: the published (shard, class) tables and the metrics snapshots
    agree at every step, through a warning and a burning stretch."""
    clock = FakeClock()
    tw = Twin(clock, n_shards=4, flush_docs=8)
    rng = np.random.default_rng(21)
    doc = 0
    for i in range(80):
        for _ in range(int(rng.integers(0, 4))):
            shard = int(rng.integers(0, 4))
            cls = tqos.QOS_CLASSES[int(rng.integers(3))]
            n_ops = int(rng.integers(1, 20))
            tw.each(lambda _c, q: q.submit(shard, f"t{shard}-doc{doc:03d}",
                                           n_ops, clock(), qos=cls))
            tw.each(lambda c, _q: c.metrics.bump_class(cls, "admitted"))
            doc += 1
        if i % 7 == 6:
            due = tw.each(lambda _c, q: q.due(clock()))
            assert due[0] == due[1]
            for shard, bucket, _r in due[1]:
                tw.each(lambda _c, q: [it.doc_id for it in
                                       q.take(shard, bucket)])
        if i == 30:
            tw.each(lambda c, _q: c.force_mesh_state("warning"))
        if i == 50:
            tw.each(lambda c, _q: c.force_mesh_state("burning",
                                                     retry_after=2.0))
        if i == 65:
            tw.each(lambda c, _q: c.force_mesh_state(None))
        clock.advance(float(rng.random()) * 0.3)
        tw.step()
        fills = tw.each(lambda _c, q: [q.bucket_fill(s) for s in range(4)])
        assert fills[0] == fills[1]
    assert set(tw.port._table) == {(s, c) for s in range(4)
                                   for c in tqos.QOS_CLASSES}
    counts = tw.ctl_counts()
    assert counts["steps"] == 80 and counts["ceilings"] > 0
    assert counts["stretched"] > 0 and counts["shrunk"] > 0


def test_controller_lock_and_thread_lifecycle():
    ctls = [pkg.qos.QosController(interval_s=0.01) for pkg in PKGS]
    locks = [(c._qos_lock.name, c._qos_lock.order_class, c._qos_lock.rank)
             for c in ctls]
    assert locks[0] == locks[1] == ("qos.controller", "qos", None)
    port = ctls[1]
    q = tadm.AdmissionQueue(2, max_pending=16, flush_docs=4,
                            flush_deadline_s=0.05)
    port.bind(q)
    port.start()
    try:
        import time
        deadline = time.monotonic() + 10.0
        while port.metrics.snapshot()["controller"]["steps"] < 3:
            assert time.monotonic() < deadline, "the controller never stepped"
            time.sleep(0.01)
        assert port.export()["running"]
    finally:
        port.stop()
    assert not port.export()["running"]


# ---- the device scheduler with a controller attached ---------------------------

FUSED = {"cap": 256, "max_ins": 4}


COMMON = dict(engine="device", fused=True, flush_docs=4,
              flush_deadline_s=0.05, flush_workers=False, device_plan=True)


def test_device_scheduler_with_qos_matches_jax():
    clock = FakeClock()
    rng = np.random.default_rng(5)
    n_docs = 16
    ids = [f"t{k % 4}-doc{k:03d}" for k in range(n_docs)]
    classes = {d: tqos.QOS_CLASSES[int(rng.integers(3))] for d in ids}
    docs = {}
    for k, d in enumerate(ids):
        tw = TwinDocs([JOpLog(), TOpLog()], 700 + k)
        tw.type_base("alice", int(rng.integers(20, 200)))
        tw.fork(("alice", "bob", "carol"))
        docs[d] = tw
    js = JaxScheduler(4, resolve=lambda d: docs[d].oplogs[0],
                      fused_opts=FUSED, **COMMON)
    ts = MergeScheduler(4, resolve=lambda d: docs[d].oplogs[1],
                        fused_opts=dict(FUSED, device="cpu"), **COMMON)
    scheds = (js, ts)
    ctls = []
    for pkg, s in zip(PKGS, scheds):
        ctl = pkg.qos.QosController(clock=clock)
        s.attach_qos(ctl)
        ctl.attach_obs(FakeObs(pkg.ts.TimeSeries(window_s=1.0,
                                                 n_windows=600,
                                                 clock=clock)))
        ctls.append(ctl)
    assert ts.queue.qos is ctls[1] and ts.qos is ctls[1]
    launches = (kernels.apply_ops_window.launches,
                kernels.xform_positions.launches)
    for s in scheds:                  # open every document (build sessions)
        for d in ids:
            s.submit(d, 1, now=clock(), qos=classes[d])
        s.drain()
    for rnd in range(6):
        if rnd == 3:
            for c in ctls:
                c.force_mesh_state("warning")
        if rnd == 5:
            for c in ctls:
                c.force_mesh_state("burning", retry_after=1.0)
        for d in ids:
            if rng.random() >= 0.7:
                continue
            got = [c.admit(classes[d], tenant=tqos.tenant_of(d))
                   for c in ctls]
            assert got[0] == got[1]
            if not got[1][0]:
                assert rnd == 5 and classes[d] != "interactive"
                continue                  # a shed edit is never applied
            k = int(rng.integers(1, 4))
            docs[d].concurrent_round(("alice", "bob", "carol"), k,
                                     max_ins=11, max_del=9)
            subs = [s.submit(d, n_ops=3 * k + 1, now=clock(),
                             qos=classes[d]) for s in scheds]
            assert subs[0] == subs[1] and subs[1]["accepted"]
            clock.advance(float(rng.random()) * 0.02)
            if rng.random() < 0.3:
                dec = [c.step() for c in ctls]
                assert dec[0] == dec[1]
                assert _tables_close(ctls[0]._table, ctls[1]._table)
            if rng.random() < 0.4:
                due = [s.queue.due(clock()) for s in scheds]
                assert due[0] == due[1]
                pumped = [s.pump(now=clock()) for s in scheds]
                assert pumped[0] == pumped[1]
            fills = [[s.queue.bucket_fill(i) for i in range(4)]
                     for s in scheds]
            assert fills[0] == fills[1]
        for s in scheds:
            s.drain()
        for d in ids:
            want = docs[d].oplogs[1].checkout_tip().snapshot()
            assert [s.text(d) for s in scheds] == [want, want], (rnd, d)
        snaps = [c.metrics.snapshot() for c in ctls]
        assert snaps[0] == snaps[1], rnd
    snap = snaps[1]["classes"]
    assert snap["bulk"]["shed"] + snap["catchup"]["shed"] > 0
    assert snap["bulk"]["deferred"] + snap["catchup"]["deferred"] > 0
    assert snap["interactive"]["shed"] == snap["interactive"]["deferred"] == 0
    assert ts.metrics_json()["totals"]["host_fallbacks"] == 0
    assert ts.metrics_json()["transform"]["device_docs"] > 0
    assert (kernels.apply_ops_window.launches,
            kernels.xform_positions.launches) == launches
