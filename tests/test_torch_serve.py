"""The port's serve layer against the JAX package's.

The same concurrent tape (`torch_parity.serve_docs` / `serve_round`) goes
through the JAX scheduler (`engine="device"`, `fused=True`, `device_plan`,
`pallas=True` with the Pallas kernel interpreted) and the port's
(sessions on `device="cpu"`, where K1 and K2 run their plain versions).
Per round, both must give byte-identical texts equal to the host checkout,
equal `metrics_json()` counters and transform blocks, and equal steer
snapshots (the JAX cache "pallas" is the port's "kernel"). The router,
the admission queue and `run_serve_bench` are held against the JAX
package's too. The fault tests pin what the port does NOT copy: a kernel
or build error propagates out of `drain()`; only the length fence sends a
document to the host.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from diamond_types_tpu.serve.admission import AdmissionQueue as JaxQueue
from diamond_types_tpu.serve.admission import Backpressure as JaxBackpressure
from diamond_types_tpu.serve.driver import run_serve_bench as jax_bench
from diamond_types_tpu.serve.router import ShardRouter as JaxRouter
from diamond_types_tpu.serve.scheduler import MergeScheduler as JaxScheduler
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import flush_fuse as jff
from diamond_types_tpu.tpu.steer import STEER as JAX_STEER
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import flush_fuse as tff
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu.steer import STEER
from diamond_types_tpu_torch.serve import (AdmissionQueue, Backpressure,
                                           MergeScheduler, SessionBank,
                                           ShardRouter)
from diamond_types_tpu_torch.serve.driver import run_serve_bench, synth_trace

from torch_parity import serve_docs, serve_round

pytestmark = pytest.mark.serve

FUSED = {"cap": 256, "max_ins": 4}
COUNTERS = ("submits", "coalesced", "builds", "evictions", "resyncs",
            "syncs", "host_fallbacks", "fused_calls", "fused_docs",
            "flushes", "flushed_docs", "flushed_ops")


def _port_steer(snap):
    out = dict(snap)
    out["warm_classes"] = {{"pallas": "kernel"}.get(k, k): v
                           for k, v in snap["warm_classes"].items()}
    return out


def _twin_schedulers(n_docs, seed, n_shards=2, engine="device", **kw):
    """The tape's documents and one scheduler per package over them."""
    docs = serve_docs([JaxOpLog, OpLog], n_docs, seed)
    jols = {d: tw.oplogs[0] for d, tw in docs.items()}
    tols = {d: tw.oplogs[1] for d, tw in docs.items()}
    common = dict(engine=engine, fused=True, flush_docs=4,
                  flush_deadline_s=10.0, flush_workers=False,
                  device_plan=engine == "device")
    common.update(kw)
    JAX_STEER.reset(table=True)
    STEER.reset(table=True)
    js = JaxScheduler(n_shards, resolve=jols.__getitem__, fused_opts=FUSED,
                      pallas=True, **common)
    ts = MergeScheduler(n_shards, resolve=tols.__getitem__,
                        fused_opts=dict(FUSED, device="cpu"), **common)
    return docs, tols, js, ts


def _round(docs, seed, rnd, scheds):
    subs = serve_round(docs, seed, rnd)
    for d, n in subs:
        for s in scheds:
            assert s.submit(d, n_ops=n)["accepted"]
    for s in scheds:
        s.pump()
    for s in scheds:
        s.drain()
    return subs


def _assert_texts(docs, tols, scheds, rnd):
    for d in docs:
        want = tols[d].checkout_tip().snapshot()
        got = [s.text(d) for s in scheds]
        assert all(g == want for g in got), (rnd, d)


def _assert_metrics_equal(js, ts, rnd):
    jm, tm = js.metrics_json(), ts.metrics_json()
    assert {k: tm["totals"][k] for k in COUNTERS} == \
        {k: jm["totals"][k] for k in COUNTERS}, rnd
    assert tm["transform"] == jm["transform"], rnd
    assert tm["fused"] == jm["fused"], rnd
    assert tm["router_counts"] == jm["router_counts"]
    assert jm["totals"]["pallas_fallbacks"] == 0     # JAX stayed on Pallas
    return tm


def test_scheduler_matches_jax_per_round():
    seed = 3
    docs, tols, js, ts = _twin_schedulers(12, seed)
    launches = (kernels.apply_ops_window.launches,
                kernels.xform_positions.launches)
    for rnd in range(5):
        _round(docs, seed, rnd, (js, ts))
        _assert_texts(docs, tols, (js, ts), rnd)
        tm = _assert_metrics_equal(js, ts, rnd)
        assert STEER.snapshot() == _port_steer(JAX_STEER.snapshot()), rnd
    assert tm["totals"]["host_fallbacks"] == 0
    assert tm["transform"]["device_docs"] > 0
    assert tm["fused"]["device_calls"] > 0
    steer = STEER.snapshot()
    assert steer["lookups"] > 0 and set(steer["warm_classes"]) == \
        {"fused", "kernel"}
    # CPU sessions: plain versions ran, no kernel was launched
    assert (kernels.apply_ops_window.launches,
            kernels.xform_positions.launches) == launches


def test_scheduler_with_flush_workers_texts_match():
    seed = 4
    docs, tols, js, ts = _twin_schedulers(10, seed, n_shards=3,
                                          flush_workers=True)
    for rnd in range(3):
        _round(docs, seed, rnd, (js, ts))
        _assert_texts(docs, tols, (js, ts), rnd)
    for s in (js, ts):
        s.stop_workers()
    assert ts.metrics_json()["totals"]["host_fallbacks"] == 0


@pytest.mark.parametrize("engine,max_sessions", [("host", 8), ("host", 2),
                                                 ("device", 2)])
def test_host_engine_and_lru_eviction_match_jax(engine, max_sessions):
    seed = 5
    docs, tols, js, ts = _twin_schedulers(
        8, seed, engine=engine, max_sessions_per_shard=max_sessions)
    for rnd in range(3):
        _round(docs, seed, rnd, (js, ts))
        _assert_texts(docs, tols, (js, ts), rnd)
        jm, tm = js.metrics_json(), ts.metrics_json()
        for k in ("evictions", "builds", "syncs", "host_fallbacks"):
            assert tm["totals"][k] == jm["totals"][k], (rnd, k)
    if max_sessions == 2:
        assert tm["totals"]["evictions"] > 0


def _write_corpus(path) -> str:
    """A gzipped crdt-testdata trace (the driver's `corpus`)."""
    import gzip
    import json
    data = synth_trace(n_txns=8, seed=21)
    with gzip.open(path, "wt", encoding="utf8") as f:
        json.dump({"startContent": data.start_content,
                   "endContent": data.end_content,
                   "txns": [{"patches": [list(p) for p in t]}
                            for t in data.txns]}, f)
    return str(path)


@pytest.mark.parametrize("mode", ["trace", "concurrent", "flash", "corpus"])
def test_serve_bench_matches_jax(mode, tmp_path):
    kw = dict(shards=2, docs=4, txns=6, engine="device", mode=mode,
              flush_docs=2, max_sessions=8, steady_rounds=3,
              flush_workers=False, flush_deadline_s=10.0)
    if mode == "corpus":
        kw.update(mode="trace", corpus=_write_corpus(tmp_path / "t.json.gz"))
    jr = jax_bench(**kw)
    tr = run_serve_bench(device="cpu", **kw)
    assert jr["parity_ok"] and tr["parity_ok"], tr["parity_mismatches"]
    assert tr["total_ops"] == jr["total_ops"]
    assert tr["fused_device_calls"] == jr["fused_device_calls"]
    assert tr["fused_occupancy"] == jr["fused_occupancy"]
    assert tr["config"]["device"] == "cpu"
    assert tr["steer"]["lookups"] > 0
    assert {"ops_per_sec", "transform", "metrics"} <= set(tr)


def test_router_matches_jax():
    ids = [f"doc{i}" for i in range(300)] + ["", "é中😀", "x" * 200]
    for n in (1, 2, 3, 4, 7, 16):
        jr, tr = JaxRouter(n), ShardRouter(n)
        assert [tr.shard_of(d) for d in ids] == [jr.shard_of(d) for d in ids]
        for d in ids[:50]:
            assert tr.assign(d) == jr.assign(d)
        assert tr.rebalance(max(n - 1, 1)) == jr.rebalance(max(n - 1, 1))
        assert tr.counts() == jr.counts()


def test_admission_matches_jax():
    """The same submit/due/take sequence, with coalescing, deadlines and
    backpressure, gives the same buckets, reasons and rejects."""
    rng = np.random.default_rng(9)
    jq = JaxQueue(3, max_pending=5, flush_docs=3, flush_deadline_s=0.5)
    tq = AdmissionQueue(3, max_pending=5, flush_docs=3,
                        flush_deadline_s=0.5)
    now = 0.0
    for step in range(400):
        now += float(rng.random()) * 0.1
        shard = int(rng.integers(3))
        if rng.random() < 0.7:
            doc = f"d{int(rng.integers(12))}"
            n = int(rng.integers(0, 40))
            qos = ["interactive", "bulk", "catchup", "bogus"][
                int(rng.integers(4))]
            got = []
            for q, exc in ((jq, JaxBackpressure), (tq, Backpressure)):
                try:
                    got.append(q.submit(shard, doc, n, now, qos=qos))
                except exc as e:
                    got.append(("backpressure", e.shard, e.depth,
                                e.retry_after))
            assert got[1] == got[0], step
        else:
            force = rng.random() < 0.2
            due = tq.due(now, force=force)
            assert due == jq.due(now, force=force), step
            for s, bucket, _reason in due:
                limit = None if rng.random() < 0.5 else 2
                ti, ji = tq.take(s, bucket, limit), jq.take(s, bucket, limit)
                assert [(i.doc_id, i.n_ops, i.enqueued_at, i.qos)
                        for i in ti] == \
                    [(i.doc_id, i.n_ops, i.enqueued_at, i.qos) for i in ji]
        assert [tq.depth(s) for s in range(3)] == \
            [jq.depth(s) for s in range(3)]


# ---- faults: no fallback hides the device or the kernel --------------------

def _faulty_sched(monkeypatch, fault, workers):
    docs = serve_docs([OpLog], 6, 8)
    ols = {d: tw.oplogs[0] for d, tw in docs.items()}
    sched = MergeScheduler(2, resolve=ols.__getitem__, engine="device",
                           fused_opts=dict(FUSED, device="cpu"),
                           flush_docs=4, flush_deadline_s=10.0,
                           flush_workers=workers, device_plan=True)

    def boom(*a, **k):
        raise RuntimeError(f"injected {fault} fault")
    if fault == "replay":
        # a K1 launch error: both the groups and the per-doc syncs launch
        # through the wrapper that flush_fuse calls
        monkeypatch.setattr(tff, "apply_ops_window", boom)
        serve_round(docs, 8, 0)          # sessions exist; tails pending
        for d in docs:
            sched.submit(d, 4)
        monkeypatch.undo()
        sched.drain()                    # builds only, nothing replayed
        monkeypatch.setattr(tff, "apply_ops_window", boom)
        serve_round(docs, 8, 1, share=1.0)
    else:
        monkeypatch.setattr(tff, "FusedDocSession", boom)
    for d in docs:
        sched.submit(d, 4)
    return sched


@pytest.mark.parametrize("workers", [False, True])
@pytest.mark.parametrize("fault", ["replay", "build"])
def test_kernel_or_build_fault_propagates_out_of_drain(monkeypatch, fault,
                                                       workers):
    sched = _faulty_sched(monkeypatch, fault, workers)
    with pytest.raises(RuntimeError, match=f"injected {fault} fault"):
        sched.drain()
    m = sched.metrics_json()["totals"]
    assert m["host_fallbacks"] == 0
    sched.stop_workers()          # raised once; nothing left to raise
    # the fault itself stays for the server and the replica node to read
    assert str(sched.fault) == f"injected {fault} fault"
    for w in sched._workers:
        assert w is None


@pytest.mark.parametrize("flush_docs", [1, 4])
def test_poisoned_row_goes_to_the_host_in_both_packages(monkeypatch,
                                                        flush_docs):
    """An op past max_ins in one document's plan: that document alone is
    served from the host (one host fallback) and rebuilt later, in both
    packages; flush_docs 1 takes the per-doc rung (FenceMismatch in the
    port), 4 the group rung (the adopt_results fence)."""
    seed = 6
    docs, tols, js, ts = _twin_schedulers(6, seed, flush_docs=flush_docs,
                                          device_plan=False)
    _round(docs, seed, 0, (js, ts))
    target = docs["d01"]
    for cls, ol in ((jff.FusedDocSession, target.oplogs[0]),
                    (tff.FusedDocSession, target.oplogs[1])):
        real = cls.plan_tail

        def plan_tail(self, real=real, ol=ol):
            p = real(self)
            if self.oplog is ol and p.n_ops:
                p.dlen = p.dlen.copy()
                p.dlen[0] = FUSED["max_ins"] + 1
            return p
        monkeypatch.setattr(cls, "plan_tail", plan_tail)
    target.concurrent_round(("alice", "bob", "carol"), 2, max_ins=11)
    for s in (js, ts):
        s.submit("d01", 7)
    _round(docs, seed, 1, (js, ts))
    monkeypatch.undo()
    for s in (js, ts):
        assert s.metrics_json()["totals"]["host_fallbacks"] == 1
    _assert_texts(docs, tols, (js, ts), 1)
    _round(docs, seed, 2, (js, ts))
    _assert_texts(docs, tols, (js, ts), 2)
    _assert_metrics_equal(js, ts, 2)


def test_per_doc_sync_replays_through_the_kernel_rung(monkeypatch):
    """FusedDocSession.sync launches through K1's wrapper at the pow2
    floor of its tail, notes its class under the per-doc key "fused",
    and raises FenceMismatch on a poisoned length."""
    docs = serve_docs([OpLog], 1, 10)
    tw = docs["d00"]
    sess = tff.FusedDocSession(tw.oplogs[0], device="cpu", **FUSED)
    assert sess.footprint_slots() == sess.cap
    shapes = []
    real = tff.apply_ops_window

    def spy(docs, lens, pos, *rest):
        shapes.append((docs.shape[0], pos.shape[1]))
        return real(docs, lens, pos, *rest)
    monkeypatch.setattr(tff, "apply_ops_window", spy)
    STEER.reset(table=True)
    tw.concurrent_round(("alice", "bob", "carol"), 3, max_ins=11)
    n_ops = sess.plan_tail().n_ops
    assert sess.sync() == n_ops > 0
    assert shapes == [(1, tff._pow2(n_ops))]
    snap = STEER.snapshot()
    assert snap["lookups"] == 1 and snap["warm_classes"] == {"fused": 1}
    assert sess.text() == tw.oplogs[0].checkout_tip().snapshot()
    real_plan = tff.FusedDocSession.plan_tail

    def poisoned(self):
        p = real_plan(self)
        p.ilen = p.ilen.copy()
        p.ilen[0] = FUSED["max_ins"] + 1
        return p
    monkeypatch.setattr(tff.FusedDocSession, "plan_tail", poisoned)
    tw.concurrent_round(("alice", "bob", "carol"), 2, max_ins=11)
    with pytest.raises(tff.FenceMismatch):
        sess.sync()
    assert issubclass(tff.FenceMismatch, RuntimeError)


def test_unported_options_raise():
    ol = OpLog()
    # fused=False (the zone-session bank) is ported: it no longer raises,
    # and the fused-only options fall away as in the JAX package
    sched = MergeScheduler(2, resolve=lambda d: ol, fused=False,
                           session_opts={"device": "cpu"},
                           mesh_window=True, device_plan=True)
    assert not sched.fused and not sched.mesh_window
    assert not sched.device_plan
    assert all(b.device == torch.device("cpu") for b in sched.banks)
    # the host engine ignores fused, as in the JAX package
    assert not MergeScheduler(1, resolve=lambda d: ol, engine="host",
                              fused=False).fused


def test_device_engine_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    ol = OpLog()
    for kw in ({}, {"place_on_devices": True}):
        with pytest.raises(RuntimeError, match="CUDA"):
            MergeScheduler(2, resolve=lambda d: ol, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionBank(0)
    bank = SessionBank(0, fused_opts={"device": "cpu"})
    assert bank.device == torch.device("cpu")


def test_warmup_notes_every_class_and_raises_its_faults(monkeypatch):
    STEER.reset(table=True)
    bank = SessionBank(0, fused_opts=dict(FUSED, device="cpu"),
                       warmup=True, flush_docs=4)
    bank.join_warmup()
    # batch classes {1, 2, 4} x the pow2 op classes {2, 4, 8} of
    # WARMUP_SHAPE_CLASSES (as the JAX warm-up notes them), both keys
    assert STEER.snapshot()["warm_classes"] == {"fused": 9, "kernel": 9}

    def boom(*a, **k):
        raise RuntimeError("injected warm-up fault")
    monkeypatch.setattr(kernels, "apply_ops_window", boom)
    bank = SessionBank(0, fused_opts=dict(FUSED, device="cpu"),
                       warmup=True)
    with pytest.raises(RuntimeError, match="warm-up fault"):
        bank.join_warmup()


def test_launch_counts_are_exact_across_threads():
    """The wrappers' launch counts are taken under a lock: many threads
    adding at once, with a short switch interval, lose no count."""
    names = ("apply_ops_window", "xform_positions", "materialize_runs")
    before = {n: getattr(kernels, n).launches for n in names}
    per_thread = 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda n=n: [kernels.count_launch(n)
                                for _ in range(per_thread)])
            for n in names for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for n in names:
        assert getattr(kernels, n).launches == before[n] + 8 * per_thread
        getattr(kernels, n).launches = before[n]


def test_serve_module_prints_the_report(capsys):
    """`python -m diamond_types_tpu_torch.serve` prints the bench report
    as one JSON object and exits 0 on parity."""
    import json
    from diamond_types_tpu_torch.serve.__main__ import main
    rc = main(["--device", "cpu", "--shards", "2", "--docs", "3",
               "--txns", "4", "--mode", "concurrent", "--device-plan",
               "--no-workers", "--steady-rounds", "2"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["parity_ok"]
    assert report["config"]["device_plan"] and \
        report["config"]["device"] == "cpu"
    assert report["transform"]["device_docs"] > 0
