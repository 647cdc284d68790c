"""Device-resident zone sessions (X9), the zone-session bank and the
scheduler's `fused=False` path, in the port against the JAX package's.

The same realtime histories go through a JAX-package `DeviceZoneSession`
and the port's (`device="cpu"`, where the X8 kernel's plain version runs):
after every sync both texts must equal each other and a fresh tracker
checkout, with equal `resyncs`, `merges` and `footprint_slots()`. The
bank (`SessionBank(engine="device", fused=False)`) and the scheduler
(`MergeScheduler(fused=False)`) take one concurrent tape in both packages,
with equal texts and per-round counters. The divergence the port keeps on
purpose is pinned too: a zone session's fault propagates out of the bank
and the scheduler, where the JAX bank serves the document from the host.
"""

import random

import numpy as np
import pytest
import torch

from diamond_types_tpu.serve.bank import SessionBank as JaxBank
from diamond_types_tpu.serve.driver import run_serve_bench as jax_bench
from diamond_types_tpu.serve.scheduler import MergeScheduler as JaxScheduler
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu.zone_session import DeviceZoneSession as JaxSession
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu.zone_session import DeviceZoneSession
from diamond_types_tpu_torch.listmerge import policy as tpolicy
from diamond_types_tpu_torch.serve import MergeScheduler, SessionBank
from diamond_types_tpu_torch.serve.__main__ import main as serve_main
from diamond_types_tpu_torch.serve.driver import run_serve_bench

from test_zone import random_edit
from torch_parity import serve_docs, serve_round

CPU = {"device": "cpu"}
COUNTERS = ("submits", "coalesced", "builds", "evictions", "resyncs",
            "syncs", "host_fallbacks", "fused_calls", "flushes",
            "flushed_docs", "flushed_ops")


@pytest.fixture(autouse=True)
def _fresh_port_policy(monkeypatch):
    monkeypatch.setattr(tpolicy, "GLOBAL", tpolicy.EnginePolicy())


class TwinSessions:
    """One realtime history driven into a JAX-package OpLog and a port
    OpLog by one random stream each, with a session over each."""

    def __init__(self, seed, agents=("ann", "bo", "cy"), warm=5,
                 **session_kw):
        self.rngs = [random.Random(seed), random.Random(seed)]
        self.ols = [JaxOpLog(), OpLog()]
        self.agents = [[ol.get_or_create_agent_id(n) for n in agents]
                       for ol in self.ols]
        self.heads = [{a: ([], "") for a in ags} for ags in self.agents]
        for k, ol in enumerate(self.ols):
            a0 = self.agents[k][0]
            v, c = [], ""
            for _ in range(warm):
                v, c = random_edit(self.rngs[k], ol, a0, v, c)
            for a in self.agents[k]:
                self.heads[k][a] = (v, c)
        self.sessions = [JaxSession(self.ols[0], **session_kw),
                         DeviceZoneSession(self.ols[1], device="cpu",
                                           **session_kw)]

    def step(self, merge_share=0.4):
        for k, ol in enumerate(self.ols):
            rng, heads, ags = self.rngs[k], self.heads[k], self.agents[k]
            a = ags[rng.randrange(len(ags))]
            v, c = heads[a]
            heads[a] = random_edit(rng, ol, a, v, c)
            if rng.random() < merge_share:     # peers sync up sometimes
                merged = ol.checkout_tip()
                for a2 in ags:
                    if rng.random() < 0.5:
                        heads[a2] = (list(merged.version),
                                     merged.snapshot())

    def sync_and_check(self, where=""):
        steps = [s.sync() for s in self.sessions]
        assert steps[0] == steps[1], where
        want = self.ols[1].checkout_tip().snapshot()
        assert self.ols[0].checkout_tip().snapshot() == want
        texts = [s.text() for s in self.sessions]
        assert texts[0] == texts[1] == want, where
        self.assert_counters_equal(where)

    def assert_counters_equal(self, where=""):
        js, ts = self.sessions
        assert (ts.resyncs, ts.merges, ts.footprint_slots(), ts.W_cap,
                ts.n_rows_eff) == (js.resyncs, js.merges,
                                   js.footprint_slots(), js.W_cap,
                                   js.n_rows_eff), where
        assert ts.row_of == js.row_of, where


@pytest.mark.parametrize("seed", range(10))
def test_session_realtime_fuzz_matches_jax(seed):
    """2-3 peers edit from their own heads; both sessions fold each edit
    incrementally and match each other and a fresh checkout every time."""
    tw = TwinSessions(8800 + seed, max_chars=32)
    tw.sync_and_check("build")
    for step in range(30):
        tw.step()
        tw.sync_and_check(f"seed {seed} step {step}")


def test_session_carry_matches_jax_after_syncs():
    """Beyond the text: the port's whole resident carry equals the JAX
    session's after a build and a run of incremental syncs."""
    tw = TwinSessions(4242, max_chars=16, max_blocks=2, max_dels=2)
    for step in range(12):
        tw.step(merge_share=0.3)
        tw.sync_and_check(step)
    js, ts = tw.sessions
    for name, t, j in zip(ts.carry._fields, ts.carry, js.carry):
        assert np.array_equal(t.numpy()[0], np.asarray(j)), name


def test_session_incremental_not_resyncing():
    """Sequential same-agent edits stay on the incremental path."""
    jol, tol = JaxOpLog(), OpLog()
    for ol in (jol, tol):
        a = ol.get_or_create_agent_id("solo")
        ol.add_insert_at(a, [], 0, "hello world, this is a doc. ")
    sess = [JaxSession(jol), DeviceZoneSession(tol, device="cpu")]
    for i in range(10):
        for ol in (jol, tol):
            a = ol.get_or_create_agent_id("solo")
            ol.add_insert_at(a, [len(ol) - 1], 5 + i, f"x{i}")
        assert [s.sync() for s in sess][0] > 0
    assert sess[1].resyncs == sess[0].resyncs == 0
    assert sess[1].merges == sess[0].merges == 10
    assert sess[1].text() == sess[0].text() == tol.checkout_tip().snapshot()


def test_session_two_agent_no_resync_after_warmup():
    """Two agents interleaving from their own heads with periodic merges
    stay incremental after the first build, in both packages."""
    tw = TwinSessions(4243, agents=("p1", "p2"), warm=6, max_chars=64)
    base = [s.resyncs for s in tw.sessions]
    for step in range(20):
        tw.step(merge_share=0.25)
        tw.sync_and_check(step)
    assert [s.resyncs for s in tw.sessions] == base


def test_session_capacity_growth_resyncs_as_jax():
    jol, tol = JaxOpLog(), OpLog()
    for ol in (jol, tol):
        a = ol.get_or_create_agent_id("big")
        ol.add_insert_at(a, [], 0, "tiny")
    sess = [JaxSession(jol), DeviceZoneSession(tol, device="cpu")]
    big = "y" * (sess[1].W_cap + 10)
    for ol in (jol, tol):
        ol.add_insert_at(ol.get_or_create_agent_id("big"), [len(ol) - 1], 2,
                         big)
    for s in sess:
        s.sync()
    assert sess[1].resyncs == sess[0].resyncs == 1
    assert sess[1].W_cap == sess[0].W_cap > 1024
    assert sess[1].text() == sess[0].text() == tol.checkout_tip().snapshot()


def test_session_root_anchored_op_resyncs_as_jax():
    jol, tol = JaxOpLog(), OpLog()
    for ol in (jol, tol):
        ol.add_insert_at(ol.get_or_create_agent_id("a"), [], 0, "first doc")
    sess = [JaxSession(jol), DeviceZoneSession(tol, device="cpu")]
    for ol in (jol, tol):
        ol.add_insert_at(ol.get_or_create_agent_id("b"), [], 0,
                         "root-concurrent")
    for s in sess:
        s.sync()
    assert sess[1].resyncs == sess[0].resyncs == 1
    assert sess[1].text() == sess[0].text() == tol.checkout_tip().snapshot()


def test_session_late_agent_resyncs_as_jax():
    """A new agent whose name sorts first shifts every name rank: both
    sessions rebuild instead of mixing key epochs."""
    jol, tol = JaxOpLog(), OpLog()
    for ol in (jol, tol):
        ol.add_insert_at(ol.get_or_create_agent_id("mm"), [], 0, "base ")
    sess = [JaxSession(jol), DeviceZoneSession(tol, device="cpu")]
    for ol in (jol, tol):
        v = [len(ol) - 1]          # the tip of "base "
        ol.add_insert_at(ol.get_or_create_agent_id("aa"), v, 2, "B")
        ol.add_insert_at(ol.get_or_create_agent_id("zz"), v, 2, "Z")
        ol.add_insert_at(ol.get_or_create_agent_id("mm"), v, 2, "M")
    for s in sess:
        s.sync()
    assert sess[1].resyncs == sess[0].resyncs == 1
    assert sess[1].text() == sess[0].text() == tol.checkout_tip().snapshot()


@pytest.mark.parametrize("budgets", [(4, 256, 8), (2, 16, 2)])
@pytest.mark.parametrize("seed", range(4))
def test_session_continues_its_carry_in_place_as_jax(seed, budgets):
    """With the agents fixed after the build, a sync that does not resync
    continues the resident carry: the same tensors, updated in place (the
    JAX session donates its buffers instead). After every sync the whole
    carry equals the JAX session's, and most syncs continue."""
    MB, MC, MD = budgets
    tw = TwinSessions(5100 + seed, agents=("p1", "p2"), warm=6,
                      max_blocks=MB, max_chars=MC, max_dels=MD)
    js, ts = tw.sessions
    continued = 0
    for step in range(12):
        resyncs, ptrs = ts.resyncs, [t.data_ptr() for t in ts.carry]
        tw.step(merge_share=0.25)
        tw.sync_and_check(step)
        if ts.resyncs == resyncs:
            continued += 1
            assert [t.data_ptr() for t in ts.carry] == ptrs, step
        for name, t, j in zip(ts.carry._fields, ts.carry, js.carry):
            assert np.array_equal(t.numpy()[0], np.asarray(j)), (step, name)
    assert continued > 6


def test_session_runs_each_tape_in_one_launch(monkeypatch):
    """The port has no slice budget (the JAX package slices for its TPU
    runtime's per-program time limit): even with DT_SESSION_SLICE set, a
    build and every sync run their whole tape in one wrapper call."""
    monkeypatch.setenv("DT_SESSION_SLICE", "1")
    real, steps = kernels.zone_tape_run, []

    def spy(carry, xs, plen):
        steps.append(int(xs["op"].shape[0]))
        return real(carry, xs, plen)

    monkeypatch.setattr(kernels, "zone_tape_run", spy)
    tw = TwinSessions(9100, agents=("ann", "bo"), warm=12)
    assert len(steps) == 1
    for step in range(8):
        n = len(steps)
        tw.step(merge_share=0.2)
        tw.sync_and_check(step)
        assert len(steps) == n + 1, step
    assert max(steps) > 1


def test_session_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    ol = OpLog()
    ol.add_insert_at(ol.get_or_create_agent_id("a"), [], 0, "x")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceZoneSession(ol)
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionBank(0, fused=False)


# ---- the zone-session bank and the scheduler --------------------------------

def test_bank_zone_sessions_match_jax():
    """SessionBank(engine="device", fused=False): per-doc syncs over zone
    sessions, LRU eviction by count and slots, texts and counters equal
    to the JAX package's bank."""
    from diamond_types_tpu.serve.metrics import ServeMetrics as JaxMetrics
    from diamond_types_tpu_torch.serve.metrics import ServeMetrics
    docs = serve_docs([JaxOpLog, OpLog], 5, seed=31, base_max=120)
    jm, tm = JaxMetrics(1, 4, 64), ServeMetrics(1, 4, 64)
    jb = JaxBank(0, max_sessions=3, engine="device", fused=False,
                 metrics=jm)
    tb = SessionBank(0, max_sessions=3, engine="device", fused=False,
                     metrics=tm, session_opts=CPU)
    assert not tb.fused and tb.device == torch.device("cpu")
    for rnd in range(3):
        subs = serve_round(docs, 31, rnd, share=0.8)
        for d, _n in subs:
            jr = jb.sync_doc(d, docs[d].oplogs[0])
            tr = tb.sync_doc(d, docs[d].oplogs[1])
            assert jr == tr, (rnd, d)
        for d, tw in docs.items():
            want = tw.oplogs[1].checkout_tip().snapshot()
            assert tb.text(d, tw.oplogs[1]) == jb.text(d, tw.oplogs[0]) \
                == want, (rnd, d)
        jt, tt = jm.snapshot()["totals"], tm.snapshot()["totals"]
        for k in ("builds", "syncs", "resyncs", "evictions",
                  "host_fallbacks"):
            assert tt[k] == jt[k], (rnd, k)
        assert list(tb.sessions) == list(jb.sessions)
        assert tb.footprint_slots() == jb.footprint_slots()
    assert tt["evictions"] > 0 and tt["host_fallbacks"] == 0


def _twin_zone_schedulers(n_docs, seed, n_shards=2, **kw):
    docs = serve_docs([JaxOpLog, OpLog], n_docs, seed, base_max=150)
    jols = {d: tw.oplogs[0] for d, tw in docs.items()}
    tols = {d: tw.oplogs[1] for d, tw in docs.items()}
    common = dict(engine="device", fused=False, flush_docs=4,
                  flush_deadline_s=10.0, flush_workers=False)
    common.update(kw)
    js = JaxScheduler(n_shards, resolve=jols.__getitem__, **common)
    ts = MergeScheduler(n_shards, resolve=tols.__getitem__,
                        session_opts=CPU, **common)
    return docs, tols, js, ts


@pytest.mark.parametrize("max_sessions", [8, 2])
def test_scheduler_zone_sessions_match_jax_per_round(max_sessions):
    seed = 41
    docs, tols, js, ts = _twin_zone_schedulers(
        8, seed, max_sessions_per_shard=max_sessions)
    assert not ts.fused and not js.fused
    launches = kernels.zone_tape_run.launches
    for rnd in range(3):
        subs = serve_round(docs, seed, rnd)
        for d, n in subs:
            for s in (js, ts):
                assert s.submit(d, n_ops=n)["accepted"]
        for s in (js, ts):
            s.pump()
            s.drain()
        for d in docs:
            want = tols[d].checkout_tip().snapshot()
            assert ts.text(d) == js.text(d) == want, (rnd, d)
        jm, tm = js.metrics_json(), ts.metrics_json()
        assert {k: tm["totals"][k] for k in COUNTERS} == \
            {k: jm["totals"][k] for k in COUNTERS}, rnd
        assert tm["router_counts"] == jm["router_counts"]
    assert tm["totals"]["host_fallbacks"] == 0
    assert tm["totals"]["syncs"] > 0 and tm["totals"]["fused_calls"] == 0
    if max_sessions == 2:
        assert tm["totals"]["evictions"] > 0
    # CPU sessions: the plain version ran, no kernel was launched
    assert kernels.zone_tape_run.launches == launches


def test_scheduler_zone_sessions_with_flush_workers():
    seed = 42
    docs, tols, js, ts = _twin_zone_schedulers(6, seed, n_shards=3,
                                               flush_workers=True)
    for rnd in range(2):
        subs = serve_round(docs, seed, rnd)
        for d, n in subs:
            for s in (js, ts):
                assert s.submit(d, n_ops=n)["accepted"]
        for s in (js, ts):
            s.pump()
            s.drain()
        for d in docs:
            assert ts.text(d) == js.text(d) == \
                tols[d].checkout_tip().snapshot()
    for s in (js, ts):
        s.stop_workers()
    assert ts.metrics_json()["totals"]["host_fallbacks"] == 0


def test_zone_session_fault_propagates(monkeypatch):
    """The deliberate divergence: a zone session's fault is not served from
    the host. The JAX bank catches it (host fallback); the port's bank
    raises it, and the scheduler raises it out of drain()."""
    docs = serve_docs([JaxOpLog, OpLog], 2, seed=51, base_max=60)
    d0 = next(iter(docs))
    tb = SessionBank(0, engine="device", fused=False, session_opts=CPU)
    jb = JaxBank(0, engine="device", fused=False)
    for b, k in ((tb, 1), (jb, 0)):
        b.sync_doc(d0, docs[d0].oplogs[k])
    serve_round(docs, 51, 0, share=1.0)

    def boom(*a, **k):
        raise RuntimeError("injected zone kernel fault")

    import diamond_types_tpu.tpu.zone_session as jzs
    monkeypatch.setattr(kernels, "zone_tape_run", boom)
    monkeypatch.setattr(jzs, "_micro_fn", boom)
    with pytest.raises(RuntimeError, match="injected"):
        tb.sync_doc(d0, docs[d0].oplogs[1])
    assert jb.sync_doc(d0, docs[d0].oplogs[0])["engine"] == "host"
    # the scheduler: the fault comes out of drain()
    tols = {d: tw.oplogs[1] for d, tw in docs.items()}
    sched = MergeScheduler(1, resolve=tols.__getitem__, fused=False,
                           session_opts=CPU, flush_workers=True,
                           flush_docs=4, flush_deadline_s=10.0)
    for d in docs:
        sched.submit(d, n_ops=1)
    sched.pump(force=True)
    with pytest.raises(RuntimeError, match="injected"):
        sched.drain()
    sched.stop_workers()


def test_serve_bench_zone_sessions_match_jax():
    # no workers and a far deadline: every flush is size-triggered, so
    # both packages flush the same buckets
    kw = dict(shards=2, docs=4, txns=6, mode="concurrent", flush_docs=2,
              max_sessions=4, fused=False, flush_workers=False,
              flush_deadline_s=10.0)
    t = run_serve_bench(device="cpu", **kw)
    j = jax_bench(place_on_devices=False, **kw)
    assert t["parity_ok"] and j["parity_ok"]
    assert t["config"]["fused"] is False
    for k in ("builds", "syncs", "resyncs", "host_fallbacks", "flushes"):
        assert t["metrics"]["totals"][k] == j["metrics"]["totals"][k], k
    assert t["total_ops"] == j["total_ops"]


def test_serve_module_no_fused_flag(capsys):
    import json
    rc = serve_main(["--no-fused", "--device", "cpu", "--docs", "3",
                     "--txns", "4", "--shards", "2", "--mode", "concurrent"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["parity_ok"]
    assert report["config"]["fused"] is False
    assert report["metrics"]["totals"]["fused_calls"] == 0
