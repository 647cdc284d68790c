"""The observability hooks of the port's serve path against the JAX
package's: `MergeScheduler.attach_obs`, the bank's recorder, journey and
device-profiler calls, the metrics' time-series double writes, the
`note_transfer` call sites, and the serve driver's report.

Both packages' device schedulers (`engine="device"`, `fused=True`,
`device_plan=True`; the port's sessions on the CPU, where K1, K2 and X8
run their plain versions) take one concurrent tape with a QoS controller
(`attach_qos`) and an `Observability(sample_rate=1.0)` attached. Each
package runs on its own `FakeClock`; the script advances both alike, and
the obs modules and the scheduler read their package's clock (so a flush
lasts what the test says it lasts: each bank's adoption advances its
clock by a fixed cost a document). Per round the texts, the spans (names,
parents, attributes and times; ids by order), the flight recorder's
events, each sampled trace's journey stamps, the time-series families and
their event counts, the device profiler's fused counts and transfer keys
and counts, and the controller's published table (now with `serve.flush`
live) must be equal.

The per-shard path runs the JAX scheduler with `pallas=True` (the Pallas
kernel interpreted), because the port's group rung is the counterpart of
`pallas_fused_replay` and tags its transfers `pallas.plan`, as
`test_torch_serve.py` pairs them; the flush window runs JAX's mesh rung
(`pallas=False`, the mesh on one device, as `test_torch_mesh_window.py`
runs it); the zone-session path runs `fused=False`. Transfer BYTES differ
where the port launches a smaller shape than JAX: K1 at the pow2 floor
where JAX pads to the steered class (ROADMAP §3, "K1 and the window"), and
X8's tape unpadded where JAX pads it to a power of two. There the test
states the port's bytes from the tensors it really moved. A session's
upload also moves its 4-byte length tensor, which JAX leaves uncounted.

A host-engine scheduler behind a residency tier takes the bundle and the
hydrator in either attach order: the hydrator's recorder events (among
them the gate's `flush_gate_dropped`) and its cache-miss attribution must
be JAX's.
"""

import os
import time

import numpy as np
import pytest

from diamond_types_tpu import obs as jobs
from diamond_types_tpu import qos as jqos
from diamond_types_tpu.obs.devprof import PROFILER as JAX_PROFILER
from diamond_types_tpu.parallel import arena as jarena
from diamond_types_tpu.parallel import mesh as jmesh
from diamond_types_tpu.serve import hydrate as jhydrate
from diamond_types_tpu.serve.driver import run_serve_bench as jax_bench
from diamond_types_tpu.serve.scheduler import MergeScheduler as JaxScheduler
from diamond_types_tpu.storage import tier as jtier
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu.steer import STEER as JAX_STEER
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch import obs as tobs
from diamond_types_tpu_torch import qos as tqos
from diamond_types_tpu_torch.gpu import flush_fuse as tff
from diamond_types_tpu_torch.gpu import zone_session as tzs
from diamond_types_tpu_torch.gpu.steer import STEER
from diamond_types_tpu_torch.obs.devprof import PROFILER
from diamond_types_tpu_torch.parallel import arena as tarena
from diamond_types_tpu_torch.serve import MergeScheduler
from diamond_types_tpu_torch.serve.__main__ import main as serve_main
from diamond_types_tpu_torch.serve.driver import run_serve_bench
from diamond_types_tpu_torch.serve.hydrate import Hydrator
from diamond_types_tpu_torch.storage import tier as ttier

from torch_parity import (OBS_CLOCKED, FakeClock, clock_modules, serve_docs,
                          serve_round, span_forest)

pytestmark = [pytest.mark.obs, pytest.mark.serve]

FUSED = {"cap": 256, "max_ins": 4}
REL = 1e-12                  # the float deadline tables (test_torch_qos.py)
FLUSH_COST_S = 0.004         # a flush's cost per document on the fake clock
SESSION_LEN_BYTES = 4        # the length tensor each session upload moves
CLOCKED = OBS_CLOCKED + ("serve.scheduler",)


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh steer tables, arenas and device profilers in both packages,
    the profilers enabled; restored (disabled) after the test."""
    for st in (STEER, JAX_STEER):
        st.reset(table=True)
        st.enabled = True
    tarena.reset_arenas()
    jarena.reset_arenas()
    tarena.DEVICE_STAGE.enabled = jarena.DEVICE_STAGE.enabled = True
    for p in (PROFILER, JAX_PROFILER):
        p.reset()
        p.enabled = True
    yield
    for p in (PROFILER, JAX_PROFILER):
        p.enabled = False
        p.reset()


class Spy:
    """Stands in for `owner.<name>` and records each call's arguments."""

    def __init__(self, monkeypatch, owner, name):
        self.real = getattr(owner, name)
        self.calls = []
        monkeypatch.setattr(owner, name, self)

    def __call__(self, *args, **kwargs):
        self.calls.append(args)
        return self.real(*args, **kwargs)


def _costed(monkeypatch, sched, clock):
    """Each bank's adoption advances its package's clock by a fixed cost
    a document, so a flush's measured duration is the same in both."""
    for bank in sched.banks:
        real = bank.adopt_window

        def adopt(win, *a, _real=real, **kw):
            clock.advance(FLUSH_COST_S * len(win["items"]))
            return _real(win, *a, **kw)
        monkeypatch.setattr(bank, "adopt_window", adopt)


def _twin(monkeypatch, mode, n_docs, seed, obs_first, max_sessions):
    docs = serve_docs([JaxOpLog, OpLog], n_docs, seed, base_max=150)
    common = dict(engine="device", fused=mode != "zone", flush_docs=4,
                  flush_deadline_s=0.05, flush_workers=False,
                  device_plan=True, max_sessions_per_shard=max_sessions,
                  mesh_window=mode == "window")
    out = []
    for pkg, cls, qos, obs in ((0, JaxScheduler, jqos, jobs),
                               (1, MergeScheduler, tqos, tobs)):
        clock = FakeClock()
        root = ("diamond_types_tpu", "diamond_types_tpu_torch")[pkg]
        clock_modules(monkeypatch, root, clock, CLOCKED)
        ols = {d: tw.oplogs[pkg] for d, tw in docs.items()}
        if pkg == 0:
            s = cls(4, resolve=ols.__getitem__, fused_opts=FUSED,
                    session_opts={}, pallas=mode == "shard", **common)
            if mode == "window":
                s._mesh = jmesh.serve_mesh(1)
        else:
            s = cls(4, resolve=ols.__getitem__,
                    fused_opts=dict(FUSED, device="cpu"),
                    session_opts={"device": "cpu"}, **common)
        ctl = qos.QosController(clock=clock)
        bundle = obs.Observability(sample_rate=1.0, seed=seed,
                                   ts_window_s=1.0, ts_windows=600)
        if obs_first:
            s.attach_obs(bundle)
            s.attach_qos(ctl)
        else:
            s.attach_qos(ctl)
            s.attach_obs(bundle)
        assert ctl.obs is bundle and s.metrics.ts is bundle.ts
        _costed(monkeypatch, s, clock)
        out.append((s, ctl, bundle, clock))
    return docs, out


def _ts_counts(ts) -> dict:
    """Every family the time series holds, with its event count (counter
    deltas summed, latency observations counted) over the whole ring."""
    horizon = ts.window_s * ts.n_windows
    return {n: round(ts.rate(n, horizon) * horizon, 6) for n in ts.names()}


def _journeys(bundle) -> list:
    """Each sampled admit's journey stages, in admit order."""
    return [bundle.journey.journey(s["trace"])["stages"]
            for s in bundle.tracer.spans() if s["name"] == "serve.admit"]


def _run(monkeypatch, mode, n_docs=12, seed=5, rounds=4, obs_first=False,
         max_sessions=3, compare=True):
    """The tape through both schedulers; `max_sessions` 3 a shard keeps
    the banks evicting (the recorder's `session_evicted` events)."""
    docs, twins = _twin(monkeypatch, mode, n_docs, seed, obs_first,
                        max_sessions)
    scheds = [t[0] for t in twins]
    ctls = [t[1] for t in twins]
    bundles = [t[2] for t in twins]
    clocks = [t[3] for t in twins]
    rng = np.random.default_rng(seed)
    classes = {d: tqos.QOS_CLASSES[int(rng.integers(3))] for d in docs}

    def now():
        assert clocks[0]() == clocks[1](), "the clocks drifted apart"
        return clocks[1]()

    for d in docs:                  # open every document
        t = now()
        for s in scheds:
            assert s.submit(d, 1, now=t, qos=classes[d])["accepted"]
    for s in scheds:
        s.drain()
    for rnd in range(rounds):
        for d, n in serve_round(docs, seed, rnd):
            t = now()
            subs = [s.submit(d, n_ops=n, now=t, qos=classes[d])
                    for s in scheds]
            assert subs[0] == subs[1] and subs[1]["accepted"]
            dt = float(rng.random()) * 0.02
            for c in clocks:
                c.advance(dt)
            if rng.random() < 0.4:
                dec = [c.step() for c in ctls]
                assert dec[0] == dec[1]
                tabs = [c._table for c in ctls]
                assert tabs[0].keys() == tabs[1].keys()
                assert all(tabs[1][k] == pytest.approx(v, rel=REL, abs=0.0)
                           for k, v in tabs[0].items()), rnd
            if rng.random() < 0.5:
                t = now()
                pumped = [s.pump(now=t) for s in scheds]
                assert pumped[0] == pumped[1]
        for s in scheds:
            s.drain()
        for d, tw in docs.items():
            want = tw.oplogs[1].checkout_tip().snapshot()
            assert [s.text(d) for s in scheds] == [want, want], (rnd, d)
        if compare:
            _compare(mode, scheds, ctls, bundles, rnd)
    return scheds, ctls, bundles


def _compare(mode, scheds, ctls, bundles, rnd):
    jb, tb = bundles
    drop = ("padded_b", "staged_bytes") if mode == "window" else ()
    assert span_forest(tb.tracer.spans(), drop) \
        == span_forest(jb.tracer.spans(), drop), rnd
    assert tb.recorder.dump() == jb.recorder.dump(), rnd
    assert _journeys(tb) == _journeys(jb), rnd
    assert all("adopted" in j for j in _journeys(tb)), rnd
    assert _ts_counts(tb.ts) == _ts_counts(jb.ts), rnd
    assert ctls[1].metrics.snapshot() == ctls[0].metrics.snapshot(), rnd
    jd, td = JAX_PROFILER.snapshot(), PROFILER.snapshot()
    for k in ("device_calls", "docs", "occupancy"):
        assert td["fused"][k] == jd["fused"][k], (rnd, k)
    for k in ("dispatches", "docs", "docs_per_dispatch", "mean_shards"):
        assert td["mesh_window"][k] == jd["mesh_window"][k], (rnd, k)
    assert {s: r["flushes"] for s, r in td["per_shard"].items()} \
        == {s: r["flushes"] for s, r in jd["per_shard"].items()}, rnd
    assert {k: v["transfers"] for k, v in td["transfer_detail"].items()} \
        == {k: v["transfers"] for k, v in jd["transfer_detail"].items()}
    # the untagged transfers are the K2 resolves' (and X8's tapes): one
    # per resolve call, and the window resolves once per device where the
    # JAX window resolves once per shard (ROADMAP §3)
    for snap, s in ((td, scheds[1]), (jd, scheds[0])):
        untagged = snap["transfers"] - sum(
            v["transfers"] for v in snap["transfer_detail"].values())
        if mode != "zone":
            assert untagged == s.metrics_json()["transform"]["batches"]
    if mode != "window":
        assert td["transfers"] == jd["transfers"], rnd
    assert td["jit_cache"] == {} and jd["jit_cache"]


def _untagged(snap) -> int:
    return snap["transfer_bytes"] - sum(
        v["bytes"] for v in snap["transfer_detail"].values())


def test_device_scheduler_with_obs_matches_jax(monkeypatch):
    """The per-shard path: spans, recorder, journey, time series, devprof
    and the controller's table per round; transfer bytes as stated in the
    module docstring."""
    k1 = Spy(monkeypatch, tff, "apply_ops_window")
    scheds, ctls, bundles = _run(monkeypatch, "shard")
    jd, td = JAX_PROFILER.snapshot(), PROFILER.snapshot()
    names = {s["name"] for s in bundles[1].tracer.spans()}
    assert names == {"serve.admit", "serve.flush", "serve.device_sync"}
    kinds = {e["kind"] for e in bundles[1].recorder.dump()}
    assert "session_evicted" in kinds
    assert set(td["transfer_detail"]) == {"session.stage", "fused.plan",
                                          "pallas.plan"}
    assert td["fused"]["device_calls"] \
        == scheds[1].metrics_json()["fused"]["device_calls"] > 0
    # the bytes the port moved, from its own launches' op tensors: a
    # group (b >= 2) on the kernel rung, a lone document on the per-doc
    plan = {"pallas.plan": 0, "fused.plan": 0}
    for args in k1.calls:
        rung = "pallas.plan" if args[0].shape[0] > 1 else "fused.plan"
        plan[rung] += sum(a.nbytes for a in args[2:6])
    for rung, nbytes in plan.items():
        assert td["transfer_detail"][rung]["bytes"] == nbytes
        assert nbytes <= jd["transfer_detail"][rung]["bytes"]
    st, jst = td["transfer_detail"]["session.stage"], \
        jd["transfer_detail"]["session.stage"]
    assert st["bytes"] == jst["bytes"] + SESSION_LEN_BYTES * st["transfers"]
    assert _untagged(td) == _untagged(jd) > 0      # the K2 resolves
    # the controller reads a live serve.flush series
    p99 = [b.ts.quantile("serve.flush", 0.99, window_s=30.0)
           for b in bundles]
    assert p99[0] == p99[1] > 0
    assert bundles[1].exemplars.snapshot()["families"]["serve.flush"]
    assert bundles[1].slo.verdict()["slo_ok"]


def test_window_scheduler_with_obs_matches_jax(monkeypatch):
    """The flush window: `serve.mesh_window` / `serve.mesh_dispatch` spans,
    `observe_window` and the mesh rung's transfers; the bundle attached
    before the controller this time. Every session stays resident (see
    the next test for the window under capacity pressure)."""
    scheds, _ctls, bundles = _run(monkeypatch, "window", obs_first=True,
                                  max_sessions=8)
    jd, td = JAX_PROFILER.snapshot(), PROFILER.snapshot()
    names = {s["name"] for s in bundles[1].tracer.spans()}
    assert {"serve.admit", "serve.mesh_window",
            "serve.mesh_dispatch"} <= names
    assert td["mesh_window"]["dispatches"] > 0
    assert {"session.stage", "mesh.plan"} <= set(td["transfer_detail"])
    # the window's plan bytes are the staged bytes its metrics count (the
    # pow2 floor the port launches); JAX's count its steered class
    for snap, m in ((td, scheds[1].metrics_json()),
                    (jd, scheds[0].metrics_json())):
        assert snap["transfer_detail"]["mesh.plan"]["bytes"] \
            == m["window"]["staged_bytes"]
    assert td["transfer_detail"]["mesh.plan"]["bytes"] \
        <= jd["transfer_detail"]["mesh.plan"]["bytes"]


def test_window_under_capacity_pressure_rebuilds_more(monkeypatch):
    """A recorded divergence of the window (ROADMAP §3): the port extracts
    every bucket of the window before it groups any, so a later bucket's
    session build can evict a document an earlier bucket planned; the port
    then syncs it on the per-doc rung (one more build and eviction),
    where the JAX window, planning bucket by bucket, had already committed
    it. The texts stay equal every round (`_run` checks them)."""
    scheds, _ctls, _b = _run(monkeypatch, "window", rounds=3,
                             compare=False)
    jt, tt = (s.metrics_json()["totals"] for s in scheds)
    extra = tt["builds"] - jt["builds"]
    assert extra > 0 and tt["evictions"] - jt["evictions"] == extra
    assert tt["host_fallbacks"] == jt["host_fallbacks"] == 0


def test_window_host_staging_counts_mesh_stage(monkeypatch):
    """With device staging off every resident row round-trips through host
    numpy, counted as `mesh.stage` in both packages."""
    tarena.DEVICE_STAGE.enabled = jarena.DEVICE_STAGE.enabled = False
    scheds, _ctls, _bundles = _run(monkeypatch, "window", rounds=2,
                                   max_sessions=8)
    jd, td = JAX_PROFILER.snapshot(), PROFILER.snapshot()
    assert td["transfer_detail"]["mesh.stage"]["transfers"] \
        == jd["transfer_detail"]["mesh.stage"]["transfers"] > 0
    assert td["transfer_detail"]["mesh.stage"]["bytes"] \
        + td["transfer_detail"]["mesh.plan"]["bytes"] \
        == scheds[1].metrics_json()["window"]["staged_bytes"]


def test_zone_scheduler_with_obs_matches_jax(monkeypatch):
    """`fused=False`: per-doc zone-session syncs, `observe_flush` per sync
    and the tape upload, untagged as in JAX; the port's tape is unpadded,
    so its bytes are the tensors `tape_xs` built."""
    tapes = []                      # the bytes of each tape moved
    real = tzs.tape_xs

    def tape_xs(*args, **kw):
        out = real(*args, **kw)
        tapes.append(sum(v.nbytes for v in out.values()))
        return out
    monkeypatch.setattr(tzs, "tape_xs", tape_xs)
    _scheds, _ctls, bundles = _run(monkeypatch, "zone", n_docs=8, rounds=3)
    jd, td = JAX_PROFILER.snapshot(), PROFILER.snapshot()
    assert td["transfer_detail"] == jd["transfer_detail"] == {}
    assert td["transfers"] == len(tapes) > 0
    assert td["transfer_bytes"] == sum(tapes)
    assert 0 < td["transfer_bytes"] <= jd["transfer_bytes"]
    assert td["fused"]["device_calls"] == 0
    assert sum(r["flushes"] for r in td["per_shard"].values()) > 0
    assert "device_replayed" not in _journeys(bundles[1])[0]


def test_profiler_off_counts_nothing():
    """With the profiler disabled and no bundle attached the hooks are
    no-ops: nothing is counted."""
    PROFILER.enabled = False
    docs = serve_docs([OpLog], 6, 9, base_max=100)
    s = MergeScheduler(2, resolve=lambda d: docs[d].oplogs[0],
                       fused_opts=dict(FUSED, device="cpu"),
                       flush_workers=False, device_plan=True, flush_docs=4)
    for rnd in range(2):
        for d, n in serve_round(docs, 9, rnd):
            s.submit(d, n)
        s.drain()
    snap = PROFILER.snapshot()
    assert snap["transfers"] == 0 and snap["fused"]["device_calls"] == 0
    assert snap["per_shard"] == {}
    assert s.obs is None and s.metrics.ts is None


# ---- the residency tier ---------------------------------------------------------

def _hydrated_events(OpLogCls, tier, hydrator_cls, sched_cls, obs, root,
                     obs_first):
    """`tests/test_torch_hydrate.py`'s quarantine script (a corrupt home
    dropped at the flush gate, two warm documents edited) behind a warm
    tier of one slot, so the second sync hydration evicts the first, with
    the bundle and the hydrator attached in the given order. Returns the
    recorder's events without their sequence numbers and times, and the
    per-document cache-miss counts."""
    store = tier.TieredStore(root)
    for d in ("a", "b", "bad"):
        ol = OpLogCls()
        ol.add_insert(ol.get_or_create_agent_id("w"), 0, f"[{d}] ")
        store.save(d, ol)
    with open(store.path("bad"), "r+b") as f:
        f.write(b"\xff" * os.path.getsize(store.path("bad")))
    hyd = hydrator_cls(store, workers=1, sync_wait_s=5.0, warm_max=1,
                       evict_grace_s=0.0)
    sched = sched_cls(2, hyd.resolve, engine="host", flush_deadline_s=0.01)
    bundle = obs.Observability(sample_rate=1.0, seed=3)
    if obs_first:
        sched.attach_obs(bundle)
        sched.attach_hydrator(hyd)
    else:
        sched.attach_hydrator(hyd)
        sched.attach_obs(bundle)
    assert hyd.recorder is bundle.recorder and hyd.attrib is bundle.attrib
    try:
        assert sched.submit("bad")["accepted"]
        sched.drain()
        assert sched.submit("bad")["reason"] == "quarantined"
        for d in ("a", "b"):
            ol = hyd.resolve(d)
            ol.add_insert(ol.get_or_create_agent_id("ed"),
                          len(ol.checkout_tip().snapshot()), "edited")
            assert sched.submit(d)["accepted"]
        sched.drain()
        # the eviction's snapshot is saved on the hydrator's worker
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not any(
                e["kind"] == "evicted_to_snapshot"
                for e in bundle.recorder.dump()):
            time.sleep(0.01)
        events = [{k: v for k, v in e.items() if k not in ("seq", "t")}
                  for e in bundle.recorder.dump()]
        return events, bundle.attrib.top("doc", "cache_misses")
    finally:
        sched.stop_pump(drain=False)
        hyd.stop(checkpoint=False)


@pytest.mark.parametrize("obs_first", [False, True])
def test_hydrator_with_obs_matches_jax(tmp_path, obs_first):
    """`attach_obs` and `attach_hydrator` in either order hand the
    hydrator the bundle's recorder and attribution: the quarantine, the
    gate's drop (`flush_gate_dropped`), the eviction and the sync
    hydrations' cache misses are JAX's."""
    out = {}
    for name, args in (
            ("jax", (JaxOpLog, jtier, jhydrate.Hydrator, JaxScheduler, jobs)),
            ("port", (OpLog, ttier, Hydrator, MergeScheduler, tobs))):
        root = tmp_path / name
        root.mkdir()
        out[name] = _hydrated_events(*args, str(root), obs_first)
    assert out["port"] == out["jax"]
    events, misses = out["port"]
    assert [e["kind"] for e in events] == [
        "doc_quarantined", "quarantined_drop", "flush_gate_dropped",
        "evicted_to_snapshot"]
    assert events[2] == {"kind": "flush_gate_dropped", "shard": events[1][
        "shard"], "docs": 1}
    assert misses == [("a", 1.0, 0.0), ("b", 1.0, 0.0)]


# ---- the serve driver ----------------------------------------------------------

BENCH = dict(shards=2, docs=4, txns=6, engine="device", mode="concurrent",
             flush_docs=2, max_sessions=8, steady_rounds=2,
             flush_workers=False, flush_deadline_s=10.0)


def test_driver_report_has_the_jax_keys():
    jr = jax_bench(**BENCH)
    tr = run_serve_bench(device="cpu", **BENCH)
    assert tr["parity_ok"] and jr["parity_ok"]
    assert set(tr) == set(jr) - {"events_tail"}
    assert set(tr["obs"]) == set(jr["obs"])
    assert set(tr["devprof"]) == set(jr["devprof"])
    assert set(tr["scorecard"]) == set(jr["scorecard"])
    assert set(tr["scorecard"]["serve"]) == set(jr["scorecard"]["serve"])
    assert tr["slo"] == jr["slo"] and tr["slo_ok"] is True
    assert tr["config"]["telemetry"] and tr["config"]["journey"]
    assert tr["obs"]["trace"]["sample_rate"] == 0.01
    assert tr["devprof"]["enabled"] and not PROFILER.enabled
    assert tr["devprof"]["fused"]["device_calls"] \
        == tr["fused_device_calls"] == jr["fused_device_calls"]
    assert tr["obs"]["ts_recorded"] > 0


def test_driver_jit_hit_rate_is_none_in_the_port():
    """The deliberate divergence: the port has no jit cache, so nothing
    notes a lookup; JAX's rate is a number beside it."""
    jr = jax_bench(**BENCH)
    tr = run_serve_bench(device="cpu", **BENCH)
    assert isinstance(jr["jit_hit_rate"], float) and jr["devprof"]["jit_cache"]
    assert tr["jit_hit_rate"] is None and tr["steady_jit_hit_rate"] is None
    assert tr["steady_jit_lookups"] == 0 and tr["devprof"]["jit_cache"] == {}
    assert tr["scorecard"]["serve"]["jit_cache_hit_rate"] is None


def test_driver_control_arm_turns_telemetry_and_journey_off(capsys):
    """`--no-telemetry --no-journey`: the live series and the journey
    record nothing, the SLO verdict trivially passes, parity still holds."""
    rc = serve_main(["--device", "cpu", "--shards", "2", "--docs", "4",
                     "--txns", "4", "--mode", "concurrent", "--no-workers",
                     "--no-telemetry", "--no-journey"])
    import json
    r = json.loads(capsys.readouterr().out)
    assert rc == 0 and r["parity_ok"] and r["slo_ok"]
    assert r["config"]["telemetry"] is False
    assert r["config"]["journey"] is False
    assert r["obs"]["ts_recorded"] == 0
    assert r["obs"]["journey"]["enabled"] is False
    assert r["obs"]["journey"]["stamped"] == 0
    on = run_serve_bench(device="cpu", shards=2, docs=4, txns=4,
                         mode="concurrent", flush_workers=False,
                         obs_sample_rate=1.0)
    assert on["obs"]["ts_recorded"] > 0 and on["obs"]["journey"]["stamped"]
