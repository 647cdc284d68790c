"""The port's flush window (`mesh_window=True`) and window arenas against
the JAX package's.

The same seeded documents and edits (`torch_parity.serve_docs` /
`serve_round`, `TwinDocs`) go through the JAX package, as its own tests
run it (the CPU mesh; the mesh program on `make_mesh(1)` /
`serve_mesh(1)`, so a window pads for one device, as on one H100), and
through the port on `device="cpu"`, where K1 and K2 run their plain
versions. Every comparison is exact: texts byte for byte, integer
counters, ok lists, padded rows and staged bytes.

The JAX package's steering is process-global: each test resets its table
first. The JAX window launches the STEERED class and the port the pow2
floor (a listed divergence), so `mesh_padded_rows` and `staged_bytes` count
what each package pads. They are held equal where JAX pads no further than
the floor (its steering off, or its steer snapshot showing no padding);
elsewhere the port's are held to the floor it launches. The transform's
`batches` is the other divergence: one resolve per device per window in
the port, one per shard in the JAX window.
"""

import json

import numpy as np
import pytest
import torch

from diamond_types_tpu.parallel import arena as jarena
from diamond_types_tpu.parallel import mesh as jmesh
from diamond_types_tpu.serve.driver import run_serve_bench as jax_bench
from diamond_types_tpu.serve.scheduler import MergeScheduler as JaxScheduler
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import flush_fuse as jff
from diamond_types_tpu.tpu.steer import STEER as JAX_STEER
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import flush_fuse as tff
from diamond_types_tpu_torch.gpu import kernels, xform
from diamond_types_tpu_torch.parallel import arena as tarena
from diamond_types_tpu_torch.parallel import mesh as tmesh
from diamond_types_tpu_torch.serve import MergeScheduler, ServeMetrics
from diamond_types_tpu_torch.serve import bank as tbank
from diamond_types_tpu_torch.serve.driver import run_serve_bench

from torch_parity import port_warmup_classes, serve_docs, serve_round

pytestmark = [pytest.mark.serve, pytest.mark.mesh]

FUSED = {"cap": 256, "max_ins": 4}
CPU = torch.device("cpu")
COUNTERS = ("submits", "coalesced", "builds", "evictions", "resyncs",
            "syncs", "host_fallbacks", "fused_calls", "fused_docs",
            "flushes", "flushed_docs", "flushed_ops", "fenced")
WINDOW_SAME = ("windows", "device_windows", "dispatches",
               "device_calls_per_window", "docs", "mesh_docs", "shards_hist")


@pytest.fixture(autouse=True)
def _fresh_tables():
    """A fresh JAX steer table and fresh arenas in both packages, JAX's
    steering and device staging on; restored after the test."""
    JAX_STEER.reset(table=True)
    JAX_STEER.enabled = True
    tarena.reset_arenas()
    jarena.reset_arenas()
    jarena.DEVICE_STAGE.enabled = True
    yield
    JAX_STEER.enabled = True
    jarena.DEVICE_STAGE.enabled = True


def _twin(n_docs, seed, n_shards=2, device_plan=True, **kw):
    """The tape's documents and one window scheduler per package over
    them; the JAX one's mesh is one device, as on one H100."""
    docs = serve_docs([JaxOpLog, OpLog], n_docs, seed)
    jols = {d: tw.oplogs[0] for d, tw in docs.items()}
    tols = {d: tw.oplogs[1] for d, tw in docs.items()}
    common = dict(engine="device", fused=True, flush_docs=4,
                  flush_deadline_s=10.0, flush_workers=False,
                  device_plan=device_plan, mesh_window=True)
    common.update(kw)
    js = JaxScheduler(n_shards, resolve=jols.__getitem__, fused_opts=FUSED,
                      **common)
    js._mesh = jmesh.serve_mesh(1)
    ts = MergeScheduler(n_shards, resolve=tols.__getitem__,
                        fused_opts=dict(FUSED, device="cpu"), **common)
    return docs, tols, js, ts


def _round(docs, seed, rnd, scheds, share=0.7):
    for d, n in serve_round(docs, seed, rnd, share=share):
        for s in scheds:
            assert s.submit(d, n_ops=n)["accepted"]
    for s in scheds:
        s.pump()
        s.drain()


def _texts_exact(docs, tols, scheds, rnd):
    for d in docs:
        want = tols[d].checkout_tip().snapshot()
        assert [s.text(d) for s in scheds] == [want] * len(scheds), (rnd, d)


# ---- padding contract -------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_pad_batch_count_classes_match_jax(n_devices):
    for b in range(0, 300):
        assert tmesh.pad_batch_count(b, n_devices) == \
            jmesh.pad_batch_count(b, n_devices), b
    # one device: the pow2 batch class, 1 for 1
    assert [tmesh.pad_batch_count(b, 1) for b in (1, 2, 3, 5, 9)] == \
        [1, 2, 4, 8, 16]


def test_pad_batch_to_mesh_sentinel_rows_survive_k1_plain():
    """Padding rows (zero ops, length -1) come out of K1's plain version
    at -1 with their row untouched, as through the JAX replay body."""
    b, n, mi, cap = 3, 2, 2, 16
    pos = np.zeros((b, n), np.int32)
    dlen = np.zeros((b, n), np.int32)
    ilen = np.zeros((b, n), np.int32)
    ilen[:, 0] = 2
    chars = np.full((b, n, mi), ord("x"), np.int32)
    got = tmesh.pad_batch_to_mesh(pos, dlen, ilen, chars, 4)
    want = jmesh.pad_batch_to_mesh(pos, dlen, ilen, chars, 4)
    assert got[4] == want[4] == 4
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g, w)
    docs = torch.zeros((4, cap), dtype=torch.int32)
    docs[3] = 7
    lens = torch.tensor([0, 0, 0, -1], dtype=torch.int32)
    out_d, out_l = kernels.apply_ops_window_plain(
        docs, lens, *(torch.from_numpy(a) for a in got[:4]), mi)
    assert out_l.tolist() == [2, 2, 2, -1]
    assert torch.equal(out_d[3], docs[3])


# ---- mesh_fused_replay ------------------------------------------------------

def _replay_twins(n_docs, seed):
    docs = serve_docs([JaxOpLog, OpLog], n_docs, seed, base_min=10,
                      base_max=60)
    jss = [jff.FusedDocSession(tw.oplogs[0], **FUSED) for tw in
           docs.values()]
    tss = [tff.FusedDocSession(tw.oplogs[1], device="cpu", **FUSED)
           for tw in docs.values()]
    assert {s.cap for s in jss + tss} == {256}
    return docs, jss, tss


@pytest.mark.parametrize("steer", [False, True])
def test_mesh_fused_replay_matches_jax(monkeypatch, steer):
    """Random windows over one set of sessions, re-windowed across rounds
    (a recurring session list takes the arena path), with one poisoned
    row in round 3, JAX's steering on and off: equal ok lists, texts and
    arena hits, and equal padded rows and staged bytes wherever JAX
    padded no further than the floor."""
    JAX_STEER.enabled = steer
    jax_hits = []
    jax_acquire = jarena.acquire

    def counted_acquire(*args):
        got = jax_acquire(*args)
        jax_hits.append(got is not None)
        return got
    monkeypatch.setattr(jarena, "acquire", counted_acquire)
    docs, jss, tss = _replay_twins(7, 41)
    jm = jmesh.make_mesh(1)
    mesh = tmesh.serve_mesh([CPU])
    rng = np.random.default_rng(41)
    for rnd in range(6):
        pick = sorted(rng.choice(7, size=int(rng.integers(1, 7)),
                                 replace=False)) if rnd == 2 else range(7)
        for i in pick:
            list(docs.values())[i].concurrent_round(
                ("alice", "bob", "carol"), int(rng.integers(1, 4)),
                max_ins=11)
        js = [jss[i] for i in pick]
        ts = [tss[i] for i in pick]
        jp = [s.plan_tail() for s in js]
        tp = [s.plan_tail() for s in ts]
        if rnd == 3:
            for p in (jp[1], tp[1]):
                p.dlen = p.dlen.copy()
                p.dlen[0] = FUSED["max_ins"] + 1
        padded0 = JAX_STEER.snapshot()["padded"]
        jok, _, jbp, jstaged = jmesh.mesh_fused_replay(jm, js, jp)
        tok, _, tbp, tstaged = tmesh.mesh_fused_replay(mesh, ts, tp)
        assert tok == jok, rnd
        assert (rnd == 3) == (not all(tok))
        assert tbp == tmesh.pad_batch_count(len(ts), 1)
        if JAX_STEER.snapshot()["padded"] == padded0:
            assert (tbp, tstaged) == (jbp, jstaged), rnd
        else:
            assert tbp <= jbp and tstaged < jstaged
        for j, t, ok in zip(js, ts, tok):
            if ok:
                assert t.text() == j.text() == \
                    t.oplog.checkout_tip().snapshot()
            else:                            # the fence: nothing committed
                assert t.synced_to < len(t.oplog)
                for s in (j, t):
                    s._materialize()
    # hits in rounds 1 and 5: round 2 is another list, round 3 follows
    # it, and round 3's poisoned row is untagged for round 4
    assert tarena.arena_stats()["hits"] == sum(jax_hits) == 2


def test_mesh_replay_rejects_mixed_caps_and_foreign_devices():
    docs, _jss, tss = _replay_twins(2, 43)
    mesh = tmesh.serve_mesh([CPU])
    tss[1].cap = 512
    with pytest.raises(ValueError, match="cap"):
        tmesh.mesh_fused_replay(mesh, tss, [s.plan_tail() for s in tss])
    with pytest.raises(ValueError, match="outside the mesh"):
        tmesh.mesh_fused_replay([torch.device("meta")], tss[:1],
                                [tss[0].plan_tail()])
    assert tmesh.serve_mesh([CPU, torch.device("cpu"), CPU]) == [CPU]


# ---- the window arena -------------------------------------------------------

def _arena_round(docs, tss, mesh, idx, poison=None):
    for i in idx:
        list(docs.values())[i].concurrent_round(("alice", "bob", "carol"),
                                                2, max_ins=11)
    plans = [tss[i].plan_tail() for i in idx]
    if poison is not None:
        plans[poison].dlen = plans[poison].dlen.copy()
        plans[poison].dlen[0] = FUSED["max_ins"] + 1
    before = tarena.arena_stats()
    ok, _, _, _ = tmesh.mesh_fused_replay(mesh, [tss[i] for i in idx],
                                          plans)
    after = tarena.arena_stats()
    return ok, after["hits"] - before["hits"]


@pytest.mark.parametrize("breaker", ["per_shard_commit", "materialize",
                                     "poison", "other_order"])
def test_arena_hits_on_recurrence_and_misses_after_a_break(breaker):
    """The same sessions in the same order hit the arena (their rows are
    views of the parked output, no clone); a per-shard commit, a rebuild,
    a poisoned row or another session order makes the next window miss
    and gather, with every text still exact."""
    docs, _jss, tss = _replay_twins(4, 47)
    mesh = tmesh.serve_mesh([CPU])
    idx = [0, 1, 2, 3]
    assert _arena_round(docs, tss, mesh, idx) == ([True] * 4, 0)
    parked = tss[0].docs
    assert parked._base is not None         # a view of the window output
    assert _arena_round(docs, tss, mesh, idx) == ([True] * 4, 1)
    if breaker == "per_shard_commit":
        list(docs.values())[2].concurrent_round(("alice", "bob"), 1,
                                                max_ins=11)
        ok, _ = tff.kernel_fused_replay([tss[2]], [tss[2].plan_tail()])
        assert ok == [True] and tss[2]._arena_tag is None
        assert tss[2].docs._base is None    # the per-shard rung clones
    elif breaker == "materialize":
        tss[1]._materialize()
        assert tss[1]._arena_tag is None
    elif breaker == "poison":
        ok, hits = _arena_round(docs, tss, mesh, idx, poison=3)
        assert ok == [True, True, True, False] and hits == 1
        assert tss[3]._arena_tag is None
        tss[3]._materialize()
    else:
        idx = [1, 0, 2, 3]
    ok, hits = _arena_round(docs, tss, mesh, idx)
    assert ok == [True] * 4 and hits == 0
    ok, hits = _arena_round(docs, tss, mesh, idx)
    assert ok == [True] * 4 and hits == 1
    for s in tss:
        assert s.text() == s.oplog.checkout_tip().snapshot()
    assert tarena.arena_stats()["arenas"] == 1


# ---- the scheduler ----------------------------------------------------------

@pytest.mark.parametrize("device_plan", [True, False])
def test_window_scheduler_matches_jax_per_round(device_plan):
    """One tape through both window schedulers: per round equal texts
    (the host checkout's), counters, window block, the transform's
    per-document counters; padded rows where JAX padded no further than
    the floor, else the port's floor."""
    seed = 3
    docs, tols, js, ts = _twin(12, seed, device_plan=device_plan)
    for rnd in range(5):
        padded0 = JAX_STEER.snapshot()["padded"]
        jw0 = js.metrics_json()["window"]
        tw0 = ts.metrics_json()["window"]
        _round(docs, seed, rnd, (js, ts))
        _texts_exact(docs, tols, (js, ts), rnd)
        jm, tm = js.metrics_json(), ts.metrics_json()
        assert {k: tm["totals"][k] for k in COUNTERS} == \
            {k: jm["totals"][k] for k in COUNTERS}, rnd
        assert {k: tm["window"][k] for k in WINDOW_SAME} == \
            {k: jm["window"][k] for k in WINDOW_SAME}, rnd
        for k in ("device_docs", "host_docs", "fallbacks", "device_ratio"):
            assert tm["transform"][k] == jm["transform"][k], (rnd, k)
        grow = {k: (tm["window"][k] - tw0[k], jm["window"][k] - jw0[k])
                for k in ("mesh_padded_rows", "staged_bytes")}
        if JAX_STEER.snapshot()["padded"] == padded0:
            assert all(t == j for t, j in grow.values()), (rnd, grow)
        else:
            assert all(t <= j for t, j in grow.values()), (rnd, grow)
    assert tm["totals"]["host_fallbacks"] == 0
    assert tm["fused"]["device_calls"] == 0     # no per-shard rung
    assert tm["window"]["mesh_docs"] > 0
    if device_plan:
        # the divergence: one resolve per window (one device), where the
        # JAX window resolves once per shard with extracts
        assert tm["transform"]["device_docs"] > 0
        assert tm["transform"]["batches"] < jm["transform"]["batches"]
        assert tm["transform"]["batches"] <= tm["window"]["windows"]


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_window_without_steering_matches_jax_padded_rows_and_bytes(
        n_shards):
    """Windows over 2, 3 and 4 shards on one device: with JAX's steering
    off, the window blocks are equal, padded rows and staged bytes
    included. (A JAX mesh of several devices pads the super-batch across
    them, where the port pads each device's slice: unequal by design.)"""
    JAX_STEER.enabled = False
    seed = 13
    docs, tols, js, ts = _twin(10, seed, n_shards=n_shards)
    for rnd in range(4):
        _round(docs, seed, rnd, (js, ts))
        _texts_exact(docs, tols, (js, ts), rnd)
        assert ts.metrics_json()["window"] == js.metrics_json()["window"]
    assert ts.metrics_json()["window"]["mesh_padded_rows"] > 0


def _mk_logs(n):
    docs = serve_docs([OpLog, OpLog, OpLog], n, 7)
    return docs, [{d: tw.oplogs[k] for d, tw in docs.items()}
                  for k in range(3)]


def test_three_way_byte_parity_window_per_shard_host():
    """Identical edit streams through the window, the per-shard fused
    path and the host engine: every document byte-identical across all
    three and equal to the host checkout."""
    docs, logs = _mk_logs(10)
    kw = dict(fused_opts=dict(FUSED, device="cpu"), flush_docs=8,
              flush_deadline_s=10.0, flush_workers=False, device_plan=True)
    scheds = [MergeScheduler(4, resolve=logs[0].__getitem__,
                             mesh_window=True, **kw),
              MergeScheduler(4, resolve=logs[1].__getitem__, **kw),
              MergeScheduler(4, resolve=logs[2].__getitem__, engine="host",
                             mesh_window=True, **kw)]
    assert [s.mesh_window for s in scheds] == [True, False, False]
    for rnd in range(5):
        _round(docs, 7, rnd, scheds, share=0.8)
        for d in docs:
            want = logs[0][d].checkout_tip().snapshot()
            assert [s.text(d) for s in scheds] == [want] * 3, (rnd, d)
    m = scheds[0].metrics_json()
    assert m["totals"]["host_fallbacks"] == 0
    assert m["window"]["mesh_docs"] > 0 and m["fused"]["device_calls"] == 0


def _docs_on_two_shards(sched, n=2):
    by_shard = {0: [], 1: []}
    i = 0
    while any(len(v) < n for v in by_shard.values()):
        d = f"w{i:03d}"
        s = sched.router.shard_of(d)
        if s in by_shard and len(by_shard[s]) < n:
            by_shard[s].append(d)
        i += 1
    return by_shard


def _window_sched(ols, n_shards=2, **kw):
    kw.setdefault("flush_docs", 8)
    return MergeScheduler(n_shards, resolve=ols.__getitem__,
                          fused_opts=dict(FUSED, device="cpu"),
                          flush_deadline_s=10.0, flush_workers=False,
                          mesh_window=True, **kw)


def _two_shard_docs(seed):
    ols = {}
    sched = _window_sched(ols)
    by_shard = _docs_on_two_shards(sched)
    names = by_shard[0] + by_shard[1]
    twins = serve_docs([OpLog], len(names), seed, base_max=60)  # cap 256
    for name, tw in zip(names, twins.values()):
        ols[name] = tw.oplogs[0]
    return sched, ols, by_shard, dict(zip(names, twins.values()))


def test_cross_shard_poison_isolation(monkeypatch):
    """A violating document in shard 0's bucket poisons only its own row
    of the shared launch: the other rows commit, the violator goes to the
    host (one fallback) and every text stays exact."""
    sched, ols, by_shard, twins = _two_shard_docs(9)
    for d in ols:
        sched.submit(d, 1)
    sched.pump(force=True)                  # builds the sessions
    for d, tw in twins.items():
        tw.concurrent_round(("alice", "bob"), 2, max_ins=11)
        sched.submit(d, 5)
    victim = by_shard[0][0]
    real = tff.FusedDocSession.plan_tail

    def bad_plan(self):
        p = real(self)
        if self.oplog is ols[victim] and p.n_ops:
            p.dlen = p.dlen.copy()
            p.dlen[0] = self.max_ins + 1
        return p
    monkeypatch.setattr(tff.FusedDocSession, "plan_tail", bad_plan)
    sched.pump(force=True)
    monkeypatch.undo()
    m = sched.metrics_json()
    assert m["totals"]["host_fallbacks"] == 1
    assert m["window"]["dispatches"] == 1 and m["window"]["shards_hist"] \
        == {"2": 2}
    assert victim not in sched.banks[0].sessions
    for d in by_shard[1] + by_shard[0][1:]:
        assert sched.banks[sched.router.shard_of(d)].sessions[d] \
            ._arena_tag is not None
    for d in ols:
        assert sched.text(d) == ols[d].checkout_tip().snapshot()


def test_fencing_recheck_at_window_assembly():
    """Work admitted under a lease epoch the host no longer holds is
    dropped when the window is assembled: no session, no dispatch."""
    ols = {}
    sched = _window_sched(ols, n_shards=1)
    epoch = {"n": 1}
    sched.epoch_of = lambda d: epoch["n"]
    tw = serve_docs([OpLog], 1, 5)["d00"]
    ols["fenced-doc"] = tw.oplogs[0]
    assert sched.submit("fenced-doc", 1)["accepted"]
    epoch["n"] = 2
    assert sched.pump(force=True) == 0
    m = sched.metrics_json()
    assert m["totals"]["fenced"] == 1 and m["totals"]["syncs"] == 0
    assert (m["window"]["windows"], m["window"]["dispatches"],
            m["window"]["device_windows"]) == (1, 0, 0)
    assert "fenced-doc" not in sched.banks[0].sessions


def test_one_launch_per_class_per_window_vs_per_shard_control(monkeypatch):
    """Both shards' buckets due in one window: the window replays each
    (cap, max_ins) class once across shards; the per-shard control pays
    one call per bucket and class. K1 calls == dispatches + per-doc
    replays, exactly."""
    calls = []
    real = tff.apply_ops_window

    def counted(*a):
        calls.append(a[0].shape[0])
        return real(*a)
    monkeypatch.setattr(tff, "apply_ops_window", counted)

    def run(window):
        sched, ols, _by_shard, twins = _two_shard_docs(3)
        if not window:
            sched = MergeScheduler(2, resolve=ols.__getitem__,
                                   fused_opts=dict(FUSED, device="cpu"),
                                   flush_docs=8, flush_deadline_s=10.0,
                                   flush_workers=False)
        calls.clear()
        for rnd in range(3):
            for d, tw in twins.items():
                if rnd:
                    tw.concurrent_round(("alice", "bob"), 1, max_ins=3)
                assert sched.submit(d, 3)["accepted"]
            sched.pump(force=True)
        for d in ols:
            assert sched.text(d) == ols[d].checkout_tip().snapshot()
        return sched.metrics_json(), list(calls)

    m, k1 = run(True)
    w = m["window"]
    assert (w["windows"], w["device_windows"], w["dispatches"]) == (3, 2, 2)
    assert w["device_calls_per_window"] == 1.0
    assert w["mesh_docs"] == 8 and w["shards_hist"] == {"2": 3}
    assert w["mesh_padded_rows"] == 8 and w["mesh_occupancy"] == 1.0
    assert w["staged_bytes"] > 0
    assert k1 == [4, 4]        # one launch of all 4 rows per device window
    assert m["fused"]["device_calls"] == 0
    mc, k1c = run(False)
    assert mc["window"]["device_calls_per_window"] == 2.0
    assert mc["window"]["mesh_docs"] == 0
    assert k1c == [2, 2, 2, 2]


def test_window_resolve_gives_the_per_entry_plans(monkeypatch):
    """The window resolves every shard's extracts in one call; each plan is
    per document, so the TailPlans equal those of one resolve per entry."""
    docs = serve_docs([OpLog], 12, 17, base_min=40, base_max=200)
    ols = {d: tw.oplogs[0] for d, tw in docs.items()}
    banks = [tbank.SessionBank(i, fused_opts=dict(FUSED, device="cpu"),
                               device_plan=True, max_sessions=16)
             for i in range(3)]

    class Item:
        def __init__(self, d):
            self.doc_id = d
    groups = [[Item(d) for d in list(ols)[i::3]] for i in range(3)]
    for bank, items in zip(banks, groups):
        bank.plan_window(items, ols.__getitem__)   # builds the sessions
    for tw in docs.values():
        tw.concurrent_round(("alice", "bob", "carol"), 3, max_ins=11)
    calls = []
    real = xform.resolve_positions

    def spy(exts, device=None):
        calls.append(len(exts))
        return real(exts, device=device)
    monkeypatch.setattr(xform, "resolve_positions", spy)
    # extraction is a pure read: the same tails twice
    wins = [b.extract_window(it, ols.__getitem__)
            for b, it in zip(banks, groups)]
    assert tbank.resolve_windows(wins) == 1
    each = [b.extract_window(it, ols.__getitem__)
            for b, it in zip(banks, groups)]
    assert [tbank.resolve_windows([w]) for w in each] == [1, 1, 1]
    assert len(calls) == 4 and calls[0] == sum(calls[1:]) >= 9
    one = [row[2] for w in wins for row in w["planned"]]
    sep = [row[2] for w in each for row in w["planned"]]
    assert len(one) == len(sep) == 12
    for a, b in zip(one, sep):
        assert isinstance(a, tff.TailPlan) and a.n_ops > 0
        for k in ("pos", "dlen", "ilen", "chars"):
            assert np.array_equal(getattr(a, k), getattr(b, k))
        assert (a.n_ops, a.new_len, a.max_len, a.frontier, a.synced_to) \
            == (b.n_ops, b.new_len, b.max_len, b.frontier, b.synced_to)


@pytest.mark.parametrize("fault", ["replay", "resolve"])
def test_window_fault_propagates_out_of_drain(monkeypatch, fault):
    """A K1 or resolve fault inside a window, from the background pump:
    drain() raises it, no document reaches the host, and no session
    committed the window."""
    sched, ols, _by, twins = _two_shard_docs(8)
    sched.banks[0].device_plan = sched.banks[1].device_plan = True
    for d in ols:
        sched.submit(d, 1)
    sched.drain()
    for d, tw in twins.items():
        tw.concurrent_round(("alice", "bob"), 2, max_ins=11)
        sched.submit(d, 5)

    def boom(*a, **k):
        raise RuntimeError(f"injected {fault} fault")
    if fault == "replay":
        monkeypatch.setattr(tff, "apply_ops_window", boom)
    else:
        monkeypatch.setattr(xform, "resolve_positions", boom)
    sched.start_pump(interval_s=0.01)
    with pytest.raises(RuntimeError, match=f"injected {fault} fault"):
        sched.stop_pump()
    monkeypatch.undo()
    m = sched.metrics_json()
    assert m["totals"]["host_fallbacks"] == 0
    for b in sched.banks:
        for d, sess in b.sessions.items():
            assert sess.synced_to < len(ols[d])
    sched.drain()                       # nothing left queued, no error
    for d in ols:
        assert sched.text(d) == ols[d].checkout_tip().snapshot()


def test_pump_raises_inline_without_background_pump(monkeypatch):
    sched, ols, _by, twins = _two_shard_docs(12)
    for d in ols:
        sched.submit(d, 1)
    sched.pump(force=True)
    for d, tw in twins.items():
        tw.concurrent_round(("alice", "bob"), 1, max_ins=11)
        sched.submit(d, 3)

    def boom(*a, **k):
        raise RuntimeError("injected replay fault")
    monkeypatch.setattr(tff, "apply_ops_window", boom)
    with pytest.raises(RuntimeError, match="injected replay fault"):
        sched.pump(force=True)
    assert sched.metrics_json()["totals"]["host_fallbacks"] == 0


def test_warmup_notes_the_mesh_classes_as_jax_does(monkeypatch):
    """One shard, flush_docs 4: the warm-up launches K1 once at each
    super-batch class a window can assemble, the classes the JAX
    package's warm-up over a one-device mesh notes under "mesh"."""
    got = port_warmup_classes(monkeypatch,
                              fused_opts=dict(FUSED, device="cpu"),
                              flush_docs=4, mesh_window=True)
    jol = JaxOpLog()
    js = JaxScheduler(1, resolve=lambda d: jol, fused_opts=FUSED,
                      flush_docs=4, mesh_window=True, warmup=True)
    js.banks[0].join_warmup(timeout=120)
    assert len(got["mesh"]) == JAX_STEER.snapshot()["warm_classes"]["mesh"] \
        == 9
    assert sorted(got["mesh"]) == sorted(JAX_STEER._warm["mesh"])


def test_record_window_snapshot_matches_jax():
    from diamond_types_tpu.serve.metrics import ServeMetrics as JaxMetrics
    tm, jm = ServeMetrics(2, 4, 64), JaxMetrics(2, 4, 64)
    for m in (tm, jm):
        m.record_window(1, 6, 2, mesh_docs=6, padded_rows=8,
                        staged_bytes=4096)
        m.record_window(0, 0, 1)
        m.record_window(2, 3, 1, mesh_docs=3, padded_rows=4,
                        staged_bytes=100)
    tw, jw = tm.snapshot()["window"], jm.snapshot()["window"]
    assert tw == jw
    assert tw["mesh_occupancy"] == 0.75 and \
        tw["staged_bytes_per_window"] == 2098.0


@pytest.mark.parametrize("mode", ["concurrent", "flash"])
def test_serve_bench_window_matches_jax(mode):
    kw = dict(shards=2, docs=4, txns=6, engine="device", mode=mode,
              flush_docs=2, max_sessions=8, steady_rounds=3,
              flush_workers=False, flush_deadline_s=10.0, mesh_window=True,
              device_plan=True)
    jr = jax_bench(**kw)
    tr = run_serve_bench(device="cpu", **kw)
    assert jr["parity_ok"] and tr["parity_ok"], tr["parity_mismatches"]
    assert tr["total_ops"] == jr["total_ops"]
    assert tr["device_calls_per_window"] == jr["device_calls_per_window"]
    assert tr["metrics"]["window"]["mesh_docs"] == \
        jr["metrics"]["window"]["mesh_docs"] > 0
    assert tr["config"]["mesh_window"]
    assert tr["staged_bytes_per_window"] > 0


def test_serve_module_mesh_window_flag_prints_the_report(capsys):
    from diamond_types_tpu_torch.serve.__main__ import main
    rc = main(["--device", "cpu", "--shards", "2", "--docs", "3",
               "--txns", "4", "--mode", "concurrent", "--device-plan",
               "--no-workers", "--mesh-window", "--steady-rounds", "2"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["parity_ok"]
    assert report["config"]["mesh_window"]
    assert report["device_calls_per_window"] > 0
    assert report["metrics"]["window"]["mesh_docs"] > 0
