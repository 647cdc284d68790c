"""The port's residency tier (Hydrator, TieredStore) and its wiring into
the serve layer, against the JAX package's.

`tests/test_tier.py`'s scripted cases run through both packages; where a
case is deterministic (no race between the hydrator's workers and the
caller decides the outcome) each counter it pins is held equal to the
JAX run's. The quarantine case runs through both packages'
`MergeScheduler(engine="host")`. A hydrated device-engine scheduler
(sessions on `device="cpu"`, where K1 and K2 run their plain versions)
takes the same seeded edits as JAX's `MergeScheduler(engine="device")`
over the same documents, each behind its own `TieredStore` and
`Hydrator` with the same warm bound, on the per-shard path and the flush
window: every text must equal JAX's and the tracker's merge of an
in-memory mirror that never goes through the tier. The scheduler's
witness locks carry JAX's names, classes and ranks, and the port's
storage soak returns JAX's crash, compaction-kill and quarantine counts.
Where the gate defers every document of a flush window, the port's
`drain()` pumps again and merges them, where JAX's returns with them
queued (a deliberate divergence).
"""

import os
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from diamond_types_tpu import OpLog as JOpLog
from diamond_types_tpu.analysis import witness as jwitness
from diamond_types_tpu.parallel import mesh as jmesh
from diamond_types_tpu.serve import bank as jbank
from diamond_types_tpu.serve import hydrate as jhydrate
from diamond_types_tpu.serve import metrics as jmetrics
from diamond_types_tpu.serve import scheduler as jscheduler
from diamond_types_tpu.storage import soak as jsoak
from diamond_types_tpu.storage import tier as jtier
from diamond_types_tpu.tpu.steer import STEER as JAX_STEER
from diamond_types_tpu_torch import Branch
from diamond_types_tpu_torch import OpLog as TOpLog
from diamond_types_tpu_torch.analysis import witness as twitness
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu.steer import STEER
from diamond_types_tpu_torch.serve import bank as tbank
from diamond_types_tpu_torch.serve import hydrate as thydrate
from diamond_types_tpu_torch.serve import metrics as tmetrics
from diamond_types_tpu_torch.serve import scheduler as tscheduler
from diamond_types_tpu_torch.storage import soak as tsoak
from diamond_types_tpu_torch.storage import tier as ttier

from torch_parity import rand_text

pytestmark = [pytest.mark.storage, pytest.mark.serve]

JAX = SimpleNamespace(name="jax", OpLog=JOpLog, tier=jtier,
                      Hydrator=jhydrate.Hydrator, bank=jbank,
                      sched=jscheduler, witness=jwitness, soak=jsoak)
PORT = SimpleNamespace(name="port", OpLog=TOpLog, tier=ttier,
                       Hydrator=thydrate.Hydrator, bank=tbank,
                       sched=tscheduler, witness=twitness, soak=tsoak)
PKGS = (JAX, PORT)
FUSED = {"cap": 256, "max_ins": 4}


def _mk(pkg, parts, agent="a"):
    ol = pkg.OpLog()
    a = ol.get_or_create_agent_id(agent)
    pos = 0
    for part in parts:
        ol.add_insert(a, pos, part)
        pos += len(part)
    return ol


def _store_with_doc(pkg, root, doc="d", text="persisted", **kw):
    store = pkg.tier.TieredStore(root, **kw)
    store.save(doc, _mk(pkg, [text], agent="w"))
    return store


def _item(doc):
    return SimpleNamespace(doc_id=doc, n_ops=1, epoch=-1, trace=None)


def _each(tmp_path, case):
    """Run `case(pkg, root)` for both packages; returns {name: result}."""
    out = {}
    for pkg in PKGS:
        root = tmp_path / pkg.name
        root.mkdir()
        out[pkg.name] = case(pkg, str(root))
    return out


def _slow_n_times(pkg, n, slow_s=5.0):
    """Faults delaying the first `n` loads past any attempt timeout."""
    class SlowNTimes(pkg.tier.StorageFaults):
        def __init__(self):
            super().__init__(seed=0, slow_rate=0.0)
            self._left = n

        def load_delay(self, doc_id):
            if self._left > 0:
                self._left -= 1
                return slow_s
            return 0.0
    return SlowNTimes()


# ---- tests/test_tier.py's Hydrator cases, both packages ------------------

def test_hydration_timeout_then_retry_succeeds(tmp_path):
    def case(pkg, root):
        store = _store_with_doc(pkg, root)
        store.faults = _slow_n_times(pkg, 2)
        hyd = pkg.Hydrator(store, workers=1, attempt_timeout_s=0.02,
                           max_attempts=4, sync_wait_s=5.0)
        try:
            text = hyd.resolve("d").checkout_tip().snapshot()
            c = hyd.counters_snapshot()
            return (text, {k: c[k] for k in (
                "timeouts", "retries", "attempts", "hydrations",
                "sync_hydrations", "quarantined")},
                hyd.cold_start.count, hyd.status("d"))
        finally:
            hyd.stop(checkpoint=False)
    out = _each(tmp_path, case)
    assert out["port"] == out["jax"]
    text, c, n_cold, status = out["port"]
    assert text == "persisted" and status == "warm" and n_cold == 1
    assert c["timeouts"] == 2 and c["retries"] >= 2
    assert c["hydrations"] == 1 and c["quarantined"] == 0


def test_sync_resolve_exhaustion_quarantines(tmp_path):
    def case(pkg, root):
        store = _store_with_doc(pkg, root)
        store.faults = _slow_n_times(pkg, 100)
        hyd = pkg.Hydrator(store, workers=1, attempt_timeout_s=0.01,
                           max_attempts=2, sync_wait_s=0.05)
        try:
            with pytest.raises(pkg.tier.DocQuarantined) as ei:
                hyd.resolve("d")
            return (ei.value.reason, hyd.status("d"),
                    hyd.counters_snapshot()["quarantined"])
        finally:
            hyd.stop(checkpoint=False)
    out = _each(tmp_path, case)
    assert out["port"] == out["jax"] == ("hydration_timeout",
                                         "quarantined", 1)


def test_flush_gate_classifies_warm_quarantined_cold(tmp_path):
    def case(pkg, root):
        store = pkg.tier.TieredStore(root)
        for d in ("warm", "cold", "bad"):
            store.save(d, _mk(pkg, [d], agent="w"))
        store.quarantine("bad", "seeded")
        hyd = pkg.Hydrator(store, workers=1, attempt_timeout_s=0.01,
                           max_attempts=1, gate_wait_s=0.001,
                           defer_budget_s=10.0)
        try:
            assert hyd.resolve("warm") is not None
            store.faults = _slow_n_times(pkg, 100)   # "cold" stays cold
            keep, defer, dropped = hyd.flush_gate(
                0, [_item(d) for d in ("warm", "cold", "bad")])
            c = hyd.counters_snapshot()
            return ([i.doc_id for i in keep], [i.doc_id for i in defer],
                    [i.doc_id for i in dropped], c["quarantined_drops"],
                    c["deferrals"])
        finally:
            hyd.stop(checkpoint=False)
    out = _each(tmp_path, case)
    assert out["port"] == out["jax"] == (["warm"], ["cold"], ["bad"], 1, 1)


def test_second_gate_visit_escalates_to_sync_hydration(tmp_path):
    def case(pkg, root):
        class SlowWorkersOnly(pkg.tier.StorageFaults):
            def load_delay(self, doc_id):
                t = threading.current_thread().name
                return 5.0 if t.startswith("hydrate-worker") else 0.0

        store = _store_with_doc(pkg, root, text="slow home")
        store.faults = SlowWorkersOnly(seed=0, slow_rate=0.0)
        hyd = pkg.Hydrator(store, workers=1, attempt_timeout_s=0.01,
                           max_attempts=1, gate_wait_s=0.001,
                           sync_wait_s=5.0, defer_budget_s=10.0)
        try:
            visits = []
            for _ in range(2):
                keep, defer, dropped = hyd.flush_gate(0, [_item("d")])
                visits.append((len(keep), len(defer), len(dropped)))
            c = hyd.counters_snapshot()
            return (visits, hyd.status("d"), c["defer_escalations"],
                    c["deferrals"],
                    hyd.resolve("d").checkout_tip().snapshot())
        finally:
            hyd.stop(checkpoint=False)
    out = _each(tmp_path, case)
    assert out["port"] == out["jax"] == (
        [(0, 1, 0), (1, 0, 0)], "warm", 1, 1, "slow home")


def test_defer_budget_exhaustion_quarantines(tmp_path):
    def case(pkg, root):
        store = _store_with_doc(pkg, root, doc="stuck")
        store.faults = _slow_n_times(pkg, 100)
        hyd = pkg.Hydrator(store, workers=1, attempt_timeout_s=0.01,
                           max_attempts=1, gate_wait_s=0.001,
                           defer_budget_s=0.02)
        try:
            visits = []
            for i in range(2):
                if i:
                    time.sleep(0.05)     # let the defer budget lapse
                keep, defer, dropped = hyd.flush_gate(0, [_item("stuck")])
                visits.append((len(keep), len(defer), len(dropped)))
            return (visits, store.is_quarantined("stuck"),
                    hyd.counters_snapshot()["defer_gave_up"])
        finally:
            hyd.stop(checkpoint=False)
    out = _each(tmp_path, case)
    assert out["port"] == out["jax"] == (
        [(0, 1, 0), (0, 0, 1)], "hydration_stuck", 1)


def test_eviction_churn_byte_parity_vs_resident_control(tmp_path):
    """Random churn through a warm tier of 3 for 8 docs, no prefetch (so
    no worker races the caller): each package's texts equal its
    always-resident control, the counters and the homes on disk are the
    JAX package's byte for byte, and a fresh store over each root loads
    the same texts."""
    docs = [f"d{i}" for i in range(8)]

    def case(pkg, root):
        rng = random.Random(11)
        store = pkg.tier.TieredStore(root, compact_patch_records=4)
        for d in docs:
            store.save(d, _mk(pkg, [f"[{d}] "]))
        hyd = pkg.Hydrator(store, workers=2, warm_max=3, evict_grace_s=0.0,
                           sync_wait_s=5.0)
        control = {d: _mk(pkg, [f"[{d}] "]) for d in docs}
        try:
            for step in range(120):
                d = rng.choice(docs)
                live = hyd.resolve(d)
                pos = rng.randint(0, len(
                    control[d].checkout_tip().snapshot()))
                for ol in (live, control[d]):
                    ol.add_insert(ol.get_or_create_agent_id("ed"), pos,
                                  f"e{step}.")
                if rng.random() < 0.2:
                    hyd.evict_to_snapshot(rng.choice(docs), why="test")
            texts = {d: hyd.resolve(d).checkout_tip().snapshot()
                     for d in docs}
            assert texts == {d: control[d].checkout_tip().snapshot()
                             for d in docs}
            c = hyd.counters_snapshot()
            hyd.stop(checkpoint=True)
            fresh = pkg.tier.TieredStore(root)
            reloaded = {d: fresh.load(d).checkout_tip().snapshot()
                        for d in docs}
            assert reloaded == texts
            return texts, {k: c[k] for k in (
                "evictions_to_snapshot", "eviction_aborts", "snapshots",
                "hydrations", "sync_hydrations", "warm_hits",
                "spills_to_snapshot", "spill_bytes")}
        finally:
            hyd.stop(checkpoint=False)
    out = _each(tmp_path, case)
    assert out["port"] == out["jax"]
    assert out["port"][1]["evictions_to_snapshot"] > 0
    files = {name: {p.name: p.read_bytes()
                    for p in sorted((tmp_path / name).iterdir())}
             for name in ("jax", "port")}
    assert files["port"] == files["jax"]


def test_eviction_aborts_when_append_races_the_snapshot(tmp_path):
    def case(pkg, root):
        store = _store_with_doc(pkg, root, text="base ")

        class RacingStore:
            def __init__(self, inner):
                self._inner = inner
                self.racer = None

            def __getattr__(self, name):
                return getattr(self._inner, name)

            def save(self, doc_id, oplog, oplog_lock=None):
                n = self._inner.save(doc_id, oplog, oplog_lock=oplog_lock)
                if self.racer is not None:
                    self.racer(oplog)
                return n

        proxy = RacingStore(store)
        hyd = pkg.Hydrator(proxy, workers=1, sync_wait_s=5.0)
        try:
            ol = hyd.resolve("d")
            proxy.racer = lambda t: t.add_insert(
                t.get_or_create_agent_id("late"), 0, "racing-op ")
            first = hyd.evict_to_snapshot("d", why="test")
            proxy.racer = None
            aborts = hyd.counters_snapshot()["eviction_aborts"]
            kept = hyd.resolve("d") is ol
            second = hyd.evict_to_snapshot("d", why="test")
            return (first, aborts, kept, second,
                    store.load("d").checkout_tip().snapshot())
        finally:
            hyd.stop(checkpoint=False)
    out = _each(tmp_path, case)
    assert out["port"] == out["jax"] == (False, 1, True, True,
                                         "racing-op base ")


# ---- the bank's eviction tail --------------------------------------------

def _bank_script(pkg):
    """Every eviction site of a host-engine bank: capacity (LRU), explicit
    and stale-oplog (the doc's oplog replaced, as a re-hydration does).
    Returns the hook's calls in order."""
    bank = pkg.bank.SessionBank(0, max_sessions=2, engine="host")
    calls = []
    bank.snapshot_hook = lambda d, pending: calls.append((d, pending)) \
        or True
    ols = {d: _mk(pkg, [f"{d} state "]) for d in ("a", "b", "c")}
    for d in ("a", "b"):
        bank.session(d, ols[d])
    # pending ops: appended after the session synced
    ols["a"].add_insert(ols["a"].get_or_create_agent_id("x"), 0, "new ")
    bank.session("c", ols["c"])              # LRU: evicts "a" (4 pending)
    assert bank.evict("b") is True           # explicit
    assert bank.evict("b") is False          # already gone: no call
    bank.session("c", _mk(pkg, ["c state ", "more"]))   # stale-oplog
    return calls


def test_bank_evict_reports_pending_ops_and_snapshot_routing():
    """The port's `_drop(doc_id, sess, why)` calls the hook with the
    session's pending ops at every eviction site, as JAX's does."""
    tcalls = _bank_script(PORT)
    jcalls = _bank_script(JAX)
    assert tcalls == jcalls == [("a", 4), ("b", 0), ("c", 0)]
    # the port's hook is enqueue-only and its faults propagate (the JAX
    # bank swallows them)
    bank = tbank.SessionBank(0, max_sessions=4, engine="host")
    bank.session("doc", _mk(PORT, ["x"]))
    bank.snapshot_hook = lambda d, pending: 1 / 0
    with pytest.raises(ZeroDivisionError):
        bank.evict("doc")


def test_bank_evictions_counted_at_every_site():
    metrics = tmetrics.ServeMetrics(1, 4, 64)
    bank = tbank.SessionBank(0, max_sessions=1, engine="host",
                             metrics=metrics)
    seen = []
    bank.snapshot_hook = lambda d, pending: seen.append(d)
    bank.session("a", _mk(PORT, ["a"]))
    bank.session("b", _mk(PORT, ["b"]))           # capacity
    bank.session("b", _mk(PORT, ["b2"]))          # stale-oplog
    bank.evict("b")                               # explicit
    assert seen == ["a", "b", "b"]
    assert metrics.snapshot()["totals"]["evictions"] == 3


# ---- metrics -------------------------------------------------------------

def test_metrics_hydration_block_matches_jax_keys():
    assert tmetrics.HYDRATION_KEYS == jmetrics.HYDRATION_KEYS
    m = tmetrics.ServeMetrics(2, 4, 64)
    snap0 = m.snapshot()
    assert snap0["version"] == 4
    assert tuple(snap0["hydration"]) == jmetrics.HYDRATION_KEYS
    assert set(snap0["hydration"].values()) == {0}
    m.record_hydration("prefetches")
    m.record_hydration("evictions_to_snapshot", 3)
    m.observe_cold_start(0.012)
    snap = m.snapshot()
    assert snap["hydration"]["prefetches"] == 1
    assert snap["hydration"]["evictions_to_snapshot"] == 3
    assert snap["latencies"]["hydration_cold_start"]["count"] == 1
    jm = jmetrics.ServeMetrics(2, 4, 64)
    jm.record_hydration("prefetches")
    jm.record_hydration("evictions_to_snapshot", 3)
    jm.observe_cold_start(0.012)
    jsnap = jm.snapshot()
    assert snap["hydration"] == jsnap["hydration"]
    assert snap["latencies"]["hydration_cold_start"] \
        == jsnap["latencies"]["hydration_cold_start"]
    # the Hydrator's own counter set is the same tuple
    assert thydrate.HYDRATION_KEYS is tmetrics.HYDRATION_KEYS


# ---- the scheduler: quarantine, witness locks ----------------------------

def test_scheduler_rejects_quarantined_and_flushes_rest(tmp_path):
    def case(pkg, root):
        store = pkg.tier.TieredStore(root)
        for d in ("a", "b", "bad"):
            store.save(d, _mk(pkg, [f"[{d}] "]))
        with open(store.path("bad"), "r+b") as f:
            f.write(b"\xff" * os.path.getsize(store.path("bad")))
        hyd = pkg.Hydrator(store, workers=1, sync_wait_s=5.0)
        sched = pkg.sched.MergeScheduler(2, hyd.resolve, engine="host",
                                         flush_deadline_s=0.01)
        sched.attach_hydrator(hyd)
        try:
            first = sched.submit("bad")["accepted"]
            sched.drain()
            time.sleep(0.05)
            r = sched.submit("bad")
            for d in ("a", "b"):
                ol = hyd.resolve(d)
                ol.add_insert(ol.get_or_create_agent_id("ed"),
                              len(ol.checkout_tip().snapshot()), "edited")
                assert sched.submit(d)["accepted"] is True
            sched.drain()
            c = hyd.counters_snapshot()
            m = sched.metrics_json()
            return (first, r, [sched.text(d) for d in ("a", "b")],
                    c["flush_leaks"], c["quarantined_drops"],
                    store.is_quarantined("bad") is not None,
                    m["hydration"]["flush_leaks"],
                    m["totals"]["flushed_docs"])
        finally:
            sched.stop_pump(drain=False)
            hyd.stop(checkpoint=False)
    out = _each(tmp_path, case)
    assert out["port"] == out["jax"]
    first, r, texts, leaks, drops, quarantined, mleaks, flushed = \
        out["port"]
    assert first is True
    assert r == {"accepted": False, "shard": r["shard"],
                 "reason": "quarantined"}
    assert texts == ["[a] edited", "[b] edited"]
    assert leaks == mleaks == 0 and drops == 1 and quarantined


def _lock_table(pkg):
    import importlib
    root = "diamond_types_tpu" if pkg is JAX else "diamond_types_tpu_torch"
    read = importlib.import_module(f"{root}.read")
    sched = pkg.sched.MergeScheduler(3, resolve=lambda d: None,
                                     engine="host")
    locks = [sched.lock, *sched._shard_locks, *sched._device_locks,
             pkg.bank._first_touch_lock,
             read.CheckoutCache()._cache_lock,
             read.FollowerIndex()._read_lock]
    return [(lk.name, lk.order_class, lk.rank) for lk in locks]


def test_witness_lock_table_matches_jax():
    table = _lock_table(PORT)
    assert table == _lock_table(JAX)
    assert table[0] == ("scheduler.global", "global", None)
    assert table[1:4] == [(f"shard[{i}]", "shard", i) for i in range(3)]
    assert table[-3] == ("first_touch", "leaf", None)
    assert table[-2:] == [("read.cache", "io", None),
                          ("read.follower", "io", None)]


# ---- the hydrated device-engine scheduler vs JAX ---------------------------

def _edit_script(rng, text_len: int, k_max: int = 3) -> list:
    """One round's edits of a document, as a script any oplog can replay:
    two agents fork the tip and edit concurrently (each op decided from
    its branch's length alone), then the first agent edits once more on
    the merged tip. Positions and texts only, so the same script gives
    the same history in every oplog whatever its LV numbering."""
    ops = []
    lens = {"fa": text_len, "fb": text_len}
    for name in ("fa", "fb"):
        for _ in range(int(rng.integers(1, k_max + 1))):
            cur = lens[name]
            if cur and rng.random() < 0.4:
                p = int(rng.integers(0, cur))
                end = min(cur, p + int(rng.integers(1, 6)))
                ops.append((name, "del", p, end))
                lens[name] -= end - p
            else:
                p = int(rng.integers(0, cur + 1))
                s = rand_text(rng, int(rng.integers(1, 9)), "abcdé中😀 ")
                ops.append((name, "ins", p, s))
                lens[name] += len(s)
    ops.append(("tip", "merge"))
    ops.append(("tip", "ins", 0, rand_text(rng, 2, "xyz")))
    return ops


def _apply_script(ol, ops) -> int:
    brs = {"fa": ol.checkout_tip(), "fb": ol.checkout_tip()}
    names = {"fa": "alice", "fb": "bob", "tip": "carol"}
    n = 0
    for op in ops:
        name, kind = op[0], op[1]
        if kind == "merge":
            brs["tip"] = ol.checkout_tip()
            continue
        agent = ol.get_or_create_agent_id(names[name])
        if kind == "ins":
            brs[name].insert(ol, agent, op[2], op[3])
        else:
            brs[name].delete(ol, agent, op[2], op[3])
        n += 1
    return n


class _Side:
    """One package's hydrated stack: a TieredStore home per document, a
    Hydrator with `warm` slots and a device-engine MergeScheduler
    resolving through it."""

    def __init__(self, pkg, root, bases, warm, mesh_window, n_shards=2):
        self.pkg = pkg
        self.guard = pkg.witness.make_lock(f"{pkg.name}.oplog", "oplog")
        self.store = pkg.tier.TieredStore(root, compact_patch_records=4)
        for d, text in bases.items():
            self.store.save(d, _mk(pkg, [text]))
        self.hyd = pkg.Hydrator(self.store, workers=2, warm_max=warm,
                                oplog_lock=self.guard, seed=3)
        opts = dict(engine="device", fused=True, device_plan=True,
                    flush_docs=4, flush_deadline_s=10.0,
                    flush_workers=not mesh_window, mesh_window=mesh_window,
                    max_sessions_per_shard=8, sync_lock=self.guard)
        if pkg is JAX:
            self.sched = pkg.sched.MergeScheduler(
                n_shards, resolve=self.hyd.resolve, fused_opts=FUSED,
                **opts)
            if mesh_window:
                self.sched._mesh = jmesh.serve_mesh(1)
        else:
            self.sched = pkg.sched.MergeScheduler(
                n_shards, resolve=self.hyd.resolve,
                fused_opts=dict(FUSED, device="cpu"), **opts)
        self.sched.attach_hydrator(self.hyd)

    def edit(self, d, ops) -> int:
        """Apply `ops` to the document's warm oplog under the guard. An
        eviction that popped the doc between the resolve and the guard
        would strand the edits in a dropped oplog: then replay them on
        the re-hydrated one. (The pop itself runs under the guard, so
        the warm map's entry is stable while the guard is held; the
        hydrator's own lock ranks before the guard and is not taken.)"""
        while True:
            ol = self.hyd.resolve(d)
            with self.guard:
                if self.hyd._warm.get(d) is ol:
                    return _apply_script(ol, ops)

    def stop(self):
        self.sched.stop_pump(drain=False)
        self.hyd.stop(checkpoint=True)


@pytest.mark.parametrize("mesh_window", [False, True])
def test_hydrated_device_scheduler_matches_jax(tmp_path, mesh_window):
    n_docs, warm, rounds = 24, 6, 3
    rng = np.random.default_rng(17)
    bases = {f"doc{i:02d}": rand_text(rng, int(rng.integers(20, 200)),
                                      "abcdefghij ")
             for i in range(n_docs)}
    JAX_STEER.reset(table=True)
    STEER.reset(table=True)
    twitness.witness_enable()
    twitness.witness_reset()
    sides = [_Side(pkg, str(tmp_path / pkg.name), bases, warm, mesh_window)
             for pkg in PKGS]
    mirror = {d: _mk(PORT, [t]) for d, t in bases.items()}
    launches = (kernels.apply_ops_window.launches,
                kernels.xform_positions.launches)
    try:
        for rnd in range(rounds):
            chosen = [d for d in bases if rng.random() < 0.75]
            # waves of half the warm tier: a wave's documents are opened
            # (admitted and flushed: hydrated, sessions built on the warm
            # oplogs), then edited and flushed again (their tails planned
            # by K2 and replayed by K1); later waves evict them, so every
            # round hydrates its documents anew
            for w in range(0, len(chosen), warm // 2):
                wave = chosen[w:w + warm // 2]
                for side in sides:
                    for d in wave:
                        assert side.sched.submit(d, n_ops=1)["accepted"]
                    side.sched.pump()
                    side.sched.drain()
                for d in wave:
                    ops = _edit_script(rng, len(
                        mirror[d].checkout_tip().snapshot()))
                    n = _apply_script(mirror[d], ops)
                    for side in sides:
                        assert side.edit(d, ops) == n
                        assert side.sched.submit(d, n_ops=n)["accepted"]
                for side in sides:
                    side.sched.pump()
                    side.sched.drain()
            for d in bases:
                ref = Branch()
                ref.merge_reference(mirror[d], mirror[d].version)
                want = ref.snapshot()
                got = [side.sched.text(d) for side in sides]
                assert got == [want, want], (rnd, d)
        ms = [side.sched.metrics_json() for side in sides]
        cs = [side.hyd.counters_snapshot() for side in sides]
        for m, c in zip(ms, cs):
            assert c["flush_leaks"] == 0 and c["quarantined"] == 0
            assert m["totals"]["host_fallbacks"] == 0
            assert m["hydration"]["flush_leaks"] == 0
        # the tier churned: evictions went to snapshots and stale
        # sessions were rebuilt against re-hydrated oplogs
        tm, tc = ms[1], cs[1]
        assert tc["evictions_to_snapshot"] > 0
        assert tm["totals"]["evictions"] > 0
        assert tm["transform"]["device_docs"] > 0
        if mesh_window:
            assert tm["window"]["mesh_docs"] > 0
        else:
            assert tm["fused"]["device_calls"] > 0
    finally:
        for side in sides:
            side.stop()
    # CPU sessions: the plain versions ran, no kernel was launched
    assert (kernels.apply_ops_window.launches,
            kernels.xform_positions.launches) == launches
    # after a checkpointed stop, a fresh store over each root loads every
    # document to the mirror's text
    for pkg in PKGS:
        fresh = pkg.tier.TieredStore(str(tmp_path / pkg.name))
        for d in bases:
            assert fresh.load(d).checkout_tip().snapshot() \
                == mirror[d].checkout_tip().snapshot(), (pkg.name, d)
    wit = twitness.witness_snapshot()
    assert wit["acyclic"] and wit["violation_count"] == 0, wit
    assert wit["edge_count"] > 0


# ---- drain() when the gate defers a whole window ----------------------------

def _gate_defers_window(pkg, root, bases):
    """A window scheduler over a tier whose hydration workers are slow
    (their loads time out), so the first gate visit defers every document
    of the window; the second visit hydrates synchronously on the pump
    thread. Submits each document once and drains."""
    class SlowWorkersOnly(pkg.tier.StorageFaults):
        def load_delay(self, doc_id):
            t = threading.current_thread().name
            return 5.0 if t.startswith("hydrate-worker") else 0.0

    store = pkg.tier.TieredStore(root)
    for d, text in bases.items():
        store.save(d, _mk(pkg, [text], agent="w"))
    store.faults = SlowWorkersOnly(seed=0, slow_rate=0.0)
    hyd = pkg.Hydrator(store, workers=1, attempt_timeout_s=0.01,
                       max_attempts=1, gate_wait_s=0.001, sync_wait_s=5.0,
                       defer_budget_s=30.0)
    opts = dict(engine="device", fused=True, device_plan=True, flush_docs=4,
                flush_deadline_s=10.0, flush_workers=False,
                mesh_window=True)
    if pkg is JAX:
        sched = pkg.sched.MergeScheduler(2, resolve=hyd.resolve,
                                         fused_opts=FUSED, **opts)
        sched._mesh = jmesh.serve_mesh(1)
    else:
        sched = pkg.sched.MergeScheduler(
            2, resolve=hyd.resolve, fused_opts=dict(FUSED, device="cpu"),
            **opts)
    sched.attach_hydrator(hyd)
    for d in bases:
        assert sched.submit(d, n_ops=1)["accepted"]
    return sched, hyd, sched.drain()


def test_drain_flushes_a_window_the_gate_deferred(tmp_path):
    """A deliberate divergence (ROADMAP §3): the JAX `drain()` stops when a
    pump returns 0, so a window whose every document the hydration gate
    deferred stays queued after it returns. The port's `drain()` counts
    the deferral as progress and pumps again: the gate's second visit
    hydrates the documents and the window merges them."""
    bases = {f"doc{i}": f"home {i} " * (i + 1) for i in range(6)}
    out = {}
    for pkg in PKGS:
        root = tmp_path / pkg.name
        root.mkdir()
        sched, hyd, n = _gate_defers_window(pkg, str(root), bases)
        try:
            out[pkg.name] = (sched, hyd, n, sched.queue.total_depth(),
                             sched.metrics_json(), hyd.counters_snapshot())
            if pkg is PORT:
                texts = {d: sched.text(d) for d in bases}
        finally:
            sched.stop_pump(drain=False)
            hyd.stop(checkpoint=False)
    _s, _h, jn, jdepth, _jm, jc = out["jax"]
    assert jn == 0 and jdepth == len(bases)         # JAX left them queued
    assert jc["deferrals"] == len(bases)
    _s, _h, tn, tdepth, tm, tc = out["port"]
    assert tn == len(bases) and tdepth == 0
    assert tc["deferrals"] == tc["defer_escalations"] == len(bases)
    assert tc["quarantined"] == tc["flush_leaks"] == 0
    assert tm["totals"]["flushed_docs"] == len(bases)
    assert tm["totals"]["host_fallbacks"] == 0
    assert tm["window"]["windows"] >= 2
    assert texts == bases


# ---- the storage soak ------------------------------------------------------

SOAK = dict(docs=16, warm=4, rounds=3, edits_per_round=10, shards=2, seed=5,
            compact_every=6, churn=True, crash=True, slow=True)


def test_storage_soak_smoke_all_faults_matches_jax():
    rep = tsoak.run_storage_soak(**SOAK)
    assert rep["ok"], rep
    assert rep["byte_mismatches"] == 0
    assert rep["quarantine_match"] and rep["quarantine_leaks"] == 0
    assert rep["crashes"] == 1 and rep["compaction_kills"] == 3
    assert rep["lock_witness"]["acyclic"]
    assert rep["lock_witness"]["violation_count"] == 0
    jrep = jsoak.run_storage_soak(**SOAK)
    for k in ("crashes", "compaction_kills", "torn_tails", "quarantined",
              "expected_quarantined", "edits", "config"):
        assert rep[k] == jrep[k], k


def test_storage_soak_cli(tmp_path):
    out = tmp_path / "soak.json"
    rc = tsoak.main(["--docs", "8", "--warm", "3", "--rounds", "2",
                     "--edits-per-round", "6", "--seed", "2", "--churn",
                     "--json", "--metrics-out", str(out)])
    assert rc == 0 and out.exists()
