"""The fused bank under the residency tier, on the CPU: a corpus larger than
the warm tier and the card, edited in rounds of concurrent syncs, read back
from the card, the warm tier and the homes; the residency tier's phases
and timers (`build`, `gate`, `metrics_json()["residency"]`); and the
faults the tiered cell found, each pinned by a case of its own.

The documents and their syncs come from the benchmark's generator
(`dtbench/traffic/generate.py`, concurrent.json's shape cut small) and
every text is held against the benchmark's plain reference
(`dtbench/reference/listcrdt.py`), which imports nothing of the program.
Sessions live on `device="cpu"`, where K1 and K2 run their plain versions.
"""

import json
import random
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from diamond_types_tpu import OpLog as JOpLog
from diamond_types_tpu.serve import hydrate as jhydrate
from diamond_types_tpu.storage import tier as jtier
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.obs import Observability
from diamond_types_tpu_torch.serve import bank as tbank
from diamond_types_tpu_torch.serve.hydrate import Hydrator
from diamond_types_tpu_torch.serve.metrics import RESIDENCY_TIMERS
from diamond_types_tpu_torch.serve.scheduler import MergeScheduler
from diamond_types_tpu_torch.storage import tier as ttier
from diamond_types_tpu_torch.storage.tier import TieredStore
from dtbench.reference.listcrdt import merged_text
from dtbench.tiers import append_sync
from dtbench.traffic.generate import make_docs

pytestmark = [pytest.mark.storage, pytest.mark.serve]

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 2601
N_DOCS, SESSIONS, WARM, ROUNDS = 24, 2, 6, 4


def _corpus(n_docs=N_DOCS, seed=SEED):
    mix = json.loads((ROOT / "dtbench" / "traffic" / "concurrent.json")
                     .read_text())
    mix["docs"].update(base_min=100, base_max=300, run_max=16)
    mix["edits"].update(ops_min=2, ops_max=8)
    return {g.doc_id: g for g in make_docs(seed, n_docs, mix["docs"],
                                           mix["edits"])}


class Stack:
    """A fused, device-planned scheduler of 4 shards on the CPU, with a
    Hydrator over a TieredStore (`hydrated`) or with every document's op
    log resident in a dict (not)."""

    def __init__(self, root, hydrated=True, obs=None, sessions=SESSIONS,
                 **hyd_kw):
        self.lock = threading.Lock()
        self.ols = {}
        self.store = self.hyd = None
        resolve = self.ols.__getitem__
        if hydrated:
            self.store = TieredStore(str(root))
            kw = dict(workers=1, warm_max=WARM, evict_grace_s=0.0)
            kw.update(hyd_kw)
            self.hyd = Hydrator(self.store, oplog_lock=self.lock, **kw)
            resolve = self.hyd.resolve
        self.sched = MergeScheduler(
            4, resolve=resolve, engine="device", fused=True,
            device_plan=True, fused_opts={"device": "cpu"},
            max_sessions_per_shard=sessions, flush_docs=4,
            sync_lock=self.lock)
        if hydrated:
            self.sched.attach_hydrator(self.hyd)
        if obs is not None:
            self.sched.attach_obs(obs)

    def edit(self, gen, sync):
        """One sync of `gen`'s document, appended as the tiered cell's tier
        appends it, then submitted."""
        def add(ol):
            ids = {a: ol.get_or_create_agent_id(a) for a in gen.agents()}
            append_sync(ol, ids, ol.version, sync)
        doc = gen.doc_id
        if self.hyd is not None:
            self.hyd.edit(doc, add)
        else:
            with self.lock:
                add(self.ols.setdefault(doc, OpLog()))
        assert self.sched.submit(doc, 1)["accepted"]

    def where(self, doc):
        bank = self.sched.banks[self.sched.router.shard_of(doc)]
        if doc in bank.sessions:
            return "card"
        if self.hyd is not None and self.hyd.warm_oplog(doc) is None:
            return "cold"
        return "warm"

    def stop(self):
        self.sched.stop_pump(drain=True)
        if self.hyd is not None:
            self.hyd.stop(checkpoint=True)


def _rounds(stack, gens, rounds=ROUNDS, seed=7):
    """Every document's base, then `rounds` rounds of syncs to a seeded
    half of the corpus, each round drained."""
    rng = random.Random(seed)
    for g in gens.values():
        stack.edit(g, g.syncs[0])
    stack.sched.drain()
    for _ in range(rounds):
        for doc in rng.sample(sorted(gens), len(gens) // 2):
            sync = gens[doc].next_sync()
            gens[doc].syncs.append(sync)
            stack.edit(gens[doc], sync)
        stack.sched.drain()


@pytest.fixture
def builds(monkeypatch):
    """Counts the sessions `SessionBank._build` builds."""
    n = {"builds": 0}
    real = tbank.SessionBank._build

    def counted(self, doc_id, oplog):
        n["builds"] += 1
        return real(self, doc_id, oplog)
    monkeypatch.setattr(tbank.SessionBank, "_build", counted)
    return n


def test_tiered_bank_serves_the_reference_text_from_every_rung(tmp_path,
                                                               builds):
    """24 documents through 8 sessions on the card and a warm tier of 6:
    every document's text, read from its session, its warm op log or its
    home, is the reference's, and so is a fresh store's load of every
    home once the tier has stopped. The residency tier's phases and timers
    count what ran: a gate a flush, one build a miss, one load a home
    decoded, one oplog hold a save."""
    gens = _corpus()
    stack = Stack(tmp_path)
    try:
        _rounds(stack, gens)
        where = {d: stack.where(d) for d in gens}
        assert set(where.values()) == {"card", "warm", "cold"}, where
        for doc, g in gens.items():
            assert stack.sched.text(doc) == merged_text(g.syncs), \
                (doc, where[doc])
    finally:
        stack.stop()
    snap = stack.sched.metrics_json()
    fresh = TieredStore(str(tmp_path))
    for doc, g in gens.items():
        assert fresh.load(doc).checkout_tip().snapshot() \
            == merged_text(g.syncs), doc

    fp, res, tot = snap["flush_phases"], snap["residency"], snap["totals"]
    store = stack.store.counters()
    assert tot["builds"] == builds["builds"] > N_DOCS
    assert 0 < fp["count"]["build"] <= tot["flushes"]
    assert fp["seconds"]["build"] > 0
    # the gate runs once a flush (read-triggered flushes included)
    assert fp["count"]["gate"] >= tot["flushes"] > 0
    assert fp["seconds"]["gate"] > 0
    assert res["saves"] == res["save_holds"] == store["saves"] > 0
    assert res["save_s"] >= res["save_hold_s"] > 0
    assert res["loads"] == store["loads"] > 0 and res["load_s"] > 0
    assert snap["hydration"]["hydrations"] > 0


def test_timers_match_the_stores_counters_exactly(tmp_path):
    """Timed once each: the scheduler's `residency` block counts exactly
    the store's loads (a missing home, a fresh document, is no load) and
    saves, each save with one hold of the oplog lock."""
    gens = _corpus(12)
    stack = Stack(tmp_path, warm_max=4)
    _rounds(stack, gens, rounds=2)
    stack.stop()
    res = stack.sched.metrics.snapshot()["residency"]
    c = stack.store.counters()
    assert (res["loads"], res["saves"], res["save_holds"]) \
        == (c["loads"], c["saves"], c["saves"])
    assert c["fresh_docs"] == 12 and c["loads"] > 0
    assert set(res) == {k for t in RESIDENCY_TIMERS
                        for k in (f"{t}_s", f"{t}s")}


def test_without_a_hydrator_no_gate_and_no_residency(tmp_path, builds):
    """With every document resident (no Hydrator), the gate never runs,
    the residency block stays zero, and `build` holds the sessions' first
    builds, one build a document (every session stays on the card)."""
    gens = _corpus(8)
    stack = Stack(tmp_path, hydrated=False, sessions=8)
    _rounds(stack, gens, rounds=2)
    stack.sched.stop_pump(drain=True)
    snap = stack.sched.metrics_json()
    fp = snap["flush_phases"]
    assert fp["count"]["gate"] == 0 and fp["seconds"]["gate"] == 0
    assert set(snap["residency"].values()) == {0}
    assert snap["totals"]["builds"] == builds["builds"] == 8
    assert 0 < fp["count"]["build"] <= 8
    for doc, g in gens.items():
        assert stack.sched.text(doc) == merged_text(g.syncs)


def test_traced_flushes_open_the_tiers_spans(tmp_path):
    """With `trace_flushes` on, the gate opens `bank.gate` under the
    flush's span, a build `bank.build` under the device sync, and the
    store's loads and saves their own roots; with it off, none of them,
    and with no Hydrator no `bank.gate`."""
    gens = _corpus(12)
    obs = Observability(sample_rate=0.0)
    stack = Stack(tmp_path, obs=obs, warm_max=4)
    try:
        _rounds(stack, gens, rounds=1)
        assert obs.tracer.spans() == []
        stack.sched.trace_flushes = True
        _rounds(stack, gens, rounds=1, seed=9)
    finally:
        stack.stop()
    spans = obs.tracer.spans()
    by_id = {sp["span"]: sp for sp in spans}
    names = {sp["name"] for sp in spans}
    assert {"bank.gate", "bank.build", "hydrate.load",
            "hydrate.save"} <= names
    for sp in spans:
        parent = by_id.get(sp["parent"])
        if sp["name"] == "bank.gate":
            assert parent["name"] == "serve.flush"
        elif sp["name"] == "bank.build":
            assert parent["name"] == "serve.device_sync"
        elif sp["name"].startswith("hydrate."):
            assert sp["parent"] is None and "doc" in sp["attrs"]

    obs2 = Observability(sample_rate=0.0)
    plain = Stack(tmp_path / "plain", hydrated=False, obs=obs2)
    plain.sched.trace_flushes = True
    _rounds(plain, _corpus(6), rounds=1)
    plain.sched.stop_pump(drain=True)
    names = {sp["name"] for sp in obs2.tracer.spans()}
    assert "bank.build" in names and "bank.gate" not in names


# ---- the faults the tiered cell found ---------------------------------------

def test_edit_resolves_again_a_doc_evicted_under_it(tmp_path):
    """A writer that resolves a document, then waits for the oplog lock
    while the warm tier evicts that document to its home, appends to an
    op log no tier holds any more: its ops are lost (the control, below,
    does exactly that). `Hydrator.edit` takes the lock, sees that the op
    log it resolved is no longer the warm one, and resolves again, so the
    ops land in the reloaded op log and survive in the home."""
    store = TieredStore(str(tmp_path))
    lock = threading.Lock()
    hyd = Hydrator(store, workers=1, warm_max=4, evict_grace_s=0.0,
                   oplog_lock=lock)
    try:
        for doc in ("fixed", "naive"):
            ol = hyd.resolve(doc)
            with lock:
                ol.add_insert(ol.get_or_create_agent_id("w"), 0, "base ")
        real = hyd.resolve
        evicted = []

        def resolve_then_evicted(doc):
            ol = real(doc)
            if doc not in evicted:
                # the warm tier's pressure, between the resolve and the
                # writer taking the lock
                evicted.append(doc)
                assert hyd.evict_to_snapshot(doc, why="pressure")
            return ol
        hyd.resolve = resolve_then_evicted

        def add(ol):
            ol.add_insert(ol.get_or_create_agent_id("w"),
                          len(ol.checkout_tip().snapshot()), "edited")
        hyd.edit("fixed", add)
        # the control: the same race without the recheck
        ol = hyd.resolve("naive")
        with lock:
            add(ol)
        hyd.resolve = real
        assert hyd.edit_retries == 1
        assert hyd.warm_oplog("naive") is None
    finally:
        hyd.stop(checkpoint=True)
    fresh = TieredStore(str(tmp_path))
    assert fresh.load("fixed").checkout_tip().snapshot() == "base edited"
    assert fresh.load("naive").checkout_tip().snapshot() == "base "


def test_concurrent_writers_lose_no_op_under_eviction_churn(tmp_path):
    """Writers on more threads than cores append through `Hydrator.edit`
    to documents churning through a warm tier of 2 (no eviction grace),
    with the interpreter switching threads every 10 us: every op appended
    is in its document's home once the tier checkpoints. The corpus is
    12 times the warm tier: over fewer documents every one is re-touched
    while its eviction saves, each eviction aborts, the warm map settles
    above its bound with every document in it, and the churn stops. It
    lost 1-3 of the 300 ops in about one run in five to the two races the
    next two cases pin."""
    import sys
    store = TieredStore(str(tmp_path))
    lock = threading.Lock()
    hyd = Hydrator(store, workers=1, warm_max=2, evict_grace_s=0.0,
                   oplog_lock=lock)
    docs = [f"d{i}" for i in range(24)]
    n_threads, n_edits = 12, 25

    def writer(w):
        rng = random.Random(w)
        for _ in range(n_edits):
            hyd.edit(rng.choice(docs), lambda ol: ol.add_insert(
                ol.get_or_create_agent_id(f"w{w}"), 0, "x"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        hyd.stop(checkpoint=True)
    fresh = TieredStore(str(tmp_path))
    assert sum(len(fresh.load(d).checkout_tip().snapshot()) for d in docs) \
        == n_threads * n_edits
    assert hyd.counters_snapshot()["evictions_to_snapshot"] > 0


def _slow_first_load(faults_cls):
    """Faults that time out a store's first load (the gate's prefetch)."""
    class SlowOnce(faults_cls):
        def __init__(self):
            super().__init__(seed=0, slow_rate=0.0)
            self.left = 1

        def load_delay(self, doc_id):
            if self.left:
                self.left -= 1
                return 5.0
            return 0.0
    return SlowOnce()


PKGS = {"jax": (JOpLog, jtier, jhydrate.Hydrator),
        "port": (OpLog, ttier, Hydrator)}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_late_second_gate_visit_hydrates_a_healthy_doc(tmp_path, pkg):
    """A cold document deferred at the gate whose prefetch did not land
    (here its one load timed out) comes back to the gate after the queue
    held it longer than `defer_budget_s`: under load, a long queue alone
    does that. The JAX package quarantines it ("hydration_stuck") and
    drops its merge work for good, though its home reads fine; the port
    hydrates it inline on that second visit and flushes it (a divergence,
    ROADMAP section 1)."""
    oplog_cls, tier, hyd_cls = PKGS[pkg]
    ol = oplog_cls()
    ol.add_insert(ol.get_or_create_agent_id("w"), 0, "healthy")
    store = tier.TieredStore(str(tmp_path))
    store.save("d", ol)
    store.faults = _slow_first_load(tier.StorageFaults)
    hyd = hyd_cls(store, workers=1, attempt_timeout_s=0.01, max_attempts=1,
                  gate_wait_s=0.001, defer_budget_s=0.02)
    item = SimpleNamespace(doc_id="d", n_ops=1, epoch=-1, trace=None)
    try:
        visits = []
        for i in range(2):
            if i:
                # the prefetch gave up; the queue held the item past the
                # defer budget
                deadline = time.monotonic() + 5.0
                while hyd.counters_snapshot()["hydrate_gave_up"] == 0 \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)
                time.sleep(0.05)
            keep, defer, dropped = hyd.flush_gate(0, [item])
            visits.append((len(keep), len(defer), len(dropped)))
        got = (visits, store.is_quarantined("d"))
        text = hyd.status("d") == "warm" and \
            hyd.resolve("d").checkout_tip().snapshot()
    finally:
        hyd.stop(checkpoint=False)
    if pkg == "jax":
        assert got == ([(0, 1, 0), (0, 0, 1)], "hydration_stuck")
    else:
        assert got == ([(0, 1, 0), (1, 0, 0)], None)
        assert text == "healthy"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_load_that_raced_an_eviction_is_not_installed(tmp_path, pkg):
    """Two resolves of a cold document load its home at once. The first
    installs its op log, a writer appends to it, and the warm tier evicts
    it to its home; only then does the second load, which read the home
    before that save, finish. The JAX package installs that stale op log:
    it lacks the writer's op, so the agent's next op takes the same ids,
    and the next save drops it as already persisted. The port sees that
    the document went back to its home while the load ran, discards the
    load and loads again, so both ops survive (a divergence, ROADMAP
    section 1)."""
    oplog_cls, tier, hyd_cls = PKGS[pkg]
    base = oplog_cls()
    base.add_insert(base.get_or_create_agent_id("w"), 0, "base ")
    store = tier.TieredStore(str(tmp_path))
    store.save("d", base)
    lock = threading.Lock()
    hyd = hyd_cls(store, workers=1, warm_max=4, evict_grace_s=0.0,
                  oplog_lock=lock)
    real_load = store.load
    read, go = threading.Event(), threading.Event()
    loads = []

    def load(doc_id, timeout_s=None):
        ol = real_load(doc_id, timeout_s=timeout_s)
        loads.append(doc_id)
        if len(loads) == 1:
            # the first load has read the home: hold it until the race
            # below has run
            read.set()
            assert go.wait(5.0)
        return ol
    store.load = load

    def append(text):
        ol = hyd.resolve("d")
        with lock:
            ol.add_insert(ol.get_or_create_agent_id("w"),
                          len(ol.checkout_tip().snapshot()), text)
    slow = []
    t = threading.Thread(target=lambda: slow.append(hyd.resolve("d")))
    try:
        t.start()
        assert read.wait(5.0)
        append("one")
        assert hyd.evict_to_snapshot("d", why="pressure")
        go.set()
        t.join(timeout=5.0)
        assert not t.is_alive()
        append("two")
    finally:
        go.set()
        hyd.stop(checkpoint=True)
    text = tier.TieredStore(str(tmp_path)).load("d").checkout_tip() \
        .snapshot()
    if pkg == "jax":
        assert text == "base one" and len(loads) == 2
    else:
        assert text == "base onetwo" and len(loads) == 3
        assert hyd.stale_loads == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_an_eviction_pops_only_the_oplog_it_saved(tmp_path, pkg):
    """Two evictions of one document overlap: the first has saved its op
    log when a resolve claims the document back and a second eviction
    saves and pops it. The document is loaded again, a writer appends to
    the new op log, and a third eviction marks it. When the first
    eviction resumes, the JAX package pops whatever op log is warm, the
    new one with its unsaved op among them; the next load misses that op,
    the agent's next op takes its ids, and a save drops it. The port pops
    only the op log it saved, so both ops survive (a divergence, ROADMAP
    section 1)."""
    oplog_cls, tier, hyd_cls = PKGS[pkg]
    base = oplog_cls()
    base.add_insert(base.get_or_create_agent_id("w"), 0, "base ")
    store = tier.TieredStore(str(tmp_path))
    store.save("d", base)
    lock = threading.Lock()
    hyd = hyd_cls(store, workers=1, warm_max=4, evict_grace_s=0.0,
                  oplog_lock=lock)
    real_save = store.save
    e1_in, e1_go, e3_in, e3_go = (threading.Event() for _ in range(4))
    saves = []

    def save(doc_id, ol, oplog_lock=None):
        saves.append(doc_id)
        if len(saves) == 3:
            # the third eviction holds before it saves
            e3_in.set()
            assert e3_go.wait(5.0)
        n = real_save(doc_id, ol, oplog_lock=oplog_lock)
        if len(saves) == 1:
            # the first eviction holds once it has saved
            e1_in.set()
            assert e1_go.wait(5.0)
        return n
    store.save = save

    def append(text):
        ol = hyd.resolve("d")
        with lock:
            ol.add_insert(ol.get_or_create_agent_id("w"),
                          len(ol.checkout_tip().snapshot()), text)
    hyd.resolve("d")
    evictions = [threading.Thread(target=hyd.evict_to_snapshot,
                                  args=("d",)) for _ in range(2)]
    try:
        evictions[0].start()
        assert e1_in.wait(5.0)
        hyd.resolve("d")                        # claims the doc back
        assert hyd.evict_to_snapshot("d")       # the second eviction
        append("two")
        evictions[1].start()
        assert e3_in.wait(5.0)
        e1_go.set()
        evictions[0].join(timeout=5.0)
        append("six")
        e3_go.set()
        evictions[1].join(timeout=5.0)
        assert not any(t.is_alive() for t in evictions)
    finally:
        e1_go.set()
        e3_go.set()
        hyd.stop(checkpoint=True)
    text = tier.TieredStore(str(tmp_path)).load("d").checkout_tip() \
        .snapshot()
    assert text == ("base two" if pkg == "jax" else "base twosix")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_save_writes_its_page_outside_the_oplog_lock(tmp_path, pkg,
                                                       monkeypatch):
    """A save holds the oplog lock, the one every flush and every append
    takes, only while it encodes the unsaved suffix. The JAX package holds
    it through the patch's page write and fsync as well, so under load
    the whole serve tier waits on the disk; the port writes after it
    releases the lock, under the doc's own io lock, and `on_persist`
    then sees the home holding every op the save encoded. The homes and
    texts are the same."""
    oplog_cls, tier, _hyd = PKGS[pkg]
    lock = threading.Lock()
    held, persisted = [], []
    real = tier.PagedStore.append

    def append(self, stream, record):
        held.append(lock.locked())
        return real(self, stream, record)
    monkeypatch.setattr(tier.PagedStore, "append", append)
    store = tier.TieredStore(str(tmp_path), on_persist=lambda d, home:
                             persisted.append((lock.locked(), len(home))))
    ol = oplog_cls()
    agent = ol.get_or_create_agent_id("w")
    ol.add_insert(agent, 0, "base ")
    sizes = []
    for text in ("one", "two"):
        ol.add_insert(agent, len(ol.checkout_tip().snapshot()), text)
        assert store.save("d", ol, oplog_lock=lock) == len(ol)
        sizes.append(len(ol))
    monkeypatch.undo()
    got = tier.TieredStore(str(tmp_path)).load("d").checkout_tip() \
        .snapshot()
    assert got == "base onetwo"
    if pkg == "jax":
        assert held == [True, True]
        assert persisted == [(True, n) for n in sizes]
    else:
        assert held == [False, False]
        assert persisted == [(False, n) for n in sizes]
