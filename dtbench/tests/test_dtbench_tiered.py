"""The tiered cell's parts on the CPU: a rehearsal of tiered-zipf cut to a
CPU's size (by its own helper: `conftest.tiny` keeps every document
resident), its Zipf arrivals, its six readers on a fabricated window, and
two planted faults of the residency tier that must each turn `correct`
false."""

import numpy as np
import pytest

from conftest import SEED
from dtbench import metrics
from dtbench.run import cell_metrics, load_cell, run_cell
from dtbench.traffic.clients import Sync
from dtbench.traffic.generate import make_docs

CELL = "tiered-zipf"
READERS = ("card_miss_pct", "cold_sync_pct", "build_us_per_op",
           "gate_us_per_op", "home_load_ms", "snapshot_hold_us_per_op")


def tiny_tiered(n_docs: int = 48):
    """tiered-zipf cut to a CPU's size: `n_docs` documents of 150-400
    chars, a quarter of them warm, 4 sessions a shard (16 on the card), a
    client for every fourth document, a warm-up of one sync a document
    through the loop, 12 documents checked."""
    manifest, cell, config, mix = load_cell(CELL)
    mix["docs"].update(base_min=150, base_max=400, run_max=16,
                       count=n_docs)
    mix["check"]["docs"] = 12
    mix["arrivals"].update(clients=n_docs // 4, ahead_syncs_per_s=40,
                           warm_syncs=n_docs)
    config.update(corpus_docs=n_docs, live_docs=n_docs,
                  warm_max=n_docs // 4, max_sessions_per_shard=4)
    specs = cell_metrics(manifest, CELL, False) + cell_metrics(
        manifest, CELL, True)
    return cell, config, mix, specs


def read_where(seen):
    """A `doc_texts` hook: the tier's own reads, noting where each sampled
    document was at its read."""
    def read(tier, docs):
        out = {d: tier.text(d) for d in docs}
        seen.update(tier.read_states)
        return out
    return read


def test_the_cell_sizes_agree():
    """The configuration's corpus is the mix's documents, the warm tier a
    quarter of it, and the clients fewer than half the documents."""
    _m, cell, config, mix = load_cell(CELL)
    assert config["corpus_docs"] == config["live_docs"] \
        == mix["docs"]["count"] == 2048
    assert config["warm_max"] == 512 and config["max_sessions_per_shard"] \
        == 96 and cell["chips"] == 1
    assert mix["arrivals"]["clients"] == 256 \
        and mix["arrivals"]["zipf_s"] == 1.1


def test_rehearsal_is_correct_with_cold_documents_in_its_sample():
    cell, config, mix, specs = tiny_tiered()
    seen = {}
    r = run_cell(cell, config, mix, specs, SEED, 2.0, False, "cpu",
                 doc_texts=read_where(seen))
    assert r["correct"], r["notes"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["checked_docs"]["value"] >= 12
    assert seen["cold"] > 0 and seen["card"] > 0, seen
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(READERS) <= set(got)
    assert got["merged_ops_per_s"] > 0
    assert got["card_miss_pct"] > 0 and got["cold_sync_pct"] > 0
    assert got["home_load_ms"] > 0 and got["snapshot_hold_us_per_op"] > 0
    assert r["notes"]["window_totals"]["builds"] > 0


# ---- the arrivals ---------------------------------------------------------------

class FakeClients:
    """What the arrivals use of `clients.Clients`: the documents, the seed,
    what is in flight, and `send`."""

    def __init__(self, n_docs, seed=SEED):
        docs = {"base_min": 20, "base_max": 40, "run_min": 1, "run_max": 8}
        edits = {"kind": "keystrokes", "agent": "typist", "ops_min": 1,
                 "ops_max": 2, "del_share": 0.3, "del_max": 2,
                 "ins_max": 2, "jump_share": 0.0}
        self.gens = {g.doc_id: g for g in make_docs(seed, n_docs, docs,
                                                     edits)}
        self.order = list(self.gens)
        self.seed = seed
        self.inflight = {}
        self.sent = []

    def send(self, doc, sync, due):
        assert doc not in self.inflight, "two syncs in flight"
        self.inflight[doc] = Sync(doc, due, 1)
        self.sent.append(doc)


def _arrivals(fake, **kw):
    from dtbench import plugins
    p = {"kind": "zipf_closed_loop", "clients": 4, "zipf_s": 1.1,
         "ahead_syncs_per_s": 10, "ahead_margin": 2.0}
    p.update(kw)
    return plugins.load("traffic/arrivals", p["kind"]).Arrivals(fake, p)


def test_zipf_draws_are_fixed_by_the_seed_and_skewed_by_rank():
    draws = []
    for _ in range(2):
        c = FakeClients(64)
        a = _arrivals(c)
        out = []
        for _ in range(2000):
            out.append(a.draw())
        draws.append(out)
    assert draws[0] == draws[1]
    other = _arrivals(FakeClients(64, seed=SEED + 1))
    assert [other.draw() for _ in range(50)] != draws[0][:50]
    counts = np.bincount([int(d[3:]) for d in draws[0]], minlength=64)
    # rank 1 against rank 2: 2 ** 1.1 = 2.14 times as likely
    assert counts[0] > counts[1] > counts[7] > 0
    assert 1.6 < counts[0] / counts[1] < 2.8


def test_a_busy_document_is_drawn_again():
    c = FakeClients(64)
    a = _arrivals(c)
    a.start(0.0, 10.0)          # four clients, four distinct documents
    assert len(c.sent) == len(set(c.sent)) == 4
    assert "doc0" in c.inflight          # the head is drawn first
    for _ in range(200):
        d = a.draw()
        assert d not in c.inflight
    assert a.redrawn > 0


def test_a_commit_sends_the_clients_next_sync_to_a_free_document():
    c = FakeClients(64)
    a = _arrivals(c)
    a.start(0.0, 10.0)
    for _ in range(100):
        doc = c.sent[-4]
        s = c.inflight.pop(doc)
        a.committed(s, 1.0)
        assert len(c.inflight) == 4
    a.committed(Sync("doc63", 0.0, 1), 11.0)     # past the window: none
    assert len(c.inflight) == 4


def test_set_up_generates_each_documents_share():
    """Set-up plays the window through the loop once: every document gets
    what it took there, times the margin, plus two; a busy head leaves
    more to the tail than its Zipf share."""
    got = []
    for _ in range(2):
        c = FakeClients(64)
        a = _arrivals(c, ahead_syncs_per_s=10, ahead_margin=2.0)
        assert a.ahead(40.0) == 0
        got.append([len(c.gens[d].ahead) for d in c.order])
    ahead = got[0]
    assert got[0] == got[1]
    assert min(ahead) >= 2 and ahead[0] >= ahead[-1]
    played = sum((k - 2) // 2 for k in ahead)
    assert played == 2 * 4 + 10 * 40        # warm-up's clients and window's
    # one client's sync in flight at a time caps the head's share
    assert (ahead[0] - 2) / 2 < 0.9 * a.share[0] * played
    assert a.drawn == []         # the window's own draws are untouched


class LoopClients(FakeClients):
    """FakeClients whose syncs commit as soon as they are sent, in order,
    through the commit queue the warm-up reads."""

    def __init__(self, n_docs, seed=SEED):
        import queue
        super().__init__(n_docs, seed)
        self.commits = queue.Queue()
        self.clock = lambda: 0.0

    def send(self, doc, sync, due):
        super().send(doc, sync, due)
        self.commits.put((doc, 0.0))

    def _commit(self, doc, t):
        return self.inflight.pop(doc, None)


def test_the_warm_up_runs_the_loop_on_draws_of_its_own():
    """The warm-up sends one sync a client, then `warm_syncs` more as its
    syncs commit, one in flight a document, and leaves the window's draws
    as a run without it would make them."""
    c = LoopClients(64)
    a = _arrivals(c, warm_syncs=40)
    a.warm(0.0)
    assert len(c.sent) == 4 + 40
    assert len(c.inflight) == 4
    assert c.commits.qsize() == 4        # the caller waits for the last
    c.inflight.clear()
    b = _arrivals(FakeClients(64))
    assert [a.draw() for _ in range(50)] == [b.draw() for _ in range(50)]
    cold = _arrivals(LoopClients(64, seed=SEED + 1), warm_syncs=40)
    cold.warm(0.0)
    assert cold.c.sent != c.sent


def test_too_many_clients_for_the_corpus_refuse():
    with pytest.raises(ValueError):
        _arrivals(FakeClients(6), clients=4)


# ---- the readers ------------------------------------------------------------------

def _snap(builds, syncs, hydrations, phases, residency):
    snap = {"totals": {"builds": builds, "syncs": syncs},
            "hydration": {"hydrations": hydrations}}
    if phases is not None:
        snap["flush_phases"] = {"seconds": phases}
    if residency is not None:
        snap["residency"] = residency
    return snap


def _ctx(before, after, ops=(30, 70)):
    syncs = []
    for i, n in enumerate(ops):
        s = Sync(f"doc{i}", 0.0, n)
        s.committed = 0.5
        syncs.append(s)
    return {"syncs": syncs, "t_end": 1.0, "window_s": 2.0,
            "sched_before": before, "sched_after": after, "trace": None}


def _res(load_s, loads, hold_s):
    return {"load_s": load_s, "loads": loads, "save_s": 2 * hold_s,
            "saves": loads, "save_hold_s": hold_s, "save_holds": loads}


def test_the_six_readers_on_a_window():
    before = _snap(10, 100, 5, {"extract": 1.0, "build": 0.5, "gate": 0.1},
                   _res(0.2, 10, 0.05))
    after = _snap(70, 200, 45, {"extract": 1.5, "build": 0.6,
                                "gate": 0.102}, _res(0.28, 30, 0.0505))
    ctx = _ctx(before, after)
    read = {m: metrics.load(m)(ctx) for m in READERS}
    assert read["card_miss_pct"] == pytest.approx(60.0)
    assert read["cold_sync_pct"] == pytest.approx(40.0)
    assert read["build_us_per_op"] == pytest.approx(1000.0)
    assert read["gate_us_per_op"] == pytest.approx(20.0)
    assert read["home_load_ms"] == pytest.approx(4.0)
    assert read["snapshot_hold_us_per_op"] == pytest.approx(5.0)


def test_the_readers_fall_silent_on_a_program_without_the_tier():
    """The parent of this cell: no `build` or `gate` phase, no
    `residency` block; and a window with no sync or no load."""
    old = _snap(10, 100, 0, {"extract": 1.0}, None)
    ctx = _ctx(old, _snap(20, 200, 0, {"extract": 2.0}, None))
    for m in ("build_us_per_op", "gate_us_per_op", "home_load_ms",
              "snapshot_hold_us_per_op"):
        assert metrics.load(m)(ctx) is None, m
    idle = _snap(10, 100, 5, {"build": 0.0, "gate": 0.0}, _res(0, 0, 0))
    ctx = _ctx(idle, idle)
    assert metrics.load("card_miss_pct")(ctx) is None
    assert metrics.load("cold_sync_pct")(ctx) is None
    assert metrics.load("home_load_ms")(ctx) is None
    assert metrics.load("build_us_per_op")(_ctx(idle, idle, ops=())) is None


# ---- planted faults ---------------------------------------------------------------

@pytest.fixture
def in_window(monkeypatch):
    """True once the window opens (the first call of Clients.start)."""
    from dtbench.traffic.clients import Clients
    state = {"on": False}
    real_start = Clients.start

    def start(self, t0, t_end):
        state["on"] = True
        return real_start(self, t0, t_end)
    monkeypatch.setattr(Clients, "start", start)
    return state


def test_an_eviction_that_drops_the_unsaved_suffix_is_not_correct(
        monkeypatch, in_window):
    """Warm-tier evictions in the window pop the document without saving
    what its home lacks: its next open, and the check's read of a cold
    document, miss those ops."""
    from diamond_types_tpu_torch.serve.hydrate import Hydrator
    real = Hydrator.evict_to_snapshot

    def lossy(self, doc_id, why="explicit"):
        if not in_window["on"]:
            return real(self, doc_id, why)
        with self._hydrate_lock:
            self._warm.pop(doc_id, None)
            self._touched.pop(doc_id, None)
            self._evicting.discard(doc_id)
        return True
    monkeypatch.setattr(Hydrator, "evict_to_snapshot", lossy)
    cell, config, mix, specs = tiny_tiered()
    r = run_cell(cell, config, mix, specs, SEED, 2.0, False, "cpu")
    assert not r["correct"]
    c = r["checks"]
    assert c["mismatched_docs"]["value"] + c["lagging_sessions"]["value"] > 0


def test_a_home_load_that_drops_its_last_patch_is_not_correct(
        monkeypatch, in_window):
    """Loads in the window decode every record of a home but its last
    patch: a cold open rebuilds the document without its newest ops. The
    tier counts the ops it appends, so every such document reads as
    lagging, in the sample or not."""
    from diamond_types_tpu_torch.storage import pages, tier

    class LastPatchDropped(pages.PagedStore):
        """The page store `TieredStore.load` opens (saves open theirs
        through `PagedDocFile`, untouched)."""

        def records(self, stream):
            recs = list(super().records(stream))
            if in_window["on"] and stream == pages.PagedDocFile.PATCHES \
                    and len(recs) > 1:
                recs = recs[:-1]
            return iter(recs)
    monkeypatch.setattr(tier, "PagedStore", LastPatchDropped)
    cell, config, mix, specs = tiny_tiered()
    r = run_cell(cell, config, mix, specs, SEED, 2.0, False, "cpu")
    assert not r["correct"]
    assert r["checks"]["lagging_sessions"]["value"] > 0


@pytest.mark.cuda
def test_tiered_cell_runs_correct_on_the_card(cuda_card):
    import json
    import os
    import subprocess
    import sys
    from conftest import ROOT
    out = subprocess.run(
        [sys.executable, "-m", "dtbench", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(READERS) <= set(got)
    assert got["card_miss_pct"] > 0 and got["cold_sync_pct"] > 0
