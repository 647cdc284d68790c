"""The port's follower-read tier (`read/`) against the JAX package's.

`read/cache.py`, `read/follower.py`, `read/metrics.py` and
`read/__init__.py` are byte-identical copies; `read/path.py` differs only
where it materializes a checkout (through `store.checkout`, on the store's
device) and `read/bench.py` only by its `device` keyword. Every case of
`tests/test_read.py` runs through both packages: the index, cache and
metrics units return what they observe, which must be equal; the two-server
acceptance cases run the same script over JAX servers (the host engine)
and port servers on `device="cpu"` (the fused device scheduler, K2 and K1
in their plain versions), and the sequence of statuses and read sources
each sees must be equal; the read bench runs in both and each must pass.

Beyond those: the `read` block of `/metrics` has JAX's keys; the
scheduler's `read_invalidate` hook fires for every document a flush
commits, on the per-shard path and in the flush window, under capacity
pressure too, as JAX's does; the Hydrator's `on_warm` pre-materializes
the checkout cache; and `serve(follower_reads=True)` serves a
follower-local read.
"""

import collections
import importlib
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from torch_parity import serve_docs, serve_round

pytestmark = pytest.mark.read

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = ROOTS = ("diamond_types_tpu", "diamond_types_tpu_torch")
COPIED = ("read/cache.py", "read/follower.py", "read/metrics.py",
          "read/__init__.py")


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _both(case, *args):
    """`case(root, *args)` for JAX, then the port; the port's observation
    must equal JAX's."""
    jax_obs = case(JAX, *args)
    port_obs = case(PORT, *args)
    assert port_obs == jax_obs
    return port_obs


def _diff_lines(rel):
    """The (JAX, port) lines of `rel` that differ, in order."""
    import difflib
    a = (REPO / JAX / rel).read_text().splitlines()
    b = (REPO / PORT / rel).read_text().splitlines()
    out = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            a=a, b=b, autojunk=False).get_opcodes():
        if tag != "equal":
            out.append((a[i1:i2], b[j1:j2]))
    return out


# ---- the copies ---------------------------------------------------------------

@pytest.mark.parametrize("rel", COPIED)
def test_module_is_a_byte_identical_copy(rel):
    assert (REPO / PORT / rel).read_bytes() == (REPO / JAX / rel).read_bytes()


def test_read_path_differs_only_in_its_checkouts():
    diffs = _diff_lines("read/path.py")
    # the module docstring's note, then the two materializations
    assert len(diffs) == 3
    assert diffs[0][0] == [] and "store.checkout" in " ".join(diffs[0][1])
    for jax_lines, port_lines in diffs[1:]:
        assert [ln.strip() for ln in jax_lines] == \
            ["return ol.checkout(frontier).snapshot()"]
        assert [ln.strip() for ln in port_lines] == \
            ["return self.store.checkout(ol, frontier).snapshot()"]


def test_read_bench_differs_only_by_its_device():
    added = [ln for _j, p in _diff_lines("read/bench.py") for ln in p]
    removed = [ln for j, _p in _diff_lines("read/bench.py") for ln in j]
    assert all("device" in ln or "resolve_device" in ln or "serve_shards"
               in ln or "progress" in ln for ln in removed)
    assert any("resolve_device(device)" in ln for ln in added)
    assert any("serve(port=0, serve_shards=serve_shards, device=device)"
               in ln for ln in added)


def test_package_exports_match():
    jr, tr = (_mod(r, "read") for r in ROOTS)
    assert tr.__all__ == jr.__all__
    assert all(hasattr(tr, name) for name in tr.__all__)


# ---- FollowerIndex ----------------------------------------------------------------

def _index_no_evidence(root):
    idx = _mod(root, "read").FollowerIndex()
    return (idx.staleness("d", "owner", lambda fr: True),
            idx.lag("d", "owner", lambda fr: True))


def test_index_no_evidence_is_unbounded():
    assert _both(_index_no_evidence) == (None, None)


def _index_advert(root):
    idx = _mod(root, "read").FollowerIndex()
    idx.note_advert("d", "owner", [["a", 3]], as_of=100.0)
    return (idx.staleness("d", "owner", lambda fr: True, now=100.5),
            idx.staleness("d", "owner", lambda fr: False, now=100.5))


def test_index_advert_bounds_staleness_only_when_dominated():
    st, not_dominated = _both(_index_advert)
    assert st == pytest.approx(0.5)
    assert not_dominated is None


def _index_reconcile(root):
    idx = _mod(root, "read").FollowerIndex()
    idx.note_reconciled("d", "owner", as_of=200.0)
    first = idx.staleness("d", "owner", lambda fr: False, now=201.0)
    idx.note_reconciled("d", "owner", as_of=150.0)
    return first, idx.staleness("d", "owner", lambda fr: False, now=201.0)


def test_index_reconcile_floor_needs_no_dominance():
    first, after = _both(_index_reconcile)
    assert first == pytest.approx(1.0) and after == pytest.approx(1.0)


def _index_tightest(root):
    idx = _mod(root, "read").FollowerIndex()
    idx.note_reconciled("d", "owner", as_of=100.0)
    idx.note_advert("d", "owner", [["a", 1]], as_of=104.0)
    return (idx.staleness("d", "owner", lambda fr: True, now=105.0),
            idx.staleness("d", "owner", lambda fr: True, now=103.0))


def test_index_takes_tightest_bound_and_clamps():
    st, future = _both(_index_tightest)
    assert st == pytest.approx(1.0)
    assert future == 0.0


def _index_per_peer(root):
    idx = _mod(root, "read").FollowerIndex()
    idx.note_advert("d", "old-owner", [["a", 9]], as_of=300.0)
    idx.note_advert("d", "owner", [["a", 2]], as_of=310.0)
    out = [idx.advert_of("d", "owner"),
           idx.staleness("d", "owner", lambda fr: True, now=311.0)]
    idx.note_advert("d", "owner", [["a", 1]], as_of=305.0)
    return out + [idx.advert_of("d", "owner")[1], idx.snapshot()]


def test_index_adverts_are_per_peer():
    advert, st, as_of, snap = _both(_index_per_peer)
    assert advert == ([["a", 2]], 310.0)
    assert st == pytest.approx(1.0) and as_of == 310.0
    assert snap == {"docs": 1, "adverts": 2, "reconciled": 0}


def _index_lag(root):
    idx = _mod(root, "read").FollowerIndex()
    idx.note_advert("d", "owner", [["a", 5], ["b", 2]], as_of=1.0)
    have = {("a", 5)}
    out = [idx.lag("d", "owner",
                   lambda fr: tuple((h[0], h[1]) for h in fr)[0] in have)]
    have.add(("b", 2))
    out.append(idx.lag("d", "owner", lambda fr: (fr[0][0], fr[0][1]) in have))
    idx.forget("d")
    out.append(idx.lag("d", "owner", lambda fr: True))
    return out


def test_index_lag_counts_missing_heads():
    assert _both(_index_lag) == [1, 0, None]


def _frontier_known(root):
    frontier_known = _mod(root, "read.follower").frontier_known
    ol = _mod(root, "text.oplog").OpLog()
    a = ol.get_or_create_agent_id("alice")
    ol.add_insert(a, 0, "hey")
    remote = ol.cg.local_to_remote_frontier(ol.version)
    agent, seq = remote[0][0], int(remote[0][1])
    return [frontier_known(ol, remote),
            frontier_known(ol, [[agent, seq + 1]]),
            frontier_known(ol, [["nobody", 0]])]


def test_frontier_known_against_real_oplog():
    assert _both(_frontier_known) == [True, False, False]


# ---- CheckoutCache --------------------------------------------------------------

def _cache_lru(root):
    read = _mod(root, "read")
    m = read.ReadMetrics()
    c = read.CheckoutCache(capacity=2, metrics=m)
    k = _mod(root, "read.cache").frontier_key([["a", 1]])
    out = [c.get("d0", k, lambda: "v0"), c.get("d0", k, lambda: "BOOM")]
    c.get("d1", k, lambda: "v1")
    c.get("d0", k, lambda: "BOOM")
    c.get("d2", k, lambda: "v2")
    out.append(c.get("d1", k, lambda: "v1b"))
    return out + [m.snapshot()["counters"]]


def test_cache_hit_miss_and_lru_eviction():
    *gets, counters = _both(_cache_lru)
    assert gets == [("v0", "miss"), ("v0", "hit"), ("v1b", "miss")]
    assert counters["cache_hits"] == 2 and counters["cache_misses"] == 4
    assert counters["cache_evictions"] >= 1


def _cache_invalidate(root):
    read = _mod(root, "read")
    frontier_key = _mod(root, "read.cache").frontier_key
    m = read.ReadMetrics()
    c = read.CheckoutCache(capacity=8, metrics=m)
    for seq in (1, 2, 3):
        c.get("d0", frontier_key([["a", seq]]), lambda: f"v{seq}")
    c.get("other", frontier_key([["a", 1]]), lambda: "keep")
    return [c.invalidate("d0"), len(c), c.invalidate("d0"),
            c.get("other", frontier_key([["a", 1]]), lambda: "BOOM"),
            m.snapshot()["counters"]["invalidated_entries"]]


def test_cache_invalidate_drops_every_frontier_of_doc():
    assert _both(_cache_invalidate) == [3, 1, 0, ("keep", "hit"), 3]


def _cache_single_flight(root):
    read = _mod(root, "read")
    m = read.ReadMetrics()
    c = read.CheckoutCache(capacity=8, metrics=m)
    k = _mod(root, "read.cache").frontier_key([["a", 1]])
    entered, release = threading.Event(), threading.Event()
    calls, results = [], []

    def materialize():
        calls.append(1)
        entered.set()
        release.wait(5)
        return "value"

    lt = threading.Thread(
        target=lambda: results.append(c.get("d", k, materialize)))
    lt.start()
    assert entered.wait(5)
    ws = [threading.Thread(
        target=lambda: results.append(c.get("d", k, lambda: "WRONG")))
        for _ in range(3)]
    for w in ws:
        w.start()
    time.sleep(0.05)        # waiters parked on the flight event
    release.set()
    lt.join(5)
    for w in ws:
        w.join(5)
    return [len(calls), sorted({r[0] for r in results}),
            sorted(r[1] for r in results),
            m.snapshot()["counters"]["cache_coalesced"]]


def test_cache_single_flight_coalesces_flash_crowd():
    assert _both(_cache_single_flight) == [
        1, ["value"], ["coalesced", "coalesced", "coalesced", "miss"], 3]


def _cache_leader_failure(root):
    c = _mod(root, "read").CheckoutCache(capacity=8, flight_timeout_s=2.0)
    k = _mod(root, "read.cache").frontier_key([["a", 1]])
    entered = threading.Event()
    raised = []

    def bad():
        entered.set()
        time.sleep(0.1)
        raise RuntimeError("materialize failed")

    def leader():
        try:
            c.get("d", k, bad)
        except RuntimeError as e:
            raised.append(str(e))

    lt = threading.Thread(target=leader)
    lt.start()
    assert entered.wait(5)
    mine = c.get("d", k, lambda: "mine")
    lt.join(5)
    return [mine, raised, len(c)]


def test_cache_leader_failure_releases_waiters():
    assert _both(_cache_leader_failure) == [("mine", "timeout"),
                                            ["materialize failed"], 0]


# ---- ReadMetrics ------------------------------------------------------------------

def _metrics_shape(root):
    read = _mod(root, "read")
    m = read.ReadMetrics()
    with pytest.raises(KeyError):
        m.bump("no_such_counter")
    m.bump("reads", 4)
    m.bump("local", 3)
    m.bump("proxied_staleness")
    m.observe_staleness(0.25)
    snap = m.snapshot()
    return [snap["version"], set(snap["counters"]) == set(read.READ_KEYS),
            snap["proxied"], snap["local_ratio"], snap["staleness"]["count"],
            read.ReadMetrics().snapshot()["local_ratio"], sorted(snap)]


def test_metrics_fixed_keys_and_snapshot_shape():
    got = _both(_metrics_shape)
    assert got[:6] == [2, True, 1, pytest.approx(0.75), 1, None]


def _prom_read(root):
    render_metrics = _mod(root, "obs.prom").render_metrics
    m = _mod(root, "read").ReadMetrics()
    m.bump("reads", 2)
    m.bump("local", 2)
    m.observe_staleness(0.1)
    m.observe_wait(0.02)
    text = render_metrics({"read": m.snapshot()})
    sm = _mod(root, "serve.metrics").ServeMetrics(n_shards=1, flush_docs=8,
                                                  max_pending=64)
    sm.read = m
    text2 = render_metrics({"serve": sm.snapshot()})
    return [text, text2.count("dt_read_reads_total 2"),
            sorted(ln for ln in text2.splitlines()
                   if ln.startswith("dt_read_"))]


def test_prom_renders_read_families():
    text, once, read_lines = _both(_prom_read)
    for line in ("dt_read_reads_total 2", "dt_read_local_total 2",
                 "dt_read_local_ratio 1",
                 "dt_read_staleness_seconds_count 1",
                 "dt_read_wait_latency_seconds_count 1"):
        assert line in text
    assert once == 1 and read_lines


def test_metrics_read_block_matches_jax_keys():
    """The serve block's `read`: null until a ReadPath is attached, then
    the ReadMetrics snapshot, key for key JAX's; every other key of the
    snapshot is JAX's but the Pallas rung's fallback counter."""
    snaps = {}
    for root in ROOTS:
        sm = _mod(root, "serve.metrics").ServeMetrics(2, 4, 64)
        before = sm.snapshot()
        sm.read = _mod(root, "read").ReadMetrics()
        sm.read.bump("reads")
        snaps[root] = (before, sm.snapshot())
    (jb, ja), (tb, ta) = snaps[JAX], snaps[PORT]
    assert jb["read"] is None and tb["read"] is None
    assert set(ta) == set(ja)
    assert set(ta["read"]) == set(ja["read"])
    assert set(ta["read"]["counters"]) == set(ja["read"]["counters"])
    assert ta["read"]["counters"] == ja["read"]["counters"]
    assert set(ja["totals"]) - set(ta["totals"]) == {"pallas_fallbacks"}
    assert ta["version"] == 4


# ---- two-server acceptance ----------------------------------------------------------

def _serve(root, **kw):
    if root == PORT:
        kw.setdefault("device", "cpu")
    return _mod(root, "tools.server").serve(**kw)


def _mesh2(root, faults=None, read_opts=None, via_serve=False):
    """Two servers in one mesh with follower reads: attached after boot
    (`attach_follower_reads`, as `tests/test_read.py` does), or booted
    with `serve(follower_reads=True)`."""
    attach_replication = _mod(root, "replicate").attach_replication
    attach_follower_reads = _mod(root, "read").attach_follower_reads
    httpds, addrs, nodes = [], [], []
    for _ in range(2):
        httpd = _serve(root, port=0, serve_shards=1,
                       follower_reads=via_serve,
                       read_opts=read_opts if via_serve else None)
        httpds.append(httpd)
        addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
    for i, httpd in enumerate(httpds):
        nodes.append(attach_replication(
            httpd, addrs[i], [a for a in addrs if a != addrs[i]],
            faults=faults, lease_ttl_s=30.0, timeout_s=0.5,
            backoff_base_s=0.01, backoff_cap_s=0.05))
        if not via_serve:
            attach_follower_reads(httpd.store, **(read_opts or {}))
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()
    return httpds, nodes, addrs


def _teardown(httpds):
    for h in httpds:
        h.shutdown()
        h.server_close()


def _step(nodes, rounds=1):
    for _ in range(rounds):
        for n in nodes:
            n.table.probe_once()
            n.maintain()
        for n in nodes:
            n.antientropy.run_round()


def _edit(addr, doc, agent, version, text):
    req = urllib.request.Request(
        f"http://{addr}/doc/{doc}/edit",
        data=json.dumps({"agent": agent, "version": version,
                         "ops": [{"kind": "ins", "pos": 0,
                                  "text": text}]}).encode("utf8"))
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read())["version"]


def _read(addr, doc, max_staleness=None, token=None):
    """Returns (status, headers, body-dict-or-None)."""
    url = f"http://{addr}/doc/{doc}/state"
    if max_staleness is not None:
        url += f"?max_staleness={max_staleness}"
    headers = {}
    if token is not None:
        headers["X-DT-Min-Version"] = json.dumps(token)
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, dict(e.headers), \
            (json.loads(body) if body else None)


def _settle_owner(nodes, doc):
    for _ in range(200):
        _step(nodes)
        holders = [n for n in nodes if n.leases.active_epoch(doc) > 0]
        if len(holders) == 1:
            owner = holders[0]
            follower = next(n for n in nodes if n is not owner)
            if follower.route_mutation(doc) == owner.self_id:
                return owner, follower
        time.sleep(0.02)
    raise AssertionError("lease never settled")


def _dominated(headers, token):
    heads = {a: int(s)
             for a, s in json.loads(headers["X-DT-Frontier"])}
    return all(heads.get(a, -1) >= int(s) for a, s in token)


def _partition_story(root):
    """`tests/test_read.py`'s acceptance story; returns what each step
    saw: statuses, read sources, body checks and counter floors."""
    faults = _mod(root, "replicate").FaultInjector(seed=3)
    httpds, nodes, addrs = _mesh2(root, faults=faults,
                                  read_opts={"max_wait_s": 0.05})
    seen = []
    try:
        doc = "accept0"
        _edit(addrs[0], doc, "w", [], "hello ")
        owner, follower = _settle_owner(nodes, doc)
        _step(nodes, rounds=2)
        st, hdr, body = _read(follower.self_id, doc, max_staleness=10.0)
        seen.append((st, hdr["X-DT-Read-Source"],
                     float(hdr["X-DT-Staleness"]) <= 10.0,
                     hdr["Cache-Control"], "hello" in body["text"]))
        st, hdr, _ = _read(follower.self_id, doc, max_staleness=0.0)
        seen.append((st, hdr["X-DT-Read-Source"]))
        faults.partition(owner.self_id, follower.self_id)
        time.sleep(0.25)
        st, _, body = _read(follower.self_id, doc, max_staleness=0.01)
        seen.append((st, body["error"]))
        token = _edit(owner.self_id, doc, "w", None, "more ")
        st, _, _ = _read(follower.self_id, doc, max_staleness=10.0,
                         token=token)
        fm = follower.store.reads.metrics.snapshot()["counters"]
        seen.append((st, fm["refused"] >= 2, fm["catchup_timeouts"] >= 1))
        faults.heal(owner.self_id, follower.self_id)
        for _ in range(50):
            _step(nodes)
            st, hdr, body = _read(follower.self_id, doc,
                                  max_staleness=10.0, token=token)
            if st == 200 and hdr["X-DT-Read-Source"] == "local":
                break
            time.sleep(0.02)
        fm = follower.store.reads.metrics.snapshot()["counters"]
        seen.append((st, hdr["X-DT-Read-Source"], _dominated(hdr, token),
                     "more" in body["text"], fm["local"] >= 2,
                     fm["adverts"] >= 1))
        return seen
    finally:
        _teardown(httpds)


def test_follower_partition_refuses_then_honors_token_after_heal():
    assert _both(_partition_story) == [
        (200, "local", True, "no-store", True), (200, "proxied"),
        (503, "read contract unsatisfiable"), (503, True, True),
        (200, "local", True, True, True, True)]


def _proxy_loop(root):
    httpds, nodes, addrs = _mesh2(root, read_opts={"max_wait_s": 0.05})
    try:
        doc = "loop0"
        _edit(addrs[0], doc, "w", [], "x")
        owner, follower = _settle_owner(nodes, doc)
        req = urllib.request.Request(
            f"http://{follower.self_id}/doc/{doc}/state",
            headers={"X-DT-Proxied": "1",
                     "X-DT-Min-Version": json.dumps([["w", 10_000]])})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        ei.value.read()
        snap = follower.store.reads.metrics.snapshot()["counters"]
        return [ei.value.code, snap["proxied_forced"] >= 1,
                snap["refused"] >= 1]
    finally:
        _teardown(httpds)


def test_owner_side_of_proxy_never_loops():
    assert _both(_proxy_loop) == [503, True, True]


def _read_bench(root):
    kw = {"device": "cpu"} if root == PORT else {}
    report = _mod(root, "read.bench").run_read_bench(
        docs=2, readers=2, reads_per_reader=10, seed=11, doc_bytes=2048,
        min_speedup=None, **kw)
    return [report["ok"], report["settled"], report["violations"],
            report["errors"], report["control"]["reads"],
            report["follower"]["reads"], report["follower"]["local"],
            report["control"]["proxied"],
            sorted({s["version"] for s in report["read_metrics"].values()}),
            sorted(report)]


def test_read_bench_smoke_end_to_end():
    assert _both(_read_bench)[:9] == [True, True, 0, 0, 20, 20, 20, 20, [2]]


# ---- the hooks ----------------------------------------------------------------------

def test_serve_with_follower_reads_serves_a_follower_local_read():
    """`serve(follower_reads=True)`: each server's scheduler has its read
    path's invalidation hook, its metrics the read block, and a follower
    answers a bounded read locally."""
    httpds, nodes, addrs = _mesh2(PORT, via_serve=True,
                                  read_opts={"max_wait_s": 0.05})
    try:
        for h in httpds:
            sched, reads = h.store.scheduler, h.store.reads
            assert sched.read_invalidate == reads.on_flush
            assert sched.metrics.read is reads.metrics
        doc = "served0"
        _edit(addrs[0], doc, "w", [], "please ")
        owner, follower = _settle_owner(nodes, doc)
        # an edit at the lease holder: its flush invalidates the doc's
        # checkout-cache entries there
        _edit(owner.self_id, doc, "w", None, "local ")
        owner.store.scheduler.drain()
        om = owner.store.reads.metrics.snapshot()["counters"]
        assert om["flush_invalidations"] >= 1
        _step(nodes, rounds=2)
        st, hdr, body = _read(follower.self_id, doc, max_staleness=10.0)
        assert st == 200 and hdr["X-DT-Read-Source"] == "local"
        with urllib.request.urlopen(f"http://{owner.self_id}/doc/{doc}",
                                    timeout=5) as r:
            assert body["text"] == r.read().decode("utf8")
        assert sorted(body["text"].split()) == ["local", "please"]
        m = json.loads(urllib.request.urlopen(
            f"http://{follower.self_id}/metrics", timeout=5).read())
        assert m["serve"]["read"]["counters"]["local"] >= 1
    finally:
        _teardown(httpds)


FUSED = {"cap": 256, "max_ins": 4}


def _invalidations(window: bool, max_sessions: int, rounds: int = 3):
    """The serve tape through one scheduler per package with a recorder on
    `read_invalidate`; per round, the documents each invalidated. JAX's
    window runs its device engine on a one-device mesh, its per-shard path
    the host engine (the hook is per flushed item, whatever the engine)."""
    from diamond_types_tpu.parallel import mesh as jmesh
    from diamond_types_tpu.serve.scheduler import \
        MergeScheduler as JaxScheduler
    from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
    from diamond_types_tpu_torch.serve.scheduler import MergeScheduler
    from diamond_types_tpu_torch.text.oplog import OpLog
    docs = serve_docs([JaxOpLog, OpLog], 10, seed=3)
    logs = [{d: tw.oplogs[k] for d, tw in docs.items()} for k in (0, 1)]
    common = dict(flush_docs=4, flush_deadline_s=10.0, flush_workers=False,
                  max_sessions_per_shard=max_sessions)
    if window:
        js = JaxScheduler(2, resolve=logs[0].__getitem__, engine="device",
                          fused_opts=FUSED, device_plan=True,
                          mesh_window=True, **common)
        js._mesh = jmesh.serve_mesh(1)
    else:
        js = JaxScheduler(2, resolve=logs[0].__getitem__, engine="host",
                          **common)
    ts = MergeScheduler(2, resolve=logs[1].__getitem__, engine="device",
                        device_plan=True, mesh_window=window,
                        fused_opts=dict(FUSED, device="cpu"), **common)
    got = {JAX: [], PORT: []}
    for root, s in ((JAX, js), (PORT, ts)):
        s.read_invalidate = got[root].append
    per_round = []
    for rnd in range(rounds):
        marks = {r: len(v) for r, v in got.items()}
        subs = serve_round(docs, 11, rnd)
        for d, n in subs:
            for s in (js, ts):
                assert s.submit(d, n_ops=n)["accepted"]
        for s in (js, ts):
            s.pump()
            s.drain()
        for d in docs:
            want = logs[1][d].checkout_tip().snapshot()
            assert ts.text(d) == js.text(d) == want, (rnd, d)
        per_round.append({
            "submitted": sorted({d for d, _n in subs}),
            **{r: collections.Counter(v[marks[r]:])
               for r, v in got.items()}})
    return per_round, ts.metrics_json()["totals"]


@pytest.mark.parametrize("window,max_sessions", [(False, 8), (True, 8),
                                                 (True, 2)])
def test_read_invalidate_fires_for_every_committed_document(window,
                                                            max_sessions):
    """Per round, both schedulers invalidate the same documents the same
    number of times, and every submitted document at least once. With 2
    sessions a shard the port's window re-syncs capacity-pressure victims
    on the per-doc rung (ROADMAP §3); they are invalidated all the same."""
    per_round, totals = _invalidations(window, max_sessions)
    for r in per_round:
        assert r[PORT] == r[JAX]
        assert sorted(r[PORT]) == r["submitted"]
    if window and max_sessions == 2:
        assert totals["evictions"] > 0


def _on_warm(root, tmp_path):
    """A server whose scheduler has a Hydrator when follower reads attach:
    a hydration pre-materializes the checkout cache, so the first read is
    a cache hit."""
    tier = _mod(root, "storage.tier")
    Hydrator = _mod(root, "serve.hydrate").Hydrator
    OpLog = _mod(root, "text.oplog").OpLog
    store = tier.TieredStore(str(tmp_path / root / "tier"))
    ol = OpLog()
    ol.add_insert(ol.get_or_create_agent_id("a"), 0, "warm me up")
    store.save("cold", ol)
    httpd = _serve(root, port=0, serve_shards=1)
    hyd = Hydrator(store, warm_max=4, workers=1)
    try:
        httpd.store.scheduler.attach_hydrator(hyd)
        rp = _mod(root, "read").attach_follower_reads(httpd.store)
        wired = hyd.on_warm == rp.warm_on_hydrate
        warm = hyd.resolve("cold")
        remote = warm.cg.local_to_remote_frontier(list(warm.version))
        fkey = _mod(root, "read.cache").frontier_key(remote)
        hit = rp.cache.get("cold", fkey, lambda: "BOOM")
        c = rp.metrics.snapshot()["counters"]
        return [wired, len(rp.cache), hit, c["warmed_on_hydrate"],
                c["cache_misses"], c["cache_hits"]]
    finally:
        hyd.stop(checkpoint=False)
        httpd.server_close()


def test_on_warm_pre_materializes_on_hydration(tmp_path):
    assert _both(_on_warm, tmp_path) == [True, 1, ("warm me up", "hit"),
                                         1, 1, 1]
