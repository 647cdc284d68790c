"""The port's replication layer (`replicate/`) against the JAX package's.

Every module of the port's `replicate/` is a byte-identical copy of the
JAX package's except `__init__.py`, whose docstring names what is
ported; the exports are the same. The units of `tests/test_replicate.py`,
`tests/test_writergroup.py` and `tests/test_rebalance.py` (backoff,
retries, fault injection, rendezvous placement, the lease state machine,
the promise protocol, the replica journal, membership, writer groups,
placement overrides and the rebalancer) run through both packages with the
same seeds, and what each observes must be equal.

The mesh cases (the two-server smoke, proxy routing, handoff, the
circuit breaker, convergence under faults, wire frames and the
Prometheus families, the mixed-version mesh, and the writer groups' live
mesh) run the same script once over JAX servers (`tools.server.serve`,
the host engine) and once over the port's servers on `device="cpu"` (the
fused device engine with the device plan, K2 and K1 in their plain
versions), with the lock witness of each package on. Ports are ephemeral
and rendezvous placement hashes them, so observations are taken relative
to each document's owner; both runs must agree on the final texts, on the
owners' and followers' lease states and epochs after each scripted step,
on the key sets of `/metrics` (with the node addresses named by role) and
of the Prometheus families, and the port's witness graph must stay
acyclic. The serve block of the port's metrics lacks
`totals.pallas_fallbacks` (no Pallas rung), and nothing else; the
two-server smoke runs with follower reads, so its `read` blocks are held
equal key for key.

Across the packages: a `ReplicaJournal` written by either is restored by
the other (the same script writes byte-identical files), and a JAX server
(host engine) and a port server converge in one mesh over the wire
protocol, as a rolling upgrade from the reference to the port would run.
"""

import difflib
import importlib
import json
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

pytestmark = pytest.mark.replicate

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = ROOTS = ("diamond_types_tpu", "diamond_types_tpu_torch")
COPIED = ("replicate/faults.py", "replicate/metrics.py",
          "replicate/peers.py", "replicate/membership.py",
          "replicate/ownership.py", "replicate/quorum.py",
          "replicate/writergroup.py", "replicate/rebalance.py",
          "replicate/antientropy.py")
# serve-block keys of JAX's /metrics the port does not have (the Pallas
# rung's fallback counter)
SERVE_ONLY_IN_JAX = {"serve.totals.pallas_fallbacks"}
PROM_ONLY_IN_JAX = {"dt_serve_pallas_fallbacks_total"}
# devprof's jit-cache block and its families in JAX's /metrics: the port
# has no jit cache
JIT_ONLY_IN_JAX = {"obs.devprof.jit_cache"}
JIT_PROM_ONLY_IN_JAX = {"dt_devprof_jit_hits_total",
                        "dt_devprof_jit_misses_total",
                        "dt_devprof_jit_hit_rate"}
# the port's flush timing (serve/metrics.py, schema version 5), its
# linearizer counters (6), its zone-session counters (7) and its residency
# tier's timers (8): the key paths under these prefixes and these families
# are the port's alone
SERVE_ONLY_IN_PORT = ("serve.flush_phases", "serve.latencies.admit_wait",
                      "serve.latencies.oplog_hold",
                      "serve.transform.linearized_", "serve.zone",
                      "serve.residency")
PROM_ONLY_IN_PORT = {"dt_serve_flush_phase_seconds_total",
                     "dt_serve_oplog_wait_seconds_total",
                     "dt_admit_wait_latency_seconds",
                     "dt_oplog_hold_latency_seconds",
                     "dt_serve_linearize_total"}


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _both(scenario, *args):
    """Run `scenario(root, *args)` for JAX, then the port; hold the
    port's observations equal to JAX's and return them."""
    jax_obs = scenario(JAX, *args)
    port_obs = scenario(PORT, *args)
    assert port_obs == jax_obs
    return port_obs


@pytest.fixture
def witnessed():
    """Both packages' lock witnesses on for the test; the port's graph
    must be acyclic, with no unsorted same-class acquisition, after it."""
    wits = [_mod(r, "analysis.witness") for r in ROOTS]
    for w in wits:
        w.witness_enable()
        w.witness_reset()
    try:
        yield
        snap = wits[1].witness_snapshot()
        assert snap["acyclic"], snap["cycles"]
        assert snap["violation_count"] == 0, snap["violations"][:4]
        assert snap["acquires"] > 0
    finally:
        for w in wits:
            w.witness_disable()
            w.witness_reset()


# ---- the copies -----------------------------------------------------------

@pytest.mark.parametrize("rel", COPIED)
def test_module_is_a_byte_identical_copy(rel):
    assert (REPO / PORT / rel).read_bytes() == (REPO / JAX / rel).read_bytes()


def test_node_is_the_jax_node_plus_the_fail_stop():
    """The port's `replicate/node.py` is JAX's with lines added, and only
    inside the probe loop: the fail-stop on a scheduler fault."""
    jax = (REPO / JAX / "replicate/node.py").read_text().splitlines()
    port = (REPO / PORT / "replicate/node.py").read_text().splitlines()
    ops = [op for op in difflib.SequenceMatcher(
        a=jax, b=port, autojunk=False).get_opcodes() if op[0] != "equal"]
    assert [op[0] for op in ops] == ["insert"]
    _tag, i1, _i2, j1, j2 = ops[0]
    assert jax[i1 - 2:i1] == ["                except Exception:   "
                              "# pragma: no cover - keep running",
                              "                    pass"]
    added = port[j1:j2]
    assert '"fault", None) is not None:' in added[1]
    assert added[-3:] == ["                    self.antientropy.stop()",
                          "                    self.table.stop_probe_loop()",
                          "                    return"]


def test_package_exports_match():
    jr, tr = (_mod(r, "replicate") for r in ROOTS)
    assert tr.__all__ == jr.__all__
    for name in jr.__all__:
        obj = getattr(tr, name)
        assert obj.__module__.startswith(PORT + "."), name


def test_mesh_lock_table_matches_jax(tmp_path):
    """The mesh's witness locks carry JAX's names, classes and ranks."""
    def table(root):
        srv = _serve(root, port=0, data_dir=str(tmp_path / root))
        try:
            node = _mod(root, "replicate").attach_replication(
                srv, "127.0.0.1:1", [],
                journal_prefix=str(tmp_path / root / "_replica"))
            store = srv.store
            locks = [store.lock, store.io_lock, node._maintain_lock,
                     node.leases.lock, node.membership._lock,
                     node.table._lock, node.journal._lock,
                     node.writergroups.lock, node.overrides._rebalance_lock,
                     node.wire._frame_cache_lock]
            rb = _mod(root, "replicate.rebalance").Rebalancer(node)
            locks.append(rb._rebalance_lock)
            node.stop()
            return [(lk.name, lk.order_class, lk.rank) for lk in locks]
        finally:
            srv.server_close()

    got = _both(table)
    assert got[:2] == [("store.oplog", "oplog", None),
                       ("store.io", "io", None)]
    assert {n for n, _c, _r in got} >= {
        "repl.peers", "repl.leases", "repl.membership", "repl.journal",
        "repl.writergroup", "repl.maintain", "wire.frames",
        "repl.rebalance.overrides", "repl.rebalance.plan"}


# ---- units: backoff, retries, faults --------------------------------------

def _backoff(root):
    Backoff = _mod(root, "replicate.peers").Backoff
    a = Backoff(base_s=0.1, cap_s=2.0, seed=3, key="x")
    b = Backoff(base_s=0.1, cap_s=2.0, seed=9, key="jit")
    return {"seeded": [a.delay(i) for i in range(12)],
            "jitter": [b.delay(i) for i in range(12)],
            "huge": Backoff(base_s=0.1, cap_s=2.0, seed=5).delay(5000),
            "negative": Backoff(base_s=0.2, cap_s=2.0, seed=1).delay(-5)}


def test_backoff_deterministic_bounded_and_jittered():
    got = _both(_backoff)
    da = got["seeded"]
    assert all(0.05 <= d <= 2.0 for d in da) and da[0] < 0.1 <= da[4]
    for attempt, d in enumerate(got["jitter"]):
        nominal = min(0.1 * (2 ** attempt), 2.0)
        assert nominal * 0.5 <= d < nominal
    assert 1.0 <= got["huge"] <= 2.0 and 0.1 <= got["negative"] < 0.2


def _circuit(root):
    peers = _mod(root, "replicate.peers")
    t = peers.PeerTable("self:0", ["127.0.0.1:9"], fail_threshold=3,
                        backoff_base_s=0.05, backoff_cap_s=60.0, seed=4)
    st = t.peers["127.0.0.1:9"]
    opens = []
    for _ in range(9):
        t._record_failure(st)
        if st.open_until:
            opens.append(st.open_until)
    try:
        t.call("127.0.0.1:9", "/replicate/ping")
        refused = None
    except peers.CircuitOpen as e:
        refused = (e.peer_id, e.retry_at == st.open_until)
    return {"opens": len(opens),
            "growing": all(b > a for a, b in zip(opens, opens[1:])),
            "refused": refused, "state": sorted(t.state("127.0.0.1:9"))}


def test_circuit_open_retry_at_monotonic():
    got = _both(_circuit)
    assert got["opens"] == 7 and got["growing"]
    assert got["refused"] == ("127.0.0.1:9", True)


def _retries(root):
    call_with_retries = _mod(root, "replicate.peers").call_with_retries
    calls, n4xx, out = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "ok"

    out.append(call_with_retries(flaky, retries=3, sleep=lambda s: None))
    out.append(len(calls))

    def always_fails():
        raise ConnectionError("down")

    def client_error():
        n4xx.append(1)
        raise urllib.error.HTTPError("u", 400, "bad", {}, None)

    for fn, retries in ((always_fails, 2), (client_error, 3)):
        try:
            call_with_retries(fn, retries=retries, sleep=lambda s: None)
            out.append(None)
        except (ConnectionError, urllib.error.HTTPError) as e:
            out.append(type(e).__name__)
    out.append(len(n4xx))
    return out


def test_call_with_retries_transient_vs_client_error():
    assert _both(_retries) == ["ok", 3, "ConnectionError", "HTTPError", 1]


def _faults(root):
    faults = _mod(root, "replicate.faults")

    def schedule(inj, n=40):
        out = []
        for _ in range(n):
            try:
                out.append("dup" if inj.before_call("x", "y") else "ok")
            except faults.FaultDrop:
                out.append("drop")
        return out

    out = {"schedule": schedule(faults.FaultInjector(seed=11, drop_rate=0.3,
                                                     dup_rate=0.2))}
    inj = faults.FaultInjector(seed=0)
    inj.partition("a", "b")
    blocked = []
    for src, dst in (("a", "b"), ("b", "a"), ("a", "c")):
        try:
            inj.before_call(src, dst)
            blocked.append(False)
        except faults.FaultDrop:
            blocked.append(True)
    inj.heal("a", "b")
    inj.before_call("a", "b")
    out["partition"] = blocked
    out["partition_snapshot"] = inj.snapshot()
    one = faults.FaultInjector(seed=5)
    one.partition("a", "b", oneway=True)
    try:
        one.before_call("a", "b")
        out["oneway_forward"] = "passed"
    except faults.FaultDrop:
        out["oneway_forward"] = "dropped"
    one.before_call("b", "a")
    out["oneway"] = [one.partitioned("a", "b"), one.partitioned("b", "a")]
    out["oneway_snapshot"] = one.snapshot()
    one.heal("a", "b")
    t0 = time.monotonic()
    one.set_link_latency("a", "c", 0.01, jitter_s=0.005)
    one.before_call("a", "c")
    out["latency_slept"] = time.monotonic() - t0 >= 0.01
    one.before_call("c", "a")
    out["latency_snapshot"] = one.snapshot()
    one.set_link_latency("a", "c", 0.0)
    one.set_clock_skew("b", 0.75)
    out["skew_ahead"] = one.now("b") > one.now("a")
    out["skew_snapshot"] = one.snapshot()
    jit = faults.FaultInjector(seed=8, drop_rate=0.3, dup_rate=0.2)
    jit.set_link_latency("x", "y", 0.0001, jitter_s=0.0001)
    out["jittered_schedule"] = schedule(jit, 30)
    return out


def test_fault_injector_deterministic_partition_latency_skew():
    got = _both(_faults)
    assert "drop" in got["schedule"] and "ok" in got["schedule"]
    assert got["partition"] == [True, True, False]
    assert got["partition_snapshot"]["partition_blocks"] == 2
    assert got["oneway_forward"] == "dropped" and got["oneway"] == [True,
                                                                     False]
    assert got["oneway_snapshot"]["oneway_partitions"] == [["a", "b"]]
    assert got["latency_slept"]
    assert got["latency_snapshot"]["link_delays"] == 1
    assert got["latency_snapshot"]["link_latency"] == {
        "a->c": {"latency_s": 0.01, "jitter_s": 0.005}}
    assert got["skew_ahead"]
    assert got["skew_snapshot"]["clock_skew"] == {"b": 0.75}
    assert got["skew_snapshot"]["link_latency"] == {}
    assert "drop" in got["jittered_schedule"]


# ---- units: ownership, promises, journal, membership ------------------------

def _placement(root):
    owner_of = _mod(root, "replicate.ownership").owner_of
    hosts = ["127.0.0.1:8001", "127.0.0.1:8002", "127.0.0.1:8003"]
    return {"owners": {d: owner_of(d, hosts) for d in
                       (f"doc-{i}" for i in range(64))},
            "reversed": owner_of("doc-3", list(reversed(hosts))),
            "without_non_owner": owner_of("doc-3", hosts[1:])}


def test_owner_rendezvous_process_independent():
    got = _both(_placement)
    assert {d: got["owners"][d] for d in ("doc-0", "doc-3", "doc-5")} == {
        "doc-0": "127.0.0.1:8001", "doc-3": "127.0.0.1:8003",
        "doc-5": "127.0.0.1:8001"}
    assert got["reversed"] == got["without_non_owner"] == "127.0.0.1:8003"


def _lease_machine(root):
    own = _mod(root, "replicate.ownership")
    a = own.LeaseManager("hostA", ttl_s=60.0)
    b = own.LeaseManager("hostB", ttl_s=60.0)
    out = [a.ensure_local("d", True), b.ensure_local("d", False),
           a.get("d").state, a.get("d").epoch]
    b.observe_remote("d", "hostA", 1, own.ACTIVE, ttl_s=60.0)
    out.append(b.ensure_local("d", True))
    b.observe_remote("d", "hostA", 2, own.ACTIVE, ttl_s=0.0)
    out += [b.ensure_local("d", True), b.get("d").epoch, b.get("d").holder]
    out += [a.begin_handoff("d"), a.ensure_local("d", True)]
    a.abort_handoff("d")
    out.append(a.ensure_local("d", True))
    out += [b.accept_grant("e", 5, ttl_s=60.0), b.get("e").state,
            b.ensure_local("e", True), b.activate_grant("e", 5),
            b.activate_grant("e", 5), b.activate_grant("e", 4),
            b.ensure_local("e", True)]
    m = _mod(root, "replicate.metrics").ReplicationMetrics()
    c = own.LeaseManager("hostC", ttl_s=60.0, metrics=m)
    c.observe_remote("d", "hostB", 4, own.ACTIVE, ttl_s=60.0)
    c.observe_remote("d", "hostA", 4, own.ACTIVE, ttl_s=60.0)
    c2 = own.LeaseManager("hostC", ttl_s=60.0)
    c2.observe_remote("d", "hostA", 4, own.ACTIVE, ttl_s=60.0)
    c2.observe_remote("d", "hostB", 4, own.ACTIVE, ttl_s=60.0)
    out += [c.get("d").holder, m.get("leases", "tie_breaks"),
            c2.get("d").holder]
    x = own.LeaseManager("hostA", ttl_s=60.0)
    x.ensure_local("x", True)
    exp = x.get("x").expires_at
    x.observe_remote("x", "hostA", 1, own.ACTIVE, ttl_s=0.0)
    out.append(x.get("x").expires_at == exp)
    return out


def test_lease_state_machine_takeover_and_tie_break():
    own = _mod(PORT, "replicate.ownership")
    assert _both(_lease_machine) == [
        True, False, own.ACTIVE, 1, False, True, 3, "hostB", 2, False, True,
        True, own.GRANTED, False, True, True, False, True,
        "hostA", 1, "hostA", True]


def _promises(root):
    own = _mod(root, "replicate.ownership")
    m = _mod(root, "replicate.metrics").ReplicationMetrics()
    v = own.LeaseManager("voter", ttl_s=60.0, metrics=m)
    out = [v.promise("d", 3, "hostA"), v.promise("d", 3, "hostA"),
           v.promise("d", 3, "hostB"), m.get("quorum", "promise_conflicts"),
           v.promise("d", 2, "hostB"), v.promise("d", 4, "hostB"),
           v.max_epoch_of("d")]
    v.observe_remote("e", "hostA", 5, own.ACTIVE, ttl_s=60.0)
    out.append(v.promise("e", 5, "hostB"))
    h = own.LeaseManager("hostA", ttl_s=60.0,
                         metrics=_mod(root, "replicate.metrics")
                         .ReplicationMetrics())
    out += [h.ensure_local("f", True), h.get("f").epoch,
            h.promise("f", 9, "hostB"), h.max_epoch_of("f"),
            h.ensure_local("f", True),
            h.metrics.get("fencing", "stale_lease_revoked"), h.get("f")]
    return [tuple(o) if isinstance(o, tuple) else o for o in out]


def test_promise_protocol_exclusive_and_fencing():
    got = _both(_promises)
    assert [ok for ok, _why in got[:3]] == [True, True, False]
    assert got[2][1] == "promise_conflict" and got[3] == 1
    assert got[4] == (False, "stale_epoch") and got[5][0] and got[6] == 4
    assert got[7] == (False, "live_lease")
    assert got[8:10] == [True, 1] and got[10][0] and got[11] == 9
    assert got[12:] == [False, 1, None]


def _journal_script(prefix: str, root: str) -> None:
    j = _mod(root, "replicate.quorum").ReplicaJournal(prefix)
    j.note_incarnation(3)
    j.note_epoch("d", 7)
    j.note_epoch("d", 5)
    j.note_promise("d", 7, "hostA")
    j.note_lease("d", "me", 7, "active")
    j.note_lease("e", "me", 2, "active")
    j.drop_lease("e")
    j.note_override("d", "hostB", 2)
    j.note_group("g", 4, ["hostA", "me"], "hostA")
    # crash: no close(); the WAL holds every record


def _journal_files(prefix: str) -> dict:
    p = Path(prefix)
    return {f.name: f.read_bytes() for f in sorted(p.parent.iterdir())
            if f.name.startswith(p.name)}


def _restored(root: str, prefix: str) -> dict:
    j = _mod(root, "replicate.quorum").ReplicaJournal(prefix)
    try:
        return {"prior": j.has_prior_state(),
                "incarnation": j.restored_incarnation(),
                "epochs": j.restored_max_epochs(),
                "promises": j.restored_promises(),
                "leases": j.restored_leases(),
                "overrides": j.restored_overrides(),
                "groups": j.restored_groups()}
    finally:
        j.close()


def test_replica_journal_bytes_match_and_restore_across_packages(tmp_path):
    """The same script writes byte-identical journal files in both
    packages; a journal written by one, crashed (no close) and then
    closed (compacted), is restored by the other."""
    prefixes = {r: str(tmp_path / r / "rj") for r in ROOTS}
    for r in ROOTS:
        _journal_script(prefixes[r], r)
    files = {r: _journal_files(prefixes[r]) for r in ROOTS}
    assert files[JAX] and files[PORT] == files[JAX]
    want = {"prior": True, "incarnation": 3, "epochs": {"d": 7},
            "promises": {"d": {"epoch": 7, "holder": "hostA"}},
            "leases": {"d": {"holder": "me", "epoch": 7,
                             "state": "active"}},
            "overrides": {"d": {"target": "hostB", "ver": 2}},
            "groups": {"g": {"epoch": 4, "members": ["hostA", "me"],
                             "leader": "hostA"}}}
    # WAL replay across the packages, then the compacted snapshot
    assert _restored(PORT, prefixes[JAX]) == want
    assert _restored(JAX, prefixes[PORT]) == want
    compacted = {r: _journal_files(prefixes[r]) for r in ROOTS}
    assert compacted[PORT] == compacted[JAX]
    assert _restored(PORT, prefixes[JAX]) == want
    assert _restored(JAX, prefixes[PORT]) == want


def _journal_restore(root, tmp_path):
    prefix = str(tmp_path / root / "rj")
    q = _mod(root, "replicate.quorum")
    own = _mod(root, "replicate.ownership")
    j = q.ReplicaJournal(prefix)
    out = [j.has_prior_state()]
    j.note_incarnation(3)
    j.note_epoch("d", 7)
    j.note_epoch("d", 5)
    j.note_promise("d", 7, "hostA")
    j.note_lease("d", "me", 7, "active")
    j.note_lease("e", "me", 2, "active")
    j.drop_lease("e")
    j2 = q.ReplicaJournal(prefix)
    out += [j2.has_prior_state(), j2.restored_incarnation(),
            j2.restored_max_epochs(), j2.restored_promises(),
            j2.restored_leases()]
    j2.close()
    j3 = q.ReplicaJournal(prefix)
    out.append(j3.restored_max_epochs())
    lm = own.LeaseManager("me", ttl_s=60.0)
    lm.restore(j3)
    out += [lm.max_epoch_of("d"), lm.get("d").state,
            lm.ensure_local("d", True), lm.get("d").epoch]
    j3.close()
    j4 = q.ReplicaJournal(prefix)
    out += [j4.restored_max_epochs()["d"],
            j4.restored_leases()["d"]["epoch"]]
    j4.close()
    out.append(_journal_files(prefix))
    return out


def test_replica_journal_persist_restore(tmp_path):
    own = _mod(PORT, "replicate.ownership")
    got = _both(_journal_restore, tmp_path)
    assert got[:6] == [False, True, 3, {"d": 7},
                       {"d": {"epoch": 7, "holder": "hostA"}},
                       {"d": {"holder": "me", "epoch": 7,
                              "state": "active"}}]
    assert got[6:13] == [{"d": 7}, 7, own.RELEASED, True, 8, 8, 8]


def _membership(root):
    mem = _mod(root, "replicate.membership")
    v = mem.MembershipView("a", incarnation=2)
    v.add("b", state=mem.ALIVE)
    v.add("c", state=mem.ALIVE)
    out = [v.universe(), v.voters(), v.quorum_size()]
    v.note_health("b", 1.0, dead_after_s=5.0)
    out += [v.state_of("b"), v.universe()]
    v.note_health("b", 6.0, dead_after_s=5.0)
    out += [v.state_of("b"), v.universe(), v.voters(), v.quorum_size()]
    v.note_health("b", None, dead_after_s=5.0)
    out.append(v.state_of("b"))
    v.merge_remote({"b": {"state": mem.DEAD, "incarnation": 0}})
    out.append(v.state_of("b"))
    v.merge_remote({"b": {"state": mem.DEAD, "incarnation": 9}})
    out.append(v.state_of("b"))
    inc = v.self_incarnation
    v.merge_remote({"a": {"state": mem.SUSPECT, "incarnation": inc}})
    out += [v.self_incarnation - inc, v.state_of("a")]
    v.leave("c")
    out += [v.state_of("c"), v.voters(), v.quorum_size()]
    v2 = mem.MembershipView("b")
    v2.add("c", state=mem.ALIVE)
    v2.merge_remote(v.gossip_payload())
    out.append(v2.state_of("c"))
    return out


def test_membership_states_and_refutation():
    mem = _mod(PORT, "replicate.membership")
    got = _both(_membership)
    assert got[:3] == [["a", "b", "c"], ["a", "b", "c"], 2]
    assert got[3] == mem.SUSPECT and got[5] == mem.DEAD
    assert got[6] == ["a", "c"] and got[7] == ["a", "b", "c"]
    assert got[9:12] == [mem.ALIVE, mem.ALIVE, mem.DEAD]
    assert got[12:14] == [1, mem.ALIVE]
    assert got[14:] == [mem.LEFT, ["a", "b"], 2, mem.LEFT]


# ---- units: writer groups -------------------------------------------------

def _group_install(root):
    t = _mod(root, "replicate.writergroup").WriterGroupTable("hostB",
                                                             ttl_s=60.0)
    m = ["hostA", "hostB"]
    out = [t.install("d", 5, m, "hostA", floor=5), t.get("d").epoch,
           t.get("d").quorum_size(),
           t.install("d", 4, m, "hostA", floor=5),
           t.install("d", 7, m, "hostA", floor=5),
           t.install("d", 6, m, "hostA", floor=5), t.get("d").epoch,
           t.install("d", 7, m, "hostA", floor=5)]
    u = _mod(root, "replicate.writergroup").WriterGroupTable("hostB",
                                                             ttl_s=60.0)
    u.install("d", 7, m, "hostA", floor=0)
    out += [u.drop("d", at_or_below=5), u.get("d") is not None,
            u.drop("d", at_or_below=7), u.get("d"), u.drop("d")]
    f = _mod(root, "replicate.writergroup").WriterGroupTable("hostB",
                                                             ttl_s=60.0)
    f.install("d", 7, m, "hostA", floor=0)
    f.fence_below("d", 7)
    out.append(f.get("d") is not None)
    f.fence_below("d", 8)
    out.append(f.get("d"))
    return out


def test_writer_group_install_drop_and_fence():
    assert _both(_group_install) == [True, 5, 2, False, True, False, 7,
                                     True, False, True, True, None, False,
                                     True, None]


def _group_journal(root, tmp_path):
    prefix = str(tmp_path / root / "rj")
    q = _mod(root, "replicate.quorum")
    wg = _mod(root, "replicate.writergroup")
    j = q.ReplicaJournal(prefix)
    t = wg.WriterGroupTable("hostB", ttl_s=60.0)
    t.journal = j
    t.install("d", 7, ["hostA", "hostB"], "hostA", floor=0)
    t.install("e", 3, ["hostA", "hostB"], "hostA", floor=0)
    t.install("gone", 2, ["hostA", "hostB"], "hostA", floor=0)
    t.drop("gone")
    j2 = q.ReplicaJournal(prefix)
    out = [sorted(j2.restored_groups())]
    t2 = wg.WriterGroupTable("hostB", ttl_s=60.0)
    out += [t2.restore(j2, {"d": 0, "e": 5}.get), t2.get("e")]
    g = t2.get("d")
    out += [g.epoch, g.members, t2.clock() >= g.expires_at,
            t2.refresh("d", 6), t2.refresh("d", 7),
            t2.clock() < t2.get("d").expires_at]
    j2.close()
    return out


def test_writer_group_journal_round_trip(tmp_path):
    assert _both(_group_journal, tmp_path) == [
        ["d", "e"], 1, None, 7, ("hostA", "hostB"), True, False, True, True]


# ---- units: placement overrides and the rebalancer --------------------------

def _overrides(root):
    reb = _mod(root, "replicate.rebalance")
    t = reb.PlacementOverrides()
    out = [t.target_of("d0"), t.version_of("d0"), t.set("d0", "hostB"),
           t.set("d0", "hostC"), t.target_of("d0"), t.size(),
           t.clear("d0"), t.target_of("d0"), t.size(), t.as_json()]
    p = reb.PlacementOverrides()
    p.set("d0", "hostB")
    out += [p.merge([["d0", "hostC", 5]]), p.merge([["d0", "hostZ", 3]]),
            p.merge([["d0", None, 6]]), p.as_json()]
    e = reb.PlacementOverrides()
    e.merge([["d0", "hostB", 2]])
    out += [e.merge([["d0", "hostC", 2]]), e.merge([["d0", "hostA", 2]]),
            e.merge([["d0", None, 2]]), e.merge([["d0", "hostA", 2]])]
    u = reb.PlacementOverrides()
    for row in ([["d0", None, 2]], [["d0", "hostA", 2]],
                [["d0", "hostC", 2]]):
        u.merge(row)
    out.append(u.as_json() == e.as_json())
    bad = reb.PlacementOverrides()
    out += [bad.merge("not-a-list"),
            bad.merge([["d0", "hostB"], ["d1", "hostB", "notint"],
                       [7, "hostB", 1], ["d2", 9, 1], ["d3", "hostB", 1]]),
            bad.as_json()]
    g = reb.PlacementOverrides()
    for i in range(8):
        g.set(f"d{i}", "hostB")
    g.clear("d3")
    payload = g.gossip_payload()
    fresh = reb.PlacementOverrides()
    out += [["d3", None, 2] in payload, fresh.merge(payload),
            fresh.as_json() == g.as_json(), len(g.gossip_payload(cap=3))]

    class Journal:
        def __init__(self):
            self.rows = {}

        def note_override(self, doc, target, ver):
            self.rows[doc] = {"target": target, "ver": ver}

        def restored_overrides(self):
            return dict(self.rows)

    jn = Journal()
    w = reb.PlacementOverrides(journal=jn)
    w.set("d0", "hostB")
    w.set("d1", "hostC")
    w.clear("d1")
    w.merge([["d2", "hostB", 4]])
    r = reb.PlacementOverrides(journal=jn)
    out += [r.as_json() == w.as_json(), r.target_of("d0"),
            r.version_of("d1"), r.version_of("d2")]
    m = _mod(root, "replicate.metrics").ReplicationMetrics("hostA")
    mt = reb.PlacementOverrides(metrics=m)
    mt.set("d0", "hostB")
    mt.clear("d0")
    mt.merge([["d1", "hostC", 3]])
    out += [m.get("rebalance", k) for k in
            ("overrides_set", "overrides_cleared", "override_merges")]
    return out


def test_placement_overrides_versions_merge_gossip_journal_metrics():
    got = _both(_overrides)
    assert got[:9] == [None, 0, 1, 2, "hostC", 1, 3, None, 0]
    assert got[9] == {"d0": {"target": None, "ver": 3}}
    assert got[10:14] == [1, 0, 1, {"d0": {"target": None, "ver": 6}}]
    assert got[14:19] == [0, 1, 1, 0, True]
    assert got[19:22] == [0, 1, {"d3": {"target": "hostB", "ver": 1}}]
    assert got[22:26] == [True, 8, True, 3]
    assert got[26:30] == [True, "hostB", 2, 4]
    assert got[30:] == [1, 1, 1]


class _StubNode:
    """Just enough ReplicaNode surface for `Rebalancer` (the stub of
    tests/test_rebalance.py), built from one package's modules."""

    def __init__(self, root, held=("d1", "d2", "d3"),
                 peers=("hostB", "hostC"), down=(), peer_load=None,
                 handoff_ok=True):
        from types import SimpleNamespace as NS
        reb = _mod(root, "replicate.rebalance")
        self.self_id = "hostA"
        self.leases = NS(held_ids=lambda: list(held),
                         held_count=lambda: len(held))
        members = [self.self_id, *peers]
        self.membership = NS(universe=lambda: list(members))
        self.table = NS(is_healthy=lambda m: m not in set(down))
        self.peer_load = dict(peer_load or {})
        self.metrics = _mod(root, "replicate.metrics").ReplicationMetrics(
            self.self_id)
        self.overrides = reb.PlacementOverrides(metrics=self.metrics)
        self.obs = None
        self.rejoining = False
        self.store = object()
        self.handoff_ok = handoff_ok
        self.handoffs = []
        self._now = 100.0

    def clock(self):
        return self._now

    def handoff(self, doc_id, target, override_version=None):
        self.handoffs.append((doc_id, target, override_version))
        return self.handoff_ok


def _obs(state):
    from types import SimpleNamespace as NS
    return NS(slo=NS(evaluate=lambda: [{"name": "soak_edit_rtt",
                                        "state": state}]))


def _rebalancer(root):
    Rebalancer = _mod(root, "replicate.rebalance").Rebalancer
    out = {}
    n = _StubNode(root)
    out["healthy"] = Rebalancer(n, obs=_obs("ok")).tick()
    out["disabled"] = Rebalancer(n, obs=_obs("burning"),
                                 enabled=False).tick()["migrated"]
    n.rejoining = True
    out["rejoining"] = Rebalancer(n, obs=_obs("burning")).tick()["migrated"]
    out["idle_handoffs"] = n.handoffs
    n = _StubNode(root, peer_load={"hostB": 0, "hostC": 1})
    out["warning_narrowed"] = Rebalancer(n, obs=_obs("warning"),
                                         act_on=("burning",)).tick()
    out["burning_narrowed"] = Rebalancer(
        n, obs=_obs("burning"), act_on=("burning",)).tick()["migrated"]
    n = _StubNode(root, peer_load={"hostB": 0, "hostC": 1})
    out["stressed"] = Rebalancer(n, obs=_obs("burning")).tick()
    out["stressed_node"] = [n.handoffs, n.overrides.target_of("d1"),
                            n.metrics.get("rebalance", "migrations_started"),
                            n.metrics.get("rebalance",
                                          "migrations_completed")]
    n = _StubNode(root, peer_load={"hostB": 0, "hostC": 1}, down=("hostB",))
    out["unhealthy"] = Rebalancer(n, obs=_obs("warning")).tick()["migrated"]
    n = _StubNode(root, held=("d1", "d2"), peer_load={"hostB": 2,
                                                      "hostC": 2})
    out["gap"] = [Rebalancer(n, obs=_obs("burning"), min_load_gap=1).tick(),
                  n.handoffs]
    n = _StubNode(root, held=("d1",), peer_load={"hostB": 0, "hostC": 5})
    rb = Rebalancer(n, obs=_obs("burning"), cooldown_s=3.0)
    cool = [rb.tick()["migrated"], rb.tick()["migrated"]]
    n._now += 5.0
    cool += [rb.tick()["migrated"], len(n.handoffs)]
    out["cooldown"] = cool
    n = _StubNode(root, held=("d1",), peer_load={"hostB": 0, "hostC": 5},
                  handoff_ok=False)
    out["aborted"] = [Rebalancer(n, obs=_obs("burning")).tick(),
                      n.overrides.target_of("d1"),
                      n.overrides.version_of("d1")] + [
        n.metrics.get("rebalance", k) for k in (
            "migrations_started", "migrations_completed",
            "migrations_aborted")]
    return out


def test_rebalancer_against_a_stub_node():
    got = _both(_rebalancer)
    empty = {"stressed": [], "migrated": [], "aborted": [], "promoted": [],
             "demoted": []}
    assert got["healthy"] == empty and got["warning_narrowed"] == empty
    assert got["disabled"] == got["rejoining"] == got["idle_handoffs"] == []
    assert got["burning_narrowed"] == [["d1", "hostB"]]
    assert got["stressed"]["stressed"] == ["soak_edit_rtt"]
    assert got["stressed"]["migrated"] == [["d1", "hostB"]]
    assert got["stressed_node"] == [[("d1", "hostB", 1)], "hostB", 1, 1]
    assert got["unhealthy"] == [["d1", "hostC"]]
    assert got["gap"][0]["stressed"] and got["gap"][0]["migrated"] == []
    assert got["cooldown"] == [[["d1", "hostB"]], [], [["d1", "hostB"]], 2]
    assert got["aborted"][0]["aborted"] == [["d1", "hostB"]]
    assert got["aborted"][1:] == [None, 2, 1, 0, 1]


# ---- mesh helpers ------------------------------------------------------------

def _serve(root, **kw):
    """`tools.server.serve` of one package; the port's server runs its
    scheduler on the CPU (the kernels' plain versions)."""
    if root == PORT:
        kw.setdefault("device", "cpu")
    return _mod(root, "tools.server").serve(**kw)


def _mesh(root, n, tmp_path=None, serve_shards=2, faults=None,
          lease_ttl_s=5.0, follower_reads=False, **opts):
    opts.setdefault("backoff_base_s", 0.01)
    opts.setdefault("backoff_cap_s", 0.05)
    httpds, addrs = [], []
    try:
        for i in range(n):
            data_dir = str(tmp_path / root / f"s{i}") if tmp_path else None
            httpd = _serve(root, port=0, data_dir=data_dir,
                           serve_shards=serve_shards,
                           follower_reads=follower_reads)
            httpds.append(httpd)
            addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
        attach = _mod(root, "replicate").attach_replication
        nodes = []
        for i, httpd in enumerate(httpds):
            nodes.append(attach(httpd, addrs[i],
                                [a for a in addrs if a != addrs[i]],
                                faults=faults, lease_ttl_s=lease_ttl_s,
                                **opts))
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
    except BaseException:
        _teardown(httpds)
        raise
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


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read()


def _text(addr, doc):
    return _get(f"http://{addr}/doc/{doc}").decode("utf8")


def _metrics(addr):
    return json.loads(_get(f"http://{addr}/metrics"))


# maps whose keys are data (series names, lock-order edges, histogram
# buckets, flush reasons): their own key is schema, their children are not
DATA_KEYED = ("edges", "series", "flush_reasons", "hist")


def _key_paths(d, addrs, pre=""):
    """Every key path of a JSON document, the node addresses replaced by
    their role (n0, n1, ...) so two meshes on other ports compare."""
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            name = f"n{addrs.index(k)}" if k in addrs else k
            out.add(pre + name)
            if not name.endswith(DATA_KEYED):
                out |= _key_paths(v, addrs, pre + name + ".")
    return out


def _docs_owned_by(nodes, addrs, pattern, prefix):
    """One document name per entry of `pattern`, the k-th owned by
    `addrs[pattern[k]]`: ports are ephemeral and placement hashes them,
    so each run picks its own names to give both runs the same traffic
    relative to the owners."""
    out = []
    for k, want in enumerate(pattern):
        out.append(next(
            f"{prefix}-{k}-{j}" for j in range(1024)
            if nodes[0].desired_owner(f"{prefix}-{k}-{j}") == addrs[want]))
    return out


def _prom_families(addr) -> set:
    text = _get(f"http://{addr}/metrics?format=prom").decode("utf8")
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE")}


def _lease_view(nodes, doc):
    """Each node's lease record for `doc`, relative to the doc's owner:
    (role, state, epoch, holder role) with the owner first."""
    owner = nodes[0].desired_owner(doc)
    ids = [owner] + sorted(n.self_id for n in nodes if n.self_id != owner)
    out = []
    for n in sorted(nodes, key=lambda n: ids.index(n.self_id)):
        lease = n.leases.get(doc)
        out.append(None if lease is None else (
            lease.state, lease.epoch,
            ids.index(lease.holder) if lease.holder in ids else "?"))
    return out


def _compare_metrics(jax_got, port_got):
    """The /metrics key sets of two runs: equal but for the serve keys
    only JAX has, JAX's jit-cache block, the port's flush timing and its
    linearizer counters."""
    port_only = {k for k in port_got["keys"]
                 if k.startswith(SERVE_ONLY_IN_PORT)}
    assert "serve.flush_phases.seconds.extract" in port_only
    assert "serve.transform.linearized_plain" in port_only
    assert jax_got["keys"] - port_got["keys"] == \
        SERVE_ONLY_IN_JAX | JIT_ONLY_IN_JAX
    assert port_got["keys"] - port_only <= jax_got["keys"]
    assert jax_got["prom"] - port_got["prom"] <= \
        PROM_ONLY_IN_JAX | JIT_PROM_ONLY_IN_JAX
    assert PROM_ONLY_IN_PORT <= port_got["prom"]
    assert port_got["prom"] - PROM_ONLY_IN_PORT <= jax_got["prom"]


# ---- mesh: the scripted cases ------------------------------------------------

def _two_server_smoke(root, tmp_path):
    SyncClient = _mod(root, "tools.server").SyncClient
    httpds, nodes, addrs = _mesh(root, 2, tmp_path, follower_reads=True)
    try:
        # written at nodes 0, 1, 0: the second and third are proxied
        docs = _docs_owned_by(nodes, addrs, (0, 0, 1), "smoke")
        for i, doc in enumerate(docs):
            c = SyncClient(f"http://{addrs[i % 2]}", doc, f"u{i}")
            c.insert(0, f"content of doc {i}. ")
            c.sync()
        leases_after_sync = [_lease_view(nodes, d) for d in docs]
        _step(nodes, rounds=2)
        out = {"texts": [sorted({_text(a, d) for a in addrs}) for d in docs],
               "leases_after_sync": leases_after_sync,
               "leases": [_lease_view(nodes, d) for d in docs]}
        mergers = []
        for doc in docs:
            m = [n.self_id for n in nodes if doc in n.merged_docs]
            mergers.append((len(m), m == [nodes[0].leases.holder_of(doc)]
                            if m else None))
        out["mergers"] = mergers
        ms = [_metrics(a) for a in addrs]
        out["replication"] = [
            (m["replication"]["version"],
             m["replication"]["antientropy"]["rounds"] >= 1,
             m["replication"]["quorum_view"]["quorum"],
             m["replication"]["quorum_view"]["rejoining"],
             m["replication"]["membership_view"]["view_version"] >= 1,
             "handoff" in m["replication"]["latencies"],
             "denied" in m["serve"]["totals"],
             "fenced" in m["serve"]["totals"]) for m in ms]
        out["keys"] = set().union(*(_key_paths(m, addrs) for m in ms))
        out["prom"] = _prom_families(addrs[0])
        ping = json.loads(_get(f"http://{addrs[0]}/replicate/ping"))
        out["ping"] = (ping["ok"], ping["id"] == addrs[0], sorted(ping))
        return out
    finally:
        _teardown(httpds)


def test_two_server_smoke(tmp_path, witnessed):
    got = {r: _two_server_smoke(r, tmp_path) for r in ROOTS}
    _compare_metrics(got[JAX], got[PORT])
    for r in ROOTS:
        got[r].pop("keys")
        got[r].pop("prom")
    assert got[PORT] == got[JAX]
    port = got[PORT]
    assert all(len(t) == 1 for t in port["texts"])
    assert all(n <= 1 and ok in (True, None) for n, ok in port["mergers"])
    assert all(r[:4] == (8, True, 2, False) and all(r[4:])
               for r in port["replication"])
    assert port["ping"][:2] == (True, True)


def _proxy(root):
    SyncClient = _mod(root, "tools.server").SyncClient
    httpds, nodes, addrs = _mesh(root, 2, serve_shards=2)
    try:
        doc = "proxied-doc"
        owner = nodes[0].desired_owner(doc)
        other = next(a for a in addrs if a != owner)
        c = SyncClient(f"http://{other}", doc, "writer")
        c.insert(0, "written at the wrong server")
        c.sync()
        owner_node = next(n for n in nodes if n.self_id == owner)
        other_node = next(n for n in nodes if n.self_id != owner)
        return {"owner_merged": doc in owner_node.merged_docs,
                "other_merged": doc in other_node.merged_docs,
                "proxied": other_node.metrics_json()["proxy"]["proxied"],
                "owner_text": _text(owner, doc),
                "owner_sched_text": owner_node.store.scheduler.text(doc),
                "leases": _lease_view(nodes, doc)}
    finally:
        _teardown(httpds)


def test_mutation_proxy_routes_to_owner(witnessed):
    got = _both(_proxy)
    assert got["owner_merged"] and not got["other_merged"]
    assert got["proxied"] >= 1
    assert got["owner_text"] == got["owner_sched_text"] == \
        "written at the wrong server"


def _handoff(root):
    SyncClient = _mod(root, "tools.server").SyncClient
    own = _mod(root, "replicate.ownership")
    httpds, nodes, addrs = _mesh(root, 2, serve_shards=2)
    try:
        doc = "handoff-doc"
        owner = nodes[0].desired_owner(doc)
        src = next(n for n in nodes if n.self_id == owner)
        dst = next(n for n in nodes if n.self_id != owner)
        c = SyncClient(f"http://{owner}", doc, "writer")
        c.insert(0, "pre-handoff state")
        c.sync()
        out = {"before": [src.owns(doc), dst.owns(doc)],
               "leases_before": _lease_view(nodes, doc)}
        epoch_before = src.leases.get(doc).epoch
        out["handoff"] = src.handoff(doc, dst.self_id)
        out["dst"] = [dst.leases.get(doc).state == own.ACTIVE,
                      dst.leases.get(doc).epoch - epoch_before,
                      dst.owns(doc), src.owns(doc)]
        out["leases_after"] = _lease_view(nodes, doc)
        out["dst_text"] = _text(dst.self_id, doc)
        hm = src.metrics_json()["handoffs"]
        out["metrics"] = [hm["completed"], hm["latency_s_total"] > 0]
        return out
    finally:
        _teardown(httpds)


def test_explicit_handoff_moves_active_merger(witnessed):
    got = _both(_handoff)
    assert got["before"] == [True, False] and got["handoff"]
    assert got["dst"] == [True, 1, True, False]
    assert "pre-handoff" in got["dst_text"]
    assert got["metrics"] == [1, True]


def _circuit_mesh(root):
    faults = _mod(root, "replicate.faults")
    httpds, nodes, addrs = _mesh(root, 2, serve_shards=0)
    try:
        n0 = nodes[0]
        n0.table.faults = faults.FaultInjector(seed=1, drop_rate=1.0)
        for _ in range(n0.table.fail_threshold):
            n0.table.probe_once()
        st = n0.table.state(addrs[1])
        out = {"down": [n0.table.is_healthy(addrs[1]),
                        n0.table.healthy_ids() == [addrs[0]],
                        st["circuit_open"],
                        st["consecutive_failures"] >= 3],
               "takeover": [n0.takeover_after_s,
                            n0.ownership_ids() == sorted(addrs)]}
        n0.takeover_after_s = 0.0
        out["collapsed"] = [n0.ownership_ids() == [addrs[0]],
                            n0.desired_owner("any-doc") == addrs[0]]
        n0.takeover_after_s = 5.0
        n0.table.faults = None
        deadline = time.monotonic() + 10
        while not n0.table.is_healthy(addrs[1]):
            n0.table.probe_once()
            assert time.monotonic() < deadline
        m = n0.metrics_json()["probes"]
        out["healed"] = [n0.table.state(addrs[1])["consecutive_failures"],
                         m["circuit_opens"], m["circuit_closes"]]
        # down_duration across the next outage and recovery
        t = n0.table
        out["down_duration"] = [t.down_duration(addrs[1]),
                                t.down_duration(t.self_id),
                                t.down_duration("unknown:1")]
        t.faults = faults.FaultInjector(seed=2, drop_rate=1.0)
        for _ in range(t.fail_threshold):
            t.probe_once()
        d1 = t.down_duration(addrs[1])
        time.sleep(0.02)
        peer = t.peers[addrs[1]]
        out["down_duration"] += [
            d1 is not None and d1 >= 0.0, t.down_duration(addrs[1]) > d1,
            t.down_duration(addrs[1], now=peer.down_since + 1.5)]
        t.faults = None
        deadline = time.monotonic() + 10
        while t.down_duration(addrs[1]) is not None:
            t.probe_once()
            assert time.monotonic() < deadline
        out["down_duration"].append(t.is_healthy(addrs[1]))
        return out
    finally:
        _teardown(httpds)


def test_circuit_breaker_opens_recovers_and_times_the_outage():
    got = _both(_circuit_mesh)
    assert got["down"] == [False, True, True, True]
    assert got["takeover"] == [5.0, True] and got["collapsed"] == [True,
                                                                    True]
    assert got["healed"] == [0, 1, 1]
    assert got["down_duration"] == [None, None, float("inf"), True, True,
                                    1.5, True]


def _syncclient_retries(root):
    srv = _mod(root, "tools.server")
    httpd = _serve(root, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    real_urlopen = urllib.request.urlopen
    fail = {"n": 2}

    def flaky_urlopen(req, timeout=None):
        if fail["n"] > 0:
            fail["n"] -= 1
            raise ConnectionResetError("injected")
        return real_urlopen(req, timeout=timeout)

    srv.urllib.request.urlopen = flaky_urlopen
    try:
        c = srv.SyncClient(f"http://127.0.0.1:{port}", "retry-doc", "amy",
                           retries=3)
        c.insert(0, "survives flaky transport")
        c.sync()
        fail["n"] = 2
        c.pull()
        out = [c.text()]
        fail["n"] = 99
        c.insert(0, "x")
        try:
            c.push()
            out.append(None)
        except OSError as e:
            out.append(type(e).__name__)
        return out
    finally:
        srv.urllib.request.urlopen = real_urlopen
        _teardown([httpd])


def test_syncclient_retries_transient_failures():
    assert _both(_syncclient_retries) == ["survives flaky transport",
                                          "ConnectionResetError"]


def _converge_under_faults(root, tmp_path):
    SyncClient = _mod(root, "tools.server").SyncClient
    faults = _mod(root, "replicate.faults").FaultInjector(
        seed=1234, drop_rate=0.25, dup_rate=0.1)
    httpds, nodes, addrs = _mesh(root, 2, tmp_path, serve_shards=2,
                                 faults=faults)
    try:
        docs = _docs_owned_by(nodes, addrs, (0, 1, 0), "conv")
        clients = {(i, d): SyncClient(f"http://{addrs[i]}", d, f"w{i}-{d}",
                                      retries=1)
                   for i in range(2) for d in docs}

        def edit(i, d, text):
            c = clients[(i, d)]
            try:
                c.pull()
            except OSError:
                pass
            c.insert(0, text)
            try:
                c.sync()
            except OSError:
                pass

        for k, (i, d) in enumerate([(0, docs[0]), (1, docs[1]),
                                    (0, docs[2])]):
            edit(i, d, f"seed {k}. ")
        _step(nodes)
        steps = [[_lease_view(nodes, d) for d in docs]]
        faults.partition(addrs[0], addrs[1])
        for r in range(3):
            for d in docs:
                edit(0, d, f"left{r} ")
                edit(1, d, f"right{r} ")
            _step(nodes)
        faults.heal()
        for _ in range(40):
            time.sleep(0.06)
            _step(nodes)
            if all(len({_text(a, d) for a in addrs}) == 1 for d in docs):
                break
        steps.append([_lease_view(nodes, d) for d in docs])
        out = {"converged": [len({_text(a, d) for a in addrs}) == 1
                             for d in docs],
               "both_sides": all("left" in _text(addrs[0], d)
                                 and "right" in _text(addrs[0], d)
                                 for d in docs),
               "single_merger": [
                   [n.self_id for n in nodes if d in n.merged_docs]
                   in ([], [nodes[0].desired_owner(d)]) for d in docs],
               "metrics": [(_metrics(a)["replication"]["antientropy"]
                            ["rounds"] >= 4,
                            _metrics(a)["replication"]["faults"]["drops"]
                            >= 1) for a in addrs],
               "blocks": faults.snapshot()["partition_blocks"] >= 1,
               "texts": {d: _text(addrs[0], d) for d in docs},
               "leases": steps}
        for n in nodes:
            sched = n.store.scheduler
            for d in docs:
                if n.owns(d):
                    out.setdefault("owner_sched", []).append(
                        sched.text(d) == _text(n.self_id, d))
        return out
    finally:
        _teardown(httpds)


def test_convergence_under_faults(tmp_path, witnessed):
    """The same seeded faults over both meshes: every doc converges with
    both sides' edits, merges ran only on the owner, and the owner's
    scheduler serves the converged text. The texts themselves depend on
    which pushes the injector dropped, so they are compared only within
    each run; the lease states are compared across runs."""
    runs = {r: _converge_under_faults(r, tmp_path) for r in ROOTS}
    for got in runs.values():
        assert got["converged"] == [True] * 3 and got["both_sides"]
        assert all(got["single_merger"]) and got["blocks"]
        assert got["metrics"] == [(True, True)] * 2
        assert got["owner_sched"] and all(got["owner_sched"])
    assert runs[PORT]["leases"] == runs[JAX]["leases"]


def _wire_mesh(root, tmp_path):
    SyncClient = _mod(root, "tools.server").SyncClient
    httpds, nodes, addrs = _mesh(root, 2, tmp_path)
    try:
        docs = _docs_owned_by(nodes, addrs, (0, 0), "wire")
        for i, doc in enumerate(docs):
            c = SyncClient(f"http://{addrs[i]}", doc, f"w{i}")
            c.insert(0, f"framed content of doc {i}. ")
            c.sync()
        _step(nodes, rounds=3)
        wires = [_metrics(a)["replication"]["wire"] for a in addrs]
        prom = _get(f"http://{addrs[0]}/metrics?format=prom").decode("utf8")
        return {"texts": [sorted({_text(a, d) for a in addrs})
                          for d in docs],
                "wire": [w["antientropy_bytes_sent"] > 0 for w in wires]
                + [sum(w["antientropy_frames"] for w in wires) > 0,
                   sum(w["gossip_bytes_sent"] for w in wires) > 0],
                "wire_keys": [sorted(w) for w in wires],
                "prom": sorted(re.findall(r"^dt_wire_\w+\{channel=\"\w+\"\}",
                                          prom, re.M))}
    finally:
        _teardown(httpds)


def test_wire_mesh_frames_and_prom(tmp_path, witnessed):
    got = _both(_wire_mesh, tmp_path)
    assert all(len(t) == 1 for t in got["texts"]) and all(got["wire"])
    assert 'dt_wire_bytes_sent_total{channel="antientropy"}' in got["prom"]
    assert 'dt_wire_frames_total{channel="proxy"}' in got["prom"]


def _mixed_version(root, tmp_path):
    SyncClient = _mod(root, "tools.server").SyncClient
    attach = _mod(root, "replicate").attach_replication
    httpds, addrs = [], []
    try:
        for i in range(2):
            httpd = _serve(root, port=0, data_dir=str(tmp_path / root /
                                                      f"s{i}"),
                           serve_shards=2)
            httpds.append(httpd)
            addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
        nodes = [attach(h, addrs[i], [a for a in addrs if a != addrs[i]],
                        backoff_base_s=0.01, backoff_cap_s=0.05,
                        wire_enabled=(i == 0))
                 for i, h in enumerate(httpds)]
        for h in httpds:
            threading.Thread(target=h.serve_forever, daemon=True).start()
        doc = "mixed"
        c0 = SyncClient(f"http://{addrs[0]}", doc, "alice")
        c0.insert(0, "héllo ")
        c0.sync()
        c1 = SyncClient(f"http://{addrs[1]}", doc, "bob")
        c1.pull()
        c1.insert(len(c1.text()), "wörld ")
        c1.sync()
        _step(nodes, rounds=3)
        w0 = nodes[0].metrics.wire_counters()
        w1 = nodes[1].metrics.wire_counters()
        return {"enabled": [nodes[0].wire.enabled, nodes[1].wire.enabled],
                "texts": sorted({_text(a, doc) for a in addrs}),
                "frames": [w[f"{ch}_frames"] for w in (w0, w1)
                           for ch in ("antientropy", "proxy", "hydrate",
                                      "gossip")],
                "bytes_sent": [w0["antientropy_bytes_sent"] > 0,
                               w1["antientropy_bytes_sent"] > 0],
                "use_wire": nodes[0].wire.use_wire(addrs[1])}
    finally:
        _teardown(httpds)


def test_mixed_version_mesh_converges_on_json(tmp_path, witnessed):
    got = _both(_mixed_version, tmp_path)
    assert got["enabled"] == [True, False]
    assert got["texts"] == ["héllo wörld "]
    assert got["frames"] == [0] * 8 and got["bytes_sent"] == [True, True]
    assert not got["use_wire"]


# ---- mesh: writer groups ------------------------------------------------------

def _wg_mesh(root, faults=None, **opts):
    opts.setdefault("lease_ttl_s", 30.0)
    return _mesh(root, 3, serve_shards=1, faults=faults, **opts)


def _promote(nodes, doc):
    _step(nodes)
    leader = next(n for n in nodes if n.desired_owner(doc) == n.self_id)
    assert leader.owns(doc)
    member = next(n for n in nodes if n is not leader)
    assert leader.promote_writer_group(doc, [member.self_id])
    return leader, member


def _wg_promotion(root):
    httpds, nodes, addrs = _wg_mesh(root)
    try:
        doc = "wg-promote"
        _step(nodes)
        leader = next(n for n in nodes if n.desired_owner(doc) == n.self_id)
        out = [leader.owns(doc)]
        e0 = leader.leases.active_epoch(doc)
        member = next(n for n in nodes if n is not leader)
        real = leader._run_quorum
        leader._run_quorum = lambda d, e, t: False
        out += [leader.promote_writer_group(doc, [member.self_id]),
                leader.writergroups.get(doc),
                leader.leases.active_epoch(doc) == e0]
        leader._run_quorum = real
        out.append(leader.promote_writer_group(doc, [member.self_id]))
        g = leader.writergroups.get(doc)
        gm = member.writergroups.get(doc)
        out += [g.leader == leader.self_id,
                set(g.members) == {leader.self_id, member.self_id},
                g.epoch - e0, leader.leases.active_epoch(doc) == g.epoch,
                gm is not None and gm.epoch == g.epoch,
                member.leases.max_epoch_of(doc) >= g.epoch,
                member.group_accepts(doc), member.owns(doc),
                member.active_epoch(doc) == g.epoch,
                member.metrics.get("writergroup", "member_admits")]
        return out
    finally:
        _teardown(httpds)


def test_writer_group_promotion_runs_quorum_and_rekeys_lease(witnessed):
    got = _both(_wg_promotion)
    assert got[:5] == [True, False, None, True, True]
    assert got[5:7] == [True, True] and got[7] > 0
    assert got[8:] == [True, True, True, True, True, True, 1]


def _wg_stale_grant(root):
    httpds, nodes, addrs = _wg_mesh(root)
    try:
        doc = "wg-stale"
        leader, member = _promote(nodes, doc)
        old = leader.writergroups.get(doc).epoch
        out = [leader.can_demote(doc), leader.demote_writer_group(doc),
               leader.writergroups.get(doc), member.writergroups.get(doc),
               member.leases.max_epoch_of(doc) > old,
               member.group_accepts(doc)]
        rejected0 = member.metrics.get("writergroup",
                                       "stale_installs_rejected")
        out.append(member.writergroups.install(
            doc, old, [leader.self_id, member.self_id], leader.self_id,
            floor=member.leases.max_epoch_of(doc)))
        resp = leader.table.call_json(
            member.self_id, "/replicate/lease",
            {"action": "group", "doc": doc, "epoch": old,
             "members": [leader.self_id, member.self_id],
             "leader": leader.self_id, "ttl_s": 30.0})
        out += [resp["ok"],
                member.metrics.get("writergroup", "stale_installs_rejected")
                > rejected0]
        return out
    finally:
        _teardown(httpds)


def test_writer_group_stale_grant_refused_after_demotion(witnessed):
    assert _both(_wg_stale_grant) == [True, True, None, None, True, False,
                                      False, False, True]


def _wg_self_fence(root):
    faults = _mod(root, "replicate.faults").FaultInjector(seed=3)
    httpds, nodes, addrs = _wg_mesh(root, faults=faults, group_ttl_s=1.0)
    try:
        doc = "wg-fence"
        leader, member = _promote(nodes, doc)
        out = [member.group_accepts(doc)]
        faults.partition(member.self_id, leader.self_id)
        for _ in range(4):
            member.table.probe_once()
        out += [member.table.is_healthy(leader.self_id),
                member.group_accepts(doc), member.owns(doc)]
        deadline = member.clock() + 3 * member.writergroups.ttl_s
        while member.clock() < deadline \
                and member.writergroups.get(doc) is not None:
            member.maintain()
            time.sleep(0.02)
        out += [member.writergroups.get(doc),
                member.metrics.get("writergroup", "self_fenced") >= 1]
        return out
    finally:
        _teardown(httpds)


def test_writer_group_member_self_fences_on_quorum_loss(witnessed):
    assert _both(_wg_self_fence) == [True, False, False, False, None, True]


def _wg_drain(root):
    httpds, nodes, addrs = _wg_mesh(root)
    try:
        doc = "wg-drain"
        leader, member = _promote(nodes, doc)
        body = (b'{"agent": "wg-agent", "version": [], "ops": '
                b'[{"kind": "ins", "pos": 0, "text": "member-write "}]}')
        req = urllib.request.Request(
            f"http://{member.self_id}/doc/{doc}/edit", data=body)
        with urllib.request.urlopen(req, timeout=5) as r:
            out = [r.status]
        out += [member.metrics.get("writergroup", "member_admits") >= 1,
                leader.demote_writer_group(doc),
                leader.writergroups.get(doc), member.writergroups.get(doc),
                leader.leases.active_epoch(doc) > 0,
                member.group_accepts(doc)]
        _step(nodes, rounds=4)
        out.append(sorted({_text(a, doc) for a in addrs}))
        return out
    finally:
        _teardown(httpds)


def test_writer_group_demote_drains_member_write(witnessed):
    assert _both(_wg_drain) == [200, True, True, None, None, True, False,
                                ["member-write "]]


# ---- across the packages --------------------------------------------------------

def test_jax_and_port_servers_converge_in_one_mesh(tmp_path, witnessed):
    """A rolling upgrade from the reference to the port: one JAX server
    (host engine) and one port server (device engine on the CPU) in one
    mesh. Writes land on both; mutations are proxied to each document's
    owner whichever package it runs, leases are granted by quorum across
    the packages, anti-entropy converges every document byte-identically
    over the wire protocol (binary frames both ways), and each owner's
    scheduler serves the converged text."""
    roots = (JAX, PORT)
    httpds, addrs, nodes = [], [], []
    try:
        for i, root in enumerate(roots):
            h = _serve(root, port=0, data_dir=str(tmp_path / f"s{i}"),
                       serve_shards=2)
            httpds.append(h)
            addrs.append(f"127.0.0.1:{h.server_address[1]}")
        for i, (root, h) in enumerate(zip(roots, httpds)):
            nodes.append(_mod(root, "replicate").attach_replication(
                h, addrs[i], [a for a in addrs if a != addrs[i]],
                backoff_base_s=0.01, backoff_cap_s=0.05, lease_ttl_s=5.0))
            threading.Thread(target=h.serve_forever, daemon=True).start()
        docs = [f"rolling-{k}" for k in range(6)]
        owners = {d: nodes[0].desired_owner(d) for d in docs}
        assert {nodes[1].desired_owner(d) for d in docs} <= set(addrs)
        assert all(nodes[1].desired_owner(d) == owners[d] for d in docs)
        assert set(owners.values()) == set(addrs), owners
        _step(nodes)
        for k, d in enumerate(docs):
            for i, root in enumerate(roots):
                c = _mod(root, "tools.server").SyncClient(
                    f"http://{addrs[i]}", d, f"{root[-5:]}-{k}")
                c.pull()
                c.insert(len(c.text()), f"[{i}:{d}]")
                c.sync()
        for _ in range(20):
            _step(nodes)
            if all(len({_text(a, d) for a in addrs}) == 1 for d in docs):
                break
        for d in docs:
            texts = {_text(a, d) for a in addrs}
            assert len(texts) == 1, (d, texts)
            text = texts.pop()
            assert f"[0:{d}]" in text and f"[1:{d}]" in text
            owner = next(n for n in nodes if n.self_id == owners[d])
            assert [n.self_id for n in nodes if d in n.merged_docs] == \
                [owner.self_id]
            assert owner.store.scheduler.text(d) == text
            views = [n.leases.get(d) for n in nodes]
            assert all(v is not None and v.holder == owners[d]
                       and v.epoch == 1 for v in views)
        proxied = [n.metrics_json()["proxy"]["proxied"] for n in nodes]
        assert all(p >= 1 for p in proxied), proxied
        frames = [n.metrics.wire_counters()["antientropy_frames"]
                  for n in nodes]
        assert all(f > 0 for f in frames), frames
        for i, n in enumerate(nodes):
            assert n.wire.use_wire(addrs[1 - i])
    finally:
        _teardown(httpds)


# ---- the Hydrator's remote fill ----------------------------------------------

def _remote_fill(root, tmp_path):
    """A node whose scheduler has a Hydrator when replication attaches:
    `attach_replication` wires `remote_fetch`, and a cold miss with an
    empty home for a doc its peer owns pulls the peer's snapshot frame."""
    SyncClient = _mod(root, "tools.server").SyncClient
    tier = _mod(root, "storage.tier")
    Hydrator = _mod(root, "serve.hydrate").Hydrator
    httpds, addrs = [], []
    try:
        for i in range(2):
            h = _serve(root, port=0, data_dir=str(tmp_path / root / f"s{i}"),
                       serve_shards=2)
            httpds.append(h)
            addrs.append(f"127.0.0.1:{h.server_address[1]}")
        store1 = tier.TieredStore(str(tmp_path / root / "tier1"))
        hyd = Hydrator(store1, warm_max=4, workers=1)
        httpds[1].store.scheduler.attach_hydrator(hyd)
        attach = _mod(root, "replicate").attach_replication
        nodes = [attach(h, addrs[i], [a for a in addrs if a != addrs[i]],
                        backoff_base_s=0.01, backoff_cap_s=0.05)
                 for i, h in enumerate(httpds)]
        for h in httpds:
            threading.Thread(target=h.serve_forever, daemon=True).start()
        doc = next(f"fill-{k}" for k in range(64)
                   if nodes[0].desired_owner(f"fill-{k}") == addrs[0])
        c = SyncClient(f"http://{addrs[0]}", doc, "owner-writer")
        c.insert(0, "owned elsewhere, fetched cold")
        c.sync()
        _step(nodes)
        wired = hyd.remote_fetch == nodes[1].fetch_remote_snapshot
        ol = hyd.resolve(doc)
        try:
            return {"wired": wired,
                    "text": ol.checkout_tip().snapshot(),
                    "fills": hyd.counters["remote_fills"],
                    "errors": hyd.counters["remote_fill_errors"],
                    "hydrate_frames":
                        nodes[0].metrics.wire_counters()["hydrate_frames"]}
        finally:
            hyd.stop(checkpoint=False)
    finally:
        _teardown(httpds)


def test_remote_fill_pulls_the_owners_snapshot(tmp_path):
    got = _both(_remote_fill, tmp_path)
    assert got == {"wired": True, "text": "owned elsewhere, fetched cold",
                   "fills": 1, "errors": 0, "hydrate_frames": 1}


# ---- fail-stop on a kernel fault -----------------------------------------

@pytest.mark.parametrize("exc", [RuntimeError, ValueError])
def test_kernel_fault_under_a_probe_loop_handoff_stops_the_node(
        monkeypatch, exc):
    """A K1 fault met by the drain of a handoff that the probe loop's
    `maintain` started: the drain flushes the queued edit of a document
    that stays (the moving document's own work is fenced). A RuntimeError
    passes through the handoff to the loop's catch-all, a ValueError is
    caught by the handoff's own except; either way the scheduler keeps the
    fault, the node's loop ends, and the server answers every request with
    503 naming the fault."""
    server = _mod(PORT, "tools.server")
    tff = _mod(PORT, "gpu.flush_fuse")
    owner_of = _mod(PORT, "replicate.ownership").owner_of
    opts = dict(probe_interval_s=0.05, backoff_base_s=0.01,
                backoff_cap_s=0.05)
    httpds = []
    try:
        for _ in range(2):
            h = _serve(PORT, port=0, serve_shards=2, peers=[],
                       replicate_opts=dict(opts))
            httpds.append(h)
            threading.Thread(target=h.serve_forever, daemon=True).start()
        src, dst = (h.store.replica for h in httpds)
        # docs src owns alone; once dst joins, `move`'s owner is dst and
        # `stay`'s is still src
        owners = {f"fs-{k}": owner_of(f"fs-{k}", [src.self_id, dst.self_id])
                  for k in range(64)}
        move = next(d for d, o in owners.items() if o == dst.self_id)
        stay = next(d for d, o in owners.items() if o == src.self_id)
        clients = [server.SyncClient(f"http://{src.self_id}", d, "writer")
                   for d in (move, stay)]
        for c in clients:
            c.insert(0, "merged before the fault")
            c.sync()
        sched = src.store.scheduler
        sched.stop_pump()       # from here only the handoff drains
        assert src.owns(move) and src.owns(stay) and sched.fault is None

        def boom(*a, **k):
            raise exc("injected K1 fault")
        monkeypatch.setattr(tff, "apply_ops_window", boom)
        for c in clients:
            c.insert(0, "queued: ")
            c.sync()
        assert sched.queue.total_depth() == 2
        assert dst.join_mesh(src.self_id)
        deadline = time.monotonic() + 20
        while src._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not src._thread.is_alive()
        assert isinstance(sched.fault, exc)
        assert str(sched.fault) == "injected K1 fault"
        assert src.metrics_json()["handoffs"]["started"] >= 1
        assert src.metrics_json()["handoffs"]["completed"] == 0
        for path, data in (("/replicate/ping", None),
                           (f"/doc/{stay}/edit", b"{}")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://{src.self_id}{path}",
                                       data=data, timeout=5)
            assert ei.value.code == 503
            assert json.loads(ei.value.read()) == {
                "error": "scheduler_fault",
                "fault": f"{exc.__name__}: injected K1 fault"}
        assert dst.store.scheduler.fault is None
    finally:
        monkeypatch.undo()
        _teardown(httpds)
