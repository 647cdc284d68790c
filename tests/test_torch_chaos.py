"""The port's chaos and mesh soaks against the JAX package's.

`tests/test_chaos.py`'s five cases run through both packages: the two
seeded soaks (`replicate/soak.py` `run_replicate_soak`, the port's on
`device="cpu"`: every server merges with the fused device scheduler, K2
and K1 in their plain versions) and the three scripted cases (a fenced
stale-owner write, a crash-restart that must re-earn quorum at a fresh
epoch, a join and a leave moving ownership). Threads and ports make the
soaks' counts vary from run to run in either package, so what is held
equal is each soak's verdict; the scripted cases compare what each step
observes. Then the elastic-mesh soaks of `replicate/rebalance_soak.py`
on the port: the flash crowd (`tests/test_rebalance.py`'s acceptance run,
field by field) and the hot-doc write split (the `rebalance-soak
--split-hot-doc` verdict).

`replicate/soak.py` and `replicate/rebalance_soak.py` differ from JAX's
only by their `device` keyword and the CLI's `--device`.
"""

import importlib
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest

pytestmark = [pytest.mark.chaos, pytest.mark.replicate]

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = ROOTS = ("diamond_types_tpu", "diamond_types_tpu_torch")


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _both(case, tmp_path):
    jax_obs = case(JAX, tmp_path / "jax")
    port_obs = case(PORT, tmp_path / "port")
    assert port_obs == jax_obs
    return port_obs


def _dev(root) -> dict:
    return {"device": "cpu"} if root == PORT else {}


@pytest.mark.parametrize("rel", ["replicate/soak.py",
                                 "replicate/rebalance_soak.py"])
def test_soaks_differ_only_by_their_device(rel):
    """Each hunk where the port's soak differs from JAX's is about the
    servers' merge device: the keyword, its check, its pass to `serve`,
    the CLI's `--device`."""
    import difflib
    a = (REPO / JAX / rel).read_text().splitlines()
    b = (REPO / PORT / rel).read_text().splitlines()
    hunks = [(a[i1:i2], b[j1:j2]) for tag, i1, i2, j1, j2 in
             difflib.SequenceMatcher(a=a, b=b, autojunk=False).get_opcodes()
             if tag != "equal"]
    assert hunks
    for removed, added in hunks:
        assert "device" in "\n".join(added), (removed, added)
        assert "device" not in "\n".join(removed)
    calls = sum(ln.count("serve(port=") for ln in b)
    assert sum(ln.count("device=device)") for ln in b) >= calls


# ---- the acceptance soaks ---------------------------------------------------------

def _soak_verdict(r):
    return {"converged": r["converged"],
            "zero_split_brain": r["zero_split_brain"],
            "crashes": r["crashes"],
            "quorum_won": r["quorum"]["rounds_won"] >= 1,
            "rejoins": r["quorum"]["rejoins_completed"] >= 1,
            "config": {k: r["config"][k] for k in ("asym", "churn",
                                                     "crash")},
            "witness_acyclic": r.get("lock_witness", {}).get("acyclic")}


def _crash_churn_soak(root, tmp_path):
    r = _mod(root, "replicate.soak").run_replicate_soak(
        servers=3, docs=2, rounds=8, edits_per_round=2, seed=5,
        drop_rate=0.05, partition_rounds=3, reconcile_rounds=16,
        lease_ttl_s=0.3, crash=True, asym=True, churn=True,
        data_dir=str(tmp_path), **_dev(root))
    return {**_soak_verdict(r),
            "partition_blocks": r["faults"]["partition_blocks"] >= 1}


def test_asym_partition_crash_churn_soak_no_split_brain(tmp_path):
    got = _both(_crash_churn_soak, tmp_path)
    assert got == {"converged": True, "zero_split_brain": True,
                   "crashes": 2, "quorum_won": True, "rejoins": True,
                   "config": {"asym": True, "churn": True, "crash": True},
                   "witness_acyclic": True, "partition_blocks": True}


def _asym_soak(root, tmp_path):
    r = _mod(root, "replicate.soak").run_replicate_soak(
        servers=3, docs=2, rounds=6, edits_per_round=2, seed=11,
        drop_rate=0.1, partition_rounds=3, reconcile_rounds=16,
        lease_ttl_s=0.3, asym=True, data_dir=str(tmp_path), **_dev(root))
    return {"converged": r["converged"],
            "zero_split_brain": r["zero_split_brain"],
            "healed": r["faults"]["oneway_partitions"] == []
            or r["config"]["asym"],
            "serve_shards": r["config"]["serve_shards"]}


def test_asym_partition_soak_converges(tmp_path):
    assert _both(_asym_soak, tmp_path) == {
        "converged": True, "zero_split_brain": True, "healed": True,
        "serve_shards": 1}


# ---- the scripted cases ---------------------------------------------------------

def _post(addr, path, obj, headers=None):
    req = urllib.request.Request(
        f"http://{addr}{path}",
        data=json.dumps(obj).encode("utf8") if isinstance(obj, dict)
        else obj)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status, r.read()


def _serve(root, **kw):
    return _mod(root, "tools.server").serve(**kw, **_dev(root))


def _mesh(root, n, tmp_path, lease_ttl_s=5.0, serve_shards=1):
    attach_replication = _mod(root, "replicate").attach_replication
    httpds, addrs = [], []
    for i in range(n):
        httpd = _serve(root, port=0, data_dir=str(tmp_path / f"s{i}"),
                       serve_shards=serve_shards)
        httpds.append(httpd)
        addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
    nodes = []
    for i, httpd in enumerate(httpds):
        nodes.append(attach_replication(
            httpd, addrs[i], [a for a in addrs if a != addrs[i]],
            lease_ttl_s=lease_ttl_s, backoff_base_s=0.01,
            backoff_cap_s=0.05,
            journal_prefix=str(tmp_path / f"s{i}" / "_replica")))
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()
    return httpds, nodes, addrs


def _teardown(httpds):
    for h in httpds:
        h.shutdown()
        h.server_close()


def _step(nodes):
    for n in nodes:
        n.table.probe_once()
        n.maintain()


def _fenced_write(root, tmp_path):
    httpds, nodes, addrs = _mesh(root, 2, tmp_path)
    out = []
    try:
        _step(nodes)
        doc = "fence-doc"
        owner = nodes[0].desired_owner(doc)
        owner_node = next(n for n in nodes if n.self_id == owner)
        other_node = next(n for n in nodes if n.self_id != owner)
        out.append(owner_node.owns(doc))
        epoch = owner_node.leases.get(doc).epoch
        ok, _ = owner_node.leases.promise(doc, epoch + 5,
                                          other_node.self_id)
        out.append(ok)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(owner, f"/doc/{doc}/edit",
                  {"agent": "stale", "pos": 0, "insert": "ghost"},
                  headers={"X-DT-Proxied": "1",
                           "X-DT-Lease-Epoch": str(epoch)})
        body = json.loads(ei.value.read())
        out += [ei.value.code, body["error"], body["max_epoch"] - epoch,
                owner_node.metrics.get("fencing", "rejected_writes")]
        with urllib.request.urlopen(f"http://{owner}/doc/{doc}",
                                    timeout=5) as r:
            out.append(b"ghost" in r.read())
        other_node.leases.observe_remote(doc, owner, epoch, "active",
                                         ttl_s=60.0)
        relay = other_node.proxy(
            owner, f"/doc/{doc}/edit",
            json.dumps({"agent": "relay", "pos": 0,
                        "insert": "via proxy"}).encode("utf8"),
            doc_id=doc)
        out += [relay, other_node.metrics.get("proxy", "fenced_relays"),
                owner_node.owns(doc),
                owner_node.metrics.get("fencing", "stale_lease_revoked")]
        return out
    finally:
        _teardown(httpds)


def test_fenced_stale_owner_write_rejected(tmp_path):
    assert _both(_fenced_write, tmp_path) == [
        True, True, 409, "fenced", 5, 1, False, None, 1, False, 1]


def _crash_restart(root, tmp_path):
    attach_replication = _mod(root, "replicate").attach_replication
    httpds, nodes, addrs = _mesh(root, 3, tmp_path, lease_ttl_s=0.5)
    out = []
    try:
        _step(nodes)
        doc = next(f"crash-doc-{i}" for i in range(50)
                   if nodes[0].desired_owner(f"crash-doc-{i}")
                   == addrs[0])
        out.append(nodes[0].owns(doc))
        old_epoch = nodes[0].leases.get(doc).epoch
        old_inc = nodes[0].membership.self_incarnation
        crashed = nodes[0]
        crashed.journal = None
        crashed.leases.journal = None
        httpds[0].shutdown()
        httpds[0].server_close()
        httpd = _serve(root, port=int(addrs[0].split(":")[1]),
                       data_dir=str(tmp_path / "s0"), serve_shards=1)
        httpds[0] = httpd
        node = attach_replication(
            httpd, addrs[0], [addrs[1], addrs[2]], lease_ttl_s=0.5,
            backoff_base_s=0.01, backoff_cap_s=0.05,
            journal_prefix=str(tmp_path / "s0" / "_replica"))
        nodes[0] = node
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()
        out += [node.rejoining,
                node.membership.self_incarnation > old_inc,
                node.leases.max_epoch_of(doc) >= old_epoch,
                node.owns(doc),
                node.metrics.get("fencing", "rejoin_denials") >= 1]
        for _ in range(4):
            _step(nodes)
            if not node.rejoining:
                break
        out += [node.rejoining,
                node.metrics.get("quorum", "rejoins_completed"),
                node.owns(doc), node.leases.get(doc).epoch > old_epoch]
        hist = (crashed.leases.activation_history()
                + node.leases.activation_history())
        holders = {}
        for rec in hist:
            holders.setdefault((rec["doc"], rec["epoch"]),
                               set()).add(rec["holder"])
        epochs = [rec["epoch"] for rec in hist if rec["doc"] == doc]
        out += [all(len(h) == 1 for h in holders.values()),
                len(epochs) == len(set(epochs))]
        return out
    finally:
        _teardown(httpds)


def test_crash_restart_rejoins_and_never_reissues_epoch(tmp_path):
    assert _both(_crash_restart, tmp_path) == [
        True, True, True, True, False, True,
        False, 1, True, True, True, True]


def _join_leave(root, tmp_path):
    attach_replication = _mod(root, "replicate").attach_replication
    httpds, nodes, addrs = _mesh(root, 2, tmp_path, lease_ttl_s=5.0)
    out = []
    try:
        _step(nodes)
        httpd3 = _serve(root, port=0, data_dir=str(tmp_path / "s2"),
                        serve_shards=1)
        addr3 = f"127.0.0.1:{httpd3.server_address[1]}"
        node3 = attach_replication(
            httpd3, addr3, [], lease_ttl_s=5.0, backoff_base_s=0.01,
            backoff_cap_s=0.05,
            journal_prefix=str(tmp_path / "s2" / "_replica"))
        threading.Thread(target=httpd3.serve_forever,
                         daemon=True).start()
        out.append(node3.join_mesh(addrs[0]))
        all_nodes = nodes + [node3]
        _step(all_nodes)
        out.append([(n.membership.universe() == sorted(addrs + [addr3]),
                     n.membership.quorum_size()) for n in all_nodes])
        doc = next(f"churn-doc-{i}" for i in range(100)
                   if node3.desired_owner(f"churn-doc-{i}") == addr3)
        out += [nodes[0].desired_owner(doc) == addr3, node3.owns(doc)]
        epoch_joined = node3.leases.get(doc).epoch
        _post(addrs[0], "/replicate/leave", {"id": addr3})
        httpd3.shutdown()
        httpd3.server_close()
        _step(nodes)
        out.append([(addr3 in n.membership.universe(),
                     addr3 in n.membership.voters(),
                     n.membership.quorum_size()) for n in nodes])
        new_owner = nodes[0].desired_owner(doc)
        owner_node = next(n for n in nodes if n.self_id == new_owner)
        owner_node.leases.observe_remote(doc, addr3, epoch_joined,
                                         "active", ttl_s=0.0)
        out += [new_owner in addrs, owner_node.owns(doc),
                owner_node.leases.get(doc).epoch > epoch_joined]
        return out
    finally:
        _teardown(httpds)


def test_membership_join_leave_moves_ownership(tmp_path):
    assert _both(_join_leave, tmp_path) == [
        True, [(True, 2)] * 3, True, True, [(False, False, 2)] * 2,
        True, True, True]


# ---- the elastic-mesh soaks, on the port -------------------------------------------

def test_flash_crowd_soak_migrates_joins_and_recovers():
    """`tests/test_rebalance.py`'s acceptance run on port servers: the
    flash crowd burns the SLO, the rebalancer sheds the hot doc, the
    mid-soak joiner absorbs load, the injected abort rolls back, and the
    mesh reconverges byte-identical with zero split-brain."""
    rep = _mod(PORT, "replicate.rebalance_soak").run_rebalance_soak(
        device="cpu")
    assert rep["ok"], rep
    assert rep["settled"]
    assert rep["slo_states"][0] == "ok"
    assert rep["burning_seen"]
    assert rep["slo_states"][-1] == "ok"
    assert rep["slo_journey_ok"]
    assert len(rep["migrations"]) >= 1
    assert rep["joined"]
    assert rep["join_absorbed"]
    assert rep["abort_rollback_ok"]
    assert rep["converged"]
    assert rep["zero_split_brain"]


def test_split_hot_doc_soak_verdict():
    """`rebalance-soak --split-hot-doc` on port servers: promotion and
    both demotions without an operator, admission scaled >= 2x with two
    writers, every acked marker on every server, zero split-brain."""
    rep = _mod(PORT, "replicate.rebalance_soak").run_split_soak(
        device="cpu")
    assert rep["ok"], {k: v for k, v in rep.items() if k != "metrics"}
    assert rep["settled"] and rep["promoted"] and rep["repromoted"]
    assert rep["throughput_ok"] and rep["speedup"] >= 2.0
    assert all(rep["member_crash"].values())
    assert all(rep["partition_minority"].values())
    assert rep["lost_markers"] == [] or rep["lost_markers"] == 0
    assert rep["converged"] and rep["zero_split_brain"]
    assert rep["groups_clear"]


# ---- on the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_split_hot_doc_soak_on_card_launches_its_kernels(monkeypatch):
    """`run_split_soak` with every server merging on the card: the soak's
    verdict, K1 launched for every fused call and per-doc replay of the
    servers' schedulers, K2 for every resolve."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch_parity import ServedLaunches
    served = ServedLaunches(monkeypatch)
    rep = _mod(PORT, "replicate.rebalance_soak").run_split_soak()
    assert rep["ok"], {k: v for k, v in rep.items() if k != "metrics"}
    assert len(served.httpds) == 3
    served.check()
