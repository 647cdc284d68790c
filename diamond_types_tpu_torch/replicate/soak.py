"""In-process N-server replication soak (CLI: `replicate-soak`).

Boots N sync servers on ephemeral localhost ports, wires them into one
mesh sharing a single seeded FaultInjector, then drives rounds of
client edits at random servers while dropping, delaying and
partitioning the inter-server links. After the fault window every
partition heals and reconciliation rounds run until every live server
holds byte-identical text for every doc (or the round budget runs out).

Chaos mode (the partition-safety PR's acceptance surface) layers on:

  * `asym`      — the partition window uses ONE-WAY cuts (a hears b,
                  b cannot reach a: the TTL-takeover killer), plus a
                  jittered slow link and clock-skew bookkeeping;
  * `crash`     — two nodes are crash-restarted mid-run: the process
                  is torn down WITHOUT closing its replica journal
                  (the WAL replays at reboot), restarted on the same
                  port + data dir, and must re-earn quorum through the
                  rejoining fence before merging again;
  * `churn`     — an extra node joins the mesh mid-run via
                  /replicate/join, then explicitly leaves.

Stepping is inline and single-threaded on purpose — probes, lease
maintenance and anti-entropy advance once per round in a fixed order —
so a given seed replays the exact fault schedule (see faults.py's
determinism contract). The HTTP servers themselves still run real
threads; only the *replication control plane* is stepped.

Invariants checked (report fields):
  * convergence — all live servers byte-identical on every doc;
  * zero split-brain — the detector scans EVERY node incarnation's
    activation history (live + crashed) for two ACTIVE holders sharing
    one (doc, epoch); `split_brain` must be empty. This is the quorum
    safety property, checked from the ground truth rather than
    asserted from the design;
  * owner-only merges — across the run a doc may legitimately appear
    in several hosts' merged sets (lease takeover after a partition /
    crash), reported as `multi_merger_docs` and required to be 0 when
    no partition, crash or churn was configured.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.request
from typing import Dict, List, Optional

from .faults import FaultInjector
from .node import attach_replication

_WORDS = ("sync", "merge", "lease", "patch", "shard", "probe",
          "quorum", "epoch", "drain", "heal")


def _split_brain(all_nodes) -> List[str]:
    """Scan every node incarnation's activation history for a
    (doc, epoch) that two DIFFERENT holders both activated — the
    at-most-one-ACTIVE-per-(doc, epoch) violation quorum forbids."""
    holders: Dict[tuple, set] = {}
    for n in all_nodes:
        for rec in n.leases.activation_history():
            holders.setdefault(
                (rec["doc"], rec["epoch"]), set()).add(rec["holder"])
    return sorted(f"{d}@e{e}" for (d, e), hs in holders.items()
                  if len(hs) > 1)


def run_replicate_soak(servers: int = 3, docs: int = 4, rounds: int = 20,
                       edits_per_round: int = 4, seed: int = 7,
                       drop_rate: float = 0.15, delay_rate: float = 0.0,
                       max_delay_s: float = 0.0, dup_rate: float = 0.05,
                       partition_rounds: int = 6,
                       reconcile_rounds: int = 12,
                       lease_ttl_s: float = 1.0,
                       serve_shards: int = 0,
                       crash: bool = False, asym: bool = False,
                       churn: bool = False,
                       witness: Optional[bool] = None,
                       data_dir: Optional[str] = None,
                       progress: bool = False, device=None) -> dict:
    from ..gpu import resolve_device
    from ..tools.server import SyncClient, serve

    # the servers' merge device (serve(device=...)): None means CUDA,
    # which must exist; "cpu" runs the kernels' plain versions
    resolve_device(device)

    # the lease machinery is exercised through the scheduler's admit
    # gate, so the chaos modes (whose whole point is quorum + fencing)
    # force at least one serve shard
    if (crash or asym or churn) and serve_shards == 0:
        serve_shards = 1
    # runtime lock witness: on by default for the chaos modes — those
    # are exactly the runs whose thread interleavings are worth mining
    # for lock-order edges (witness=False forces it off, True forces on)
    use_witness = witness if witness is not None else (crash or churn)
    if use_witness:
        from ..analysis import witness_enable, witness_reset
        witness_reset()
        witness_enable()
    rng = random.Random(seed)
    faults = FaultInjector(seed=seed, drop_rate=drop_rate,
                           dup_rate=dup_rate, delay_rate=delay_rate,
                           max_delay_s=max_delay_s)
    # crash-restart needs persistence (docs survive via .dt files, the
    # replica journal survives via the Wal); make dirs on demand
    if crash and data_dir is None:
        import tempfile
        data_dir = tempfile.mkdtemp(prefix="dt-soak-")
    dirs: List[Optional[str]] = []

    httpds: List = []
    nodes: List = []
    addrs: List[str] = []
    live: List[bool] = []
    dead_nodes: List = []    # crashed/left incarnations, kept for the
    #                          split-brain scan (their logs are evidence)
    node_opts = dict(seed=seed, lease_ttl_s=lease_ttl_s, faults=faults,
                     timeout_s=2.0, backoff_base_s=0.02,
                     backoff_cap_s=0.1)

    def _dir(i: int) -> Optional[str]:
        if data_dir is None:
            return None
        d = os.path.join(data_dir, f"n{i}")
        os.makedirs(d, exist_ok=True)
        return d

    def boot(i: int, port: int = 0, join_to: Optional[str] = None):
        """Boot (or reboot) server slot `i` and attach its replica."""
        # sample_rate=1.0: every soak edit gets a trace AND a journey.
        # follower_reads gives each owner a FollowerIndex, whose advert
        # hook closes journeys at advert_usable — without it the
        # verdict's convergence-lag column exists but never populates.
        httpd = serve(port=port, serve_shards=serve_shards,
                      data_dir=dirs[i], follower_reads=True,
                      obs_opts=dict(sample_rate=1.0), device=device)
        addr = f"127.0.0.1:{httpd.server_address[1]}"
        opts = dict(node_opts)
        if dirs[i] is not None:
            opts["journal_prefix"] = os.path.join(dirs[i], "_replica")
        peer_list = [a for j, a in enumerate(addrs) if j != i] \
            if join_to is None else []
        node = attach_replication(httpd, addr, peer_list, **opts)
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()
        if join_to is not None:
            node.join_mesh(join_to)
        return httpd, node, addr

    for i in range(servers):
        dirs.append(_dir(i))
        httpd = serve(port=0, serve_shards=serve_shards,
                      data_dir=dirs[i], follower_reads=True,
                      obs_opts=dict(sample_rate=1.0), device=device)
        httpds.append(httpd)
        addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
        live.append(True)
    for i, httpd in enumerate(httpds):
        opts = dict(node_opts)
        if dirs[i] is not None:
            opts["journal_prefix"] = os.path.join(dirs[i], "_replica")
        node = attach_replication(
            httpd, addrs[i], [a for a in addrs if a != addrs[i]],
            **opts)
        nodes.append(node)
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()

    def crash_node(i: int) -> None:
        """Tear slot `i` down WITHOUT closing its journal (the reboot
        replays the WAL, torn tail and all)."""
        node = nodes[i]
        node.journal = None          # crash: no graceful close/compact
        node.leases.journal = None
        httpds[i].shutdown()
        httpds[i].server_close()
        dead_nodes.append(node)
        live[i] = False

    def reboot_node(i: int) -> None:
        port = int(addrs[i].split(":")[1])
        httpd, node, _addr = boot(i, port=port)
        httpds[i] = httpd
        nodes[i] = node
        live[i] = True

    doc_ids = [f"soak-{i}" for i in range(docs)]
    clients: Dict[tuple, SyncClient] = {}

    def client(server_i: int, doc_id: str) -> SyncClient:
        key = (server_i, doc_id)
        if key not in clients:
            clients[key] = SyncClient(
                f"http://{addrs[server_i]}", doc_id,
                f"agent-{server_i}-{doc_id}", retries=2)
        return clients[key]

    def step_control_plane() -> None:
        for j, node in enumerate(nodes):
            if not live[j]:
                continue
            node.table.probe_once()
            node.maintain()
        for j, node in enumerate(nodes):
            if live[j]:
                node.antientropy.run_round()

    def live_addrs() -> List[str]:
        return [a for j, a in enumerate(addrs) if live[j]]

    part_pair = (addrs[0], addrs[1]) if servers >= 2 \
        and partition_rounds > 0 else None
    if asym and servers >= 3:
        # one slow, jittered link + a skewed clock: neither may break
        # safety, only latency
        faults.set_link_latency(addrs[0], addrs[2], 0.005,
                                jitter_s=0.005)
        faults.set_clock_skew(addrs[1], 0.5)
    # two crash-restart events, spread across the run, avoiding the
    # partition window's endpoints (those nodes are already stressed)
    crash_at = {}
    if crash and rounds >= 6:
        victims = [rng.randrange(servers) for _ in range(2)]
        crash_at = {max(2, rounds // 3): victims[0],
                    max(4, (2 * rounds) // 3): victims[1]}
    churn_join_at = rounds // 2 if churn else None
    churn_leave_at = (3 * rounds) // 4 if churn else None
    churn_idx: Optional[int] = None

    t0 = time.monotonic()
    edits = 0
    crashes = 0
    pending_reboot: Dict[int, int] = {}   # slot -> reboot round
    for r in range(rounds):
        if part_pair and r == 1:
            faults.partition(*part_pair, oneway=asym)
        if part_pair and r == 1 + partition_rounds:
            faults.heal(*part_pair)
        if r in crash_at and live[crash_at[r]]:
            i = crash_at[r]
            crash_node(i)
            crashes += 1
            pending_reboot[i] = r + 2     # two rounds of downtime
            if progress:
                print(f"round {r + 1}: crashed {addrs[i]}")
        for i, back_at in list(pending_reboot.items()):
            if r >= back_at:
                reboot_node(i)
                del pending_reboot[i]
                if progress:
                    print(f"round {r + 1}: rebooted {addrs[i]}")
        if churn_join_at is not None and r == churn_join_at:
            dirs.append(_dir(len(dirs)))
            churn_idx = len(addrs)
            addrs.append("")              # placeholder; boot fills it
            live.append(False)
            httpd, node, addr = boot(churn_idx,
                                     join_to=live_addrs()[0])
            httpds.append(httpd)
            nodes.append(node)
            addrs[churn_idx] = addr
            live[churn_idx] = True
            if progress:
                print(f"round {r + 1}: joined {addr}")
        if churn_leave_at is not None and r == churn_leave_at \
                and churn_idx is not None and live[churn_idx]:
            # explicit leave, announced to a surviving member so the
            # LEFT state gossips; then the node goes away for good
            target = [a for j, a in enumerate(addrs)
                      if live[j] and j != churn_idx][0]
            who = addrs[churn_idx]
            try:
                req = urllib.request.Request(
                    f"http://{target}/replicate/leave",
                    data=json.dumps({"id": who}).encode("utf8"))
                urllib.request.urlopen(req, timeout=2).read()
            except OSError:
                pass
            node = nodes[churn_idx]
            httpds[churn_idx].shutdown()
            httpds[churn_idx].server_close()
            dead_nodes.append(node)
            live[churn_idx] = False
            if progress:
                print(f"round {r + 1}: left {who}")
        for _ in range(edits_per_round):
            alive = [j for j in range(len(addrs)) if live[j]]
            si = rng.choice(alive)
            doc = rng.choice(doc_ids)
            c = client(si, doc)
            try:
                c.pull()
            except OSError:
                pass    # client keeps editing its local replica
            pos = rng.randrange(len(c.text()) + 1)
            c.insert(pos, rng.choice(_WORDS) + " ")
            try:
                c.sync()
                edits += 1
            except OSError:
                pass    # retries exhausted mid-fault; next round
        step_control_plane()
        if progress:
            print(f"round {r + 1}/{rounds}: {edits} edits applied")

    # fault window over: reboot stragglers, heal everything and
    # reconcile to convergence
    for i in list(pending_reboot):
        reboot_node(i)
        del pending_reboot[i]
    faults.heal()
    converged_after = None
    for r in range(reconcile_rounds):
        time.sleep(0.05)   # let breaker backoff windows lapse
        step_control_plane()
        if _converged(live_addrs(), doc_ids):
            converged_after = r + 1
            break

    texts = _final_texts(live_addrs(), doc_ids)
    converged = all(len(set(v.values())) == 1 for v in texts.values())
    all_nodes = nodes + dead_nodes
    split_brain = _split_brain(all_nodes)
    live_nodes = [n for j, n in enumerate(nodes) if live[j]]
    mergers = {d: sorted({n.self_id for n in all_nodes
                          if d in n.merged_docs}) for d in doc_ids}
    multi = sorted(d for d, who in mergers.items() if len(who) > 1)
    fencing_totals = {
        k: sum(n.metrics.get("fencing", k) for n in all_nodes)
        for k in ("rejected_writes", "stale_lease_revoked",
                  "rejoin_denials")}
    quorum_totals = {
        k: sum(n.metrics.get("quorum", k) for n in all_nodes)
        for k in ("rounds_won", "rounds_lost", "promise_conflicts",
                  "rejoins_completed")}
    report = {
        "config": {"servers": servers, "docs": docs, "rounds": rounds,
                   "edits_per_round": edits_per_round, "seed": seed,
                   "drop_rate": drop_rate, "dup_rate": dup_rate,
                   "partition_rounds": partition_rounds,
                   "lease_ttl_s": lease_ttl_s,
                   "serve_shards": serve_shards,
                   "crash": crash, "asym": asym, "churn": churn},
        "edits_applied": edits,
        "converged": converged,
        "converged_after_reconcile_rounds": converged_after,
        "split_brain": split_brain,
        "zero_split_brain": not split_brain,
        "crashes": crashes,
        "fencing": fencing_totals,
        "quorum": quorum_totals,
        "multi_merger_docs": multi,
        "mergers": mergers,
        "doc_lengths": {d: {a: len(t) for a, t in v.items()}
                        for d, v in texts.items()},
        "faults": faults.snapshot(),
        "wall_s": round(time.monotonic() - t0, 3),
        "metrics": {n.self_id: n.metrics_json() for n in live_nodes},
        # edit-to-visibility: per-peer convergence-lag rollup of every
        # journey each owner tracked (admitted -> advert_usable)
        "convergence_lag": {
            n.self_id: n.obs.journey.lag_summary()
            for n in live_nodes if getattr(n, "obs", None) is not None},
    }
    if use_witness:
        # the observed lock-order graph across every thread the soak
        # ran (flush workers, maintenance loops, HTTP handlers): a
        # cycle is a latent deadlock the run merely didn't lose the
        # race to, so acyclicity joins the verdict
        from ..analysis import witness_disable, witness_snapshot
        snap = witness_snapshot()
        witness_disable()
        report["lock_witness"] = {
            "acquires": snap["acquires"],
            "edge_count": snap["edge_count"],
            "edges": snap["edges"],
            "violation_count": snap["violation_count"],
            "cycles": snap["cycles"],
            "acyclic": snap["acyclic"]
            and not snap["violation_count"],
        }
    if not (converged and not split_brain
            and report.get("lock_witness", {}).get("acyclic", True)):
        # flight-recorder tail makes a failed soak diagnosable from the
        # JSON report alone: last 50 events across all live recorders
        events = []
        for n in live_nodes:
            obs = getattr(n, "obs", None)
            if obs is None:
                continue
            for ev in obs.recorder.tail(50):
                events.append(dict(ev, node=n.self_id))
        events.sort(key=lambda e: e.get("t", 0.0))
        report["events_tail"] = events[-50:]
    for j, httpd in enumerate(httpds):
        if live[j]:
            httpd.shutdown()
            httpd.server_close()
    return report


def _get_text(addr: str, doc_id: str) -> str:
    with urllib.request.urlopen(f"http://{addr}/doc/{doc_id}",
                                timeout=5) as r:
        return r.read().decode("utf8")


def _final_texts(addrs: List[str],
                 doc_ids: List[str]) -> Dict[str, Dict[str, str]]:
    return {d: {a: _get_text(a, d) for a in addrs} for d in doc_ids}


def _converged(addrs: List[str], doc_ids: List[str]) -> bool:
    for d in doc_ids:
        if len({_get_text(a, d) for a in addrs}) > 1:
            return False
    return True


def main(argv=None) -> int:  # pragma: no cover - exercised via cli.py
    import argparse
    p = argparse.ArgumentParser(prog="replicate-soak")
    p.add_argument("--servers", type=int, default=3)
    p.add_argument("--docs", type=int, default=4)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--drop-rate", type=float, default=0.15)
    p.add_argument("--crash", action="store_true")
    p.add_argument("--asym", action="store_true")
    p.add_argument("--churn", action="store_true")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None,
                   help="the servers' merge device (default: CUDA, "
                   "which must exist)")
    args = p.parse_args(argv)
    report = run_replicate_soak(servers=args.servers, docs=args.docs,
                                rounds=args.rounds, seed=args.seed,
                                drop_rate=args.drop_rate,
                                crash=args.crash, asym=args.asym,
                                churn=args.churn, device=args.device)
    print(json.dumps(report if args.json else {
        k: report[k] for k in ("converged", "edits_applied",
                               "split_brain", "zero_split_brain",
                               "crashes", "fencing",
                               "multi_merger_docs", "wall_s")
        if k in report}))
    return 0 if (report["converged"] and report["zero_split_brain"]
                 and report.get("lock_witness",
                                {}).get("acyclic", True)) else 1
