"""Flash-crowd elastic-mesh soak (CLI: `rebalance-soak`).

Boots N in-process sync servers (one serve shard each, follower reads
on) into one replication mesh, lets rendezvous placement spread the
docs, then runs a deterministic closed-loop load model against a
tight custom SLO:

  * healthy phase — per-edit RTT observations land under the latency
    threshold on every owner; the `soak_edit_rtt` objective reads
    `ok` everywhere;
  * flash crowd — one doc goes hot and its owner's capacity saturates
    (modeled as a fixed load boost on top of that host's held-lease
    count); every edit owned by the crowded host observes an
    over-threshold RTT, its objective burns, and the REBALANCER —
    ticked from the same single-threaded control-plane step as probes
    and anti-entropy, no operator in the loop — sheds the hot doc
    first (attribution-ranked) and keeps shedding until the host fits
    its capacity again;
  * scale-out — on the first non-`ok` evaluation a fresh host joins
    the mesh via /replicate/join; with gossiped load 0 it is the
    least-loaded target and must absorb at least one migrated doc;
  * self-healing — one migration is aimed at an unreachable target on
    purpose: the handoff must abort back to ACTIVE at the source with
    the SAME epoch and the placement override tombstoned (a failed
    target never strands a doc);
  * recovery — with the crowd still running, the migrated layout keeps
    every host under capacity, good observations dilute / age out the
    burn windows, and the objective returns to `ok`.

Exit-0 verdict (the `--flash-crowd` acceptance gate): the SLO journey
ok -> burning -> ok completed without operator action, at least one
migration ran, the joined host absorbed load, the seeded abort rolled
back cleanly, every server converged byte-identically on every doc,
and the activation-history scan found zero split-brain.

Like the other soaks, the replication control plane is stepped inline
and single-threaded so a given seed replays exactly; only the HTTP
servers run real threads.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, List, Optional

from ..obs import Objective
from .node import attach_replication
from .rebalance import attach_rebalancer
from .soak import _converged, _final_texts, _split_brain

# per-event latency budget of the soak objective; the load model emits
# 0.01 s (healthy) or 1.0 s (saturated) observations around it
_RTT_THRESHOLD_S = 0.5
_RTT_GOOD_S = 0.01
_RTT_BAD_S = 1.0
# observation weights: the hot doc is hammered, the crowded host's
# other docs feel the contention, everything else idles along
_W_HOT = 12
_W_CROWDED = 3


def _objective(fast_window_s: float, slow_window_s: float) -> Objective:
    # target 0.7 => warning at bad-fraction 0.3, burning at 0.6 on
    # both windows — tight enough that one saturated round pages,
    # short enough that recovery is observable in soak wall time
    return Objective("soak_edit_rtt", "soak.edit_rtt",
                     threshold_s=_RTT_THRESHOLD_S, target=0.7,
                     fast_window_s=fast_window_s,
                     slow_window_s=slow_window_s,
                     fast_burn=2.0, slow_burn=2.0)


def run_rebalance_soak(servers: int = 3, docs: int = 8, seed: int = 7,
                       capacity: int = 5, crowd_boost: int = 3,
                       healthy_rounds: int = 3,
                       crowd_rounds: int = 6,
                       recover_rounds: int = 60,
                       reconcile_rounds: int = 20,
                       flash_crowd: bool = True,
                       join: bool = True,
                       inject_abort: bool = True,
                       lease_ttl_s: float = 30.0,
                       fast_window_s: float = 3.0,
                       slow_window_s: float = 6.0,
                       progress: bool = False, device=None) -> dict:
    from ..gpu import resolve_device
    from ..tools.server import SyncClient, serve

    # the servers' merge device (serve(device=...)): None means CUDA,
    # which must exist; "cpu" runs the kernels' plain versions
    resolve_device(device)
    rng = random.Random(seed)
    doc_ids = [f"elastic-{i}" for i in range(docs)]
    # sample_rate=1.0 so every edit carries a journey — the verdict's
    # convergence-lag column needs advert_usable stamps to aggregate
    obs_opts = dict(sample_rate=1.0, ts_window_s=0.5, ts_windows=64,
                    objectives=[_objective(fast_window_s,
                                           slow_window_s)])
    node_opts = dict(seed=seed, lease_ttl_s=lease_ttl_s,
                     probe_interval_s=0.25,
                     antientropy_interval_s=0.25,
                     timeout_s=2.0, backoff_base_s=0.02,
                     backoff_cap_s=0.1)
    # act only on burning: the gate's SLO journey must REACH burning
    # before the first migration cures the crowd — acting on warning
    # too (the default) would race the journey against the fix under
    # wall-clock contention
    rb_opts = dict(cooldown_s=0.2, max_migrations_per_tick=1,
                   min_load_gap=2, top_n=4, act_on=("burning",))

    httpds: List = []
    nodes: List = []
    addrs: List[str] = []

    def boot(join_to: Optional[str] = None):
        httpd = serve(port=0, serve_shards=1, follower_reads=True,
                      obs_opts=dict(obs_opts), device=device)
        httpd.socket.listen(128)
        addr = f"127.0.0.1:{httpd.server_address[1]}"
        node = attach_replication(httpd, addr, [], **node_opts)
        attach_rebalancer(node, **rb_opts)
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()
        if join_to is not None:
            node.join_mesh(join_to)
        return httpd, node, addr

    for i in range(servers):
        httpd = serve(port=0, serve_shards=1, follower_reads=True,
                      obs_opts=dict(obs_opts), device=device)
        httpd.socket.listen(128)
        httpds.append(httpd)
        addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
    for i, httpd in enumerate(httpds):
        node = attach_replication(
            httpd, addrs[i], [a for a in addrs if a != addrs[i]],
            **node_opts)
        attach_rebalancer(node, **rb_opts)
        nodes.append(node)
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()

    migrations: List[List[str]] = []
    tick_aborts: List[List[str]] = []

    def step_control_plane() -> None:
        for n in nodes:
            n.table.probe_once()
            n.maintain()
        for n in nodes:
            rep = n.rebalancer.tick()
            migrations.extend(rep["migrated"])
            tick_aborts.extend(rep["aborted"])
        for n in nodes:
            n.antientropy.run_round()

    clients: Dict[tuple, SyncClient] = {}

    def client(i: int, doc_id: str) -> SyncClient:
        key = (i, doc_id)
        if key not in clients:
            clients[key] = SyncClient(
                f"http://{addrs[i]}", doc_id,
                f"agent-{i}-{doc_id}", retries=2)
        return clients[key]

    def edit(i: int, doc_id: str, word: str) -> bool:
        c = client(i, doc_id)
        try:
            c.pull()
        except OSError:
            pass
        c.insert(rng.randrange(len(c.text()) + 1), word + " ")
        try:
            c.sync()
            return True
        except OSError:
            return False

    def owner_of(doc_id: str):
        holders = [n for n in nodes
                   if n.leases.active_epoch(doc_id) > 0]
        return holders[0] if len(holders) == 1 else None

    crowd_target = None     # the host the SLO journey is tracked on
    hot_doc = doc_ids[0]    # re-picked after settle (most-loaded host)

    def observe_round(crowd_on: bool) -> None:
        """The load model: weighted RTT observations per doc at its
        owner. The crowd load FOLLOWS the hot doc — whichever host
        currently owns it carries the boost on top of its held-lease
        count, so migrating the hot doc to a host with headroom (and
        only that) is what restores the SLO."""
        hot_owner = owner_of(hot_doc) if crowd_on else None
        for doc_id in doc_ids:
            own = owner_of(doc_id)
            if own is None:
                continue
            eff = own.leases.held_count() \
                + (crowd_boost if own is hot_owner else 0)
            rtt = _RTT_BAD_S if eff > capacity else _RTT_GOOD_S
            if not crowd_on:
                weight = 1
            elif doc_id == hot_doc:
                weight = _W_HOT
            elif own is hot_owner:
                weight = _W_CROWDED
            else:
                weight = 1
            for _ in range(weight):
                own.obs.ts.observe("soak.edit_rtt", rtt)
            own.obs.attrib.note("ops", doc=doc_id, n=float(weight))

    def slo_state() -> str:
        if crowd_target is None:
            return "ok"
        return crowd_target.obs.slo.evaluate()[0]["state"]

    t0 = time.monotonic()
    edits = 0

    # ---- seed + settle: one ACTIVE owner per doc --------------------------
    for doc_id in doc_ids:
        if edit(rng.randrange(servers), doc_id, "seed"):
            edits += 1
    for _ in range(40):
        step_control_plane()
        if all(owner_of(d) is not None for d in doc_ids):
            break
        time.sleep(0.02)
    settled = all(owner_of(d) is not None for d in doc_ids)
    held_initial = {n.self_id: n.leases.held_count() for n in nodes}
    # the hot doc lives on the most-loaded host: with boost just under
    # capacity, saturation needs co-resident load, and the crowded
    # host only recovers by SHEDDING (a one-doc host never saturates)
    crowd_target = max(nodes, key=lambda n: n.leases.held_count())
    held = crowd_target.leases.held_ids()
    if held:
        hot_doc = held[0]

    states: List[str] = []

    # ---- healthy phase ----------------------------------------------------
    for _ in range(healthy_rounds):
        if edit(rng.randrange(servers), rng.choice(doc_ids), "calm"):
            edits += 1
        observe_round(crowd_on=False)
        step_control_plane()
        states.append(slo_state())
        time.sleep(0.02)
    healthy_state = states[-1] if states else "ok"

    joined_addr: Optional[str] = None
    joined_node = None
    burn_seen = False

    # ---- flash crowd ------------------------------------------------------
    if flash_crowd and crowd_target is not None:
        # adaptive: at least crowd_rounds, and keep crowding until the
        # SLO actually reaches burning (capped) — window rollover
        # timing under a loaded machine must not decide the journey
        max_crowd = max(crowd_rounds, 40)
        r = -1
        while (r := r + 1) < crowd_rounds \
                or (not burn_seen and r < max_crowd):
            for _ in range(2):
                if edit(rng.randrange(len(addrs)), hot_doc, "crowd"):
                    edits += 1
            if edit(rng.randrange(len(addrs)),
                    rng.choice(doc_ids), "bg"):
                edits += 1
            observe_round(crowd_on=True)
            st = slo_state()
            states.append(st)
            burn_seen = burn_seen or st == "burning"
            # scale-out response: the join lands BEFORE this round's
            # rebalancer tick, so the fresh (load 0) host is already
            # the preferred target when migrations are planned
            if st != "ok" and join and joined_node is None:
                httpd, joined_node, joined_addr = boot(
                    join_to=addrs[0])
                httpds.append(httpd)
                nodes.append(joined_node)
                addrs.append(joined_addr)
                if progress:
                    print(f"crowd round {r + 1}: slo={st}; "
                          f"joined {joined_addr}")
            step_control_plane()
            if progress:
                print(f"crowd round {r + 1}: slo={st} target.held="
                      f"{crowd_target.leases.held_count()} "
                      f"migrations={len(migrations)}")
            time.sleep(0.05)

        # ---- recovery: the crowd keeps running ----------------------------
        for r in range(recover_rounds):
            if edit(rng.randrange(len(addrs)), hot_doc, "crowd"):
                edits += 1
            observe_round(crowd_on=True)
            step_control_plane()
            st = slo_state()
            states.append(st)
            if st == "ok":
                break
            time.sleep(0.25)

    # ---- seeded abort: migration at an unreachable target -----------------
    abort_rollback_ok = None
    if inject_abort:
        victims = [n for n in nodes if n.leases.held_count() > 0]
        src = victims[0] if victims else nodes[0]
        doc_id = src.leases.held_ids()[0]
        epoch_before = src.leases.active_epoch(doc_id)
        aborted_before = src.metrics.get("rebalance",
                                         "migrations_aborted")
        moved = src.rebalancer.migrate(doc_id, "127.0.0.1:1")
        abort_rollback_ok = (
            not moved
            and src.leases.active_epoch(doc_id) == epoch_before
            and epoch_before > 0
            and src.overrides.target_of(doc_id) is None
            and src.metrics.get("rebalance", "migrations_aborted")
            == aborted_before + 1)

    # ---- reconcile to convergence -----------------------------------------
    converged_after = None
    for r in range(reconcile_rounds):
        step_control_plane()
        if _converged(addrs, doc_ids):
            converged_after = r + 1
            break
        time.sleep(0.05)
    texts = _final_texts(addrs, doc_ids)
    converged = all(len(set(v.values())) == 1 for v in texts.values())
    split_brain = _split_brain(nodes)

    slo_journey_ok = (not flash_crowd) or (
        healthy_state == "ok" and burn_seen
        and bool(states) and states[-1] == "ok")
    join_absorbed = (not (flash_crowd and join)) or (
        joined_node is not None
        and (joined_node.leases.held_count() > 0
             or any(n.overrides.target_of(d) == joined_addr
                    for n in nodes for d in doc_ids)))
    ok = bool(
        settled and converged and not split_brain
        and slo_journey_ok and join_absorbed
        and (not flash_crowd or len(migrations) >= 1)
        and (abort_rollback_ok is None or abort_rollback_ok))

    report = {
        "config": {"servers": servers, "docs": docs, "seed": seed,
                   "capacity": capacity, "crowd_boost": crowd_boost,
                   "flash_crowd": flash_crowd, "join": join,
                   "inject_abort": inject_abort,
                   "lease_ttl_s": lease_ttl_s},
        "edits_applied": edits,
        "settled": settled,
        "held_initial": held_initial,
        "crowd_target": getattr(crowd_target, "self_id", None),
        "hot_doc": hot_doc,
        "slo_states": states,
        "slo_journey_ok": slo_journey_ok,
        "burning_seen": burn_seen,
        "migrations": migrations,
        "tick_aborts": tick_aborts,
        "joined": joined_addr,
        "join_absorbed": join_absorbed,
        "abort_rollback_ok": abort_rollback_ok,
        "held_final": {n.self_id: n.leases.held_count()
                       for n in nodes},
        "override_tables": {n.self_id: n.overrides.size()
                            for n in nodes},
        "converged": converged,
        "converged_after_reconcile_rounds": converged_after,
        "split_brain": split_brain,
        "zero_split_brain": not split_brain,
        "wall_s": round(time.monotonic() - t0, 3),
        "metrics": {n.self_id: n.metrics_json() for n in nodes},
        # edit-to-visibility per peer (admitted -> advert_usable); a
        # migration that stalls replication shows up here even when
        # the lease counters look healthy
        "convergence_lag": {
            n.self_id: n.obs.journey.lag_summary()
            for n in nodes if getattr(n, "obs", None) is not None},
        "ok": ok,
    }
    if not ok:
        events = []
        for n in nodes:
            obs = getattr(n, "obs", None)
            if obs is None:
                continue
            for ev in obs.recorder.tail(50):
                events.append(dict(ev, node=n.self_id))
        events.sort(key=lambda e: e.get("t", 0.0))
        report["events_tail"] = events[-50:]
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()
    return report


def run_split_soak(servers: int = 3, docs: int = 4, seed: int = 11,
                   capacity_per_round: int = 4,
                   offered_per_round: int = 10,
                   measure_rounds: int = 6,
                   lease_ttl_s: float = 30.0,
                   group_ttl_s: float = 1.5,
                   fast_window_s: float = 3.0,
                   slow_window_s: float = 6.0,
                   progress: bool = False, device=None) -> dict:
    """Hot-doc write-splitting soak (CLI: `rebalance-soak
    --split-hot-doc`).

    The single-writer wall: every hot-doc write must be APPLIED at the
    one lease holder — writes ingested elsewhere are proxied to it —
    so one host's apply capacity caps the doc no matter how many peers
    idle. Like the flash-crowd soak's RTT model, capacity is modeled
    explicitly (`capacity_per_round` applied writes per WRITER host per
    control round, offered load above it); every admitted write is a
    REAL HTTP edit with a unique marker, so convergence, acked-loss
    and split-brain are checked for real, not modeled.

    Phases, all driven by the closed loop (no operator action):

      * single-writer baseline — offered load arrives at two ingress
        hosts; the non-owner PROXIES (its merge gate admits nothing),
        so per-round admission is 1x capacity;
      * promotion — sustained hot-doc burn makes the REBALANCER
        promote the doc to a {leader, member} writer group;
      * split measurement — the same two ingress hosts now BOTH accept
        locally (the member's merge gate admits under the group
        epoch): per-round admission is 2x capacity — the >= 2x
        throughput gate — while raw wall-clock rates are reported
        unmodeled alongside;
      * member-crash — the member is isolated from the whole mesh
        (mesh-indistinguishable from a crash): it must self-fence to
        proxy-only immediately, and the leader must demote once the
        registration TTL has provably expired;
      * partition-minority — after re-promotion, an ASYMMETRIC cut
        (member cannot reach the leader, the leader still hears the
        member): renewals fail, the member self-fences on expiry, the
        leader's un-renewed registration expires and demotes cleanly.

    Exit-0 verdict: promotion and both demotions happened without
    operator action, admission scaled >= 2x with 2 writers, every
    acked marker is present on every server byte-identically, and the
    activation-history scan found zero split-brain. `device` is the
    servers' merge device, as in `run_rebalance_soak`."""
    from ..gpu import resolve_device
    from ..tools.server import SyncClient, serve
    from .faults import FaultInjector

    resolve_device(device)
    rng = random.Random(seed)
    doc_ids = [f"split-{i}" for i in range(docs)]
    faults = FaultInjector(seed=seed)
    obs_opts = dict(sample_rate=1.0, ts_window_s=0.5, ts_windows=64,
                    objectives=[_objective(fast_window_s,
                                           slow_window_s)])
    node_opts = dict(seed=seed, lease_ttl_s=lease_ttl_s,
                     group_ttl_s=group_ttl_s, faults=faults,
                     probe_interval_s=0.25,
                     antientropy_interval_s=0.25,
                     timeout_s=2.0, backoff_base_s=0.02,
                     backoff_cap_s=0.1)
    # demote_after_s is pushed out of soak range on purpose: the two
    # demotions under test are the FAULT paths (maintain-loop demote on
    # an unhealthy member after TTL), not cooled load
    rb_opts = dict(cooldown_s=0.2, max_migrations_per_tick=1,
                   min_load_gap=2, top_n=4,
                   act_on=("warning", "burning"),
                   split_hot_docs=True, group_size=2,
                   promote_after_ticks=2, demote_after_s=300.0)

    httpds: List = []
    nodes: List = []
    addrs: List[str] = []
    for i in range(servers):
        httpd = serve(port=0, serve_shards=1, follower_reads=True,
                      obs_opts=dict(obs_opts), device=device)
        httpd.socket.listen(128)
        httpds.append(httpd)
        addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
    for i, httpd in enumerate(httpds):
        node = attach_replication(
            httpd, addrs[i], [a for a in addrs if a != addrs[i]],
            **node_opts)
        attach_rebalancer(node, **rb_opts)
        nodes.append(node)
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()

    promotions: List[List] = []
    demotions: List[str] = []

    def step_control_plane() -> None:
        for n in nodes:
            n.table.probe_once()
            n.maintain()
        for n in nodes:
            rep = n.rebalancer.tick()
            promotions.extend(rep["promoted"])
            demotions.extend(rep["demoted"])
        for n in nodes:
            n.antientropy.run_round()

    clients: Dict[tuple, SyncClient] = {}

    def client(addr: str, doc_id: str) -> SyncClient:
        key = (addr, doc_id)
        if key not in clients:
            clients[key] = SyncClient(
                f"http://{addr}", doc_id,
                f"agent-{addr}-{doc_id}", retries=2)
        return clients[key]

    acked_markers: List[Tuple[str, str]] = []   # (doc_id, marker)
    marker_seq = 0

    def write(addr: str, doc_id: str) -> bool:
        nonlocal marker_seq
        marker = f"w{marker_seq}."
        marker_seq += 1
        c = client(addr, doc_id)
        try:
            c.pull()
        except OSError:
            pass
        # always PREPEND: concurrent inserts at position 0 order
        # themselves but can never split an existing marker run, so
        # the acked-loss scan's substring check stays sound under
        # two-writer concurrency
        c.insert(0, marker + " ")
        try:
            c.sync()
        except OSError:
            return False
        acked_markers.append((doc_id, marker))
        return True

    def owner_of(doc_id: str):
        holders = [n for n in nodes
                   if n.leases.active_epoch(doc_id) > 0]
        return holders[0] if len(holders) == 1 else None

    t0 = time.monotonic()

    # ---- seed + settle ----------------------------------------------------
    for doc_id in doc_ids:
        write(addrs[rng.randrange(servers)], doc_id)
    for _ in range(40):
        step_control_plane()
        if all(owner_of(d) is not None for d in doc_ids):
            break
        time.sleep(0.02)
    settled = all(owner_of(d) is not None for d in doc_ids)
    hot_doc = doc_ids[0]
    leader = owner_of(hot_doc)
    if leader is None:
        leader = nodes[0]
    # the co-writer the rebalancer will pick (same selection code)
    picked = leader.rebalancer._pick_members(1)
    member_addr = picked[0] if picked else \
        next(a for a in addrs if a != leader.self_id)
    member = next(n for n in nodes if n.self_id == member_addr)
    ingress = [leader.self_id, member_addr]

    def measure_phase(writers: int):
        """`measure_rounds` control rounds of the capacity model:
        offered load round-robins across both ingress hosts, the first
        `capacity_per_round * writers` writes per round are applied as
        real HTTP edits, the rest are deferred (capacity, not
        transport, is the modeled limit)."""
        acked = 0
        deferred = 0
        t = time.monotonic()
        for _ in range(measure_rounds):
            cap = capacity_per_round * writers
            for i in range(offered_per_round):
                if i >= cap:
                    deferred += 1
                    continue
                if write(ingress[i % 2], hot_doc):
                    acked += 1
            step_control_plane()
        return acked, deferred, time.monotonic() - t

    # ---- single-writer baseline -------------------------------------------
    member_admits_0 = member.metrics.get("writergroup", "member_admits")
    single_acked, single_deferred, single_wall = measure_phase(1)
    single_member_admits = member.metrics.get(
        "writergroup", "member_admits") - member_admits_0

    # ---- promotion under sustained burn -----------------------------------
    promoted = False
    for r in range(40):
        leader.obs.ts.observe("soak.edit_rtt", _RTT_BAD_S)
        leader.obs.attrib.note("ops", doc=hot_doc, n=float(_W_HOT))
        step_control_plane()
        g = leader.writergroups.get(hot_doc)
        if g is not None and g.leader == leader.self_id:
            promoted = True
            break
        time.sleep(0.02)
    g = leader.writergroups.get(hot_doc)
    group_members = list(g.members) if g is not None else []
    member_in_group = member_addr in group_members
    # let the burn windows drain so the measured phase is load-model
    # only (and the member's registration is renewed at least once)
    for _ in range(4):
        leader.obs.ts.observe("soak.edit_rtt", _RTT_GOOD_S)
        step_control_plane()
        time.sleep(0.02)

    # ---- split measurement ------------------------------------------------
    member_admits_1 = member.metrics.get("writergroup", "member_admits")
    group_acked, group_deferred, group_wall = measure_phase(2)
    group_member_admits = member.metrics.get(
        "writergroup", "member_admits") - member_admits_1

    speedup = (group_acked / measure_rounds) \
        / max(single_acked / measure_rounds, 1e-9)
    rate_single = single_acked / max(single_wall, 1e-9)
    rate_group = group_acked / max(group_wall, 1e-9)

    def demote_phase(mem, cut: List[tuple], oneway: bool) -> dict:
        """Inject the cut, require the member to self-fence and the
        leader to demote (TTL-gated, closed loop), then heal."""
        for a, b in cut:
            faults.partition(a, b, oneway=oneway)
        self_fenced = False
        demoted = False
        # count demotions instead of polling for a missing entry: the
        # still-hot rebalancer may legally re-promote (with a healthy
        # co-writer) between our observations
        d0 = leader.metrics.get("writergroup", "demotions")
        deadline = time.monotonic() + max(group_ttl_s * 8, 8.0)
        while time.monotonic() < deadline:
            step_control_plane()
            self_fenced = self_fenced \
                or not mem.group_accepts(hot_doc)
            if leader.metrics.get("writergroup", "demotions") > d0:
                demoted = True
                break
            time.sleep(0.05)
        # the member's registration must be gone BEFORE the heal
        # (self-fence on expiry, or the leader's demote fence); after
        # the heal a still-hot rebalancer may legally re-grant one
        entry_gone = mem.writergroups.get(hot_doc) is None
        if not entry_gone:
            for _ in range(20):
                step_control_plane()
                if mem.writergroups.get(hot_doc) is None:
                    entry_gone = True
                    break
                time.sleep(0.02)
        self_fenced = self_fenced or not mem.group_accepts(hot_doc)
        faults.heal()
        for _ in range(6):
            step_control_plane()
            time.sleep(0.02)
        return {"self_fenced": bool(self_fenced),
                "leader_demoted": demoted,
                "member_entry_gone": entry_gone,
                "owner_active": owner_of(hot_doc) is leader}

    # ---- member-crash: full isolation -------------------------------------
    crash_phase = None
    if promoted:
        crash_phase = demote_phase(
            member,
            [(member_addr, a) for a in addrs if a != member_addr],
            oneway=False)

    # ---- partition-minority: asymmetric member->leader cut ----------------
    repromoted = False
    minority_phase = None
    if promoted and crash_phase is not None:
        member2 = None
        for r in range(40):
            leader.obs.ts.observe("soak.edit_rtt", _RTT_BAD_S)
            leader.obs.attrib.note("ops", doc=hot_doc, n=float(_W_HOT))
            step_control_plane()
            g2 = leader.writergroups.get(hot_doc)
            if g2 is not None and g2.leader == leader.self_id:
                repromoted = True
                others = [m for m in g2.members
                          if m != leader.self_id]
                member2 = next(n for n in nodes
                               if n.self_id == others[0])
                break
            time.sleep(0.02)
        if repromoted and member2 is not None:
            minority_phase = demote_phase(
                member2, [(member2.self_id, leader.self_id)],
                oneway=True)

    # ---- wind-down: cooled-load demotion ----------------------------------
    # stop the burn and let the rebalancer's cooled-load path drain any
    # still-standing group (the closed loop end to end). Re-promotion
    # is blocked by an unreachable tick floor rather than by disabling
    # the policy, so the demote plan stays armed.
    for n in nodes:
        n.rebalancer.promote_after_ticks = 10 ** 9
        n.rebalancer.demote_after_s = 0.0
    winddown_rounds = None
    for r in range(200):
        leader.obs.ts.observe("soak.edit_rtt", _RTT_GOOD_S)
        step_control_plane()
        if all(not n.writergroups.entries() for n in nodes):
            winddown_rounds = r + 1
            break
        time.sleep(0.02)

    # ---- reconcile + verdict ----------------------------------------------
    converged_after = None
    for r in range(40):
        step_control_plane()
        if _converged(addrs, doc_ids):
            converged_after = r + 1
            break
        time.sleep(0.05)
    texts = _final_texts(addrs, doc_ids)
    converged = all(len(set(v.values())) == 1 for v in texts.values())
    split_brain = _split_brain(nodes)
    lost = sorted(
        m for d, m in acked_markers
        if not texts.get(d)
        or any(m not in t for t in texts[d].values()))
    groups_clear = all(not n.writergroups.entries() for n in nodes)

    throughput_ok = (
        single_member_admits == 0          # baseline really proxied
        and group_member_admits > 0        # split really local-accepts
        and speedup >= 2.0)
    demotes_ok = (
        crash_phase is not None
        and all(crash_phase.values())
        and minority_phase is not None
        and all(minority_phase.values()))
    ok = bool(settled and promoted and member_in_group
              and throughput_ok and repromoted and demotes_ok
              and converged and not lost and not split_brain
              and groups_clear)

    report = {
        "config": {"servers": servers, "docs": docs, "seed": seed,
                   "capacity_per_round": capacity_per_round,
                   "offered_per_round": offered_per_round,
                   "measure_rounds": measure_rounds,
                   "group_ttl_s": group_ttl_s,
                   "lease_ttl_s": lease_ttl_s},
        "settled": settled,
        "hot_doc": hot_doc,
        "leader": getattr(leader, "self_id", None),
        "member": member_addr,
        "promoted": promoted,
        "group_members": group_members,
        "single_writer": {
            "acked": single_acked, "deferred": single_deferred,
            "wall_s": round(single_wall, 3),
            "rate_per_s": round(rate_single, 1),
            "member_admits": single_member_admits},
        "writer_group": {
            "acked": group_acked, "deferred": group_deferred,
            "wall_s": round(group_wall, 3),
            "rate_per_s": round(rate_group, 1),
            "member_admits": group_member_admits},
        "speedup": round(speedup, 3),
        "throughput_ok": throughput_ok,
        "member_crash": crash_phase,
        "repromoted": repromoted,
        "partition_minority": minority_phase,
        "rebalancer_promotions": promotions,
        "rebalancer_demotions": demotions,
        "acked_markers": len(acked_markers),
        "lost_markers": lost,
        "converged": converged,
        "winddown_rounds": winddown_rounds,
        "converged_after_reconcile_rounds": converged_after,
        "split_brain": split_brain,
        "zero_split_brain": not split_brain,
        "groups_clear": groups_clear,
        "faults": faults.snapshot(),
        "wall_s": round(time.monotonic() - t0, 3),
        "metrics": {n.self_id:
                    n.metrics_json()["writergroup"] for n in nodes},
        "ok": ok,
    }
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()
    return report


def main(argv=None) -> int:  # pragma: no cover - exercised via cli.py
    import argparse
    p = argparse.ArgumentParser(prog="rebalance-soak")
    p.add_argument("--servers", type=int, default=3)
    p.add_argument("--docs", type=int, default=8)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--flash-crowd", action="store_true")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None,
                   help="the servers' merge device (default: CUDA, "
                   "which must exist)")
    args = p.parse_args(argv)
    report = run_rebalance_soak(servers=args.servers, docs=args.docs,
                                seed=args.seed,
                                flash_crowd=args.flash_crowd,
                                device=args.device)
    print(json.dumps(report if args.json else {
        k: report[k] for k in ("ok", "slo_journey_ok", "burning_seen",
                               "migrations", "join_absorbed",
                               "abort_rollback_ok", "converged",
                               "zero_split_brain", "wall_s")}))
    return 0 if report["ok"] else 1
