"""Scenario runner: drive serve+replicate+read against the SLO engine.

Execution model (deterministic from the scenario seed):

  1. **Schedule** — every interactive write, read, bulk-import op and
     session-churn event is generated up front on the virtual clock
     (arrivals.py / popularity.py), then sorted into `tick_s` buckets.
  2. **Boot** — N in-process sync servers on ephemeral ports (the
     replicate-soak boot pattern: follower reads on, sample_rate=1.0
     so journeys and convergence lag populate), wired into one mesh
     whose control plane is stepped inline once per tick — probes,
     lease maintenance, anti-entropy — never free-running threads.
  3. **Drive** — each tick executes its bucket over real HTTP (writes
     POST /doc/{id}/edit, reads GET /doc/{id} round-robin across the
     mesh so followers serve them), steps the control plane, evaluates
     every node's SLO engine and integrates burn-minutes (a tick in a
     non-ok state charges tick_s/60 to that objective, summed across
     nodes), and publishes the live snapshot obs-watch renders.
  4. **Bank lane** — scenarios with a `bank` section then churn docs
     through an undersized Hydrator warm tier wired to the primary
     server's ServeMetrics, so device-tier spills land in the same
     hydration block /metrics and the scorecard read.
  5. **Reconcile + scorecard** — anti-entropy rounds until every
     server holds byte-identical text, then the run is snapshotted
     into a versioned scorecard (obs/scorecard.py).

Wall time is bounded by real work: nothing sleeps to simulate load.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from ..analysis.witness import make_lock
from ..obs.hist import Histogram
from ..obs.incident import INCIDENT_KINDS
from ..obs.scorecard import build_scorecard, publish_scenario
from .arrivals import make_arrivals
from .popularity import Zipf, make_popularity
from .spec import Scenario

# detector tuning for scenario runs: windows sized to wall seconds of
# tick work (not virtual time); min_rate high enough that boot-burst
# series (lease acquires, quorum rounds — steady for a few startup
# polls, then legitimately quiet forever) never warm into the stall
# watch; stall_after_s longer than the flash-crowd tape's 4.5 s
# inter-burst gap so bursty-but-healthy traffic never alarms; and a
# cooldown short enough that a partition and a crash in one tape each
# get their own bundle. Tuned empirically: flash-crowd must produce
# ZERO bundles, chaos-churn at least one (the p99 step the partition
# puts on read staleness).
RUNNER_INCIDENT_OPTS = dict(cooldown_s=30.0, rate_window_s=10.0,
                            stall_after_s=5.0, warmup_polls=4,
                            min_rate=1.0, spike_factor=8.0,
                            p99_factor=6.0, min_p99_s=0.01)

_WRITE_TOKENS = ("edit", "merge", "patch", "sync", "word", "line")


class _Session:
    """One editing session: an agent name plus its last-known version
    per doc (the `version` field each edit applies at). Churn retires
    the whole object and mints a fresh agent name."""

    def __init__(self, tenant: int, slot: int, gen: int) -> None:
        self.agent = f"t{tenant}s{slot}g{gen}"
        self.versions: Dict[str, list] = {}


class _Counts:
    def __init__(self) -> None:
        self.writes = 0          # successful interactive edit calls
        self.write_ops = 0
        self.reads = 0
        self.read_refusals = 0   # follower 503s (staleness contract)
        self.bulk_ops = 0
        self.bank_edits = 0
        self.sheds = 0           # QoS 429s (deliberate, not errors)
        self.errors = 0
        self.bytes_sent = 0
        self.bytes_received = 0

    def ops(self) -> int:
        return self.writes + self.reads + self.bulk_ops \
            + self.bank_edits

    def as_dict(self) -> Dict[str, int]:
        return {"ops": self.ops(), "writes": self.writes,
                "write_ops": self.write_ops, "reads": self.reads,
                "read_refusals": self.read_refusals,
                "bulk_ops": self.bulk_ops,
                "bank_edits": self.bank_edits, "sheds": self.sheds,
                "errors": self.errors,
                "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received}


def _build_events(sc: Scenario) -> List[tuple]:
    """The full deterministic event tape: (t, kind, payload) sorted by
    virtual time. Kinds: write(doc_idx, n), read(doc_idx), bulk(tenant),
    churn()."""
    events: List[tuple] = []
    writes = make_arrivals(sc.arrivals, seed=sc.seed)
    times = writes.schedule(sc.duration_s)
    docs = make_popularity(sc.popularity, len(sc.doc_ids()),
                           seed=sc.seed).draws(times)
    acc = 0.0
    for t, d in zip(times, docs):
        events.append((t, "write", d))
        acc += sc.reads_per_write
        n_reads, acc = int(acc), acc - int(acc)
        for j in range(n_reads):
            events.append((t, "read", d))
    if sc.bulk:
        bulk = make_arrivals(sc.bulk["arrivals"], seed=sc.seed + 1)
        for i, t in enumerate(bulk.schedule(sc.duration_s)):
            events.append((t, "bulk", i % sc.tenants))
    if sc.session_churn_every_s > 0:
        t = sc.session_churn_every_s
        while t < sc.duration_s:
            events.append((t, "churn", None))
            t += sc.session_churn_every_s
    if sc.chaos:
        p = sc.chaos.get("partition")
        if p:
            events.append((float(p["at_s"]), "cut", None))
            events.append((float(p["heal_s"]), "heal", None))
        c = sc.chaos.get("crash")
        if c:
            events.append((float(c["at_s"]), "crash",
                           int(c.get("server", 1))))
            events.append((float(c["restart_s"]), "reboot",
                           int(c.get("server", 1))))
    events.sort(key=lambda e: (e[0], e[1]))
    return events


def run_scenario(sc: Optional[Scenario], data_dir: Optional[str] = None,
                 progress: bool = False, qos: bool = False,
                 incidents: bool = True,
                 incident_opts: Optional[dict] = None,
                 checkpoint_every_s: float = 0.0,
                 resume_dir: Optional[str] = None,
                 stop_after_ticks: Optional[int] = None,
                 device=None) -> dict:
    """`qos=True` attaches the adaptive-admission controller to every
    server and tags lanes with their class (interactive edits vs bulk
    imports); the scorecard then carries a `qos` block merged across
    the mesh. Default False keeps the static admission path byte-
    identical — the A/B control arm for `scorecard-diff`.

    `incidents=True` (default) arms the incident engine's anomaly
    detector on every server (polled once per tick) and embeds an
    `incidents` block in the scorecard; `incidents=False` is the
    overhead A/B control arm.

    Long-run mode: `checkpoint_every_s > 0` arms per-server persistent
    data dirs (the chaos-churn journaling) and writes a runner-state
    checkpoint — tape cursor, per-session frontiers, rng state,
    interim counters, incident index — every N *virtual* seconds.
    `resume_dir` reloads such a checkpoint (`sc` may be None; the
    scenario rides inside it), reboots the servers on their journaled
    dirs, and replays the tape from the cursor, so the final scorecard
    is the one the uninterrupted run would have produced.
    `stop_after_ticks` force-checkpoints after that tick and tears the
    mesh down crash-style (the in-process kill used by the resume test
    and the bench soak-resume smoke), returning an `aborted` marker
    instead of a scorecard.

    `device` is every server's merge device (`serve(device=...)`): None
    means CUDA, which must exist; "cpu" runs the kernels' plain versions.
    A resumed run takes it from the caller, not from the checkpoint."""
    from ..gpu import resolve_device
    from ..qos.classes import QOS_HEADER
    from ..qos.metrics import merge_snapshots
    from ..replicate.node import attach_replication
    from ..tools.server import serve

    resolve_device(device)

    # ---- resume: the scenario and all toggles ride the checkpoint --------
    ck = None
    run_root = None
    if resume_dir is not None:
        with open(os.path.join(resume_dir, "checkpoint.json"),
                  encoding="utf8") as f:
            ck = json.load(f)
        sc = Scenario.from_dict(ck["scenario"])
        qos = bool(ck["qos"])
        incidents = bool(ck["incidents"])
        incident_opts = ck.get("incident_opts") or incident_opts
        checkpoint_every_s = float(ck.get("checkpoint_every_s") or 0.0)
        run_root = resume_dir

    rng = random.Random(f"runner:{sc.name}:{sc.seed}")
    events = _build_events(sc)
    doc_ids = sc.doc_ids()
    counts = _Counts()
    read_latency = Histogram()
    t_start = time.monotonic()
    inc_opts = {**RUNNER_INCIDENT_OPTS, **(incident_opts or {})}

    # ---- persistence arming (replicate/faults.py + long-run mode) --------
    # a chaos tape needs two things the plain runner skips: a shared
    # FaultInjector on every PeerTable, and per-server persistence so
    # the crash victim reboots on its own journals and .dt files. The
    # long-run mode arms the same per-server dirs (checkpoint/resume
    # rides the journals), chaos or not.
    faults = None
    persist = bool(sc.chaos) or checkpoint_every_s > 0 \
        or resume_dir is not None
    keep_root = checkpoint_every_s > 0 or resume_dir is not None
    dirs: List[Optional[str]] = [None] * sc.servers
    chaos_counts = {"partitions": 0, "heals": 0, "crashes": 0,
                    "reboots": 0}
    if sc.chaos:
        from ..replicate.faults import FaultInjector
        faults = FaultInjector(seed=sc.seed)
    if persist:
        if run_root is None:
            run_root = tempfile.mkdtemp(prefix="dt-scenario-run-")
        dirs = [os.path.join(run_root, f"n{i}")
                for i in range(sc.servers)]
        for d in dirs:
            os.makedirs(d, exist_ok=True)

    def _node_opts(i: int) -> Dict:
        opts = dict(seed=sc.seed, lease_ttl_s=1.0, timeout_s=2.0,
                    backoff_base_s=0.02, backoff_cap_s=0.1)
        if faults is not None:
            opts["faults"] = faults
        if dirs[i] is not None:
            opts["journal_prefix"] = os.path.join(dirs[i], "_replica")
        return opts

    # ---- boot the mesh (replicate-soak pattern, stepped inline) ----------
    httpds, nodes, addrs = [], [], []
    live = [True] * sc.servers
    boots = [0] * sc.servers
    tick_box = {"tick": 0}
    burn_minutes: Dict[str, float] = {}
    prior_incidents: List[dict] = []
    prior_suppressed = 0

    def _mk_context(i: int):
        """Capture-time context frozen into each incident bundle: the
        burn-minute integral and tick let the scorecard rank bundles
        by worst burn."""
        def ctx() -> dict:
            return {"server": addrs[i] if i < len(addrs) else None,
                    "tick": tick_box["tick"],
                    "burn_minutes_total":
                        round(sum(burn_minutes.values()), 4)}
        return ctx

    def _serve_node(i: int, port: int = 0):
        boots[i] += 1
        httpd = serve(port=port, serve_shards=sc.serve_shards,
                      data_dir=dirs[i], follower_reads=True,
                      obs_opts=dict(
                          sample_rate=1.0, incidents=incidents,
                          incident_opts=dict(
                              inc_opts,
                              prefix=f"n{i}.{boots[i]}.")),
                      qos=qos, device=device)
        httpd.store.obs.incidents.context_provider = _mk_context(i)
        return httpd

    saved_ports = (ck.get("ports") or []) if ck is not None else []
    for i in range(sc.servers):
        httpd = None
        if i < len(saved_ports):
            # resume prefers the checkpointed ports (replica journals
            # key lease state by self_id = host:port); fall back to an
            # ephemeral port if something else grabbed it meanwhile
            try:
                httpd = _serve_node(i, port=int(saved_ports[i]))
            except OSError:
                httpd = None
        if httpd is None:
            httpd = _serve_node(i)
        httpds.append(httpd)
        addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
    for i, httpd in enumerate(httpds):
        if sc.servers > 1:
            node = attach_replication(
                httpd, addrs[i], [a for a in addrs if a != addrs[i]],
                **_node_opts(i))
            nodes.append(node)
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()

    def _harvest_incidents(i: int) -> None:
        """Fold server i's in-memory incident index (+ per-bundle burn
        context) into the run-level rows before its obs bundle is lost
        to a crash/teardown, exactly once per boot."""
        nonlocal prior_suppressed
        httpd = httpds[i]
        if getattr(httpd, "_incidents_harvested", False):
            return
        httpd._incidents_harvested = True
        obs = httpd.store.obs
        for r in obs.incidents.index_json()["incidents"]:
            b = obs.incidents.get(r["id"]) or {}
            ctx = b.get("context") or {}
            prior_incidents.append({
                "id": r["id"], "t": r["t"], "kind": r["kind"],
                "series": r["series"], "detail": r.get("detail"),
                "server": addrs[i],
                "burn_minutes_total":
                    ctx.get("burn_minutes_total", 0.0)})
        prior_suppressed += obs.incident_detector.suppressed

    def crash_server(i: int) -> None:
        """Tear slot `i` down WITHOUT closing its journal (the reboot
        replays the WAL, torn tail and all) — the soak's crash shape."""
        _harvest_incidents(i)
        nodes[i].journal = None
        nodes[i].leases.journal = None
        httpds[i].shutdown()
        httpds[i].server_close()
        live[i] = False

    def reboot_server(i: int) -> None:
        port = int(addrs[i].split(":")[1])
        httpd = _serve_node(i, port=port)
        node = attach_replication(
            httpd, addrs[i], [a for a in addrs if a != addrs[i]],
            **_node_opts(i))
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()
        httpds[i] = httpd
        nodes[i] = node
        live[i] = True

    def pick_server() -> int:
        """Round-robin target among LIVE servers (the load balancer's
        health check; a crashed server takes no client traffic)."""
        alive = [i for i in range(sc.servers) if live[i]]
        return alive[rng.randrange(len(alive))]

    def step_control_plane() -> None:
        for j, node in enumerate(nodes):
            if not live[j]:
                continue
            node.table.probe_once()
            node.maintain()
        for j, node in enumerate(nodes):
            if live[j]:
                node.antientropy.run_round()

    # ---- HTTP primitives -------------------------------------------------
    def post_edit(si: int, doc: str, session: _Session,
                  ops: List[dict], qos_cls: Optional[str] = None) -> bool:
        body = json.dumps({"agent": session.agent,
                           "version": session.versions.get(doc, []),
                           "ops": ops}).encode("utf8")
        req = urllib.request.Request(
            f"http://{addrs[si]}/doc/{doc}/edit", data=body)
        if qos_cls is not None:
            req.add_header(QOS_HEADER, qos_cls)
        counts.bytes_sent += len(body)
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                resp = r.read()
        except urllib.error.HTTPError as e:
            e.close()
            if e.code == 429:    # deliberate QoS shed, not a failure
                counts.sheds += 1
            else:
                counts.errors += 1
            return False
        except OSError:
            counts.errors += 1
            return False
        counts.bytes_received += len(resp)
        session.versions[doc] = json.loads(resp)["version"]
        return True

    def get_doc(si: int, doc: str) -> None:
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(
                    f"http://{addrs[si]}/doc/{doc}", timeout=5) as r:
                counts.bytes_received += len(r.read())
        except urllib.error.HTTPError as e:
            e.close()
            if e.code == 503:     # honest staleness refusal, not a bug
                counts.read_refusals += 1
            else:
                counts.errors += 1
            return
        except OSError:
            counts.errors += 1
            return
        counts.reads += 1
        read_latency.record(time.monotonic() - t0)

    # ---- sessions --------------------------------------------------------
    gen = 0
    sessions: Dict[int, List[_Session]] = {
        t: [_Session(t, k, gen) for k in range(sc.sessions_per_tenant)]
        for t in range(sc.tenants)}
    session_churns = 0

    # ---- tick loop -------------------------------------------------------
    ticks = max(int(sc.duration_s / sc.tick_s + 0.999999), 1)
    # zero-filled per objective so the scorecard column is explicit
    # (and diffable) even on a fully healthy run (update in place:
    # the incident context closures hold a reference)
    for o in httpds[0].store.obs.slo.objectives:
        burn_minutes[o.name] = 0.0
    ev_i = 0
    start_tick = 0

    # ---- resume: restore the runner state the checkpoint froze ----------
    if ck is not None:
        start_tick = int(ck["tick"])
        ev_i = int(ck["ev_i"])
        gen = int(ck["gen"])
        session_churns = int(ck["session_churns"])
        counts.__dict__.update(ck["counts"])
        burn_minutes.update(ck["burn_minutes"])
        chaos_counts.update(ck["chaos_counts"])
        st = ck["rng_state"]
        rng.setstate((st[0], tuple(st[1]), st[2]))
        h = ck["read_latency"]
        read_latency.counts = list(h["counts"])
        read_latency.overflow = int(h["overflow"])
        read_latency.count = int(h["count"])
        read_latency.sum = float(h["sum"])
        read_latency.max = float(h["max"])
        sessions = {}
        for t_key, rows in ck["sessions"].items():
            lst = []
            for k, row in enumerate(rows):
                s = _Session(int(t_key), k, gen)
                s.agent = row["agent"]
                s.versions = {d: list(v)
                              for d, v in row["versions"].items()}
                lst.append(s)
            sessions[int(t_key)] = lst
        prior_incidents.extend(ck.get("incident_index") or [])
        prior_suppressed += int(ck.get("suppressed") or 0)
        # re-create the mid-crash topology the checkpoint froze (the
        # tape's pending reboot event will bring the victim back)
        for i, was_live in enumerate(ck.get("live") or []):
            if not was_live and live[i] and nodes:
                crash_server(i)

    def _write_checkpoint(next_tick: int) -> None:
        """Atomic runner-state checkpoint under the run root: enough
        to replay the tape from `next_tick` against rebooted servers.
        The doc/lease state itself is NOT here — it lives in the
        per-server journals the same dirs already persist."""
        state = {
            "version": 1,
            "scenario": sc.to_dict(),
            "qos": qos, "incidents": incidents,
            "incident_opts": incident_opts,
            "checkpoint_every_s": checkpoint_every_s,
            "tick": next_tick, "ticks": ticks, "ev_i": ev_i,
            "gen": gen, "session_churns": session_churns,
            "counts": dict(counts.__dict__),
            "burn_minutes": dict(burn_minutes),
            "chaos_counts": dict(chaos_counts),
            "live": list(live),
            "ports": [int(a.split(":")[1]) for a in addrs],
            "rng_state": [rng.getstate()[0], list(rng.getstate()[1]),
                          rng.getstate()[2]],
            "read_latency": {"counts": list(read_latency.counts),
                             "overflow": read_latency.overflow,
                             "count": read_latency.count,
                             "sum": read_latency.sum,
                             "max": read_latency.max},
            "sessions": {str(t): [{"agent": s.agent,
                                   "versions": s.versions}
                                  for s in lst]
                         for t, lst in sessions.items()},
            "incident_index": prior_incidents + [
                r for i in range(sc.servers) if live[i]
                for r in _peek_incidents(i)],
            "suppressed": prior_suppressed + sum(
                httpds[i].store.obs.incident_detector.suppressed
                for i in range(sc.servers) if live[i]),
            # interim scorecard: the coarse progress numbers an
            # operator tails while the soak runs
            "interim": {"writes": counts.writes, "reads": counts.reads,
                        "errors": counts.errors,
                        "sheds": counts.sheds,
                        "burn_minutes_total":
                            round(sum(burn_minutes.values()), 4)},
        }
        path = os.path.join(run_root, "checkpoint.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf8") as f:
            f.write(json.dumps(state) + "\n")
        os.replace(tmp, path)

    def _peek_incidents(i: int) -> List[dict]:
        """Server i's current in-memory incident rows (burn-enriched),
        without marking them harvested."""
        obs = httpds[i].store.obs
        rows = []
        for r in obs.incidents.index_json()["incidents"]:
            b = obs.incidents.get(r["id"]) or {}
            ctx = b.get("context") or {}
            rows.append({"id": r["id"], "t": r["t"], "kind": r["kind"],
                         "series": r["series"],
                         "detail": r.get("detail"),
                         "server": addrs[i],
                         "burn_minutes_total":
                             ctx.get("burn_minutes_total", 0.0)})
        return rows

    def publish(phase: str, tick: int, extra: str = "") -> None:
        worst, names = "ok", []
        for httpd in httpds:
            v = httpd.store.obs.slo.verdict()
            if v["burning"]:
                worst = "burning"
                names += v["burning"]
            elif v["warning"] and worst != "burning":
                worst = "warning"
                names += v["warning"]
        publish_scenario({
            "name": sc.name, "phase": phase,
            "tick": tick, "ticks": ticks,
            "virtual_t": round(min(tick * sc.tick_s, sc.duration_s), 2),
            "writes": counts.writes, "reads": counts.reads,
            "errors": counts.errors,
            "slo_state": worst,
            "verdict": (f"slo={worst}"
                        + (" [" + ",".join(sorted(set(names))) + "]"
                           if names else "") + extra),
        })

    next_ckpt = 0.0
    if checkpoint_every_s > 0:
        next_ckpt = (start_tick * sc.tick_s) + checkpoint_every_s
    for tick in range(start_tick, ticks):
        tick_box["tick"] = tick + 1
        horizon = (tick + 1) * sc.tick_s
        while ev_i < len(events) and events[ev_i][0] < horizon:
            t, kind, arg = events[ev_i]
            ev_i += 1
            if kind == "write":
                doc = doc_ids[arg]
                tenant = int(doc[1:doc.index("-")])
                ses = sessions[tenant][
                    rng.randrange(sc.sessions_per_tenant)]
                tok = f"{rng.choice(_WRITE_TOKENS)} "
                if post_edit(pick_server(), doc, ses,
                             [{"kind": "ins", "pos": 0, "text": tok}]):
                    counts.writes += 1
                    counts.write_ops += 1
            elif kind == "read":
                get_doc(pick_server(), doc_ids[arg])
            elif kind == "bulk":
                tenant = arg
                doc = f"t{tenant}-bulk000"
                ses = sessions[tenant][0]
                payload = "x" * int(sc.bulk.get("bytes_per_op", 1024))
                if post_edit(pick_server(), doc, ses,
                             [{"kind": "ins", "pos": 0,
                               "text": payload}],
                             qos_cls="bulk" if qos else None):
                    counts.bulk_ops += 1
            elif kind == "cut":
                p = sc.chaos["partition"]
                faults.partition(addrs[int(p.get("a", 1))],
                                 addrs[int(p.get("b", 0))],
                                 oneway=bool(p.get("oneway", True)))
                chaos_counts["partitions"] += 1
            elif kind == "heal":
                p = sc.chaos["partition"]
                faults.heal(addrs[int(p.get("a", 1))],
                            addrs[int(p.get("b", 0))])
                chaos_counts["heals"] += 1
            elif kind == "crash":
                if live[arg]:
                    crash_server(arg)
                    chaos_counts["crashes"] += 1
            elif kind == "reboot":
                if not live[arg]:
                    reboot_server(arg)
                    chaos_counts["reboots"] += 1
            elif kind == "churn":
                gen += 1
                session_churns += 1
                sessions = {
                    t: [_Session(t, k, gen)
                        for k in range(sc.sessions_per_tenant)]
                    for t in range(sc.tenants)}
        step_control_plane()
        # burn-minute integration: a tick spent in a non-ok state
        # charges tick_s/60 to that objective (summed across nodes —
        # mesh-wide burn)
        for httpd in httpds:
            for row in httpd.store.obs.slo.evaluate():
                if row["state"] != "ok":
                    burn_minutes[row["name"]] = burn_minutes.get(
                        row["name"], 0.0) + sc.tick_s / 60.0
        # incident engine: one detector poll per live server per tick
        # (the slo_transition events the evaluate() above just recorded
        # are visible to this poll — burn bundles fire the same tick)
        for j in range(sc.servers):
            if live[j]:
                httpds[j].store.obs.incident_detector.poll()
        publish("traffic", tick + 1)
        if progress:    # pragma: no cover - human pacing output
            print(f"  tick {tick + 1}/{ticks}: {counts.writes} writes "
                  f"{counts.reads} reads {counts.errors} errors")
        virt = (tick + 1) * sc.tick_s
        if checkpoint_every_s > 0 and virt >= next_ckpt:
            _write_checkpoint(tick + 1)
            while next_ckpt <= virt:
                next_ckpt += checkpoint_every_s
        if stop_after_ticks is not None and tick + 1 >= stop_after_ticks \
                and tick + 1 < ticks:
            # the in-process kill: force a checkpoint, then tear every
            # server down crash-style (journals left open — resume
            # replays the WALs, torn tails and all)
            _write_checkpoint(tick + 1)
            publish("aborted", tick + 1, extra=" aborted=True")
            for i in range(sc.servers):
                if not live[i]:
                    continue
                if nodes:
                    nodes[i].journal = None
                    nodes[i].leases.journal = None
                httpds[i].shutdown()
                httpds[i].server_close()
            return {"aborted": True, "resume_dir": run_root,
                    "tick": tick + 1, "ticks": ticks,
                    "scenario": sc.name}

    # ---- bank-churn lane (device-tier spill accounting) ------------------
    bank_report = None
    if sc.bank:
        publish("bank-churn", ticks)
        bank_report = _run_bank_lane(sc, httpds[0], rng, counts,
                                     data_dir=data_dir,
                                     progress=progress)

    # ---- reconcile to convergence ----------------------------------------
    publish("reconcile", ticks)
    converged_after = None
    for r in range(sc.reconcile_rounds):
        step_control_plane()
        if _converged(addrs, doc_ids):
            converged_after = r + 1
            break
        time.sleep(0.02)    # let advert/breaker windows lapse
    converged = _converged(addrs, doc_ids)

    # ---- collect ---------------------------------------------------------
    serve_snaps = [h.store.scheduler.metrics.snapshot()
                   if h.store.scheduler is not None else None
                   for h in httpds]
    flush_p99 = max((s["latencies"]["flush"]["p99"]
                     for s in serve_snaps if s), default=None)
    vis_p99s = [h.store.obs.ts.quantile("journey.visibility", 0.99,
                                        window_s=3600.0)
                for h in httpds]
    vis_p99 = max((v for v in vis_p99s if v > 0), default=0.0)
    hydration: Dict[str, int] = {}
    for s in serve_snaps:
        if s:
            for k, v in s["hydration"].items():
                hydration[k] = hydration.get(k, 0) + v
    slo_burning, slo_warning, slo_ok = [], [], True
    for httpd in httpds:
        v = httpd.store.obs.slo.verdict()
        slo_ok = slo_ok and v["slo_ok"]
        slo_burning += v["burning"]
        slo_warning += v["warning"]
    lag = {addrs[i]: n.obs.journey.lag_summary()
           for i, n in enumerate(nodes)}
    # wire transport: per-channel counters summed across the mesh (every
    # host accounts the bytes IT sends, so the sum is total transport);
    # single-server runs have no mesh and omit the block entirely
    wire: Optional[Dict[str, Dict[str, float]]] = None
    if nodes:
        from ..wire.frames import WIRE_CHANNELS, WIRE_KEYS
        wire = {ch: {k: 0 for k in WIRE_KEYS} for ch in WIRE_CHANNELS}
        for node in nodes:
            flat = node.metrics.wire_counters()
            for ch in WIRE_CHANNELS:
                for k in WIRE_KEYS:
                    wire[ch][k] += flat[f"{ch}_{k}"]
    per_server = [{
        "addr": addrs[i],
        "flush_p99_s": (serve_snaps[i]["latencies"]["flush"]["p99"]
                        if serve_snaps[i] else None),
        "flushed_ops": (serve_snaps[i]["totals"]["flushed_ops"]
                        if serve_snaps[i] else 0),
        "visibility_p99_s": round(vis_p99s[i], 6),
    } for i in range(sc.servers)]
    # QoS: merge every server's QosMetrics snapshot into one mesh-wide
    # block (None when the controller was off, so A/B control cards
    # diff clean against pre-QoS baselines)
    qos_block = merge_snapshots([
        h.store.scheduler.qos.metrics.snapshot()
        if h.store.scheduler is not None
        and h.store.scheduler.qos is not None else None
        for h in httpds])
    if qos_block is not None:
        qos_block["sheds_observed"] = counts.sheds
    # incident engine: fold every surviving server's index into the
    # run-level rows (crash victims were harvested at crash time, and
    # a resumed run carries its pre-kill rows via the checkpoint)
    for i in range(sc.servers):
        _harvest_incidents(i)
    by_kind = dict.fromkeys(INCIDENT_KINDS, 0)
    for r in prior_incidents:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0) + 1
    worst = max(prior_incidents,
                key=lambda r: r.get("burn_minutes_total", 0.0),
                default=None)
    incidents_block = {
        "enabled": bool(incidents),
        "count": len(prior_incidents),
        "by_kind": by_kind,
        "suppressed": prior_suppressed,
        "worst_burn_minutes_id": worst["id"] if worst else None,
        "worst_burn_minutes":
            worst.get("burn_minutes_total", 0.0) if worst else 0.0,
        "timeline": sorted(prior_incidents, key=lambda r: r["t"]),
    }
    # device flush-pipeline block (scorecard `serve`): summed window
    # staging + dispatch fan-in from the servers' ServeMetrics.
    # Host-engine runs never dispatch a device window, so the block
    # stays None and the serve.* bands skip (missing-path semantics).
    serve_block: Optional[dict] = None
    dw = sum(s["window"]["device_windows"] for s in serve_snaps if s)
    if dw > 0:
        staged = sum(s["window"].get("staged_bytes", 0)
                     for s in serve_snaps if s)
        disp = sum(s["window"]["dispatches"] for s in serve_snaps if s)
        serve_block = {
            "staged_bytes": staged,
            "staged_bytes_per_window": round(staged / dw, 2),
            "device_calls_per_window": round(disp / dw, 4),
        }
    wall_s = time.monotonic() - t_start
    # under an injected-fault tape, availability degrades by DESIGN
    # (client errors while partitioned, SLO burn during the crash) —
    # the run's gate is the safety property: byte-identical
    # convergence once healed and rebooted. Errors and burn are still
    # recorded honestly in the scorecard.
    ok = bool(converged) if sc.chaos else \
        bool(converged and slo_ok and counts.errors == 0)

    card = build_scorecard(
        scenario=sc.to_dict(),
        wall_s=wall_s, virtual_s=sc.duration_s,
        totals=counts.as_dict(),
        latency_p99_s={
            "flush": flush_p99,
            "read": read_latency.snapshot()["p99"],
            "visibility": round(vis_p99, 6),
        },
        latencies={"read": read_latency.snapshot()},
        slo={"slo_ok": slo_ok,
             "burning": sorted(set(slo_burning)),
             "warning": sorted(set(slo_warning))},
        burn_minutes=burn_minutes,
        convergence={"converged": converged,
                     "reconcile_rounds": converged_after,
                     "lag": lag},
        hydration=hydration,
        wire=wire,
        per_server=per_server,
        ok=ok,
        qos=qos_block,
        incidents=incidents_block,
        serve=serve_block,
        extra={"session_churns": session_churns,
               **({"bank": bank_report} if bank_report else {}),
               **({"chaos": {**chaos_counts,
                             "faults": faults.snapshot()}}
                  if sc.chaos else {}),
               **({"run_dir": run_root, "resumed": ck is not None}
                  if keep_root else {})},
    )
    publish("done", ticks, extra=f" ok={ok}")
    for httpd in httpds:
        httpd.shutdown()
        httpd.server_close()
    if run_root is not None and not keep_root:
        shutil.rmtree(run_root, ignore_errors=True)
    return card


def _run_bank_lane(sc: Scenario, primary, rng: random.Random,
                   counts: _Counts, data_dir: Optional[str] = None,
                   progress: bool = False) -> dict:
    """Churn `bank.docs` docs through a `bank.warm_slots`-sized
    Hydrator warm tier. The hydrator reports into the PRIMARY server's
    ServeMetrics, so spills_to_snapshot / spill_bytes land in the same
    hydration block the /metrics endpoint, prom families and scorecard
    read. Docs materialize on first touch (a missing home loads as a
    fresh oplog) — the population size costs nothing up front."""
    import shutil
    import tempfile

    from ..serve.hydrate import Hydrator
    from ..storage.tier import TieredStore

    bank = sc.bank
    root = data_dir or tempfile.mkdtemp(prefix="dt-scenario-bank-")
    own_root = data_dir is None
    guard = make_lock("workload.bank_oplog", "oplog")
    metrics = primary.store.scheduler.metrics \
        if primary.store.scheduler is not None else None
    store = TieredStore(root)
    hyd = Hydrator(store, workers=2, warm_max=bank["warm_slots"],
                   evict_grace_s=0.0, oplog_lock=guard,
                   metrics=metrics, seed=sc.seed)
    law = Zipf(bank["docs"], s=1.1, seed=sc.seed + 2)
    t0 = time.monotonic()
    touched = set()
    try:
        for rnd in range(bank["rounds"]):
            picks = law.draws([0.0] * bank["edits_per_round"])
            for j, d in enumerate(picks):
                doc = f"bank{d:07d}"
                ol = hyd.resolve(doc)
                a = ol.get_or_create_agent_id(f"bank{sc.seed}")
                with guard:
                    ol.add_insert(a, 0, f"<{rnd}.{j}> ")
                counts.bank_edits += 1
                touched.add(doc)
            if progress:    # pragma: no cover - human pacing output
                print(f"  bank round {rnd + 1}/{bank['rounds']}: "
                      f"{counts.bank_edits} edits, "
                      f"{hyd.warm_count()} warm")
    finally:
        hyd.stop(checkpoint=True)
    snap = hyd.counters_snapshot()
    return {"docs": bank["docs"], "warm_slots": bank["warm_slots"],
            "docs_touched": len(touched),
            "edits": counts.bank_edits,
            "spills_to_snapshot": snap.get("spills_to_snapshot", 0),
            "spill_bytes": snap.get("spill_bytes", 0),
            "wall_s": round(time.monotonic() - t0, 3),
            "cleaned": own_root and bool(
                shutil.rmtree(root, ignore_errors=True) or True)}


def _converged(addrs: List[str], doc_ids: List[str]) -> bool:
    for d in doc_ids:
        texts = set()
        for a in addrs:
            try:
                with urllib.request.urlopen(
                        f"http://{a}/doc/{d}", timeout=5) as r:
                    texts.add(r.read())
            except OSError:
                return False
        if len(texts) > 1:
            return False
    return True
