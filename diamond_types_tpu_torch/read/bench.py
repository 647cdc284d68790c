"""Follower-read A/B bench (CLI: `read-bench`).

Boots a two-server replication mesh on ephemeral localhost ports with
follower reads attached to both nodes, drives a continuous single-agent
writer per doc at each doc's owner, and runs two phases of Zipf-skewed
reader threads. Each read is routed to the chosen doc's NON-owner
replica — docs split across both nodes by the lease machinery, so the
readers spread across both; reads landing on the owner are identical
in both worlds and would only dilute the A/B contrast:

  * control   — every GET carries `?max_staleness=0`: only a node with
                staleness 0 (the lease holder) may serve locally, so
                every follower-side read proxies to the owner. This is
                the owner-only-checkout world the subsystem replaces.
  * follower  — every GET carries `?max_staleness=<bound>`: followers
                serve from their own oplog whenever the staleness
                evidence (anti-entropy adverts + reconcile floors)
                proves the bound, falling back to the proxy otherwise.

Every response is verified CLIENT-side, not trusted from the server:

  * staleness — a local response under a finite bound must carry
                `X-DT-Staleness` and it must not exceed the bound;
  * RYW       — every Nth read sends the doc's latest write token as
                `X-DT-Min-Version`; the response's `X-DT-Frontier`
                must carry the writer agent at a seq >= the token's
                (one writer agent per doc makes this check exact).

The verdict (`ok`) requires ZERO violations of either contract and
zero transport errors in both phases; when `min_speedup` is set the
follower/control aggregate-throughput ratio must also clear it. A
failing verdict embeds the flight-recorder tail of both nodes
(`events_tail`), same as replicate-soak.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from ..replicate.node import attach_replication


def _zipf_weights(n: int, s: float) -> List[float]:
    return [1.0 / (i + 1) ** s for i in range(n)]


def _post_json(addr: str, path: str, doc: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        f"http://{addr}{path}", data=json.dumps(doc).encode("utf8"))
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode("utf8"))


class _Writer(threading.Thread):
    """One sequential writer agent per doc, always at the doc's owner:
    the doc's frontier stays single-headed on that agent, so the RYW
    check below is an exact per-agent seq comparison."""

    def __init__(self, owners: Dict[str, str], tokens: Dict[str, list],
                 interval_s: float, timeout_s: float) -> None:
        super().__init__(daemon=True)
        self.owners = owners
        self.tokens = tokens        # doc -> latest remote frontier
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.writes = 0
        self.errors = 0
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        doc_ids = sorted(self.owners)
        i = 0
        while not self._halt.is_set():
            doc_id = doc_ids[i % len(doc_ids)]
            i += 1
            try:
                out = _post_json(
                    self.owners[doc_id], f"/doc/{doc_id}/edit",
                    {"agent": f"w-{doc_id}",
                     "version": self.tokens[doc_id],
                     "ops": [{"kind": "ins", "pos": 0, "text": "w"}]},
                    self.timeout_s)
                self.tokens[doc_id] = out["version"]
                self.writes += 1
            except (OSError, KeyError, ValueError):
                self.errors += 1
            self._halt.wait(self.interval_s)


class _Reader(threading.Thread):
    """Zipf-skewed GETs, each routed to the chosen doc's NON-owner
    replica (the population follower reads exist for: a read landing
    on the owner is identical in both worlds and would only dilute the
    A/B contrast), verifying the staleness bound and the RYW token on
    every response. ``tokens`` is a phase-start snapshot of each doc's
    latest write version — the re-read-your-earlier-write flow — so a
    token read measures contract verification, not the catch-up wait
    (the acceptance test covers the wait/fallback path)."""

    def __init__(self, route: Dict[str, str], doc_ids: List[str],
                 weights: List[float],
                 tokens: Dict[str, list], reads: int,
                 max_staleness: float, min_version_every: int,
                 seed: int, timeout_s: float) -> None:
        super().__init__(daemon=True)
        self.route = route
        self.doc_ids = doc_ids
        self.weights = weights
        self.tokens = tokens
        self.reads = reads
        self.max_staleness = max_staleness
        self.min_version_every = min_version_every
        self.rng = random.Random(seed)
        self.timeout_s = timeout_s
        self.ok_reads = 0
        self.local = 0
        self.proxied = 0
        self.refused = 0
        self.errors = 0
        self.staleness_violations = 0
        self.ryw_violations = 0
        self.max_seen_staleness = 0.0
        self.latencies: List[float] = []

    def _check(self, doc_id: str, headers, token: Optional[list]) -> None:
        source = headers.get("X-DT-Read-Source", "")
        if source == "local":
            self.local += 1
            st = headers.get("X-DT-Staleness")
            if st is None:
                # a local response under a finite bound must PROVE it
                self.staleness_violations += 1
            else:
                val = float(st)
                self.max_seen_staleness = max(self.max_seen_staleness,
                                              val)
                if val > self.max_staleness + 1e-9:
                    self.staleness_violations += 1
        else:
            self.proxied += 1
        if token:
            heads = {a: int(s) for a, s in
                     json.loads(headers.get("X-DT-Frontier") or "[]")}
            for agent, seq in token:
                if heads.get(agent, -1) < int(seq):
                    self.ryw_violations += 1
                    break

    def run(self) -> None:
        for i in range(self.reads):
            doc_id = self.rng.choices(self.doc_ids,
                                      weights=self.weights)[0]
            token = None
            headers = {}
            if self.min_version_every and \
                    i % self.min_version_every == 0:
                token = self.tokens[doc_id]
                if token:
                    headers["X-DT-Min-Version"] = json.dumps(token)
            url = (f"http://{self.route[doc_id]}/doc/{doc_id}/state"
                   f"?max_staleness={self.max_staleness}")
            t0 = time.monotonic()
            try:
                req = urllib.request.Request(url, headers=headers)
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as r:
                    r.read()
                    self.ok_reads += 1
                    self.latencies.append(time.monotonic() - t0)
                    self._check(doc_id, r.headers, token)
            except urllib.error.HTTPError as e:
                e.read()
                if e.code == 503:
                    self.refused += 1
                else:
                    self.errors += 1
            except (OSError, ValueError):
                self.errors += 1


def run_read_bench(docs: int = 3, readers: int = 6,
                   reads_per_reader: int = 120, seed: int = 7,
                   zipf_s: float = 1.2, max_staleness_s: float = 2.0,
                   write_interval_s: float = 0.02,
                   min_version_every: int = 4,
                   lease_ttl_s: float = 30.0, serve_shards: int = 1,
                   settle_rounds: int = 80, doc_bytes: int = 16384,
                   min_speedup: Optional[float] = None,
                   progress: bool = False, device=None) -> dict:
    """`device` is the servers' merge device (`serve(device=...)`): None
    means CUDA, which must exist; "cpu" runs the kernels' plain
    versions."""
    from ..gpu import resolve_device
    from ..tools.server import serve
    from . import attach_follower_reads

    resolve_device(device)

    doc_ids = [f"doc{i}" for i in range(docs)]
    weights = _zipf_weights(docs, zipf_s)
    node_opts = dict(seed=seed, lease_ttl_s=lease_ttl_s,
                     probe_interval_s=0.25,
                     antientropy_interval_s=0.25,
                     timeout_s=2.0, backoff_base_s=0.02,
                     backoff_cap_s=0.1)

    httpds, nodes, addrs = [], [], []
    for _ in range(2):
        httpd = serve(port=0, serve_shards=serve_shards, device=device)
        # the reader fleet opens a fresh connection per GET; the default
        # listen backlog (5) overflows under that churn whenever the
        # accept loop is briefly starved, and one dropped SYN costs the
        # client a ~1s kernel retransmit that dominates the phase wall
        httpd.socket.listen(256)
        httpds.append(httpd)
        addrs.append(f"127.0.0.1:{httpd.server_address[1]}")
    for i, httpd in enumerate(httpds):
        node = attach_replication(
            httpd, addrs[i], [a for a in addrs if a != addrs[i]],
            **node_opts)
        attach_follower_reads(httpd.store)
        nodes.append(node)
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()

    def step_control_plane() -> None:
        for n in nodes:
            n.table.probe_once()
            n.maintain()
        for n in nodes:
            n.antientropy.run_round()

    t0 = time.monotonic()
    # seed every doc (the mutation router proxies to whichever node
    # the lease machinery elects), then step until both nodes agree on
    # one ACTIVE owner per doc and the follower side holds a usable
    # staleness advert for it
    # checkout-sized payloads: a proxied read (de)serializes the body
    # an extra time and ships it over one extra hop, so the A/B
    # contrast is only visible with documents of realistic weight
    seed_text = ("lorem ipsum dolor sit amet " * 64)[:1707]
    tokens: Dict[str, list] = {}
    for doc_id in doc_ids:
        version: list = []
        for _ in range(max(1, doc_bytes // len(seed_text))):
            out = _post_json(addrs[0], f"/doc/{doc_id}/edit",
                             {"agent": f"w-{doc_id}", "version": version,
                              "ops": [{"kind": "ins", "pos": 0,
                                       "text": seed_text}]}, 5.0)
            version = out["version"]
        tokens[doc_id] = version

    owners: Dict[str, str] = {}

    def _settled() -> bool:
        owners.clear()
        for doc_id in doc_ids:
            holder = [n for n in nodes
                      if n.leases.active_epoch(doc_id) > 0]
            if len(holder) != 1:
                return False
            owner = holder[0]
            follower = next(n for n in nodes if n is not owner)
            if follower.route_mutation(doc_id) != owner.self_id:
                return False
            # the follower must already hold evidence good enough to
            # serve within the bound, or phase B starts cold
            rp = follower.store.reads
            fol = follower.store.get(doc_id)
            st = rp.index.staleness(
                doc_id, owner.self_id,
                lambda fr: rp._dominates(fol, fr))
            if st is None or st > max_staleness_s:
                return False
            owners[doc_id] = owner.self_id
        return True

    settled = False
    for _ in range(settle_rounds):
        step_control_plane()
        if _settled():
            settled = True
            break
        time.sleep(0.02)

    writer = _Writer(owners if settled else
                     {d: addrs[0] for d in doc_ids},
                     tokens, write_interval_s, timeout_s=5.0)
    writer.start()
    # background control plane keeps adverts fresh while the reader
    # phases run (manual stepping stops here)
    for n in nodes:
        n.start()

    # per-doc follower route: every read lands on the replica that
    # does NOT own the doc (docs split across both nodes, so the
    # readers spread across both; a read at the owner behaves the same
    # in both phases and would only dilute the A/B contrast)
    route = {d: next(a for a in addrs if a != owners.get(d, addrs[1]))
             for d in doc_ids}

    def _caught_up(snap: Dict[str, list]) -> bool:
        for doc_id, token in snap.items():
            follower = next(n for n in nodes
                            if n.self_id == route[doc_id])
            rp = follower.store.reads
            if not rp._dominates(follower.store.get(doc_id), token):
                return False
        return True

    def run_phase(max_staleness: float, label: str) -> dict:
        # phase-start RYW snapshot: each doc's latest write version,
        # then wait for the followers to absorb it so a token read
        # measures verification, not the anti-entropy catch-up sleep
        snap = {d: list(tokens[d]) for d in doc_ids}
        deadline = time.monotonic() + 4 * max(max_staleness_s, 0.5)
        while not _caught_up(snap) and time.monotonic() < deadline:
            time.sleep(0.02)
        rs = [_Reader(route, doc_ids, weights, snap,
                      reads_per_reader, max_staleness,
                      min_version_every, seed * 1000 + j, 10.0)
              for j in range(readers)]
        p0 = time.monotonic()
        for r in rs:
            r.start()
        for r in rs:
            r.join()
        wall = max(time.monotonic() - p0, 1e-9)
        total = sum(r.ok_reads for r in rs)
        out = {
            "max_staleness_s": max_staleness,
            "reads": total,
            "reads_per_s": round(total / wall, 1),
            "wall_s": round(wall, 3),
            "local": sum(r.local for r in rs),
            "proxied": sum(r.proxied for r in rs),
            "refused": sum(r.refused for r in rs),
            "errors": sum(r.errors for r in rs),
            "staleness_violations": sum(r.staleness_violations
                                        for r in rs),
            "ryw_violations": sum(r.ryw_violations for r in rs),
            "max_observed_staleness_s": round(
                max(r.max_seen_staleness for r in rs), 4),
        }
        lat = sorted(x for r in rs for x in r.latencies)
        if lat:
            out["latency_s"] = {
                "p50": round(lat[len(lat) // 2], 5),
                "p95": round(lat[int(len(lat) * 0.95)], 5),
                "max": round(lat[-1], 5),
            }
        if progress:
            print(f"{label}: {out['reads_per_s']} reads/s "
                  f"({out['local']} local / {out['proxied']} proxied)")
        return out

    control = run_phase(0.0, "control")
    follower = run_phase(max_staleness_s, "follower")

    writer.stop()
    writer.join(timeout=5)
    for n in nodes:
        n.stop()

    speedup = round(follower["reads_per_s"]
                    / max(control["reads_per_s"], 1e-9), 2)
    violations = sum(p["staleness_violations"] + p["ryw_violations"]
                    for p in (control, follower))
    errors = control["errors"] + follower["errors"] + writer.errors
    ok = (settled and violations == 0 and errors == 0
          and (min_speedup is None or speedup >= min_speedup))
    report = {
        "config": {"docs": docs, "readers": readers,
                   "reads_per_reader": reads_per_reader, "seed": seed,
                   "zipf_s": zipf_s, "max_staleness_s": max_staleness_s,
                   "min_version_every": min_version_every,
                   "serve_shards": serve_shards,
                   "min_speedup": min_speedup},
        "settled": settled,
        "owners": dict(owners),
        "writes": writer.writes,
        "write_errors": writer.errors,
        "control": control,
        "follower": follower,
        "speedup": speedup,
        "violations": violations,
        "errors": errors,
        "ok": ok,
        "wall_s": round(time.monotonic() - t0, 3),
        "read_metrics": {n.self_id:
                         n.store.reads.metrics.snapshot()
                         for n in nodes},
    }
    if not ok:
        # flight-recorder tail makes a failed bench diagnosable from
        # the JSON report alone (same idiom as replicate-soak)
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
