"""Workload driver for the merge scheduler (`python -m
diamond_types_tpu_torch.serve`).

Port of the JAX package's `serve/driver.py`: replays a workload through a
MergeScheduler over N shards and byte-parity-gates every document against
the host merge. Three workload shapes:

  * trace      — every doc replays the same editing trace (the reference's
                 crdt-testdata JSON format, `text/trace.py`, or a
                 synthetic one), linear single-agent history;
  * concurrent — per doc, two agents keep typing from their OWN heads; the
                 (agent, length) schedule is shared across docs while
                 positions derive from a per-doc rng;
  * flash      — a migrating hot doc takes op BURSTS while the cold tail
                 trickles, so each window's max-op count (the pow2 `n`
                 shape class) thrashes: the shape-class stress tape.

Parity: for engine="device" the scheduler's answer comes from the device
rows (`FusedDocSession.text()`, or `DeviceZoneSession.text()` with
`fused=False`), the reference from the host tracker called directly
(`Branch.merge_reference`, which no engine switch or policy reaches) — two
independent engines, compared byte for byte per document.

Observability: the bench runs with the production defaults (1% trace
sampling, live telemetry and the journey on), so its throughput numbers are
the instrumented numbers. It enables and resets the process-wide device
profiler (`obs.devprof.PROFILER`), attaches an `obs.Observability` bundle
to the scheduler, and reports the SLO verdict (`slo`, `slo_ok`), the
profiler's snapshot (`devprof`: flush wall vs. device-wait seconds, the
host-to-device transfers by rung and purpose), the tracer's and journey's
state (`obs`) and a banded `scorecard`; a parity failure also carries the
flight recorder's tail (`events_tail`). The port has no jit cache, so the
JAX report's jit hit rates have no counterpart here.
`telemetry=False` / `journey=False` are the overhead control arms.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs import Observability
from ..obs.devprof import PROFILER
from ..obs.scorecard import build_scorecard
from ..parallel.arena import reset_arenas
from ..text.branch import Branch
from ..text.oplog import OpLog
from ..text.trace import TestData, load_trace
from .scheduler import MergeScheduler


def synth_trace(n_txns: int = 40, ops_per_txn: int = 3,
                seed: int = 7) -> TestData:
    """Deterministic typing-shaped trace (inserts with occasional
    deletes) in the crdt-testdata format — the corpus when no trace file
    is given."""
    rng = random.Random(seed)
    doc: List[str] = []
    txns: List[List[Tuple[int, int, str]]] = []
    for _ in range(n_txns):
        txn: List[Tuple[int, int, str]] = []
        for _ in range(ops_per_txn):
            if doc and rng.random() < 0.25:
                pos = rng.randrange(len(doc))
                n = min(rng.randint(1, 3), len(doc) - pos)
                txn.append((pos, n, ""))
                del doc[pos:pos + n]
            else:
                pos = rng.randint(0, len(doc))
                s = "".join(rng.choice("abcdefgh ")
                            for _ in range(rng.randint(1, 4)))
                txn.append((pos, 0, s))
                doc[pos:pos] = list(s)
        txns.append(txn)
    return TestData(start_content="", end_content="".join(doc),
                    txns=txns)


def _trace_feeders(data: TestData, doc_ids: List[str]):
    """Per-doc generators: each yield applies one txn to the doc's oplog
    (linear append) and reports its op count."""
    def feeder(ol: OpLog):
        agent = ol.get_or_create_agent_id("trace")
        for txn in data.txns:
            n = 0
            for (pos, num_del, ins) in txn:
                if num_del:
                    ol.add_delete_without_content(agent, pos,
                                                  pos + num_del)
                    n += 1
                if ins:
                    ol.add_insert(agent, pos, ins)
                    n += 1
            yield n
    return {d: feeder for d in doc_ids}


def _concurrent_schedule(rounds: int, edits_per_round: int,
                         seed: int) -> List[List[Tuple[int, int]]]:
    """(agent_idx, insert_len) per edit, SHARED across docs so their
    session shapes coincide (positions stay per-doc)."""
    rng = random.Random(seed)
    return [[(e % 2, rng.randint(1, 4))
             for e in range(edits_per_round)]
            for _ in range(rounds)]


def _concurrent_feeders(schedule, doc_ids: List[str], seed: int):
    def make_feeder(doc_idx: int):
        def feeder(ol: OpLog):
            rng = random.Random(seed * 7919 + doc_idx)
            agents = [ol.get_or_create_agent_id(n)
                      for n in ("ca", "cb")]
            heads: Dict[int, list] = {0: [], 1: []}
            lens = {0: 0, 1: 0}
            for round_edits in schedule:
                for (ai, n) in round_edits:
                    pos = rng.randrange(max(lens[ai], 1)) \
                        if lens[ai] else 0
                    ch = chr(ord("a") + (doc_idx % 26))
                    heads[ai] = [ol.add_insert_at(
                        agents[ai], heads[ai], pos, ch * n)]
                    lens[ai] += n
                yield len(round_edits)
        return feeder
    return {d: make_feeder(i) for i, d in enumerate(doc_ids)}


def _flash_feeders(doc_ids: List[str], rounds: int, seed: int):
    """Flash-crowd tape: a migrating hot doc takes op BURSTS while the
    cold tail trickles, so each window's max-op count — and with it the
    pow2 `n` shape class — thrashes from round to round."""
    ndocs = len(doc_ids)

    def make_feeder(doc_idx: int):
        def feeder(ol: OpLog):
            agent = ol.get_or_create_agent_id("flash")
            rng = random.Random(seed * 104729 + doc_idx)
            ln = 0
            for r in range(rounds):
                hot = (r // 2) % max(ndocs, 1)
                if doc_idx == hot:
                    burst = 6 + rng.randrange(10)
                elif (doc_idx + r) % 7 == 0:
                    burst = 3 + rng.randrange(4)
                else:
                    burst = 1 + rng.randrange(2)
                n = 0
                for _ in range(burst):
                    pos = rng.randint(0, ln)
                    s = "".join(rng.choice("abcdefgh ")
                                for _ in range(rng.randint(1, 3)))
                    ol.add_insert(agent, pos, s)
                    ln += len(s)
                    n += 1
                yield n
        return feeder
    return {d: make_feeder(i) for i, d in enumerate(doc_ids)}


def run_serve_bench(shards: int = 4, docs: int = 8,
                    txns: Optional[int] = None, engine: str = "device",
                    mode: str = "trace", corpus: Optional[str] = None,
                    flush_docs: int = 4, flush_deadline_s: float = 0.02,
                    max_pending: int = 64, max_sessions: int = 4,
                    seed: int = 7, place_on_devices: bool = True,
                    device=None, flush_workers: bool = True,
                    warmup: bool = False,
                    steady_rounds: int = 0,
                    device_plan: bool = False,
                    mesh_window: bool = False,
                    fused: bool = True,
                    obs_sample_rate: float = 0.01,
                    telemetry: bool = True,
                    journey: bool = True) -> dict:
    """Replay the workload through a fresh scheduler; returns a JSON-able
    report with throughput, the metrics snapshot and the parity gate.
    `device` is where the sessions live: None means CUDA, with shard i on
    `cuda:(i % device_count)` when `place_on_devices`; `device="cpu"` runs
    the kernels' plain versions on the CPU. `device_plan=True` plans flush
    tails through the device transform (K2) — the report's `transform`
    block counts the tails that resolved on the device. `mesh_window=True`
    flushes through the scheduler's flush window (one K1 launch per class
    and device per window, instead of one call per shard's bucket): the
    report's `device_calls_per_window` is the A/B signal. With
    `steady_rounds`, every doc takes that many more lockstep rounds against
    resident sessions after the continuous feed (the fused occupancy
    measurement). `fused=False` keeps zone sessions (`DeviceZoneSession`)
    and syncs each document on its own; the window and device planning are
    fused-only. `obs_sample_rate` head-samples trace roots;
    `telemetry=False` turns off the live time series (the SLO verdict then
    trivially passes) and `journey=False` the journey stamps (module
    docstring: the report's obs keys)."""
    doc_ids = [f"doc{i:03d}" for i in range(docs)]
    ols: Dict[str, OpLog] = {}
    for d in doc_ids:
        ol = OpLog()
        ol.doc_id = d
        ols[d] = ol

    if mode == "trace":
        data = load_trace(corpus) if corpus else \
            synth_trace(n_txns=txns or 40, seed=seed)
        if txns:
            data = TestData(start_content=data.start_content,
                            end_content=data.end_content,
                            txns=data.txns[:txns])
        feeders = {d: f(ols[d])
                   for d, f in _trace_feeders(data, doc_ids).items()}
        n_rounds = len(data.txns)
    elif mode == "concurrent":
        n_rounds = txns or 24
        schedule = _concurrent_schedule(n_rounds, 2, seed)
        feeders = {d: f(ols[d]) for d, f in
                   _concurrent_feeders(schedule, doc_ids, seed).items()}
    elif mode == "flash":
        n_rounds = txns or 24
        feeders = {d: f(ols[d]) for d, f in
                   _flash_feeders(doc_ids, n_rounds, seed).items()}
    else:
        raise ValueError(f"unknown mode {mode!r}")

    # the profiler and the window arenas are process-global: fresh state
    # per bench run
    PROFILER.reset()
    PROFILER.enabled = True
    reset_arenas()
    # with flush workers on, worker threads READ oplogs (tail planning)
    # while this loop APPENDS to them — the oplog lock makes that safe,
    # exactly the way the sync server passes DocStore.lock
    oplog_lock = threading.Lock()
    sched = MergeScheduler(
        shards, resolve=ols.__getitem__, engine=engine,
        max_sessions_per_shard=max_sessions,
        max_pending=max_pending, flush_docs=flush_docs,
        flush_deadline_s=flush_deadline_s,
        place_on_devices=place_on_devices and device is None,
        sync_lock=oplog_lock, fused=fused,
        fused_opts=None if device is None else {"device": device},
        session_opts=None if device is None else {"device": device},
        flush_workers=flush_workers, warmup=warmup,
        device_plan=device_plan, mesh_window=mesh_window)
    obs = Observability(sample_rate=obs_sample_rate, seed=seed,
                        telemetry=telemetry, journey=journey)
    sched.attach_obs(obs)
    try:
        if warmup:
            # measure warm flushes, not the warm-up's first launches
            sched.banks[0].join_warmup()
        report = _feed(sched, ols, doc_ids, feeders, oplog_lock, mode,
                       seed, steady_rounds)
        report.update(_obs_report(obs, report, mode, seed))
    finally:
        sched.stop_workers()
        PROFILER.enabled = False
    return {"config": {
        "shards": shards, "docs": docs, "engine": engine, "mode": mode,
        "corpus": corpus, "rounds": n_rounds, "flush_docs": flush_docs,
        "flush_deadline_s": flush_deadline_s, "max_pending": max_pending,
        "max_sessions": max_sessions, "seed": seed,
        "device": str(sched.banks[0].device),
        "place_on_devices": place_on_devices and device is None,
        "fused": sched.fused, "flush_workers": flush_workers,
        "warmup": warmup, "steady_rounds": steady_rounds,
        "device_plan": sched.device_plan,
        "mesh_window": sched.mesh_window,
        "telemetry": telemetry, "journey": journey}, **report}


def _feed(sched, ols, doc_ids, feeders, oplog_lock, mode: str, seed: int,
          steady_rounds: int) -> dict:
    t0 = time.perf_counter()
    total_ops = 0
    retries = 0
    live = dict(feeders)
    while live:
        done = []
        for d, gen in live.items():
            try:
                with oplog_lock:
                    n = next(gen)
            except StopIteration:
                done.append(d)
                continue
            total_ops += n
            r = sched.submit(d, n_ops=n)
            attempts = 0
            while not r["accepted"]:
                # reject-with-retry-after: flush due work and retry; a
                # couple of polite retries, then force a flush so the
                # feed loop always terminates
                retries += 1
                attempts += 1
                sched.pump(force=attempts > 2)
                r = sched.submit(d, n_ops=n)
        for d in done:
            del live[d]
        sched.pump()
    sched.drain()

    # steady-state phase (lockstep): every doc is RESIDENT; each round
    # appends one more txn per doc and drains, so each flush carries its
    # whole bucket with fresh tails
    if steady_rounds:
        if mode == "trace":
            sdata = synth_trace(n_txns=steady_rounds, seed=seed + 1)
            sfeeders = {d: f(ols[d]) for d, f in
                        _trace_feeders(sdata, doc_ids).items()}
        elif mode == "flash":
            sfeeders = {d: f(ols[d]) for d, f in _flash_feeders(
                doc_ids, steady_rounds, seed + 1).items()}
        else:
            ssched = _concurrent_schedule(steady_rounds, 2, seed + 1)
            sfeeders = {d: f(ols[d]) for d, f in _concurrent_feeders(
                ssched, doc_ids, seed + 1).items()}
        for _ in range(steady_rounds):
            for d, gen in sfeeders.items():
                try:
                    with oplog_lock:
                        n = next(gen)
                except StopIteration:
                    continue
                total_ops += n
                r = sched.submit(d, n_ops=n)
                while not r["accepted"]:
                    retries += 1
                    sched.pump(force=True)
                    r = sched.submit(d, n_ops=n)
            sched.drain()
    feed_wall = time.perf_counter() - t0
    sched.stop_workers()

    mismatches = []
    for d in doc_ids:
        ref = Branch()
        ref.merge_reference(ols[d], ols[d].version)
        want = ref.snapshot()
        if sched.text(d) != want:
            mismatches.append(d)
    wall = time.perf_counter() - t0
    m = sched.metrics_json()
    return {
        "total_ops": total_ops,
        "submit_retries": retries,
        "feed_wall_s": round(feed_wall, 3),
        "wall_s": round(wall, 3),
        "ops_per_sec": round(total_ops / max(feed_wall, 1e-9)),
        "parity_ok": not mismatches,
        "parity_mismatches": mismatches,
        "fused_device_calls": m["fused"]["device_calls"],
        "fused_occupancy": m["fused"]["occupancy"],
        "device_calls_per_window": m["window"]["device_calls_per_window"],
        # host->device staging per flush window (0 without the window)
        "staged_bytes_per_window": m["window"]["staged_bytes_per_window"],
        # the transform rung's engagement: tails whose merge positions
        # resolved on the device vs. the host tracker walk
        "transform": m["transform"],
        "metrics": m,
    }


def _obs_report(obs, report: dict, mode: str, seed: int) -> dict:
    """The report's observability keys, after the parity check: the SLO
    verdict over the run's telemetry (a bench that passes parity but
    burned its latency budget fails), the profiler's snapshot, the
    tracer's and journey's state and a banded scorecard."""
    m = report["metrics"]
    mismatches = report["parity_mismatches"]
    obs.slo.evaluate()
    slo_verdict = obs.slo.verdict()
    out = {
        "slo": slo_verdict,
        "slo_ok": slo_verdict["slo_ok"],
        "devprof": PROFILER.snapshot(),
        "obs": {"trace": obs.tracer.stats(),
                "ts_recorded": obs.ts.recorded,
                "journey": obs.journey.snapshot()},
    }
    # a banded scorecard so serve-bench A/B arms gate through the same
    # engine as the JAX package's scenario runs (`diff_scorecards`)
    out["scorecard"] = build_scorecard(
        scenario={"name": f"serve-bench-{mode}", "seed": seed},
        wall_s=report["wall_s"], virtual_s=0.0,
        totals={"ops": report["total_ops"], "writes": report["total_ops"],
                "reads": 0, "errors": len(mismatches)},
        latency_p99_s={"flush": m["latencies"]["flush"]["p99"]},
        slo={"slo_ok": slo_verdict["slo_ok"],
             "burning": slo_verdict["burning"],
             "warning": slo_verdict["warning"]},
        ok=bool(not mismatches and slo_verdict["slo_ok"]),
        serve={
            "staged_bytes_per_window": report["staged_bytes_per_window"],
            "device_calls_per_window": report["device_calls_per_window"],
        },
    )
    if mismatches:
        # a parity failure report should be diagnosable standalone:
        # attach the flight recorder's tail (evictions, fallbacks, fencing)
        out["events_tail"] = obs.recorder.tail(50)
    return out
