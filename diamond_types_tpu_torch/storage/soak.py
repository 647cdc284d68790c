"""Storage soak: churn docs through an undersized residency tier with
seeded fault injection, gating on byte-identical re-hydration.

`cli storage-soak` drives this. One process hosts the whole residency
ladder — `TieredStore` homes on real disk, a `Hydrator` warm tier
deliberately smaller than the doc population, a host-engine
`MergeScheduler` flushing through the hydration gate — and a seeded
rng injects the failure modes the tier exists to survive:

  * **crash-restart** — the hydrator is stopped WITHOUT checkpoint and
    the whole serving stack is rebuilt over the same directory; the
    expected state resets to the durable frontier (exactly what a real
    restart recovers);
  * **crash-mid-compaction** — `compact_doc` dies at a seeded fsync
    point (`snapshot_written` / `replaced` / `dir_synced`); recovery
    must read old-or-new snapshot, never a torn mix;
  * **torn tail** — the last page of a cold doc's home is garbled
    (a write the power cut mid-page); recovery must roll back to one
    of the doc's last two persisted states;
  * **corruption** — a whole home is overwritten; that doc (and ONLY
    that doc) must land in quarantine while everything else flushes;
  * **slow disk** (--slow) — seeded load delays exercise the
    per-attempt timeout / retry ladder without tripping quarantine.

The verdict JSON asserts: every surviving doc re-hydrates
byte-identical to its expected content, the quarantine set is EXACTLY
the corrupted docs, zero quarantined docs leaked into flush batches,
cold-start p99 is under budget, and the runtime lock witness stayed
acyclic. `ok` is the AND of all gates — the CLI exits nonzero
otherwise.

The JAX package's `storage/soak.py`, copied; it runs the port's
scheduler, bank, Hydrator and store. `python -m
diamond_types_tpu_torch.storage.soak` takes the JAX package's `cli
storage-soak` flags (`--churn --crash --slow --json`, ...) and exits 1
unless the verdict's `ok` is true.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import tempfile
import time
from typing import Dict, List, Optional

from ..analysis.witness import (make_lock, witness_enable,
                                witness_snapshot)
from ..obs.hist import Histogram
from ..serve.hydrate import Hydrator
from ..serve.scheduler import MergeScheduler
from ..storage.pages import PAGE_SIZE
from ..storage.tier import DocQuarantined, StorageFaults, TieredStore
from ..text.oplog import OpLog

_CRASH_POINTS = ("snapshot_written", "replaced", "dir_synced")


class _InjectedCrash(Exception):
    pass


def run_storage_soak(docs: int = 120, warm: int = 12, rounds: int = 8,
                     edits_per_round: int = 48, shards: int = 2,
                     seed: int = 0, compact_every: int = 16,
                     churn: bool = False, crash: bool = False,
                     slow: bool = False,
                     data_dir: Optional[str] = None,
                     p99_budget_s: float = 0.5,
                     progress: bool = False) -> dict:
    rng = random.Random(f"storage-soak:{seed}")
    witness_enable()
    root = data_dir or tempfile.mkdtemp(prefix="dt-storage-soak-")
    own_root = data_dir is None
    t_start = time.monotonic()

    faults = StorageFaults(seed=seed, slow_rate=0.15 if slow else 0.0,
                           slow_s=0.02)
    # last two persisted texts per doc — the torn-tail oracle (a torn
    # final record must recover to one of these, never a mix)
    persist_history: Dict[str, List[str]] = {}

    def on_persist(doc_id: str, home_oplog) -> None:
        hist = persist_history.setdefault(doc_id, [])
        hist.append(home_oplog.checkout_tip().snapshot())
        del hist[:-2]

    cold_hist = Histogram()         # shared across crash lifetimes
    hyd_totals: Dict[str, int] = {}
    oplog_guard = make_lock("soak.oplog", "oplog")

    def build():
        store = TieredStore(root, compact_patch_records=compact_every,
                            faults=faults, on_persist=on_persist)
        hyd = Hydrator(store, workers=2, warm_max=warm,
                       attempt_timeout_s=0.25, max_attempts=4,
                       sync_wait_s=5.0, evict_grace_s=0.01,
                       oplog_lock=oplog_guard, seed=seed)
        hyd.cold_start = cold_hist      # aggregate across lifetimes
        sched = MergeScheduler(shards, hyd.resolve, engine="host",
                               max_sessions_per_shard=max(warm // 2, 2),
                               max_pending=4 * edits_per_round + 16,
                               flush_docs=8, flush_deadline_s=0.02,
                               sync_lock=oplog_guard)
        sched.attach_hydrator(hyd)
        return store, hyd, sched

    def teardown(hyd, sched, checkpoint: bool):
        if checkpoint:
            sched.drain()
        sched.stop_pump(drain=checkpoint)
        hyd.stop(checkpoint=checkpoint)
        for k, v in hyd.counters_snapshot().items():
            hyd_totals[k] = hyd_totals.get(k, 0) + v

    # ---- seed the population --------------------------------------------
    control: Dict[str, str] = {}
    store, hyd, sched = build()
    for i in range(docs):
        d = f"doc{i:05d}"
        ol = OpLog()
        a = ol.get_or_create_agent_id("seed")
        ol.add_insert(a, 0, f"[{d}] genesis. ")
        store.save(d, ol, oplog_lock=oplog_guard)
        control[d] = ol.checkout_tip().snapshot()

    expected_quarantined: set = set()
    edits = crashes = compaction_kills = torn_tails = 0
    quarantine_rejects = 0
    doc_ids = sorted(control)

    def apply_edits(d: str, n: int) -> None:
        nonlocal edits
        ol = hyd.resolve(d)
        a = ol.get_or_create_agent_id(f"ed{seed}")
        with oplog_guard:
            text = control[d]
            for _ in range(n):
                if text and rng.random() < 0.25:
                    start = rng.randrange(len(text))
                    end = min(start + rng.randint(1, 4), len(text))
                    ol.add_delete_at(a, ol.version, start, end,
                                     content=text[start:end])
                    text = text[:start] + text[end:]
                else:
                    pos = rng.randint(0, len(text))
                    tok = f"<{edits}>"
                    ol.add_insert(a, pos, tok)
                    text = text[:pos] + tok + text[pos:]
                edits += 1
            control[d] = text

    def live_docs() -> List[str]:
        return [d for d in doc_ids if d not in expected_quarantined]

    # ---- churn rounds ----------------------------------------------------
    for rnd in range(rounds):
        for _ in range(edits_per_round):
            d = rng.choice(live_docs())
            apply_edits(d, rng.randint(1, 3))
            r = sched.submit(d)
            if not r["accepted"] and r.get("reason") == "quarantined":
                quarantine_rejects += 1
            if rng.random() < 0.2:
                sched.pump(force=True)
        sched.drain()

        if churn:
            # eviction-under-pressure: force extra snapshot evictions
            # beyond what warm_max already causes
            for d in rng.sample(live_docs(),
                                k=min(warm, len(live_docs()))):
                hyd.evict_to_snapshot(d, why="soak-churn")

        if crash and rnd == rounds // 3:
            # ---- crash-mid-compaction (every fsync point) --------------
            for point in _CRASH_POINTS:
                d = rng.choice(live_docs())
                hyd.evict_to_snapshot(d, why="pre-compact")
                want = persist_history[d][-1]

                def _boom(p, point=point):
                    if p == point:
                        raise _InjectedCrash(point)

                try:
                    store.compact_doc(d, _crash=_boom)
                except _InjectedCrash:
                    pass
                compaction_kills += 1
                got = store.load(d).checkout_tip().snapshot()
                if got != want:
                    return _verdict(locals(), ok=False,
                                    error=f"compaction kill at {point}: "
                                          f"torn recovery for {d}")

        if crash and rnd == rounds // 2:
            # ---- torn tail + full corruption ---------------------------
            for _ in range(2):
                d = rng.choice(live_docs())
                hyd.evict_to_snapshot(d, why="pre-torn")
                path = store.path(d)
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.seek(max(size - PAGE_SIZE, 0))
                    f.write(os.urandom(min(PAGE_SIZE, size)))
                torn_tails += 1
                try:
                    got = store.load(d).checkout_tip().snapshot()
                except DocQuarantined:
                    # the garbled page ate the only decodable chain —
                    # acceptable only if recovery itself is clean
                    expected_quarantined.add(d)
                    continue
                ok_states = persist_history.get(d, [])[-2:]
                if got not in ok_states:
                    return _verdict(locals(), ok=False,
                                    error=f"torn tail: {d} recovered to "
                                          "a state outside its last two "
                                          "persists")
                control[d] = got
                # disk rolled back; the warm copy (if any) is AHEAD of
                # the home now — drop it so the doc re-hydrates from
                # the recovered state we just asserted
                with hyd._hydrate_lock:
                    hyd._warm.pop(d, None)
                    hyd._touched.pop(d, None)

            corrupt = rng.sample(live_docs(), k=2)
            for d in corrupt:
                hyd.evict_to_snapshot(d, why="pre-corrupt")
                path = store.path(d)
                with open(path, "r+b") as f:
                    f.write(b"\xff" * os.path.getsize(path))
                expected_quarantined.add(d)
            # quarantine is discovered at hydration time: touch them
            for d in corrupt:
                r = sched.submit(d)
                if not r["accepted"]:
                    quarantine_rejects += 1
            sched.drain()

        if crash and rnd == (2 * rounds) // 3:
            # ---- crash-restart -----------------------------------------
            teardown(hyd, sched, checkpoint=False)
            crashes += 1
            store, hyd, sched = build()
            for d in doc_ids:
                if d in expected_quarantined:
                    continue
                try:
                    control[d] = store.load(d) \
                        .checkout_tip().snapshot()
                except DocQuarantined:
                    expected_quarantined.add(d)

        if progress:     # pragma: no cover - human pacing output
            print(f"  round {rnd + 1}/{rounds}: {edits} edits, "
                  f"{len(expected_quarantined)} quarantined, "
                  f"warm={hyd.warm_count()}")

    # ---- final parity ----------------------------------------------------
    teardown(hyd, sched, checkpoint=True)
    verify = TieredStore(root, compact_patch_records=compact_every)
    byte_mismatches = 0
    observed_quarantined = set()
    for d in doc_ids:
        try:
            got = verify.load(d).checkout_tip().snapshot()
        except DocQuarantined:
            observed_quarantined.add(d)
            continue
        if d in expected_quarantined:
            # quarantine is per-STORE state; a fresh store may decode a
            # wiped file's salvageable WAL — only full equality to the
            # expected text counts as survival
            continue
        if got != control[d]:
            byte_mismatches += 1
    rehydrations = verify.counters()["loads"]
    return _verdict(locals(), ok=None)


def _verdict(ns: dict, ok, error: Optional[str] = None) -> dict:
    """Assemble the JSON verdict from run_storage_soak's locals (also
    the early-exit path for mid-run gate failures)."""
    wit = witness_snapshot()
    cold = ns["cold_hist"].snapshot()
    expected = ns["expected_quarantined"]
    observed = ns.get("observed_quarantined", set())
    p99_ok = cold["p99"] <= ns["p99_budget_s"]
    quarantine_match = (observed == expected) if ok is None else False
    leaks = ns["hyd_totals"].get("flush_leaks", 0) \
        + ns["hyd"].counters_snapshot().get("flush_leaks", 0)
    byte_mismatches = ns.get("byte_mismatches", -1)
    if ok is None:
        ok = (byte_mismatches == 0 and quarantine_match and leaks == 0
              and p99_ok and wit["acyclic"]
              and wit["violation_count"] == 0)
    report = {
        "config": {"docs": ns["docs"], "warm": ns["warm"],
                   "rounds": ns["rounds"],
                   "edits_per_round": ns["edits_per_round"],
                   "shards": ns["shards"], "seed": ns["seed"],
                   "compact_every": ns["compact_every"],
                   "churn": ns["churn"], "crash": ns["crash"],
                   "slow": ns["slow"],
                   "p99_budget_s": ns["p99_budget_s"]},
        "edits": ns["edits"],
        "rehydrations": ns.get("rehydrations", 0),
        "byte_mismatches": byte_mismatches,
        "quarantined": sorted(observed),
        "expected_quarantined": sorted(expected),
        "quarantine_match": quarantine_match,
        "quarantine_rejects": ns["quarantine_rejects"],
        "quarantine_leaks": leaks,
        "cold_start": {k: cold.get(k) for k in
                       ("count", "p50", "p90", "p99", "max")},
        "p99_ok": p99_ok,
        "crashes": ns["crashes"],
        "compaction_kills": ns["compaction_kills"],
        "torn_tails": ns["torn_tails"],
        "injected_slow": ns["faults"].injected_slow,
        "hydration": dict(ns["hyd_totals"]),
        "lock_witness": {"acyclic": wit["acyclic"],
                         "violation_count": wit["violation_count"],
                         "edge_count": wit["edge_count"],
                         "acquires": wit["acquires"],
                         "cycles": wit["cycles"]},
        "wall_s": round(time.monotonic() - ns["t_start"], 3),
        "ok": bool(ok),
    }
    if error:
        report["error"] = error
    if ns["own_root"]:
        shutil.rmtree(ns["root"], ignore_errors=True)
    else:
        report["data_dir"] = ns["root"]
    return report


def main(argv: Optional[List[str]] = None) -> int:
    """The `cli storage-soak` subcommand of the JAX package, for the port:
    same flags and defaults, same one-line summary (or `--json`)."""
    ap = argparse.ArgumentParser(
        prog="python -m diamond_types_tpu_torch.storage.soak",
        description="fault-injected tiered-residency soak: churn docs "
        "through an undersized warm tier and gate on byte-identical "
        "re-hydration")
    ap.add_argument("--docs", type=int, default=120)
    ap.add_argument("--warm", type=int, default=12,
                    help="warm-tier capacity (deliberately << --docs: "
                    "eviction pressure is the point)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--edits-per-round", type=int, default=48)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--compact-every", type=int, default=16,
                    help="per-doc WAL patch records before a baseline "
                    "fold (low = many compactions under churn)")
    ap.add_argument("--churn", action="store_true",
                    help="force extra evictions-to-snapshot every round "
                    "beyond what warm-tier pressure already causes")
    ap.add_argument("--crash", action="store_true",
                    help="inject crash-restart, crash-mid-compaction "
                    "(every fsync point), torn tails and wholesale "
                    "corruption")
    ap.add_argument("--slow", action="store_true",
                    help="seeded slow-disk delays on load (exercises "
                    "the per-attempt timeout / retry ladder)")
    ap.add_argument("--data-dir",
                    help="home directory for the doc snapshot files "
                    "(default: a fresh temp dir, removed afterwards)")
    ap.add_argument("--p99-budget", type=float, default=0.5,
                    help="cold-start p99 gate in seconds")
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--metrics-out")
    args = ap.parse_args(argv)
    report = run_storage_soak(
        docs=args.docs, warm=args.warm, rounds=args.rounds,
        edits_per_round=args.edits_per_round, shards=args.shards,
        seed=args.seed, compact_every=args.compact_every,
        churn=args.churn, crash=args.crash, slow=args.slow,
        data_dir=args.data_dir, p99_budget_s=args.p99_budget,
        progress=args.progress)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(report, f, indent=1)
    if args.json:
        print(json.dumps(report))
    else:
        cold = report["cold_start"]
        wit = report["lock_witness"]
        print(f"storage-soak: {report['config']['docs']} docs / "
              f"{report['config']['warm']} warm slots, "
              f"{report['edits']} edits, "
              f"{report['rehydrations']} re-hydrations "
              f"({report['byte_mismatches']} byte mismatches), "
              f"quarantine "
              f"{'EXACT' if report['quarantine_match'] else 'MISMATCH'} "
              f"({len(report['quarantined'])} docs, "
              f"{report['quarantine_leaks']} flush leaks), "
              f"cold-start p99 {cold['p99'] * 1e3:.1f}ms"
              f"{' OK' if report['p99_ok'] else ' OVER BUDGET'}"
              + (f", {report['crashes']} crash-restarts, "
                 f"{report['compaction_kills']} compaction kills, "
                 f"{report['torn_tails']} torn tails"
                 if report["config"]["crash"] else "")
              + ", lock-witness "
              + ("ACYCLIC" if wit["acyclic"] and not wit["violation_count"]
                 else "VIOLATED")
              + f" in {report['wall_s']}s: "
              + ("OK" if report["ok"] else "FAILED"
                 + (f" ({report['error']})" if "error" in report else "")))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
