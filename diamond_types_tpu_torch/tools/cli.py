"""Command-line tool for .dt files.

Capability mirror of the reference dt-cli (reference:
crates/dt-cli/src/main.rs:34-166 — create/cat/log/version/set/repack,
export.rs, git.rs git-import, dot.rs graphviz export).

Usage: python -m diamond_types_tpu_torch.tools.cli <command> [...]

The JAX package's CLI with the same subcommands, flags and exit codes.
Every subcommand that boots a merge scheduler or a server
(`serve-bench`, `scenario run`, `replicate-soak`, `rebalance-soak`,
`read-bench`) takes `--device`: the torch device its schedulers merge
on, CUDA by default, which must exist (`--device cpu` runs the kernels'
plain versions); nothing falls back to the CPU or the host engine.
`wire-bench` and `storage-soak` stay on the host, as in the JAX package.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import subprocess
import sys
import time
import uuid

from ..encoding.decode import load_oplog
from ..encoding.encode import ENCODE_FULL, EncodeOptions, encode_oplog
from ..text.op import DEL, INS
from ..text.oplog import OpLog


def _read_oplog(path: str) -> OpLog:
    with open(path, "rb") as f:
        return load_oplog(f.read())


def _write_oplog(path: str, ol: OpLog, opts: EncodeOptions = ENCODE_FULL) -> None:
    with open(path, "wb") as f:
        f.write(encode_oplog(ol, opts))


def _rand_agent() -> str:
    return uuid.uuid4().hex[:12]


def _apply_diff(ol: OpLog, agent: int, parents, old: str, new: str):
    """Apply old->new as insert/delete ops (reference: dt-cli set / git.rs)."""
    sm = difflib.SequenceMatcher(a=old, b=new, autojunk=False)
    # Apply from the end so earlier positions stay valid.
    version = list(parents)
    for tag, i1, i2, j1, j2 in reversed(sm.get_opcodes()):
        if tag == "equal":
            continue
        if tag in ("replace", "delete") and i2 > i1:
            version = [ol.add_delete_at(agent, version, i1, i2, old[i1:i2])]
        if tag in ("replace", "insert") and j2 > j1:
            version = [ol.add_insert_at(agent, version, i1, new[j1:j2])]
    return version


def cmd_create(args) -> int:
    if os.path.exists(args.filename) and not args.force:
        print(f"{args.filename} exists (use --force)", file=sys.stderr)
        return 1
    ol = OpLog()
    if args.content is not None:
        agent = ol.get_or_create_agent_id(args.agent or _rand_agent())
        ol.add_insert_at(agent, [], 0, args.content)
    _write_oplog(args.filename, ol)
    return 0


def cmd_cat(args) -> int:
    ol = _read_oplog(args.filename)
    version = json.loads(args.version) if args.version else ol.version
    out = ol.checkout(version).snapshot()
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    return 0


def cmd_log(args) -> int:
    ol = _read_oplog(args.filename)
    if args.history:
        for (lv0, lv1, parents, agent, seq) in ol.cg.iter_entries():
            name = ol.cg.agent_assignment.get_agent_name(agent)
            print(json.dumps({"span": [lv0, lv1], "parents": list(parents),
                              "agent": name, "seq": seq}))
        return 0
    if args.transformed:
        for (span, op, content) in ol.iter_xf_operations():
            if op is None:
                continue
            row = {"kind": "ins" if op.kind == INS else "del",
                   "start": op.start, "end": op.end, "fwd": op.fwd}
            if content is not None:
                row["content"] = content
            print(json.dumps(row))
        return 0
    for run in ol.ops.runs:
        row = {"lv": run.lv, "kind": "ins" if run.kind == INS else "del",
               "start": run.start, "end": run.end, "fwd": run.fwd}
        c = ol.ops.get_run_content(run)
        if c is not None:
            row["content"] = c
        print(json.dumps(row))
    return 0


def cmd_version(args) -> int:
    ol = _read_oplog(args.filename)
    print(json.dumps(ol.cg.local_to_remote_frontier(ol.version)))
    return 0


def cmd_set(args) -> int:
    ol = _read_oplog(args.filename)
    agent = ol.get_or_create_agent_id(args.agent or _rand_agent())
    old = ol.checkout_tip().snapshot()
    new = args.content if args.content is not None else sys.stdin.read()
    _apply_diff(ol, agent, ol.version, old, new)
    _write_oplog(args.filename, ol)
    return 0


def cmd_repack(args) -> int:
    ol = _read_oplog(args.filename)
    before = os.path.getsize(args.filename)
    _write_oplog(args.filename, ol)
    after = os.path.getsize(args.filename)
    print(f"{before} -> {after} bytes")
    return 0


def cmd_export(args) -> int:
    """Cross-CRDT benchmark JSON export (reference: dt-cli export.rs)."""
    ol = _read_oplog(args.filename)
    txns = []
    for (lv0, lv1, parents, agent, seq) in ol.cg.iter_entries():
        name = ol.cg.agent_assignment.get_agent_name(agent)
        patches = []
        for piece in ol.ops.iter_range((lv0, lv1)):
            content = ol.ops.get_run_content(piece) or ""
            if piece.kind == INS:
                patches.append([piece.start, 0, content])
            else:
                patches.append([piece.start, len(piece), ""])
        txns.append({
            "parents": [list(p) for p in
                        (ol.cg.local_to_remote_frontier(list(parents)))],
            "agent": name, "seqStart": seq, "patches": patches,
        })
    doc = {"kind": "concurrent", "endContent": ol.checkout_tip().snapshot(),
           "txns": txns}
    json.dump(doc, sys.stdout)
    return 0


def cmd_dot(args) -> int:
    """Graphviz export of the causal graph (reference: dt-cli dot.rs,
    src/causalgraph/dot.rs)."""
    ol = _read_oplog(args.filename)
    g = ol.cg.graph
    print("digraph dt {")
    print('  rankdir="BT";')
    for i in range(len(g)):
        label = f"{g.starts[i]}..{g.ends[i] - 1}"
        print(f'  n{i} [label="{label}"];')
        if not g.parents[i]:
            print(f"  n{i} -> root;")
        for p in g.parents[i]:
            print(f"  n{i} -> n{g.find_idx(p)};")
    print("}")
    return 0


def cmd_git_import(args) -> int:
    """Replay a file's git history into a DT doc (reference: dt-cli git.rs):
    each commit becomes an edit run by its author, parented on its git
    parents' versions — reproducing real high-fanout causal DAGs."""
    repo = args.repo or "."
    path = args.path

    log = subprocess.run(
        ["git", "-C", repo, "log", "--follow", "--reverse",
         "--format=%H %P", "--", path],
        capture_output=True, text=True, check=True).stdout
    commits = []
    for line in log.splitlines():
        parts = line.split()
        commits.append((parts[0], parts[1:]))

    ol = OpLog()
    versions = {}   # commit hash -> (frontier, content)
    known = set(h for h, _ in commits)
    for h, parents in commits:
        parents = [p for p in parents if p in known and p in versions]
        author = subprocess.run(
            ["git", "-C", repo, "show", "-s", "--format=%ae", h],
            capture_output=True, text=True, check=True).stdout.strip()
        blob = subprocess.run(
            ["git", "-C", repo, "show", f"{h}:{path}"],
            capture_output=True, text=True).stdout
        if not parents:
            base_frontier, base_content = [], ""
        elif len(parents) == 1:
            base_frontier, base_content = versions[parents[0]]
        else:
            merged = []
            for p in parents:
                merged = ol.cg.graph.version_union(merged, versions[p][0])
            base_frontier = merged
            base_content = ol.checkout(merged).snapshot()
        agent = ol.get_or_create_agent_id(author or "unknown")
        v = _apply_diff(ol, agent, base_frontier, base_content, blob)
        versions[h] = (v if v != list(base_frontier) else base_frontier, blob)

    _write_oplog(args.out, ol)
    final = ol.checkout_tip().snapshot()
    print(f"imported {len(commits)} commits, {len(ol)} ops -> {args.out} "
          f"({os.path.getsize(args.out)} bytes); final doc {len(final)} chars")
    return 0


def cmd_serve_bench(args) -> int:
    """Replay a trace corpus through the serve/ merge scheduler on N
    shards, byte-parity-gated against the single-engine merge (see
    serve/driver.py). Exits nonzero on any parity mismatch.

    The schedulers merge on `--device` (default CUDA, which must exist;
    `--real-device` is accepted and changes nothing, since the card is
    already the default). `--pallas` / `--no-pallas` are accepted and
    change nothing: the top rung is always the hand-written K1 kernel.
    `--steer` / `--no-steer` and `--device-stage` / `--no-device-stage`
    are accepted and change nothing: every launch runs at its pow2 shape
    class and the flush window gathers its rows on the device.
    `--dry-run` is the JAX package's CI preset (host engine, 2 shards, 4
    documents, 6 txns) on the CPU."""
    from ..serve.driver import run_serve_bench
    kw = dict(shards=args.shards, docs=args.docs, txns=args.txns,
              engine=args.engine, mode=args.mode, corpus=args.corpus,
              flush_docs=args.flush_docs,
              flush_deadline_s=args.flush_deadline,
              max_pending=args.max_pending,
              max_sessions=args.max_sessions, seed=args.seed,
              fused=args.fused, flush_workers=args.workers,
              warmup=args.warmup, steady_rounds=args.steady_rounds,
              mesh_window=args.mesh_window, telemetry=args.telemetry,
              journey=args.journey, device_plan=args.device_plan,
              device=args.device)
    if args.dry_run:
        # CI smoke preset: host engine, tiny workload, on the CPU
        kw.update(shards=2, docs=4, txns=6, engine="host",
                  place_on_devices=False, device="cpu")
    elif args.engine == "device":
        # the device first: None means CUDA, which must exist
        from ..gpu import resolve_device
        resolve_device(args.device)
    report = run_serve_bench(**kw)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(report, f, indent=1)
    if args.json:
        print(json.dumps(report))
    else:
        m = report["metrics"]
        print(f"serve-bench: {report['config']['docs']} docs / "
              f"{report['config']['shards']} shards "
              f"({report['config']['engine']} engine, "
              f"{report['config']['mode']} mode, "
              f"fused={'on' if report['config'].get('fused') else 'off'}): "
              f"{report['total_ops']} ops in {report['wall_s']}s "
              f"({report['ops_per_sec']} ops/s), "
              f"occupancy {m['batch_occupancy']}, "
              f"fused calls {report['fused_device_calls']} "
              f"@ {report['fused_occupancy']} docs/call, "
              f"{report['device_calls_per_window']} device calls/"
              f"window, "
              f"staged {report.get('staged_bytes_per_window', 0)} "
              f"B/window, "
              f"parity {'OK' if report['parity_ok'] else 'MISMATCH'}, "
              + ("slo OK" if report["slo_ok"] else
                 "slo BURNING " + ",".join(report["slo"]["burning"])))
    # a bench that converges byte-for-byte but burned its latency
    # budget is still a failing bench — slo_ok rides the exit code
    return 0 if (report["parity_ok"] and report["slo_ok"]) else 1


def cmd_replicate_soak(args) -> int:
    """N in-process sync servers in one fault-injected replication
    mesh: drive edits through drops/partitions, heal, reconcile, and
    gate on byte-identical convergence (see replicate/soak.py)."""
    from ..replicate.soak import run_replicate_soak
    report = run_replicate_soak(
        servers=args.servers, docs=args.docs, rounds=args.rounds,
        edits_per_round=args.edits_per_round, seed=args.seed,
        drop_rate=args.drop_rate, dup_rate=args.dup_rate,
        partition_rounds=args.partition_rounds,
        reconcile_rounds=args.reconcile_rounds,
        lease_ttl_s=args.lease_ttl, serve_shards=args.serve_shards,
        crash=args.crash, asym=args.asym, churn=args.churn,
        witness=args.witness, progress=args.progress,
        device=args.device)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(report, f, indent=1)
    if args.json:
        print(json.dumps(report))
    else:
        print(f"replicate-soak: {report['config']['servers']} servers / "
              f"{report['config']['docs']} docs, "
              f"{report['edits_applied']} edits through "
              f"{report['faults']['drops']} drops + "
              f"{report['faults']['partition_blocks']} partition blocks "
              f"in {report['wall_s']}s: "
              f"{'CONVERGED' if report['converged'] else 'DIVERGED'}"
              + (f" after {report['converged_after_reconcile_rounds']} "
                 f"reconcile rounds"
                 if report["converged_after_reconcile_rounds"] else "")
              + (f", {report['crashes']} crash-restarts" if
                 report["crashes"] else "")
              + (", split-brain: "
                 + ("NONE" if report["zero_split_brain"]
                    else ",".join(report["split_brain"])))
              + ((", lock-witness: "
                  + ("ACYCLIC" if report["lock_witness"]["acyclic"]
                     else "CYCLIC " + ";".join(
                         report["lock_witness"]["cycles"]))
                  + f" ({report['lock_witness']['edge_count']} edges, "
                  f"{report['lock_witness']['acquires']} acquires)")
                 if "lock_witness" in report else ""))
    return 0 if (report["converged"] and report["zero_split_brain"]
                 and report.get("lock_witness",
                                {}).get("acyclic", True)) else 1


def cmd_rebalance_soak(args) -> int:
    """Flash-crowd elastic-mesh soak: a hot doc saturates its owner,
    the SLO burns, and the rebalancer must migrate the doc (epoch-
    fenced handoff + placement override), absorb a mid-run join, roll
    back a seeded failed migration, and return the SLO to ok — all
    without operator action (see replicate/rebalance_soak.py).

    With --split-hot-doc, runs the writer-group arm instead: the
    rebalancer promotes the hot doc to a 2-writer group under
    sustained burn (>= 2x admission, member accepting locally), then
    member-crash and asymmetric-partition demotions must drain back to
    one writer cleanly with zero acked-loss and zero split-brain."""
    from ..replicate.rebalance_soak import run_rebalance_soak
    if args.split_hot_doc:
        from ..replicate.rebalance_soak import run_split_soak
        report = run_split_soak(servers=args.servers, seed=args.seed,
                                progress=args.progress,
                                device=args.device)
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(report, f, indent=1)
        if args.json:
            print(json.dumps(report))
        else:
            s, g = report["single_writer"], report["writer_group"]
            print(f"rebalance-soak --split-hot-doc: "
                  f"{report['config']['servers']} servers, "
                  f"hot doc {report['hot_doc']}: "
                  f"single {s['acked']} acked "
                  f"({s['rate_per_s']}/s) -> group {g['acked']} "
                  f"acked ({g['rate_per_s']}/s), "
                  f"speedup {report['speedup']}x, "
                  f"member-crash demote "
                  + ("OK" if report["member_crash"]
                     and all(report["member_crash"].values())
                     else "BROKEN")
                  + ", partition-minority demote "
                  + ("OK" if report["partition_minority"]
                     and all(report["partition_minority"].values())
                     else "BROKEN")
                  + f", acked-loss: {len(report['lost_markers'])}"
                  + ", split-brain: "
                  + ("NONE" if report["zero_split_brain"]
                     else ",".join(report["split_brain"]))
                  + f" in {report['wall_s']}s: "
                  + ("CONVERGED" if report["converged"]
                     else "DIVERGED")
                  + (" OK" if report["ok"] else " FAILED"))
        return 0 if report["ok"] else 1
    report = run_rebalance_soak(
        servers=args.servers, docs=args.docs, seed=args.seed,
        capacity=args.capacity, crowd_boost=args.crowd_boost,
        flash_crowd=args.flash_crowd, join=args.join,
        inject_abort=args.inject_abort, progress=args.progress,
        device=args.device)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(report, f, indent=1)
    if args.json:
        print(json.dumps(report))
    else:
        journey = " -> ".join(
            s for i, s in enumerate(report["slo_states"])
            if i == 0 or s != report["slo_states"][i - 1]) or "ok"
        print(f"rebalance-soak: {report['config']['servers']}+"
              f"{1 if report['joined'] else 0} servers / "
              f"{report['config']['docs']} docs, "
              f"{report['edits_applied']} edits, slo {journey}, "
              f"{len(report['migrations'])} migrations"
              + (f", join absorbed" if report["joined"]
                 and report["join_absorbed"] else "")
              + (", abort rollback "
                 + ("OK" if report["abort_rollback_ok"] else "BROKEN")
                 if report["abort_rollback_ok"] is not None else "")
              + ", split-brain: "
              + ("NONE" if report["zero_split_brain"]
                 else ",".join(report["split_brain"]))
              + f" in {report['wall_s']}s: "
              + ("CONVERGED" if report["converged"] else "DIVERGED")
              + (" OK" if report["ok"] else " FAILED"))
    return 0 if report["ok"] else 1


def cmd_storage_soak(args) -> int:
    """Churn docs through an undersized residency tier (cold snapshot
    store -> warm hydrator -> scheduler) with seeded fault injection —
    crash-restart, crash-mid-compaction, torn tails, wholesale
    corruption, slow disk — and gate on byte-identical re-hydration,
    exact quarantine containment, zero flush leaks and bounded
    cold-start p99 (see storage/soak.py)."""
    from ..storage.soak import run_storage_soak
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
              f"quarantine {'EXACT' if report['quarantine_match'] else 'MISMATCH'} "
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


def cmd_read_bench(args) -> int:
    """Two-server follower-read A/B bench: Zipf-skewed readers across
    both nodes, control phase (max_staleness=0: every follower read
    proxies to the owner) vs follower phase (bounded staleness served
    locally), with client-side verification of both the staleness
    bound and the read-your-writes token (see read/bench.py)."""
    from ..read.bench import run_read_bench
    report = run_read_bench(
        docs=args.docs, readers=args.readers,
        reads_per_reader=args.reads_per_reader, seed=args.seed,
        zipf_s=args.zipf_s, max_staleness_s=args.max_staleness,
        min_version_every=args.min_version_every,
        lease_ttl_s=args.lease_ttl, serve_shards=args.serve_shards,
        doc_bytes=args.doc_bytes,
        min_speedup=args.min_speedup, progress=args.progress,
        device=args.device)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(report, f, indent=1)
    if args.json:
        print(json.dumps(report))
    else:
        c, fo = report["control"], report["follower"]
        print(f"read-bench: {report['config']['docs']} docs / "
              f"{report['config']['readers']} readers x "
              f"{report['config']['reads_per_reader']} reads, "
              f"{report['writes']} writes riding along: "
              f"control {c['reads_per_s']} reads/s "
              f"({c['proxied']} proxied), "
              f"follower {fo['reads_per_s']} reads/s "
              f"({fo['local']} local, max staleness "
              f"{fo['max_observed_staleness_s'] * 1e3:.0f}ms), "
              f"speedup {report['speedup']}x, "
              f"{report['violations']} contract violations, "
              f"{report['errors']} errors in {report['wall_s']}s: "
              + ("OK" if report["ok"] else "FAILED"))
    return 0 if report["ok"] else 1


def wire_bench(seed: int = 7, n_ops: int = 2000, agents: int = 8,
               docs: int = 64) -> dict:
    """Wire-frame codec micro-benchmark: a deterministic churn op tape
    (unicode-heavy inserts/deletes, churning agent names) measured
    through each frame codec against its JSON twin. Returns the row
    `cli wire-bench` prints and bench.py ingests alongside serve_sched
    (encode/decode ops/sec + bytes-on-the-wire ratios)."""
    import random
    import time as _time
    from ..causalgraph.summary import summarize_versions
    from ..encoding.encode import ENCODE_FULL, encode_oplog
    from ..text.oplog import OpLog
    from ..wire.frames import (FRAME_DOCS, FRAME_OPS, FRAME_PATCH,
                               FRAME_SUMMARY, decode_frame, decode_docs,
                               decode_ops, decode_summary, encode_docs,
                               encode_frame, encode_ops, encode_summary)
    rng = random.Random(f"wire-bench:{seed}")
    alphabet = "etaoin shrdluéß世界\U0001f600"

    # ---- churn tape: edit bodies exactly as the proxy channel sees them
    reqs, doc_len = [], 0
    for i in range(n_ops):
        agent = f"t0s{i % agents}g{i // 97}"
        if doc_len > 8 and rng.random() < 0.3:
            start = rng.randrange(doc_len - 4)
            end = min(doc_len, start + 1 + rng.randrange(4))
            ops = [{"kind": "del", "start": start, "end": end}]
            doc_len -= end - start
        else:
            text = "".join(rng.choice(alphabet)
                           for _ in range(1 + rng.randrange(8)))
            pos = rng.randrange(doc_len + 1)
            ops = [{"kind": "ins", "pos": pos, "text": text}]
            doc_len += len(text)
        reqs.append({"agent": agent, "version": [[agent, max(i - 1, 0)]],
                     "ops": ops})

    t0 = _time.perf_counter()
    frames = [encode_frame(FRAME_OPS, encode_ops(r), compress=True)
              for r in reqs]
    t_enc = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    back = [decode_ops(decode_frame(f)[1]) for f in frames]
    t_dec = _time.perf_counter() - t0
    if back != reqs:
        raise AssertionError("wire-bench: OPS tape did not round-trip")
    json_bytes = sum(len(json.dumps(r).encode("utf8")) for r in reqs)
    frame_bytes = sum(len(f) for f in frames)
    row = {"tape": {"n_ops": n_ops, "agents": agents, "seed": seed},
           "ops": {
               "encode_per_sec": round(n_ops / max(t_enc, 1e-9)),
               "decode_per_sec": round(n_ops / max(t_dec, 1e-9)),
               "json_bytes": json_bytes, "frame_bytes": frame_bytes,
               "ratio": round(json_bytes / max(frame_bytes, 1), 2)}}

    # ---- summary frame: replay the tape into an oplog, frame its
    # version summary (what every anti-entropy handshake exchanges)
    ol = OpLog()
    for r in reqs:
        a = ol.get_or_create_agent_id(r["agent"])
        frontier = list(ol.version)
        op = r["ops"][0]
        if op["kind"] == "ins":
            ol.add_insert_at(a, frontier, op["pos"], op["text"])
        else:
            ol.add_delete_at(a, frontier, op["start"], op["end"], None)
    summary = summarize_versions(ol.cg)
    sj = json.dumps(summary).encode("utf8")
    t0 = _time.perf_counter()
    sf = encode_frame(FRAME_SUMMARY, encode_summary(summary),
                      compress=True)
    t_senc = _time.perf_counter() - t0
    if decode_summary(decode_frame(sf)[1]) != summary:
        raise AssertionError("wire-bench: summary did not round-trip")
    row["summary"] = {"agents": len(summary),
                      "json_bytes": len(sj), "frame_bytes": len(sf),
                      "ratio": round(len(sj) / max(len(sf), 1), 2),
                      "encode_s": round(t_senc, 6)}

    # ---- patch frame: the full encode under the lz4 envelope
    patch = encode_oplog(ol, ENCODE_FULL)
    pf = encode_frame(FRAME_PATCH, patch, compress=True)
    row["patch"] = {"raw_bytes": len(patch), "frame_bytes": len(pf),
                    "ratio": round(len(patch) / max(len(pf), 1), 2)}

    # ---- docs listing frame: the steady-state anti-entropy preamble
    listing = {"self": "127.0.0.1:8001", "docs": {
        f"t{d % 4}-doc{d:03d}": {
            "lease": {"holder": f"127.0.0.1:{8001 + d % 3}",
                      "epoch": 1 + d % 5, "state": "active",
                      "ttl_s": 0.9},
            "frontier": [[f"t0s{d % agents}g{d % 7}", d]],
        } for d in range(docs)}}
    lj = json.dumps(listing).encode("utf8")
    lf = encode_frame(FRAME_DOCS, encode_docs(listing), compress=True)
    rt = decode_docs(decode_frame(lf)[1])
    if rt["docs"] != listing["docs"] or rt["self"] != listing["self"]:
        raise AssertionError("wire-bench: docs listing did not "
                             "round-trip")
    row["docs"] = {"n_docs": docs, "json_bytes": len(lj),
                   "frame_bytes": len(lf),
                   "ratio": round(len(lj) / max(len(lf), 1), 2)}
    return row


def cmd_wire_bench(args) -> int:
    """Wire-frame codec micro-benchmark (see wire_bench)."""
    row = wire_bench(seed=args.seed, n_ops=args.ops,
                     agents=args.agents, docs=args.docs)
    print(json.dumps(row, indent=1 if args.json else None))
    return 0


def cmd_dt_lint(args) -> int:
    """Concurrency invariant lint (analysis/): lock-order violations,
    unsorted multi-lock acquisition, device dispatch under the
    global/oplog lock, unfenced doc-state mutation on write paths, and
    jit-purity checks. Exit 0 = clean tree (the tier-1 gate)."""
    from ..analysis import lint as _lint
    report = _lint.run_lint(paths=args.paths or None,
                            disable=args.disable)
    _lint.publish_report(report)
    if args.json:
        print(_lint.render_json(report))
    else:
        print(_lint.render_human(report))
    if args.fail_on == "error":
        return 1 if report["errors"] else 0
    return 0 if report["ok"] else 1


def _render_explore_human(rep: dict) -> str:
    head = (f"dt-explore {rep['scenario']}: depth {rep['depth']} "
            f"states {rep['states']} "
            f"(dedup {rep['dedup_hits']}, sleep {rep['sleep_skips']}) "
            f"{rep['states_per_s']} states/s "
            f"{'complete' if rep['complete'] else 'TRUNCATED'}"
            + (f" mutation={rep['mutation']}" if rep['mutation'] else "")
            + (": OK" if rep["ok"] else ": VIOLATION"))
    lines = [head]
    for v in rep["violations"]:
        lines.append(f"  {v['invariant']}: {v['message']}")
        trace = " -> ".join(
            a["op"] + "(" + ",".join(
                str(a[k]) for k in ("node", "peer", "doc") if k in a)
            + ")" for a in v["minimized_trace"])
        lines.append(f"  minimized trace ({len(v['minimized_trace'])} "
                     f"steps): {trace or '<initial state>'}")
    return "\n".join(lines)


def cmd_dt_explore(args) -> int:
    """Protocol model checker (analysis/explore/): exhaustively
    enumerate scheduler interleavings of the real lease/quorum/fencing
    code to a bounded depth, checking safety invariants at every state.
    Exit 0 = no violation reachable within the bounds (or, with
    --mutate, every seeded protocol mutation detected)."""
    from ..analysis import explore as _explore
    if args.mutate:
        results = []
        ok = True
        for name, m in sorted(_explore.MUTATIONS.items()):
            depth = args.depth if args.depth is not None else m.depth
            rep = _explore.explore(m.scenario, depth=depth,
                                   seed=args.seed,
                                   max_states=args.max_states,
                                   mutation=m)
            v0 = rep["violations"][0] if rep["violations"] else None
            detected = v0 is not None and v0["invariant"] in m.expect
            ok = ok and detected
            results.append({
                "mutation": name, "scenario": m.scenario,
                "depth": depth, "expect": list(m.expect),
                "detected": detected,
                "invariant": v0["invariant"] if v0 else None,
                "minimized_trace": v0["minimized_trace"] if v0 else None,
                "states": rep["states"], "wall_s": rep["wall_s"],
            })
        doc = {"mode": "mutate", "ok": ok,
               "detected": sum(1 for r in results if r["detected"]),
               "total": len(results), "results": results}
        if args.json:
            print(json.dumps(doc, indent=1))
        else:
            for r in results:
                steps = (len(r["minimized_trace"])
                         if r["minimized_trace"] is not None else 0)
                print(f"dt-explore --mutate {r['mutation']} "
                      f"({r['scenario']}, depth {r['depth']}): "
                      + (f"DETECTED {r['invariant']} "
                         f"({steps}-step trace, {r['states']} states)"
                         if r["detected"] else
                         f"MISSED (expected one of {r['expect']})"))
            print(f"dt-explore: {doc['detected']}/{doc['total']} "
                  f"mutations detected: "
                  + ("OK" if ok else "FAILED"))
        return 0 if ok else 1
    names = [args.scenario] if args.scenario \
        else sorted(_explore.SCENARIOS)
    inv = tuple(args.invariant) if args.invariant else None
    reports = []
    ok = True
    for name in names:
        try:
            rep = _explore.explore(
                name, depth=args.depth if args.depth is not None else 4,
                seed=args.seed, max_states=args.max_states,
                invariants=inv)
        except KeyError:
            print(f"dt-explore: unknown scenario {name!r} "
                  f"(have: {', '.join(sorted(_explore.SCENARIOS))})",
                  file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"dt-explore: {e}", file=sys.stderr)
            return 2
        _explore.publish_report(rep)
        reports.append(rep)
        ok = ok and rep["ok"]
        if not args.json:
            print(_render_explore_human(rep))
    if args.json:
        print(json.dumps(
            reports if len(reports) > 1 else reports[0], indent=1))
    return 0 if ok else 1


def cmd_obs_report(args) -> int:
    """One-shot observability report for a running server: scrape
    GET /metrics + GET /debug/events and print a human summary of
    endpoint/flush/handoff latencies, fencing activity and the tail of
    the flight-recorder ring (obs/)."""
    import urllib.request
    base = args.url.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    with urllib.request.urlopen(f"{base}/metrics",
                                timeout=args.timeout) as r:
        doc = json.loads(r.read())
    try:
        with urllib.request.urlopen(f"{base}/debug/events",
                                    timeout=args.timeout) as r:
            events = json.loads(r.read())
    except (OSError, ValueError):
        events = {"events": []}
    if args.json:
        print(json.dumps({"metrics": doc, "events": events}))
        return 0

    def _fmt_hist(name, snap, labels=None):
        lb = " ".join(f"{k}={v}" for k, v in sorted((labels or {})
                                                    .items()))
        print(f"  {name:<28s} {lb:<28s} n={snap.get('count', 0):<7d} "
              f"p50={snap.get('p50', 0) * 1e3:8.3f}ms "
              f"p90={snap.get('p90', 0) * 1e3:8.3f}ms "
              f"p99={snap.get('p99', 0) * 1e3:8.3f}ms "
              f"max={snap.get('max', 0) * 1e3:8.3f}ms")

    obs = doc.get("obs") or {}
    print("== latencies ==")
    for name, rows in sorted((obs.get("http") or {}).items()):
        for row in rows:
            _fmt_hist(name, row, row.get("labels"))
    serve = doc.get("serve") or {}
    for name, snap in sorted((serve.get("latencies") or {}).items()):
        _fmt_hist(f"serve.{name}", snap)
    repl = doc.get("replication") or {}
    for name, snap in sorted((repl.get("latencies") or {}).items()):
        _fmt_hist(f"repl.{name}", snap)

    if repl:
        fencing = repl.get("fencing") or {}
        quorum = repl.get("quorum") or {}
        print("== fencing / quorum ==")
        print("  " + " ".join(f"{k}={v}"
                              for k, v in sorted(fencing.items())))
        print("  " + " ".join(f"{k}={v}"
                              for k, v in sorted(quorum.items())))

    trace = obs.get("trace") or {}
    if trace:
        print("== tracing ==")
        print("  " + " ".join(f"{k}={v}"
                              for k, v in sorted(trace.items())))

    tail = (events.get("events") or [])[-args.events:]
    print(f"== events (last {len(tail)} of "
          f"{events.get('recorded', 0)}) ==")
    for ev in tail:
        rest = {k: v for k, v in ev.items()
                if k not in ("seq", "t", "kind")}
        print(f"  [{ev.get('seq', '?'):>5}] {ev.get('kind', '?'):<24s} "
              + " ".join(f"{k}={v}" for k, v in sorted(rest.items())))
    return 0


def cmd_obs_watch(args) -> int:
    """Live one-screen telemetry loop for a running server: poll
    GET /debug/slo + GET /debug/hot + GET /metrics (JSON) + the
    flight-recorder cursor (GET /debug/events?since=) and render a
    compact rates / burn-rates / hot-docs / new-events report each
    round. ``--rounds`` bounds the loop for scripts and tests;
    the default polls until interrupted."""
    import urllib.request
    base = args.url.rstrip("/")
    if "://" not in base:
        base = "http://" + base

    def _get(path):
        with urllib.request.urlopen(base + path,
                                    timeout=args.timeout) as r:
            return json.loads(r.read())

    since = 0
    rounds_done = 0
    rc = 0
    while True:
        try:
            doc = _get("/metrics")
            slo = _get("/debug/slo")
            hot = _get("/debug/hot")
            events = _get(f"/debug/events?since={since}")
        except (OSError, ValueError) as e:
            print(f"obs-watch: scrape failed: {e}", file=sys.stderr)
            return 1
        try:
            incidents = _get("/debug/incidents")
        except (OSError, ValueError):
            incidents = None    # pre-incident server: panel omitted
        tail = events.get("events") or []
        if tail:
            since = max(ev.get("seq", since) for ev in tail)

        if args.json:
            print(json.dumps({"slo": slo, "hot": hot,
                              "events": tail,
                              "timeseries": (doc.get("obs") or {})
                              .get("timeseries"),
                              "journey": (doc.get("obs") or {})
                              .get("journey"),
                              "devprof": (doc.get("obs") or {})
                              .get("devprof"),
                              "qos": doc.get("qos"),
                              "incidents": incidents,
                              "scenario": (doc.get("obs") or {})
                              .get("scenario")}))
        else:
            ts = (doc.get("obs") or {}).get("timeseries") or {}
            print(f"== obs-watch round {rounds_done + 1} "
                  f"(recorded={ts.get('recorded', 0)}) ==")
            scen = (doc.get("obs") or {}).get("scenario")
            if scen:
                # scenario panel: fed by the workload runner's
                # published snapshot (obs/scorecard.publish_scenario)
                print(f"== scenario {scen.get('name', '?')} ==")
                print(f"  phase={scen.get('phase', '?'):<10s} "
                      f"tick={scen.get('tick', 0)}/"
                      f"{scen.get('ticks', 0)} "
                      f"t={scen.get('virtual_t', 0)}s "
                      f"writes={scen.get('writes', 0)} "
                      f"reads={scen.get('reads', 0)} "
                      f"errors={scen.get('errors', 0)}")
                print(f"  {scen.get('verdict', '')}")
            series = ts.get("series") or {}
            for name, row in sorted(series.items()):
                print(f"  {name:<28s} "
                      f"rate60={row.get('rate_60s', 0):10.2f}/s "
                      f"p50={(row.get('p50_300s') or 0) * 1e3:8.2f}ms "
                      f"p99={(row.get('p99_300s') or 0) * 1e3:8.2f}ms")
            print("== slo ==")
            for o in slo.get("objectives") or []:
                fast = o.get("fast") or {}
                slow = o.get("slow") or {}
                print(f"  {o.get('name', '?'):<24s} "
                      f"{o.get('state', '?'):<8s} "
                      f"burn fast={fast.get('burn', 0):7.2f} "
                      f"slow={slow.get('burn', 0):7.2f} "
                      f"(bad {fast.get('bad', 0)}/{fast.get('total', 0)})")
            qos = doc.get("qos")
            if qos:
                # adaptive-admission panel: per-class effective
                # deadlines + admit/shed/defer counters and the mesh
                # shed gate (the /debug/qos document, inlined here via
                # the /metrics qos block)
                shed = qos.get("shed") or {}
                why = shed.get("mesh_why") or ""
                print(f"== qos (mesh={shed.get('mesh_state', 'ok')}"
                      + (f" {why}" if why else "")
                      + (" hot=" + ",".join(shed.get("hot_tenants"))
                         if shed.get("hot_tenants") else "") + ") ==")
                for cls, row in sorted((qos.get("classes") or {})
                                       .items()):
                    dl_ms = row.get("deadline_s", 0) * 1e3
                    print(f"  {cls:<14s} deadline={dl_ms:8.2f}ms "
                          f"admitted={row.get('admitted', 0):<8d} "
                          f"shed={row.get('shed', 0):<6d} "
                          f"deferred={row.get('deferred', 0)}")
                ctl = qos.get("controller") or {}
                print("  ctl " + " ".join(
                    f"{k}={ctl.get(k, 0)}"
                    for k in ("steps", "stretched", "shrunk", "held",
                              "floors", "ceilings")))
            if incidents is not None:
                # incident panel: open bundles by kind + the newest
                # bundle id (fetch the full bundle with dt-incidents)
                by_kind = incidents.get("by_kind") or {}
                kinds = " ".join(f"{k}={v}"
                                 for k, v in sorted(by_kind.items())
                                 if v)
                print(f"== incidents (open={incidents.get('open', 0)} "
                      f"total={incidents.get('total', 0)}"
                      + (f" last={incidents.get('last_id')}"
                         if incidents.get("last_id") else "")
                      + ") ==")
                if kinds:
                    print(f"  {kinds}")
                for row in (incidents.get("incidents") or [])[:5]:
                    mark = " " if row.get("acknowledged") else "!"
                    print(f"  [{mark}] {row.get('id', '?'):<16s} "
                          f"{row.get('kind', '?'):<12s} "
                          f"{row.get('series', '?')}")
            print("== hot docs ==")
            for kind, block in sorted((hot.get("doc") or {}).items()):
                tops = (block.get("top") or [])[:args.top]
                if not tops:
                    continue
                row = " ".join(f"{k}={c:.0f}" for k, c, _e in tops)
                print(f"  {kind:<14s} {row}")
            jo = (doc.get("obs") or {}).get("journey") or {}
            if jo.get("enabled"):
                print(f"== convergence (tracked={jo.get('tracked', 0)} "
                      f"dropped={jo.get('dropped', 0)}) ==")
                stages = jo.get("stages") or {}
                print("  " + " ".join(f"{s}={c}"
                                      for s, c in stages.items()))
                for peer, row in sorted(
                        (jo.get("convergence") or {}).items()):
                    print(f"  lag {peer:<22s} n={row.get('n', 0):<6d} "
                          f"mean={row.get('mean_s', 0) * 1e3:8.2f}ms "
                          f"max={row.get('max_s', 0) * 1e3:8.2f}ms")
            print(f"== events (+{len(tail)} new, cursor {since}) ==")
            for ev in tail[-args.events:]:
                rest = {k: v for k, v in ev.items()
                        if k not in ("seq", "t", "kind")}
                print(f"  [{ev.get('seq', '?'):>5}] "
                      f"{ev.get('kind', '?'):<24s} "
                      + " ".join(f"{k}={v}"
                                 for k, v in sorted(rest.items())))
        if not slo.get("ok", True):
            rc = 1
        if incidents is not None and incidents.get("open", 0) > 0:
            rc = 1    # an unacknowledged incident is an alert
        rounds_done += 1
        if args.rounds and rounds_done >= args.rounds:
            return rc
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return rc


def cmd_dt_trace(args) -> int:
    """Assemble one (or more) cross-host traces: fan out over
    ``--peers``, fetch each host's local spans for the trace id
    (GET /debug/trace/<id>), estimate per-host clock offsets from the
    request round trip, and merge everything into a single waterfall
    + critical path (obs/assemble.py). With no trace ids, list the
    primary host's recent sampled traces (GET /debug/traces)."""
    import urllib.request
    from ..obs.assemble import aggregate, assemble_trace, render_human
    hosts = [args.url] + [h for h in
                          (args.peers.split(",") if args.peers else [])
                          if h.strip()]
    bases = []
    for h in hosts:
        h = h.strip().rstrip("/")
        if "://" not in h:
            h = "http://" + h
        if h not in bases:
            bases.append(h)

    def _get(base, path):
        t_send = time.monotonic()
        with urllib.request.urlopen(base + path,
                                    timeout=args.timeout) as r:
            body = json.loads(r.read())
        return body, t_send, time.monotonic()

    if not args.trace_ids:
        try:
            body, _ts, _tr = _get(bases[0], "/debug/traces")
        except (OSError, ValueError) as e:
            print(f"dt-trace: index fetch failed: {e}", file=sys.stderr)
            return 1
        rows = body.get("traces") or []
        if args.json:
            print(json.dumps(body))
        else:
            print(f"== recent traces on {body.get('host', bases[0])} "
                  f"({len(rows)}) ==")
            for row in rows:
                print(f"  {row.get('trace', '?'):<18s} "
                      f"{row.get('root', '?'):<24s} "
                      f"{(row.get('dur_s') or 0) * 1e3:9.2f}ms "
                      f"spans={row.get('spans', 0)}")
        return 0

    reports = []
    rc = 0
    for tid in args.trace_ids:
        fetches = []
        for base in bases:
            try:
                body, t_send, t_recv = _get(base,
                                            f"/debug/trace/{tid}")
            except (OSError, ValueError) as e:
                # a down peer degrades the assembly (its spans go
                # missing / orphaned), it must not kill the command
                print(f"dt-trace: {base} fetch failed: {e}",
                      file=sys.stderr)
                continue
            fetches.append({"host": body.get("host", base),
                            "now": body.get("now"),
                            "spans": body.get("spans") or [],
                            "t_send": t_send, "t_recv": t_recv})
        rep = assemble_trace(tid, fetches)
        reports.append(rep)
        if rep.get("root") is None:
            rc = 1
    agg = aggregate(reports) if len(reports) > 1 else None
    if args.json:
        out = {"traces": reports}
        if agg is not None:
            out["aggregate"] = agg
        print(json.dumps(out))
    else:
        for i, rep in enumerate(reports):
            print(render_human(rep, agg if i == len(reports) - 1
                               else None))
    return rc


def cmd_dt_incidents(args) -> int:
    """Incident-bundle browser with dt-trace's peer fan-out. With no
    ids: list every host's incident index (`--tail` instead follows
    the indexes and prints bundles as they open). With ids: fetch each
    bundle from whichever host holds it (GET /debug/incidents/<id>)
    and print the evidence — recorder tail, SLO burn rates, hot docs,
    convergence lag, trace ids. rc=1 when a requested id resolves on
    no host."""
    import urllib.error
    import urllib.request
    hosts = [args.url] + [h for h in
                          (args.peers.split(",") if args.peers else [])
                          if h.strip()]
    bases = []
    for h in hosts:
        h = h.strip().rstrip("/")
        if "://" not in h:
            h = "http://" + h
        if h not in bases:
            bases.append(h)

    def _get(base, path):
        with urllib.request.urlopen(base + path,
                                    timeout=args.timeout) as r:
            return json.loads(r.read())

    def _indexes():
        out = []
        for base in bases:
            try:
                out.append((base, _get(base, "/debug/incidents")))
            except (OSError, ValueError) as e:
                # a down peer degrades the listing, never kills it
                print(f"dt-incidents: {base} fetch failed: {e}",
                      file=sys.stderr)
        return out

    def _print_index(base, idx):
        print(f"== incidents on {idx.get('host', base)} "
              f"(open={idx.get('open', 0)} "
              f"total={idx.get('total', 0)}) ==")
        for row in idx.get("incidents") or []:
            mark = " " if row.get("acknowledged") else "!"
            print(f"  [{mark}] {row.get('id', '?'):<16s} "
                  f"{row.get('kind', '?'):<12s} "
                  f"{row.get('series', '?'):<32s} "
                  f"t={row.get('t', 0):.1f}")

    if args.tail:
        # follow mode: poll every index and print bundles newly opened
        # since the previous round (per-host seen-id cursor)
        seen = {}
        rounds_done = 0
        while True:
            for base, idx in _indexes():
                known = seen.setdefault(base, set())
                for row in reversed(idx.get("incidents") or []):
                    if row["id"] in known:
                        continue
                    known.add(row["id"])
                    if args.json:
                        print(json.dumps({"host": idx.get("host", base),
                                          **row}))
                    else:
                        print(f"{idx.get('host', base)}  "
                              f"{row.get('id', '?'):<16s} "
                              f"{row.get('kind', '?'):<12s} "
                              f"{row.get('series', '?')}")
            rounds_done += 1
            if args.rounds and rounds_done >= args.rounds:
                return 0
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0

    if not args.incident_ids:
        idxs = _indexes()
        if args.json:
            print(json.dumps({"hosts": [dict(idx, base=base)
                                        for base, idx in idxs]}))
        else:
            for base, idx in idxs:
                _print_index(base, idx)
        return 0 if idxs else 1

    rc = 0
    for iid in args.incident_ids:
        bundle, src = None, None
        for base in bases:
            try:
                bundle = _get(base, f"/debug/incidents/{iid}")
                src = base
                break
            except urllib.error.HTTPError as e:
                e.close()    # 404 here just means "not this host"
            except (OSError, ValueError) as e:
                print(f"dt-incidents: {base} fetch failed: {e}",
                      file=sys.stderr)
        if bundle is None:
            print(f"dt-incidents: {iid} not found on any host",
                  file=sys.stderr)
            rc = 1
            continue
        if args.json:
            print(json.dumps({"host": src, **bundle}))
            continue
        print(f"== {bundle.get('id')} {bundle.get('kind')} "
              f"series={bundle.get('series')} (from {src}) ==")
        print("  detail: " + json.dumps(bundle.get("detail") or {}))
        ctx = bundle.get("context")
        if ctx:
            print("  context: " + json.dumps(ctx))
        for row in bundle.get("slo") or []:
            print(f"  slo {row.get('name', '?'):<24s} "
                  f"{row.get('state', '?'):<8s} "
                  f"fast={row.get('fast_burn', 0):.2f} "
                  f"slow={row.get('slow_burn', 0):.2f}")
        lag = bundle.get("convergence_lag") or {}
        for peer, row in sorted(lag.items()):
            print(f"  lag {peer:<22s} n={row.get('n', 0)} "
                  f"max={row.get('max_s', 0) * 1e3:.1f}ms")
        traces = [t for t in bundle.get("traces") or [] if t]
        if traces:
            print("  traces: " + " ".join(traces)
                  + "   (assemble with dt-trace)")
        tail = bundle.get("recorder_tail") or []
        print(f"  recorder tail ({len(tail)} events):")
        for ev in tail[-args.events:]:
            rest = {k: v for k, v in ev.items()
                    if k not in ("seq", "t", "kind")}
            print(f"    [{ev.get('seq', '?'):>5}] "
                  f"{ev.get('kind', '?'):<24s} "
                  + " ".join(f"{k}={v}"
                             for k, v in sorted(rest.items())))
    return rc


def cmd_scenario(args) -> int:
    """Declarative workload harness (workload/): `scenario list`
    prints the registry; `scenario run --name X` drives the scenario
    through serve+replicate+read against the live SLO engine and
    emits its versioned scorecard (exit 0 iff the run converged with
    SLOs intact and zero transport errors)."""
    from ..workload import SCENARIOS, get_scenario, run_scenario
    if args.action == "list":
        for name in sorted(SCENARIOS):
            sc = SCENARIOS[name]
            mark = " [slow]" if sc.slow else ""
            print(f"{name:<16s}{mark:>7s}  {sc.description}")
        return 0
    if args.resume:
        # the scenario (and its qos/incident toggles) ride inside the
        # checkpoint; --name is neither needed nor honored
        card = run_scenario(None, resume_dir=args.resume,
                            data_dir=args.data_dir,
                            progress=args.progress,
                            stop_after_ticks=args.stop_after_ticks,
                            device=args.device)
    else:
        if not args.name:
            print("scenario run: --name is required "
                  "(see `scenario list`)", file=sys.stderr)
            return 2
        try:
            sc = get_scenario(args.name)
        except ValueError as e:
            print(f"scenario: {e}", file=sys.stderr)
            return 2
        if args.seed is not None:
            import dataclasses
            sc = dataclasses.replace(sc, seed=args.seed)
        card = run_scenario(sc, data_dir=args.data_dir,
                            progress=args.progress, qos=args.qos,
                            incidents=args.incidents,
                            checkpoint_every_s=args.checkpoint_every,
                            stop_after_ticks=args.stop_after_ticks,
                            device=args.device)
    print(json.dumps(card, indent=1 if args.json else None))
    if card.get("aborted"):
        # deliberate mid-run kill (--stop-after-ticks): the checkpoint
        # under resume_dir is the product, not a failure
        return 0
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(card, indent=1) + "\n")
    return 0 if card["ok"] else 1


def cmd_scorecard_diff(args) -> int:
    """Compare two scenario scorecards metric-by-metric against the
    per-metric tolerance bands (obs/scorecard.py). Always prints the
    diff; with --gate the exit code is non-zero iff any gated metric
    moved in its bad direction past its band — the one-diff
    regression check BASELINE.md scenario rows hang off."""
    from ..obs.scorecard import diff_scorecards, render_diff
    with open(args.old) as f:
        old = json.load(f)
    with open(args.new) as f:
        new = json.load(f)
    diff = diff_scorecards(old, new)
    print(json.dumps(diff) if args.json else render_diff(diff))
    if args.gate and not diff["ok"]:
        return 1
    return 0


DEVICE_HELP = ("torch device the schedulers merge on (default: CUDA, "
               "which must exist; 'cpu' runs the kernels' plain "
               "versions)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dt-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create", help="create a new .dt file")
    c.add_argument("filename")
    c.add_argument("--content")
    c.add_argument("--agent")
    c.add_argument("-f", "--force", action="store_true")
    c.set_defaults(fn=cmd_create)

    c = sub.add_parser("cat", help="print the document contents")
    c.add_argument("filename")
    c.add_argument("-o", "--output")
    c.add_argument("--version", help="JSON list of LVs to check out at")
    c.set_defaults(fn=cmd_cat)

    c = sub.add_parser("log", help="print the operation log")
    c.add_argument("filename")
    c.add_argument("--transformed", action="store_true")
    c.add_argument("--history", action="store_true")
    c.set_defaults(fn=cmd_log)

    c = sub.add_parser("version", help="print the current remote version")
    c.add_argument("filename")
    c.set_defaults(fn=cmd_version)

    c = sub.add_parser("set", help="set contents (reads stdin by default)")
    c.add_argument("filename")
    c.add_argument("--content")
    c.add_argument("--agent")
    c.set_defaults(fn=cmd_set)

    c = sub.add_parser("repack", help="re-encode the file compactly")
    c.add_argument("filename")
    c.set_defaults(fn=cmd_repack)

    c = sub.add_parser("export", help="cross-CRDT benchmark JSON export")
    c.add_argument("filename")
    c.set_defaults(fn=cmd_export)

    c = sub.add_parser("dot", help="graphviz export of the causal graph")
    c.add_argument("filename")
    c.set_defaults(fn=cmd_dot)

    c = sub.add_parser("git-import", help="replay a file's git history")
    c.add_argument("path", help="file path within the repo")
    c.add_argument("--repo", help="git repo root (default .)")
    c.add_argument("--out", required=True, help="output .dt file")
    c.set_defaults(fn=cmd_git_import)

    c = sub.add_parser(
        "serve-bench",
        help="replay a workload through the sharded merge scheduler")
    c.add_argument("--shards", type=int, default=4)
    c.add_argument("--docs", type=int, default=8)
    c.add_argument("--txns", type=int, default=None,
                   help="rounds to replay (default: whole corpus)")
    c.add_argument("--engine", choices=("device", "host"),
                   default="device")
    c.add_argument("--mode", choices=("trace", "concurrent", "flash"),
                   default="trace",
                   help="flash = flash-crowd tape whose per-window op "
                   "bursts thrash the shape classes")
    c.add_argument("--corpus", help="crdt-testdata JSON trace file "
                   "(default: synthetic trace)")
    c.add_argument("--flush-docs", type=int, default=4)
    c.add_argument("--flush-deadline", type=float, default=0.02)
    c.add_argument("--max-pending", type=int, default=64)
    c.add_argument("--max-sessions", type=int, default=4)
    c.add_argument("--seed", type=int, default=7)
    c.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fused vmapped bucket flush (--no-fused = the "
                   "serial per-doc zone-session path, for speedup "
                   "comparisons)")
    c.add_argument("--workers", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="per-shard flush worker threads "
                   "(--no-workers = inline serial pump)")
    c.add_argument("--mesh-window",
                   action=argparse.BooleanOptionalAction,
                   default=False,
                   help="flush windows: every due shard's bucket in one "
                   "K1 launch per shape class and device, and one K2 "
                   "resolve per device (default: one call per shard)")
    c.add_argument("--device-plan",
                   action=argparse.BooleanOptionalAction,
                   default=False,
                   help="device-resident tail transform: resolve "
                   "concurrent merge positions on device with K2 "
                   "(gpu/xform.py) instead of the host tracker walk; "
                   "per-doc host fallback on any guard trip")
    c.add_argument("--pallas",
                   action=argparse.BooleanOptionalAction,
                   default=False,
                   help="accepted for the JAX package's command line "
                   "and changes nothing: the top rung of the port's "
                   "flush ladder is always the K1 kernel")
    c.add_argument("--steer",
                   action=argparse.BooleanOptionalAction,
                   default=True,
                   help="accepted for the JAX package's command line "
                   "and changes nothing: K1 launches at the pow2 shape "
                   "class")
    c.add_argument("--device-stage",
                   action=argparse.BooleanOptionalAction,
                   default=True,
                   help="accepted for the JAX package's command line "
                   "and changes nothing: the flush window gathers its "
                   "rows on the device")
    c.add_argument("--warmup", action="store_true",
                   help="launch K1 once per warm-up shape class before "
                   "feeding")
    c.add_argument("--steady-rounds", type=int, default=0,
                   help="extra lockstep rounds against resident "
                   "sessions after the continuous feed — the fused "
                   "occupancy measurement (see serve/driver.py)")
    c.add_argument("--telemetry",
                   action=argparse.BooleanOptionalAction,
                   default=True,
                   help="live windowed telemetry + SLO burn-rate "
                   "engine (--no-telemetry = the overhead-A/B "
                   "control arm; SLO verdict then trivially passes)")
    c.add_argument("--journey",
                   action=argparse.BooleanOptionalAction,
                   default=True,
                   help="edit-to-visibility journey stamps "
                   "(obs/journey.py; --no-journey = the overhead-A/B "
                   "control arm)")
    c.add_argument("--parity", action="store_true",
                   help="explicit parity gate (parity is always "
                   "checked; this just documents the intent in CI "
                   "invocations)")
    c.add_argument("--json", action="store_true",
                   help="print the full JSON report")
    c.add_argument("--metrics-out", help="write the JSON report here")
    c.add_argument("--dry-run", action="store_true",
                   help="tiny host-engine smoke preset on the CPU (CI)")
    c.add_argument("--real-device", action="store_true",
                   help="accepted for the JAX package's command line "
                   "and changes nothing: the card is the default")
    c.add_argument("--device", default=None,
                   help=DEVICE_HELP)
    c.set_defaults(fn=cmd_serve_bench)

    c = sub.add_parser(
        "replicate-soak",
        help="fault-injected N-server replication convergence soak")
    c.add_argument("--servers", type=int, default=3)
    c.add_argument("--docs", type=int, default=4)
    c.add_argument("--rounds", type=int, default=20)
    c.add_argument("--edits-per-round", type=int, default=4)
    c.add_argument("--seed", type=int, default=7)
    c.add_argument("--drop-rate", type=float, default=0.15)
    c.add_argument("--dup-rate", type=float, default=0.05)
    c.add_argument("--partition-rounds", type=int, default=6,
                   help="rounds the server0<->server1 link stays cut")
    c.add_argument("--reconcile-rounds", type=int, default=12)
    c.add_argument("--lease-ttl", type=float, default=1.0)
    c.add_argument("--serve-shards", type=int, default=0,
                   help="attach the device-engine merge scheduler with "
                   "N shards on every server (ownership-gated)")
    c.add_argument("--crash", action="store_true",
                   help="crash-restart two nodes mid-run (journal "
                   "recovery + rejoining fence)")
    c.add_argument("--asym", action="store_true",
                   help="one-way partitions + jittered slow link + "
                   "clock skew")
    c.add_argument("--churn", action="store_true",
                   help="join an extra node mid-run, then leave it")
    c.add_argument("--witness", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="runtime lock witness during the soak: record "
                   "held-while-acquiring edges and gate on an acyclic "
                   "lock-order graph (default: on for --crash/--churn "
                   "chaos runs)")
    c.add_argument("--device", default=None, help=DEVICE_HELP)
    c.add_argument("--progress", action="store_true")
    c.add_argument("--json", action="store_true")
    c.add_argument("--metrics-out")
    c.set_defaults(fn=cmd_replicate_soak)

    c = sub.add_parser(
        "rebalance-soak",
        help="flash-crowd elastic-mesh soak: SLO-driven hot-doc "
        "rebalancing with mid-run scale-out, seeded migration abort, "
        "and zero-split-brain / convergence gates")
    c.add_argument("--servers", type=int, default=3)
    c.add_argument("--docs", type=int, default=8)
    c.add_argument("--seed", type=int, default=7)
    c.add_argument("--capacity", type=int, default=5,
                   help="held-lease count a host serves without "
                   "latency penalty in the soak's load model")
    c.add_argument("--crowd-boost", type=int, default=3,
                   help="extra load the flash crowd puts on whichever "
                   "host currently owns the hot doc")
    c.add_argument("--flash-crowd", action="store_true",
                   help="run the full acceptance journey: ok -> "
                   "burning -> rebalance -> ok (without it only the "
                   "healthy phase runs)")
    c.add_argument("--join", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="join a fresh host on the first non-ok SLO "
                   "evaluation and require it to absorb load")
    c.add_argument("--inject-abort",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="aim one migration at an unreachable target "
                   "and require a clean rollback")
    c.add_argument("--split-hot-doc", action="store_true",
                   help="writer-group arm: promote the hot doc to a "
                   "2-writer group (>= 2x write admission), then "
                   "member-crash and asymmetric-partition demotions "
                   "must drain back to one writer with zero "
                   "acked-loss / split-brain")
    c.add_argument("--device", default=None, help=DEVICE_HELP)
    c.add_argument("--progress", action="store_true")
    c.add_argument("--json", action="store_true")
    c.add_argument("--metrics-out")
    c.set_defaults(fn=cmd_rebalance_soak)

    c = sub.add_parser(
        "storage-soak",
        help="fault-injected tiered-residency soak: churn docs "
        "through an undersized warm tier and gate on byte-identical "
        "re-hydration")
    c.add_argument("--docs", type=int, default=120)
    c.add_argument("--warm", type=int, default=12,
                   help="warm-tier capacity (deliberately << --docs: "
                   "eviction pressure is the point)")
    c.add_argument("--rounds", type=int, default=8)
    c.add_argument("--edits-per-round", type=int, default=48)
    c.add_argument("--shards", type=int, default=2)
    c.add_argument("--seed", type=int, default=7)
    c.add_argument("--compact-every", type=int, default=16,
                   help="per-doc WAL patch records before a baseline "
                   "fold (low = many compactions under churn)")
    c.add_argument("--churn", action="store_true",
                   help="force extra evictions-to-snapshot every round "
                   "beyond what warm-tier pressure already causes")
    c.add_argument("--crash", action="store_true",
                   help="inject crash-restart, crash-mid-compaction "
                   "(every fsync point), torn tails and wholesale "
                   "corruption")
    c.add_argument("--slow", action="store_true",
                   help="seeded slow-disk delays on load (exercises "
                   "the per-attempt timeout / retry ladder)")
    c.add_argument("--data-dir",
                   help="home directory for the doc snapshot files "
                   "(default: a fresh temp dir, removed afterwards)")
    c.add_argument("--p99-budget", type=float, default=0.5,
                   help="cold-start p99 gate in seconds")
    c.add_argument("--progress", action="store_true")
    c.add_argument("--json", action="store_true")
    c.add_argument("--metrics-out")
    c.set_defaults(fn=cmd_storage_soak)

    c = sub.add_parser(
        "read-bench",
        help="two-server follower-read A/B bench: bounded-staleness "
        "local reads vs owner-only proxying, with client-side "
        "staleness + read-your-writes verification")
    c.add_argument("--docs", type=int, default=3)
    c.add_argument("--readers", type=int, default=6)
    c.add_argument("--reads-per-reader", type=int, default=120)
    c.add_argument("--seed", type=int, default=7)
    c.add_argument("--zipf-s", type=float, default=1.2,
                   help="Zipf skew of the reader doc distribution")
    c.add_argument("--max-staleness", type=float, default=2.0,
                   help="staleness bound (seconds) the follower phase "
                   "requests on every read")
    c.add_argument("--min-version-every", type=int, default=4,
                   help="send the doc's latest write token as "
                   "X-DT-Min-Version on every Nth read (0 = never)")
    c.add_argument("--lease-ttl", type=float, default=30.0)
    c.add_argument("--serve-shards", type=int, default=1,
                   help="attach the device-engine merge scheduler with "
                   "N shards on both servers (leases activate through "
                   "its admit gate, so the bench needs at least 1)")
    c.add_argument("--doc-bytes", type=int, default=16384,
                   help="approximate seeded checkout size per doc")
    c.add_argument("--min-speedup", type=float, default=None,
                   help="fail unless follower/control aggregate read "
                   "throughput clears this ratio")
    c.add_argument("--device", default=None, help=DEVICE_HELP)
    c.add_argument("--progress", action="store_true")
    c.add_argument("--json", action="store_true")
    c.add_argument("--metrics-out")
    c.set_defaults(fn=cmd_read_bench)

    c = sub.add_parser(
        "wire-bench",
        help="wire-frame codec micro-benchmark: churn op tape through "
        "each frame codec vs its JSON twin (throughput + wire-byte "
        "ratios; the row bench.py ingests)")
    c.add_argument("--seed", type=int, default=7)
    c.add_argument("--ops", type=int, default=2000,
                   help="length of the churn op tape")
    c.add_argument("--agents", type=int, default=8,
                   help="concurrently-churning agent names")
    c.add_argument("--docs", type=int, default=64,
                   help="doc count for the listing-frame measurement")
    c.add_argument("--json", action="store_true",
                   help="pretty-print the row")
    c.set_defaults(fn=cmd_wire_bench)

    c = sub.add_parser(
        "dt-lint",
        help="concurrency invariant lint: lock order, device dispatch "
        "under the global/oplog lock, fencing, jit purity")
    c.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the repo's "
                   "concurrency-bearing packages)")
    c.add_argument("--fail-on", choices=("warn", "error"),
                   default="warn",
                   help="exit nonzero on any violation (warn, the "
                   "default) or only on severity=error findings")
    c.add_argument("--disable", action="append", default=[],
                   metavar="RULE",
                   help="disable a rule by name (repeatable)")
    c.add_argument("--json", action="store_true",
                   help="print the full JSON report")
    c.set_defaults(fn=cmd_dt_lint)

    c = sub.add_parser(
        "dt-explore",
        help="protocol model checker: exhaustively explore scheduler "
        "interleavings of the real lease/quorum/fencing code and check "
        "safety invariants at every state")
    c.add_argument("--scenario",
                   help="explore one scenario by name — handoff, "
                   "crash-recovery, renewal, tiebreak, migration, "
                   "writer-group (default: all)")
    c.add_argument("--depth", type=int, default=None,
                   help="interleaving depth bound (default 4; under "
                   "--mutate each mutation's own catch depth)")
    c.add_argument("--seed", type=int, default=0,
                   help="tie-break seed for the action visit order")
    c.add_argument("--invariant", action="append", default=[],
                   metavar="NAME",
                   help="check only this invariant (repeatable; "
                   "default: the scenario's full set)")
    c.add_argument("--max-states", type=int, default=200_000,
                   help="state-count safety valve; exceeding it marks "
                   "the run incomplete")
    c.add_argument("--mutate", action="store_true",
                   help="adequacy harness: apply each seeded protocol "
                   "mutation and require the explorer to catch it; "
                   "exit 0 only if every mutation is detected")
    c.add_argument("--json", action="store_true",
                   help="print the full JSON report(s)")
    c.set_defaults(fn=cmd_dt_explore)

    c = sub.add_parser(
        "obs-report",
        help="scrape a server's /metrics + /debug/events and print a "
        "human latency / fencing / flight-recorder summary")
    c.add_argument("url", help="server base URL (host:port is enough)")
    c.add_argument("--events", type=int, default=20,
                   help="flight-recorder tail length to print")
    c.add_argument("--timeout", type=float, default=5.0)
    c.add_argument("--json", action="store_true",
                   help="print the raw scraped JSON instead")
    c.set_defaults(fn=cmd_obs_report)

    c = sub.add_parser(
        "obs-watch",
        help="live telemetry loop: poll /debug/slo + /debug/hot + "
        "/metrics + the flight-recorder cursor and render a compact "
        "rates / burn-rates / hot-docs report each round")
    c.add_argument("url", help="server base URL (host:port is enough)")
    c.add_argument("--interval", type=float, default=2.0,
                   help="seconds between polls")
    c.add_argument("--rounds", type=int, default=0,
                   help="stop after N polls (0 = until interrupted)")
    c.add_argument("--top", type=int, default=5,
                   help="hot-doc keys to show per kind")
    c.add_argument("--events", type=int, default=10,
                   help="new flight-recorder events to print per round")
    c.add_argument("--timeout", type=float, default=5.0)
    c.add_argument("--json", action="store_true",
                   help="one JSON line per round instead")
    c.set_defaults(fn=cmd_obs_watch)

    c = sub.add_parser(
        "dt-trace",
        help="cross-host trace assembly: fetch one trace's spans from "
        "every peer, align clocks off the request RTT, and print the "
        "merged waterfall + critical path")
    c.add_argument("url", help="primary server base URL")
    c.add_argument("trace_ids", nargs="*",
                   help="trace ids to assemble (none: list the "
                   "primary host's recent sampled traces)")
    c.add_argument("--peers", default="",
                   help="comma-separated peer base URLs to include "
                   "in the fan-out")
    c.add_argument("--timeout", type=float, default=5.0)
    c.add_argument("--json", action="store_true",
                   help="print the assembled report(s) as JSON")
    c.set_defaults(fn=cmd_dt_trace)

    c = sub.add_parser(
        "scenario",
        help="declarative workload harness: run a registered scenario "
        "(serve+replicate+read against the live SLO engine) and emit "
        "its versioned scorecard, or list the registry")
    c.add_argument("action", choices=("run", "list"))
    c.add_argument("--name",
                   help="registered scenario name (see `scenario list`)")
    c.add_argument("--seed", type=int, default=None,
                   help="override the scenario's registered seed")
    c.add_argument("--out",
                   help="also write the scorecard JSON to this file")
    c.add_argument("--data-dir",
                   help="bank-lane home directory (default: a fresh "
                   "temp dir, removed afterwards)")
    c.add_argument("--progress", action="store_true")
    c.add_argument("--qos", dest="qos", action="store_true",
                   default=True,
                   help="attach the adaptive-admission QoS controller "
                   "to every scenario server (default)")
    c.add_argument("--no-qos", dest="qos", action="store_false",
                   help="static admission — the A/B control arm for "
                   "scorecard-diff against an adaptive run")
    c.add_argument("--incidents", dest="incidents",
                   action="store_true", default=True,
                   help="arm the incident engine's anomaly detector "
                   "on every scenario server (default)")
    c.add_argument("--no-incidents", dest="incidents",
                   action="store_false",
                   help="detector off — the overhead A/B control arm")
    c.add_argument("--checkpoint-every", type=float, default=0.0,
                   metavar="VIRT_S",
                   help="long-run mode: persist a runner-state "
                   "checkpoint (tape cursor, session frontiers, rng, "
                   "incident index) every N virtual seconds under a "
                   "kept run dir; resume with --resume")
    c.add_argument("--resume", default=None, metavar="DIR",
                   help="resume a checkpointed run: reboot the "
                   "servers on their journaled dirs and replay the "
                   "tape from the cursor (the scenario rides inside "
                   "the checkpoint)")
    c.add_argument("--stop-after-ticks", type=int, default=None,
                   metavar="N",
                   help="force-checkpoint after tick N and tear the "
                   "mesh down crash-style (the scripted mid-run kill "
                   "for soak drills; exit 0 with an aborted marker)")
    c.add_argument("--device", default=None, help=DEVICE_HELP)
    c.add_argument("--json", action="store_true",
                   help="pretty-print the scorecard")
    c.set_defaults(fn=cmd_scenario)

    c = sub.add_parser(
        "dt-incidents",
        help="incident-bundle browser: list every host's auto-captured "
        "incident index, show full evidence bundles by id, or --tail "
        "new bundles as they open (peer fan-out like dt-trace)")
    c.add_argument("url", help="primary server base URL")
    c.add_argument("incident_ids", nargs="*",
                   help="bundle ids to show (none: list the indexes)")
    c.add_argument("--peers", default="",
                   help="comma-separated peer base URLs to include "
                   "in the fan-out")
    c.add_argument("--tail", action="store_true",
                   help="follow mode: poll the indexes and print "
                   "bundles as they open")
    c.add_argument("--interval", type=float, default=2.0,
                   help="seconds between --tail polls")
    c.add_argument("--rounds", type=int, default=0,
                   help="stop --tail after N polls (0 = until "
                   "interrupted)")
    c.add_argument("--events", type=int, default=15,
                   help="recorder-tail events to print per bundle")
    c.add_argument("--timeout", type=float, default=5.0)
    c.add_argument("--json", action="store_true",
                   help="print bundles/indexes as JSON")
    c.set_defaults(fn=cmd_dt_incidents)

    c = sub.add_parser(
        "scorecard-diff",
        help="compare two scenario scorecards against per-metric "
        "tolerance bands; --gate exits non-zero on regression")
    c.add_argument("old", help="baseline scorecard JSON file")
    c.add_argument("new", help="candidate scorecard JSON file")
    c.add_argument("--gate", action="store_true",
                   help="exit non-zero when any gated metric moved in "
                   "its bad direction past its tolerance band")
    c.add_argument("--json", action="store_true",
                   help="print the diff as JSON")
    c.set_defaults(fn=cmd_scorecard_diff)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
