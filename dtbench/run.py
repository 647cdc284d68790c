"""Run one cell of the benchmark once and print its result line.

    python3 -m dtbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration (`dtbench/configs/<config>.json`), its traffic
mix (`dtbench/traffic/<traffic>.json`) and its metrics' readers
(`dtbench/metrics/<metric>.py`) are all found by name from the manifest,
`BENCHMARK.json` at the repository's root; the configuration names its
tier (`dtbench/tiers/<tier>.py`), the mix its edit shape and arrivals
(`dtbench/traffic/edits/`, `dtbench/traffic/arrivals/`). The run:

  1. set-up (`setup_s`): the kernels and the native library built (only the
     first run in a checkout compiles), the documents and every sync the
     window will send generated from the seed, the tier built, one warm
     sync a document that builds its session, one sync a client of the mix;
  2. the window: the mix's clients for `--seconds` (with --trace 1 under
     torch.profiler's device activity and the host sampler);
  3. the drain: every sync sent or due in the window waited for, a minute
     at most; the peak of device memory read; the texts of a sample of
     documents read from their sessions on the card; the tier stopped;
  4. the check: each sampled document's text against the plain reference
     (`dtbench/reference/listcrdt.py`) over the benchmark's own record of
     its syncs, and every resident session caught up with its op log.

The last line on standard output is the result; the compared numbers and
their limits are the last lines on standard error and the result's last
key, "checks".
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "dtbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "diamond_types_tpu")
DRAIN_S = 60.0          # a sync late by more than this never committed
SETUP_TIMEOUT_S = 600.0


def load_cell(name: str, manifest: Optional[dict] = None):
    """(manifest, cell, configuration, mix) for the cell called `name`."""
    if manifest is None:
        manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json")
                        .read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return manifest, cell, config, mix


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: the end-to-end ones (--trace 0)
    or the per-layer ones (--trace 1) that name the cell or name none."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def build_program(device) -> None:
    """The port's CUDA kernels and native library, built into its own
    `_build/` inside this checkout if they are not there yet."""
    from diamond_types_tpu_torch.native import build as native_build
    native_build.build()
    if device.type == "cuda":
        from diamond_types_tpu_torch.gpu import kernels
        kernels.build()


def run_cell(cell: dict, config: dict, mix: dict, metric_specs: list,
             seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, control: Optional[str] = None,
             doc_texts=None, controls=()) -> dict:
    """One run of one cell on `device`; returns the result line's object.

    `control` puts a deliberately broken merge (listcrdt.CONTROLS) in the
    program's place at the check. `controls` are merged beside the check,
    on the same sample, and their mismatches noted (`notes.controls`).
    `doc_texts(tier, doc_ids) -> {doc: text}` replaces how the program's
    texts are read (tests plant faults so)."""
    import torch

    from dtbench import metrics, plugins
    from dtbench.reference.listcrdt import merged_text
    from dtbench.traffic.clients import Clients
    from dtbench.traffic.generate import make_docs

    device = torch.device(device)
    build_program(device)
    n_docs = mix["docs"].get("count", config["live_docs"])
    gens = make_docs(seed, n_docs, mix["docs"], mix["edits"])
    clients = Clients(gens, None, mix["arrivals"], seed)
    clients.prepare(seconds)
    tier = plugins.load("tiers", config["tier"]).Tier(
        config, device, clients.on_commit)
    clients.tier = tier
    for g in gens:
        tier.add_doc(g.doc_id, g.agents())
    tier.sched.start_pump()
    try:
        clients.send_bases(clients.clock())
        clients.wait_all(SETUP_TIMEOUT_S)       # builds every session
        clients.warm(SETUP_TIMEOUT_S)           # the mix's own shapes
        clients.reset()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        gc.collect()
        gc.freeze()          # the set-up's objects out of the window's GC
        tracer = None
        if trace:
            from dtbench.trace import DeviceTrace
            tracer = DeviceTrace()
        with tracer if tracer is not None else contextlib.nullcontext():
            # the window opens once the profiler runs
            ctx = {"sched_before": tier.sched.metrics_json()}
            t0 = clients.clock()
            ctx["setup_s"] = t0 - t_start
            t_end = t0 + seconds
            clients.start(t0, t_end)
            clients.step_until(t_end)
            ctx["sched_after"] = tier.sched.metrics_json()
        clients.step_until(t_end + DRAIN_S)
        uncommitted = len(clients.inflight) + sum(
            len(b) for b in clients.folded.values())
        tier.sched.drain()
        after_drain = tier.sched.metrics_json()
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        # the sample: documents that committed in the window and are
        # resident on the card, drawn from the seed, with the one that
        # merged the most ops among them
        window_ops: dict = {}
        for s in clients.done:
            window_ops[s.doc] = window_ops.get(s.doc, 0) + s.n_ops
        state = {d: tier.residency(d) for d in clients.order}
        lagging = sorted(d for d, st in state.items() if st == "lagging")
        eligible = sorted((d for d in window_ops if state[d] == "resident"),
                          key=lambda d: int(d[3:]))
        rng = np.random.default_rng([seed, 2 << 20])
        k = min(mix["check"]["docs"], len(eligible))
        sample = [eligible[i] for i in rng.choice(len(eligible), k,
                                                  replace=False)]
        if eligible:
            top = max(eligible, key=lambda d: window_ops[d])
            if top not in sample:
                sample.append(top)
        read = doc_texts or (lambda t, ds: {d: t.text(d) for d in ds})
        got = read(tier, sample)
        oplogs = tier.oplogs
    finally:
        tier.close()
    del tier
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, on the host, after the program's state is gone
    t_check = time.perf_counter()
    mismatched, diagnosis = [], []
    by_control = {c: 0 for c in controls}
    for d in sample:
        want = merged_text(clients.gens[d].syncs)
        have = merged_text(clients.gens[d].syncs, control) \
            if control is not None else got[d]
        if have != want:
            mismatched.append(d)
            if len(diagnosis) < 4 and control is None:
                diagnosis.append(diagnose(d, have, want, oplogs[d]))
        for c in controls:
            by_control[c] += merged_text(clients.gens[d].syncs, c) != want
    check_s = time.perf_counter() - t_check

    ctx.update(window_s=seconds, syncs=clients.done, t0=t0, t_end=t_end,
               trace=None)
    red = None
    if tracer is not None:
        red = tracer.reduce()
        ctx["trace"] = red
    falls = sum(after_drain[b][k] - ctx["sched_before"][b][k]
                for b, k in (("totals", "host_fallbacks"),
                             ("transform", "fallbacks")))
    out_metrics = {}
    for m in metric_specs:
        v = metrics.load(m["name"])(ctx)
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = len(clients.done) + uncommitted
    checks = {
        "mismatched_docs": {"value": len(mismatched), "limit": 0},
        "lagging_sessions": {"value": len(lagging), "limit": 0},
        "uncommitted_syncs": {"value": uncommitted, "limit": 0},
        "checked_docs": {"value": len(sample), "at_least": 1},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values()
                  if "limit" in c) and len(sample) >= 1
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    if red is not None:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": clients.refused + falls + uncommitted,
              "metrics": out_metrics, "device": dev}
    if red is not None:
        result["breakdown"] = red["breakdown"]
    if red is not None:
        print(f"trace busy_s {red['busy_s']} (union) "
              f"{red['busy_s_by_key']} (sum by key) window_s "
              f"{red['window_s']}", file=sys.stderr)
    commits_by_s = [0] * max(1, int(np.ceil(seconds)))
    for s in clients.done:
        if s.committed <= t_end:
            commits_by_s[min(int(s.committed - t0),
                             len(commits_by_s) - 1)] += 1
    result["notes"] = {"check_s": check_s, "late_s": clients.late_s,
                       "late_at_s": clients.late_at_s,
                       "stalls": clients.stalls,
                       "made_in_window": sum(g.made_late for g in gens),
                       "commits_by_s": commits_by_s,
                       "controls": by_control,
                       "batches": clients.batches,
                       "mismatched": mismatched[:8], "lagging": lagging[:8],
                       "diagnosis": diagnosis,
                       "control": control,
                       "window_totals": {
                           k: ctx["sched_after"]["totals"][k]
                           - ctx["sched_before"]["totals"][k]
                           for k in ("syncs", "builds", "evictions",
                                     "resyncs", "flushes", "fused_calls",
                                     "fused_docs", "host_fallbacks")},
                       "window_transform": {
                           k: ctx["sched_after"]["transform"][k]
                           - ctx["sched_before"]["transform"][k]
                           for k in ("device_docs", "host_docs",
                                     "fallbacks", "batches")},
                       "committed": len([s for s in clients.done
                                         if s.committed <= t_end])}
    result["checks"] = checks
    return result


def diagnose(doc: str, have: str, want: str, oplog) -> dict:
    """What a mismatch looks like, for the record (it decides nothing):
    lengths, the first differing char, and whether the program's own host
    merge (the C++ tracker, `Branch.merge_reference`) sides with the
    reference or with the device."""
    from diamond_types_tpu_torch import Branch
    host = Branch()
    host.merge_reference(oplog, oplog.version)
    host_text = host.snapshot()
    first = next((i for i, (a, b) in enumerate(zip(have, want)) if a != b),
                 min(len(have), len(want)))
    return {"doc": doc, "len_device": len(have), "len_reference": len(want),
            "first_diff": first, "ops": len(oplog),
            "host_equals_reference": host_text == want,
            "host_equals_device": host_text == have,
            "device_around": have[max(0, first - 8):first + 8],
            "reference_around": want[max(0, first - 8):first + 8]}


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c \
            else f"at least {c['at_least']}"
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    print(json.dumps(result), flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m dtbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest, cell, config, mix = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"dtbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import diamond_types_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"dtbench: the program is not here: {e}", file=sys.stderr)
        return 2
    specs = cell_metrics(manifest, cell["name"], bool(args.trace))
    result = run_cell(cell, config, mix, specs, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"dtbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
