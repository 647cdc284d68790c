"""Find the rate an interval-arrival cell sustains: run it at several
intervals, each in a process of its own, and print one line per interval.

    python3 -m dtbench.sweep --workload fused-typing --seed <n> \\
        --seconds 40 --intervals 0.85,0.7,0.55,0.45,0.4

Each line has the offered keystroke batches per second (documents over the
interval), the batches typed and the syncs committed per second, how many
batches a sync carried, the visible tails, how late the clients typed and
what stalled them, and whether the run was correct. A rate is sustained
while syncs commit as fast as batches are offered, a sync carries about
one batch, and the commits of every second of the window keep pace; the
cell's interval is set at about four fifths of the highest such rate
(PERF.md records the sweep)."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def one(workload: str, seed: int, seconds: float, interval: float) -> dict:
    from dtbench.run import T_START, cell_metrics, load_cell, run_cell
    manifest, cell, config, mix = load_cell(workload)
    mix["arrivals"]["interval_s"] = interval
    n_docs = mix["docs"].get("count", config["live_docs"])
    tails = [{"name": n, "unit": "ms"}
             for n in ("visible_p50_ms", "visible_p95_ms")]
    r = run_cell(cell, config, mix,
                 cell_metrics(manifest, cell["name"], False) + tails,
                 seed, seconds, False, "cuda", t_start=T_START)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    n = r["notes"]
    return {"interval_s": interval, "seed": seed,
            "offered_batches_per_s": n_docs / interval,
            "typed_batches_per_s": n["batches"] / seconds,
            "committed_syncs_per_s": n["committed"] / seconds,
            "batches_per_sync": n["batches"] / max(n["committed"], 1),
            "slowest_second": min(n["commits_by_s"]),
            **m, "late_s": n["late_s"], "stalls": n["stalls"],
            "correct": r["correct"], "device": r["device"]["kind"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m dtbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--intervals", required=True)
    ap.add_argument("--one", action="store_true",
                    help="run the first interval in this process")
    args = ap.parse_args(argv)
    intervals = [float(x) for x in args.intervals.split(",")]
    if args.one:
        print(json.dumps(one(args.workload, args.seed, args.seconds,
                             intervals[0])), flush=True)
        return 0
    for i, interval in enumerate(intervals):
        out = subprocess.run(
            [sys.executable, "-m", "dtbench.sweep", "--one",
             "--workload", args.workload, "--seed", str(args.seed + i),
             "--seconds", str(args.seconds), "--intervals", str(interval)],
            capture_output=True, text=True)
        lines = out.stdout.strip().splitlines()
        print(lines[-1] if out.returncode == 0 and lines else json.dumps(
            {"interval_s": interval, "exit": out.returncode,
             "stderr": out.stderr[-400:]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
