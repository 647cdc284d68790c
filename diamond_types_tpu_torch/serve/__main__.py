"""Serve bench: replay a workload through the merge scheduler and print the
report as JSON (`run_serve_bench`). Exits 1 when any document's text
differs from the host merge.

    python -m diamond_types_tpu_torch.serve [--mode trace|concurrent|flash]
        [--shards 4] [--docs 8] [--device-plan] [--mesh-window]
        [--no-device-stage] [--no-fused] [--device cpu] ...

Sessions live on CUDA unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from .driver import run_serve_bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m diamond_types_tpu_torch.serve",
        description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--docs", type=int, default=8)
    ap.add_argument("--txns", type=int, default=None,
                    help="rounds to replay (default: whole corpus, or 24)")
    ap.add_argument("--engine", choices=("device", "host"),
                    default="device")
    ap.add_argument("--mode", choices=("trace", "concurrent", "flash"),
                    default="trace")
    ap.add_argument("--corpus", help="crdt-testdata JSON trace file "
                    "(default: synthetic trace)")
    ap.add_argument("--flush-docs", type=int, default=4)
    ap.add_argument("--flush-deadline", type=float, default=0.02)
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--max-sessions", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="where the sessions live (default: CUDA, shard i "
                    "on cuda:(i %% device count)); 'cpu' runs the "
                    "kernels' plain versions")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused bucket flush (--no-fused: zone sessions, "
                    "each document synced on its own by the X8 kernel)")
    ap.add_argument("--workers", action=argparse.BooleanOptionalAction,
                    default=True, help="per-shard flush worker threads")
    ap.add_argument("--device-plan", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="plan tails through the device transform (K2)")
    ap.add_argument("--mesh-window",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="flush windows: every due shard's bucket in one "
                    "K1 launch per shape class and device, and one K2 "
                    "resolve per device (default: one call per shard)")
    ap.add_argument("--device-stage",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="the window's device-side row gather and arenas "
                    "(--no-device-stage: host-numpy staging every window, "
                    "the A/B control arm)")
    ap.add_argument("--warmup", action="store_true",
                    help="launch K1 once per warm-up shape class first")
    ap.add_argument("--steady-rounds", type=int, default=0,
                    help="lockstep rounds against resident sessions after "
                    "the continuous feed")
    args = ap.parse_args(argv)
    report = run_serve_bench(
        shards=args.shards, docs=args.docs, txns=args.txns,
        engine=args.engine, mode=args.mode, corpus=args.corpus,
        flush_docs=args.flush_docs, flush_deadline_s=args.flush_deadline,
        max_pending=args.max_pending, max_sessions=args.max_sessions,
        seed=args.seed, device=args.device, flush_workers=args.workers,
        warmup=args.warmup, steady_rounds=args.steady_rounds,
        device_plan=args.device_plan, mesh_window=args.mesh_window,
        device_stage=args.device_stage, fused=args.fused)
    print(json.dumps(report))
    return 0 if report["parity_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
