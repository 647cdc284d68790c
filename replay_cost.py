#!/usr/bin/env python3
"""Host-clock cost of the kernel rung (`flush_fuse.kernel_fused_replay`) per
bucket, on one CUDA card, for the port found under a given root.

    python3 replay_cost.py [--root DIR] [--docs 256] [--rounds 3] [--seed 0]

`--root` is the directory that holds the `diamond_types_tpu_torch` package
to measure (default: this script's own), so two checkouts can be measured
in turns by one script on the same inputs. Builds `--docs` documents of
2,048-12,288 chars typed by one agent, resident as `FusedDocSession`s on
the card; each round every document takes 8-64 linear edits (inserts up to
48 chars, deletes up to 40), every tail is planned on the host
(`plan_tail`, not timed) and replayed through the rung in buckets of 8 per
cap, as the smoke's serve phase does. Each rung call is timed alone on the
host clock: packing, uploads, K1, the length fence and the row clones.
Prints one JSON line, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ALPHABET = "abcdefghijklmnopqrstuvwxyz      ,.\nAEIOUé中文😀"


def rand_text(rng: np.random.Generator, k: int) -> str:
    return "".join(ALPHABET[i] for i in rng.integers(0, len(ALPHABET), k))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="directory holding diamond_types_tpu_torch")
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("replay_cost: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import diamond_types_tpu_torch as pkg
    from diamond_types_tpu_torch import OpLog
    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import kernels

    kernels.build()
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    ols, lens = [], []
    for d in range(args.docs):
        ol = OpLog()
        a = ol.get_or_create_agent_id("typist")
        n = int(rng.integers(2048, 12289))
        done = 0
        while done < n:
            k = min(n - done, int(rng.integers(1, 65)))
            ol.add_insert(a, done, rand_text(rng, k))
            done += k
        ols.append(ol)
        lens.append(n)
    sessions = [ff.FusedDocSession(ol, max_ins=16, device=dev)
                for ol in ols]
    per_bucket, per_round = [], []
    for _ in range(args.rounds):
        for d, ol in enumerate(ols):
            a = ol.get_or_create_agent_id("typist")
            for _ in range(int(rng.integers(8, 65))):
                if lens[d] and rng.random() < 0.4:
                    p = int(rng.integers(0, lens[d]))
                    end = min(lens[d], p + int(rng.integers(1, 41)))
                    ol.add_delete_without_content(a, p, end)
                    lens[d] -= end - p
                else:
                    p = int(rng.integers(0, lens[d] + 1))
                    s = rand_text(rng, int(rng.integers(1, 49)))
                    ol.add_insert(a, p, s)
                    lens[d] += len(s)
        plans = [s.plan_tail() for s in sessions]
        by_cap = {}
        for i, (s, p) in enumerate(zip(sessions, plans)):
            if not p.fits(s.cap):
                s.resync_for(p)
            elif p.n_ops == 0:
                s.commit_host(p)
            else:
                by_cap.setdefault(s.cap, []).append(i)
        torch.cuda.synchronize()
        times = []
        for cap in sorted(by_cap):
            g = by_cap[cap]
            for k in range(0, len(g), 8):
                idx = g[k:k + 8]
                t = time.perf_counter()
                ok, _ = ff.kernel_fused_replay([sessions[i] for i in idx],
                                               [plans[i] for i in idx])
                times.append(1e3 * (time.perf_counter() - t))
                if not all(ok):
                    print("replay_cost: a fence failed", file=sys.stderr)
                    return 1
        per_bucket += times
        per_round.append(float(np.mean(times)))
    for s, ol in zip(sessions, ols):
        if s.text() != ol.checkout_tip().snapshot():
            print("replay_cost: a text differs from the host's",
                  file=sys.stderr)
            return 1
    q = np.percentile(per_bucket, [10, 50, 90])
    print(json.dumps({
        "package": os.path.dirname(pkg.__file__), "docs": args.docs,
        "rounds": args.rounds, "buckets": len(per_bucket),
        "replay_ms_mean": float(np.mean(per_bucket)),
        "replay_ms_p10_p50_p90": [float(x) for x in q],
        "replay_ms_mean_per_round": per_round}), flush=True)
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    print(r.stdout.strip().splitlines()[0] if r.returncode == 0
          else "nvidia-smi failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
