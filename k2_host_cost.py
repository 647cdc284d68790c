#!/usr/bin/env python3
"""Host cost of one K2 (`kernels.xform_positions`) wrapper call, part by
part, on one CUDA card.

    python3 k2_host_cost.py [--b 256] [--n 512] [--reps 300] [--seed 0]

Each part is timed alone on the host clock over `reps` calls, few enough
that the launch queue never fills, so the host never waits on the card:
the wrapper whole, the yardstick `torch.cumsum(nv, 1)`, the wrapper's
three `torch.empty`, its current-device and current-stream lookup, and
the bare C launcher through ctypes. Prints one JSON line of microseconds
per call, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def per_call_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_host_cost: CUDA is not available", file=sys.stderr)
        return 2
    from diamond_types_tpu_torch.gpu import kernels
    b, n = args.b, args.n
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    nv, ov = (torch.from_numpy(rng.integers(0, 49, (b, n), dtype=np.int32))
              .to(dev) for _ in range(2))
    outs = [torch.empty_like(nv), torch.empty(b, dtype=torch.int32,
                                              device=dev),
            torch.empty(b, dtype=torch.int32, device=dev)]
    launch = kernels._lib("xform_positions").dt_xform_positions
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in [nv, ov] + outs]

    def three_empty():
        torch.empty_like(nv)
        torch.empty(b, dtype=torch.int32, device=dev)
        torch.empty(b, dtype=torch.int32, device=dev)

    parts = {
        "wrapper": lambda: kernels.xform_positions(nv, ov),
        "cumsum": lambda: torch.cumsum(nv, 1),
        "three_empty": three_empty,
        "device_and_stream": lambda: kernels._launch_on(
            dev, lambda s: s),
        "launch": lambda: launch(*ptrs, b, n, stream),
    }
    us = {name: per_call_us(fn, args.reps) for name, fn in parts.items()}
    print(json.dumps({"b": b, "n": n, "reps": args.reps,
                      "host_us_per_call": us}), flush=True)
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    print(r.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
