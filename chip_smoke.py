#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Drives `diamond_types_tpu_torch` only (no JAX, nothing of the JAX
package), in phases, each printing one JSON line:

  1. build   - compile every kernel in `diamond_types_tpu_torch/csrc/`
               with nvcc (one process per source, started together).
  2. kernel  - K1 (`gpu/kernels.py::apply_ops_window`) against its plain
               PyTorch version on the card over random windows: poisoned
               rows, padding rows, deletes into the roll's wrap region;
               b in {1, 8, 256}, cap in {256, 4096, 32768, 65536} (the last
               keeps the row in device memory), n in {1, 64, 256}, max_ins
               16. Full buffers and lengths must be exactly equal.
  3. serve   - the main path: 256 documents, each typed by one agent
               (2,048-12,288 chars), resident as `FusedDocSession`s on the
               card; 6 flush windows in which two more agents fork from
               each tip and edit concurrently and the first agent merges.
               Every tail is planned with `plan_tail`, grouped by cap and
               replayed through `kernel_fused_replay` in buckets of 8 (one
               window: one wide bucket per cap). Every text must equal the
               host checkout after every window, with no fence failure, and
               K1's launches (counted from 0 over this phase) must equal
               the number of buckets.
  4. kernels - one line per the port's kernels: launches on the main path,
               max error against the plain version, time (CUDA events) at
               the main path's widest bucket beside its HBM bound and the
               plain version's time; then the card's name and power limit.

The last line is {"ok": true, "device": {...}}; any failure exits nonzero
before it. Without CUDA, or without the package beside this script, it
fails at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

MAX_INS = 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
KERNEL_SHAPES = [(b, cap, n) for b in (1, 8, 256)
                 for cap in (256, 4096, 32768, 65536) for n in (1, 64, 256)]
ALPHABET = "abcdefghijklmnopqrstuvwxyz      ,.\nAEIOUé中文😀"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def exact_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max |a - b| over int32 tensors, computed in int64."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# ---- phase 1: build ---------------------------------------------------------

def phase_build() -> dict:
    from diamond_types_tpu_torch.gpu import kernels
    t0 = time.perf_counter()
    info = kernels.build()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in v["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, v in info.items()}
    return {"phase": "build", "seconds": secs, "kernels": sorted(info),
            "ptxas": ptxas}


# ---- phase 2: kernel against plain -------------------------------------------

def random_window(rng: np.random.Generator, b: int, n: int, cap: int,
                  mi: int, device) -> List[torch.Tensor]:
    """A random window of every op kind. Rows 1 and b//2 carry one op past
    max_ins (poison); the last quarter of rows are inert padding (-1
    length, zero ops); a quarter of the ops sit at the buffer's end, where
    deletes pull the roll's wrap-around into the row."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 31)))
    docs = torch.randint(1, 0x10FFFF, (b, cap), generator=gen,
                         dtype=torch.int32, device=device)
    lens = rng.integers(0, cap, b)
    shape = (b, n)
    pos = rng.integers(0, cap + 3, shape)
    pos = np.where(rng.random(shape) < 0.25,
                   cap - rng.integers(1, mi + 2, shape), pos)
    kind = rng.integers(0, 4, shape)               # ins, del, replace, no-op
    dlen = np.where((kind == 1) | (kind == 2), rng.integers(1, mi + 1, shape),
                    0)
    ilen = np.where((kind == 0) | (kind == 2), rng.integers(1, mi + 1, shape),
                    0)
    chars = rng.integers(1, 0x10FFFF, shape + (mi,))
    if b >= 8:
        for r in (1, b // 2):
            dlen[r, int(rng.integers(0, n))] = mi + 1
        for r in range(b - b // 4, b):
            lens[r] = -1
            pos[r] = dlen[r] = ilen[r] = 0
            chars[r] = 0
    host = [lens, pos, dlen, ilen, chars]
    return [docs] + [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                     .to(device) for a in host]


def window_bytes(b: int, n: int, cap: int, mi: int) -> int:
    """Bytes K1 must move at minimum: every input read once (docs, lens,
    the op tape), every output written once (docs, lens)."""
    return 4 * (2 * b * cap + 2 * b + b * n * (3 + mi))


def phase_kernel_vs_plain(rng: np.random.Generator, device) -> dict:
    from diamond_types_tpu_torch.gpu import kernels
    worst = 0
    shapes = []
    for b, cap, n in KERNEL_SHAPES:
        args = random_window(rng, b, n, cap, MAX_INS, device)
        got_d, got_l = kernels.apply_ops_window(*args, MAX_INS)
        want_d, want_l = kernels.apply_ops_window_plain(*args, MAX_INS)
        torch.cuda.synchronize()
        err = max(exact_err(got_d, want_d), exact_err(got_l, want_l))
        poisoned = int((want_l == -1).sum())
        check(err == 0 and torch.equal(got_d, want_d)
              and torch.equal(got_l, want_l),
              f"K1 differs from its plain version at b={b} cap={cap} "
              f"n={n}: max abs err {err}")
        worst = max(worst, err)
        shapes.append([b, cap, n, poisoned])
    return {"phase": "kernel_vs_plain", "kernel": "apply_ops_window",
            "shapes": len(shapes), "max_abs_err": worst,
            "b_cap_n_poisoned": shapes, "exact": True}


# ---- phase 3: the serve flush (main path) -----------------------------------

@dataclass
class ServeConfig:
    n_docs: int = 256
    base_min: int = 2048
    base_max: int = 12288
    windows: int = 6
    wide_window: int = 2          # this window replays one bucket per cap
    flush_docs: int = 8
    edits_min: int = 8
    edits_max: int = 64
    ins_max: int = 48
    del_max: int = 40
    max_ins: int = MAX_INS
    headroom: float = 2.0


def rand_text(rng: np.random.Generator, k: int) -> str:
    return "".join(ALPHABET[i] for i in rng.integers(0, len(ALPHABET), k))


def fork(branch):
    from diamond_types_tpu_torch import Branch
    from diamond_types_tpu_torch.utils.rope import Rope
    out = Branch()
    out.version = list(branch.version)
    out.content = Rope(branch.snapshot())
    return out


def random_edits(rng, ol, agent: int, branch, k: int,
                 cfg: ServeConfig) -> None:
    for _ in range(k):
        cur = len(branch)
        if cur and rng.random() < 0.4:
            p = int(rng.integers(0, cur))
            end = min(cur, p + int(rng.integers(1, cfg.del_max + 1)))
            branch.delete(ol, agent, p, end)
        else:
            p = int(rng.integers(0, cur + 1))
            branch.insert(ol, agent, p, rand_text(
                rng, int(rng.integers(1, cfg.ins_max + 1))))


def build_docs(rng, cfg: ServeConfig):
    from diamond_types_tpu_torch import OpLog
    ols = []
    for d in range(cfg.n_docs):
        ol = OpLog()
        ol.doc_id = f"doc{d}"
        a = ol.get_or_create_agent_id("typist")
        n = int(rng.integers(cfg.base_min, cfg.base_max + 1))
        done = 0
        while done < n:                    # typed in runs of 1..64 chars
            k = min(n - done, int(rng.integers(1, 65)))
            ol.add_insert(a, done, rand_text(rng, k))
            done += k
        ols.append(ol)
    return ols


def buckets_by_cap(sessions, idx: List[int], size: int) -> List[List[int]]:
    by_cap: Dict[int, List[int]] = {}
    for i in idx:
        by_cap.setdefault(sessions[i].cap, []).append(i)
    out = []
    for cap in sorted(by_cap):
        g = by_cap[cap]
        step = size if size > 0 else len(g)
        out += [g[k:k + step] for k in range(0, len(g), step)]
    return out


def run_serve(rng: np.random.Generator, device, cfg: ServeConfig,
              capture: bool) -> dict:
    """Build the documents and sessions, then drive the flush windows.
    K1's launch count is set to 0 just before the windows and read just
    after them."""
    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import kernels

    t0 = time.perf_counter()
    ols = build_docs(rng, cfg)
    sessions = [ff.FusedDocSession(ol, max_ins=cfg.max_ins,
                                   headroom=cfg.headroom, device=device)
                for ol in ols]
    tips = [ol.checkout_tip() for ol in ols]
    setup_s = time.perf_counter() - t0
    caps0 = sorted({s.cap for s in sessions})

    stats = {"windows": cfg.windows, "buckets": 0, "rows": 0, "lvs": 0,
             "fence_failures": 0, "resyncs": 0, "plan_s": 0.0,
             "replay_s": 0.0, "verify_s": 0.0, "edit_s": 0.0,
             "flush_s_per_window": []}
    captured = []                  # (window, bucket size, K1 inputs)
    kernels.apply_ops_window.launches = 0
    for w in range(cfg.windows):
        t = time.perf_counter()
        lv0 = sum(len(ol) for ol in ols)
        for ol, tip in zip(ols, tips):
            b1, b2 = fork(tip), fork(tip)
            for name, br in ((f"fork{w}a", b1), (f"fork{w}b", b2)):
                k = int(rng.integers(cfg.edits_min, cfg.edits_max + 1))
                random_edits(rng, ol, ol.get_or_create_agent_id(name), br,
                             k, cfg)
            tip.merge(ol, ol.version)      # the first agent merges...
            random_edits(rng, ol, ol.get_or_create_agent_id("typist"), tip,
                         1, cfg)           # ...and edits on top
        stats["lvs"] += sum(len(ol) for ol in ols) - lv0
        stats["edit_s"] += time.perf_counter() - t

        t_flush = t = time.perf_counter()
        plans = [s.plan_tail() for s in sessions]
        replay = []
        for i, (s, p) in enumerate(zip(sessions, plans)):
            if not p.fits(s.cap):
                s.resync_for(p)
                stats["resyncs"] += 1
            elif p.n_ops == 0:
                s.commit_host(p)
            else:
                replay.append(i)
        stats["plan_s"] += time.perf_counter() - t

        wide = w == cfg.wide_window
        capture_s = 0.0            # excluded from the flush time
        for bucket in buckets_by_cap(sessions, replay,
                                     0 if wide else cfg.flush_docs):
            bs = [sessions[i] for i in bucket]
            bp = [plans[i] for i in bucket]
            if capture and (wide or w == 0):
                t = time.perf_counter()
                captured.append((w, len(bucket), ff.pack_bucket(bs, bp)))
                capture_s += time.perf_counter() - t
            t = time.perf_counter()
            ok, _fence_s = ff.kernel_fused_replay(bs, bp)
            stats["replay_s"] += time.perf_counter() - t
            stats["buckets"] += 1
            stats["rows"] += sum(p.n_ops for p in bp)
            stats["fence_failures"] += ok.count(False)
        stats["flush_s_per_window"].append(
            time.perf_counter() - t_flush - capture_s)

        t = time.perf_counter()
        for d, (s, ol) in enumerate(zip(sessions, ols)):
            tip = ol.checkout_tip()
            check(s.text() == tip.snapshot(),
                  f"window {w}: doc {d} text differs from the host checkout")
            tips[d] = tip
        stats["verify_s"] += time.perf_counter() - t
    launches = kernels.apply_ops_window.launches

    check(stats["fence_failures"] == 0,
          f"{stats['fence_failures']} fence failures on the main path")
    check(launches == stats["buckets"],
          f"K1 launched {launches} times for {stats['buckets']} buckets")
    flush_s = stats["plan_s"] + stats["replay_s"]
    stats.update({"phase": "serve", "docs": cfg.n_docs,
                  "caps_at_build": caps0,
                  "caps_at_end": sorted({s.cap for s in sessions}),
                  "launches": launches, "setup_s": setup_s,
                  "host_plan_ms": 1e3 * stats["plan_s"],
                  "replay_ms_per_bucket": 1e3 * stats["replay_s"]
                  / max(stats["buckets"], 1),
                  "flush_lv_per_s": stats["lvs"] / flush_s,
                  "flush_rows_per_s": stats["rows"] / flush_s})
    stats["captured"] = captured
    return stats


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, CUDA events over `reps` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_captured(captured, mi: int, wide_window: int) -> dict:
    """K1 at every captured main-path bucket: held exactly against its
    plain version on the same inputs, then timed; the widest bucket's
    plain version is timed too."""
    from diamond_types_tpu_torch.gpu import kernels
    per = {"flush_docs": [], "wide": []}
    widest = None
    worst = 0
    for w, b, args in captured:
        k_d, k_l = kernels.apply_ops_window(*args, mi)
        p_d, p_l = kernels.apply_ops_window_plain(*args, mi)
        torch.cuda.synchronize()
        err = max(exact_err(k_d, p_d), exact_err(k_l, p_l))
        check(err == 0, f"K1 differs from its plain version at a main-path "
              f"bucket (window {w}, {b} docs): max abs err {err}")
        worst = max(worst, err)
        ms = time_ms(lambda: kernels.apply_ops_window(*args, mi), 5)
        bp, cap = args[0].shape
        n = args[2].shape[1]
        row = {"window": w, "docs": b, "b": bp, "cap": cap, "n": n,
               "ms": ms, "bound_ms": 1e3 * window_bytes(bp, n, cap, mi)
               / HBM_BYTES_PER_S}
        per["wide" if w == wide_window else "flush_docs"].append(row)
        if widest is None or bp * cap > widest[0]["b"] * widest[0]["cap"]:
            widest = (row, args)
    row, args = widest
    row["plain_ms"] = time_ms(
        lambda: kernels.apply_ops_window_plain(*args, mi), 1)
    return {"per_bucket": per, "widest": row, "max_abs_err": worst,
            "buckets_checked": len(captured)}


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every random input (documents, edits, "
                         "kernel windows)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from diamond_types_tpu_torch.gpu import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    device = torch.device("cuda")
    try:
        build = phase_build()
        build.update({"torch": torch.__version__, "cuda": torch.version.cuda})
        emit(build)
        t = time.perf_counter()
        kvp = phase_kernel_vs_plain(rng, device)
        kvp["seconds"] = time.perf_counter() - t
        emit(kvp)
        cfg = ServeConfig()
        serve = run_serve(rng, device, cfg, capture=True)
        timing = time_captured(serve.pop("captured"), cfg.max_ins,
                               cfg.wide_window)
        per = timing["per_bucket"]
        serve["k1_ms_flush_docs_buckets"] = [r["ms"]
                                             for r in per["flush_docs"]]
        serve["k1_wide_buckets"] = per["wide"]
        serve["plain_ms_widest"] = timing["widest"]["plain_ms"]
        serve["buckets_checked_against_plain"] = timing["buckets_checked"]
        # K1's device time as a share of the window's flush wall time
        # (plan + replay + fence), for the two windows whose buckets were
        # all captured and timed
        flush_s = serve["flush_s_per_window"]
        serve["k1_share_of_flush"] = {
            "window0": sum(r["ms"] for r in per["flush_docs"])
            / (1e3 * flush_s[0]),
            "wide_window": sum(r["ms"] for r in per["wide"])
            / (1e3 * flush_s[cfg.wide_window])}
        emit(serve)
        widest = timing["widest"]
        kern = {"name": "apply_ops_window", "route": "cuda",
                "source": "diamond_types_tpu_torch/csrc/apply_ops.cu",
                "replaces": "diamond_types_tpu/tpu/pallas_kernels.py:99",
                "launches": serve["launches"],
                "max_abs_err": max(kvp["max_abs_err"], timing["max_abs_err"]),
                "ms": widest["ms"], "plain_ms": widest["plain_ms"],
                "bound_ms": widest["bound_ms"], "bound_by": "bytes",
                "library_ms": None,
                "shape": {k: widest[k] for k in ("b", "cap", "n")}}
        card = nvidia_smi_line()
        emit({"kernels": [kern]})
        print(card, flush=True)
    except Exception as e:     # every phase fails loudly, and the run too
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
