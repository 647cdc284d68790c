#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Drives `diamond_types_tpu_torch` only (no JAX, nothing of the JAX
package), in phases, each printing one JSON line:

  1. build    - compile every kernel in `diamond_types_tpu_torch/csrc/`
                with nvcc (one process per source, started together) and,
                at the same time, the port's native library with g++
                (`native/build.py`); each one's seconds.
  2. kernel   - each kernel against its plain PyTorch version on the card,
                exactly equal on every shape:
                K1 (`apply_ops_window`) over random windows: poisoned rows,
                padding rows, deletes into the roll's wrap region, ops past
                cap; b in {1, 8, 256}, cap in {256, 4096, 32768, 65536},
                n in {1, 64, 256}; then cap 4,100 (no multiple of the
                tile), cap == max_ins (16 and 64), b 8 at caps 8,192 and
                16,384, and tapes of 1,024 and 2,048 ops.
                K2 (`xform_positions`) on random [b, n] columns, b in
                {1, 7, 8, 256, 257}, n from 0 to 4,096 around the edges of
                its warp's 128-element chunks and of 32 lanes (31-33,
                255-257, 2,047-2,049), with rows whose prefix sum of
                nv - ov is negative throughout.
                K3 (`materialize_runs`) on random run tables up to 70,000
                runs, with cap < total, empty runs and runs that start
                past cap, a cap that is no multiple of its gather's
                512-output tile and b 1 at cap 65,536; and on the tiled
                gather's hazards: total 0, one run spanning every tile,
                a tile's worth of zero-length runs sharing a live run's
                start, arena offsets past the pool.
  3. serve    - the main path: 256 documents, each typed by one agent
                (2,048-12,288 chars), resident as `FusedDocSession`s on the
                card; 6 flush windows in which two more agents fork from
                each tip and edit concurrently and the first agent merges.
                Each window plans every tail with `xform.plan_tails_device`
                (host extract, then ONE device resolve: `fugue_linearize`
                and K2), groups them by cap and replays them through
                `kernel_fused_replay` (K1) in buckets of 8 (one window: one
                wide bucket per cap). Window 0 also times the host
                `plan_tail` over the same sessions, without adopting those
                plans; window 1 is traced with `torch.profiler` (device
                activity only) for the device's busy share of its flush.
                Requires 0 fence failures, 0 fallbacks, device-
                planned documents in every window, K1 launches == buckets,
                K2 launches == resolves, and every text equal to the host
                checkout after every window.
  4. checkout - `merge_kernel.prepare_doc` and `checkout_batch_device`
                (`fugue_linearize` and one K3 call per checkout: a row
                scan and a tiled gather, two kernels counted as one
                launch) over all 256 served documents, grouped by pow2
                cap; then `merge_device` of 16 documents from their
                window-0 frontier. Every text must equal the host's (the
                tip checkout; a `Branch` checked out at that frontier that
                merges the tip), and K3 launches == calls. Then every one
                of those K3 calls is held against its plain version and
                timed (b, runs, cap, call_ms, device_ms, bound_ms, and the
                gather's CTAs as derived from the launcher's grid rule, b
                * ceil(cap / 512), not observed), and one batch call per
                cap is taken apart: `pad_docs` + upload (host clock),
                `fugue_linearize` and K3 (CUDA events), download + decode
                (host clock).
  5. kernels  - one line for K1, K2 and K3: launches on the main path (K1
                and K2 in the serve phase, K3 in the checkout phase), max
                error against the plain version (on the kernel phase's
                shapes and on every captured main-path call), and at the
                main path's widest call two times: `call_ms` (CUDA events
                around back-to-back wrapper calls: host and device) and
                `device_ms` (the card's own time per call: CUDA events
                around calls queued behind a sleep on the card, so the
                host's work is not in it); for K3 also `device_ms` with
                the L2 cold (a 256 MB buffer overwritten before each call)
                and its `device_ms` at each merge call. "ms", "plain_ms"
                and "library_ms" are call times, as in earlier slices. Beside
                them the HBM bound and the library yardstick's call_ms and
                device_ms (`torch.cumsum` for K2); then the card's name and
                power limit. The serve line carries K1's call_ms and
                device_ms at every captured bucket, and K1's CTAs per
                launch as derived from the launcher's grid rule
                (b * ceil(cap / 512)), not observed.

Each phase draws from its own generator, seeded by (--seed, phase), so the
served documents do not change when the kernel phases' shapes do.

Each phase's counts are set to 0 just before it drives its path and read
just after. The last line is {"ok": true, "device": {...}}; any failure
exits nonzero before it. Without CUDA, or without the package beside this
script, it fails at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

MAX_INS = 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
# (b, cap, n, max_ins): the PR 1 grid, then the hazards of K1's tiled
# gather: a cap that is no multiple of the tile (4,100), cap == max_ins,
# the main path's flush-docs buckets at every cap, tapes of 1,024 and 2,048
# ops (past one staging tile of the op scalars)
KERNEL_SHAPES = ([(b, cap, n, MAX_INS) for b in (1, 8, 256)
                  for cap in (256, 4096, 32768, 65536) for n in (1, 64, 256)]
                 + [(8, 4100, 256, MAX_INS), (3, 4100, 64, MAX_INS),
                    (8, MAX_INS, 64, MAX_INS), (8, 64, 64, 64),
                    (8, 8192, 256, MAX_INS), (8, 16384, 256, MAX_INS),
                    (8, 8192, 1024, MAX_INS), (8, 8192, 2048, MAX_INS)])
# K2 at the edges of its warp's 128-element chunks and of 32 lanes, past
# 2,048 elements, and at the PR 2 shapes
K2_SHAPES = [(b, n) for b in (1, 7, 8, 256, 257)
             for n in (0, 1, 2, 31, 32, 33, 255, 256, 257, 511, 512, 513,
                       2047, 2048, 2049, 4096)]
# (kind, b, runs, cap, arena pool): random tables - one run; truncation
# with runs past cap; past the TPU kernel's 8,192-run table; a main-path-
# like batch; truncation at 16,384 runs; 70,000 runs; a cap that is no
# multiple of the gather's 512-output tile; b 1 at cap 65,536, truncated
# and zero-filled - then the tiled gather's hazards by name
K3_CASES = [("random", 1, 1, 8, 8), ("random", 8, 511, 256, 2048),
            ("random", 8, 16384, 65536, 40000),
            ("random", 256, 4096, 8192, 16384),
            ("random", 4, 16384, 4096, 40000),
            ("random", 2, 70000, 8192, 150000),
            ("random", 3, 900, 4100, 5000),
            ("random", 1, 2048, 65536, 40000),
            ("random", 1, 512, 65536, 40000),
            ("total_zero", 2, 64, 1024, 64),
            ("one_run_spans_every_tile", 2, 6, 16384, 16584),
            ("zero_length_runs_then_live_run", 2, 1600, 2048, 4096),
            ("arena_off_past_pool", 3, 256, 2048, 512)]
K3_TILE = 512                      # outputs per CTA of K3's gather
L2_FLUSH_BYTES = 256 << 20         # overwritten before each cold-L2 call
# device activity only: tracing every host op would multiply the window's
# wall time
PROFILED = [torch.profiler.ProfilerActivity.CUDA]
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
    """nvcc for each kernel and g++ for the native library, all at once."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.native import build as native_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(native_build.build)
        info = kernels.build()
        native_path, native_s = native.result()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in v["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, v in info.items()}
    return {"phase": "build", "seconds": secs, "kernels": sorted(info),
            "kernel_seconds": {k: v["seconds"] for k, v in info.items()},
            "native_seconds": native_s, "native_library": native_path.name,
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
    for b, cap, n, mi in KERNEL_SHAPES:
        args = random_window(rng, b, n, cap, mi, device)
        got_d, got_l = kernels.apply_ops_window(*args, mi)
        want_d, want_l = kernels.apply_ops_window_plain(*args, mi)
        torch.cuda.synchronize()
        err = max(exact_err(got_d, want_d), exact_err(got_l, want_l))
        poisoned = int((want_l == -1).sum())
        check(err == 0 and torch.equal(got_d, want_d)
              and torch.equal(got_l, want_l),
              f"K1 differs from its plain version at b={b} cap={cap} "
              f"n={n} max_ins={mi}: max abs err {err}")
        worst = max(worst, err)
        shapes.append([b, cap, n, mi, poisoned])
    return {"phase": "kernel_vs_plain", "kernel": "apply_ops_window",
            "shapes": len(shapes), "max_abs_err": worst,
            "b_cap_n_maxins_poisoned": shapes, "exact": True}


def k2_err(nv: torch.Tensor, ov: torch.Tensor) -> int:
    """Launch K2 once and hold it against its plain version."""
    from diamond_types_tpu_torch.gpu import kernels
    got = kernels.xform_positions(nv, ov)
    want = kernels.xform_positions_plain(nv, ov)
    torch.cuda.synchronize()
    return max(exact_err(g, w) for g, w in zip(got, want))


def phase_k2_vs_plain(rng: np.random.Generator, device) -> dict:
    worst = 0
    for b, n in K2_SHAPES:
        nv = rng.integers(0, 49, (b, n))
        ov = rng.integers(0, 49, (b, n))
        neg = slice(b - max(b // 4, 1), b)    # prefix sum < 0 throughout
        ov[neg] = nv[neg] + rng.integers(1, 8, ov[neg].shape)
        nv, ov = (torch.from_numpy(np.ascontiguousarray(a, np.int32))
                  .to(device) for a in (nv, ov))
        err = k2_err(nv, ov)
        check(err == 0, f"K2 differs from its plain version at b={b} "
              f"n={n}: max abs err {err}")
        worst = max(worst, err)
    return {"phase": "kernel_vs_plain", "kernel": "xform_positions",
            "shapes": len(K2_SHAPES), "b_n": K2_SHAPES,
            "max_abs_err": worst, "exact": True}


def k3_err(args: List[torch.Tensor], cap: int) -> int:
    """Launch K3 once and hold it against its plain version."""
    from diamond_types_tpu_torch.gpu import kernels, linearize
    got = kernels.materialize_runs(*args, cap)
    want = linearize.materialize(*args, cap)
    torch.cuda.synchronize()
    return max(exact_err(g, w) for g, w in zip(got, want))


def k3_table(rng: np.random.Generator, kind: str, b: int, n: int, cap: int,
             pool: int, device) -> List[torch.Tensor]:
    """perm, vis_len, arena_off, arena for K3. "random": lengths 0-5 (0-99
    on every other row, runs of several warps) with 30% empty runs. The
    hazards, with runs set in document (perm) order: "total_zero" (every
    run empty); "one_run_spans_every_tile" (one run longer than cap, in
    the last row behind a zero-length run at the same start);
    "zero_length_runs_then_live_run" (a live run, then three tiles' worth
    of empty runs that start where it ends - the next tile's first output,
    in the last row inside a thread's 4 outputs - then live runs); "arena_off_past_pool" (offsets past the pool in the first
    row, negative in half the last row's runs: the clamp's work)."""
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    vl = rng.integers(0, 6, (b, n))
    vl[::2] = rng.integers(0, 100, (len(vl[::2]), n))
    vl *= rng.random((b, n)) < 0.7
    off = rng.integers(0, pool, (b, n))
    if kind == "total_zero":
        vl[:] = 0
    elif kind == "one_run_spans_every_tile":
        vl[:] = 0
        vl[:, 0] = cap + 100
        vl[-1, 0], vl[-1, 1] = 0, cap + 3
        off[:] = rng.integers(0, pool - cap - 100, (b, n))
    elif kind == "zero_length_runs_then_live_run":
        vl[:, :3 * K3_TILE + 2] = 0
        vl[:, 0] = K3_TILE
        vl[-1, 0] = K3_TILE - 2
        vl[:, 3 * K3_TILE + 1] = 5
    elif kind == "arena_off_past_pool":
        off[0] = rng.integers(pool, pool + 5000, n)
        off[-1, ::2] = -rng.integers(1, 5000, (n + 1) // 2)
    if kind != "random":                  # lengths given in perm order
        vis, offs = np.zeros_like(vl), np.zeros_like(off)
        for r in range(b):
            vis[r, perm[r]] = vl[r]
            offs[r, perm[r]] = off[r]
        vl, off = vis, offs
    arena = rng.integers(1, 0x10FFFF, (b, pool))
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in (perm, vl, off, arena)]


def phase_k3_vs_plain(rng: np.random.Generator, device) -> dict:
    worst = 0
    cases = []
    for kind, b, n, cap, pool in K3_CASES:
        args = k3_table(rng, kind, b, n, cap, pool, device)
        err = k3_err(args, cap)
        check(err == 0, f"K3 differs from its plain version on {kind} at "
              f"b={b} runs={n} cap={cap}: max abs err {err}")
        worst = max(worst, err)
        cases.append([kind, b, n, cap, int(args[1].long().sum(1).max())])
    return {"phase": "kernel_vs_plain", "kernel": "materialize_runs",
            "shapes": len(cases), "kind_b_runs_cap_maxtotal": cases,
            "max_abs_err": worst, "exact": True}


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
    profile_window: int = 1        # this window is traced: device share


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


class Spy:
    """Stands in for `owner.<name>` inside a with-block and calls through
    to the real function, so its launch count moves as usual. Records each
    call's host seconds and, with keep=True, its arguments (fresh tensors
    that the caller never writes again) for the checks and timings after
    the phase."""

    def __init__(self, owner, name: str, keep: bool = False) -> None:
        self.owner, self.name, self.keep = owner, name, keep
        self.seconds: List[float] = []
        self.args: List[tuple] = []

    def __enter__(self) -> "Spy":
        self.real = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.owner, self.name, self.real)

    # a kernel wrapper counts its launches on its module-level name, which
    # is this stand-in while the block runs: keep the count on the real one
    @property
    def launches(self) -> int:
        return self.real.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.real.launches = value

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        out = self.real(*args, **kwargs)
        self.seconds.append(time.perf_counter() - t)
        if self.keep:
            self.args.append(args)
        return out


class Stamp(Spy):
    """A Spy that also keeps, for each call, the host clock at entry and
    at return and CUDA events recorded just before and just after it. With
    sync=True it waits for the card before it returns, so the host clock
    after it starts from an idle card."""

    def __init__(self, owner, name: str, sync: bool = False) -> None:
        super().__init__(owner, name)
        self.sync = sync
        self.marks: List[tuple] = []

    def __call__(self, *args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t = time.perf_counter()
        ev[0].record()
        out = self.real(*args, **kwargs)
        ev[1].record()
        if self.sync:
            torch.cuda.synchronize()
        self.marks.append((t, time.perf_counter(), *ev))
        return out


def checkout_breakdown(docs, cap: int, device) -> dict:
    """One `checkout_batch_device` call taken apart: `pad_docs` and the
    upload of its arrays (host clock), `fugue_linearize` and K3 (CUDA
    events around each), then the download and decode (host clock, from an
    idle card: the card is synchronized right after K3)."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import merge_kernel as mk
    with Stamp(mk, "pad_docs") as pad, \
            Stamp(mk, "fugue_linearize") as lin, \
            Stamp(kernels, "materialize_runs", sync=True) as k3:
        torch.cuda.synchronize()
        t = time.perf_counter()
        mk.checkout_batch_device(docs, cap=cap, device=device)
        call_s = time.perf_counter() - t
    p0, p1, _, _ = pad.marks[0]
    l0, _, le0, le1 = lin.marks[0]
    _, k1, ke0, ke1 = k3.marks[0]
    return {"cap": cap, "docs": len(docs), "call_ms": 1e3 * call_s,
            "pad_docs_ms": 1e3 * (p1 - p0), "upload_ms": 1e3 * (l0 - p1),
            "fugue_linearize_ms": le0.elapsed_time(le1),
            "k3_ms": ke0.elapsed_time(ke1),
            "download_decode_ms": 1e3 * (t + call_s - k1)}


def run_serve(rng: np.random.Generator, device, cfg: ServeConfig,
              capture: bool):
    """Build the documents and sessions, then drive the flush windows:
    plan through `plan_tails_device` (K2), replay through
    `kernel_fused_replay` (K1). K1's and K2's launch counts are set to 0
    just before the windows and read just after them. Returns (stats, the
    oplogs, each session's frontier after window 0)."""
    from diamond_types_tpu_torch.gpu import flush_fuse as ff
    from diamond_types_tpu_torch.gpu import kernels, xform

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
             "flush_s_per_window": [], "plan_windows": []}
    captured = []                  # (window, bucket size, K1 inputs)

    def flush(w: int) -> float:
        """Plan and replay window w; returns the seconds spent on what is
        not the flush (the host plans of window 0, captures)."""
        t = time.perf_counter()
        n_resolved, n_assembled = len(resolve.seconds), len(assemble.seconds)
        plans, pstats = xform.plan_tails_device(sessions)
        plan_s = time.perf_counter() - t
        resolve_s = sum(resolve.seconds[n_resolved:])
        stats["plan_windows"].append(dict(
            pstats, window=w, extract_ms=1e3 * (plan_s - resolve_s),
            resolve_ms=1e3 * resolve_s,
            assemble_ms=1e3 * sum(assemble.seconds[n_assembled:])))
        check(pstats["device_docs"] > 0,
              f"window {w}: no document was planned on the device")
        excluded = 0.0
        if w == 0:
            t = time.perf_counter()
            host = [s.plan_tail() for s in sessions]
            excluded = time.perf_counter() - t
            stats["host_plan_ms_window0"] = 1e3 * excluded
            for d, (h, p) in enumerate(zip(host, plans)):
                check((h.new_len, sorted(h.frontier), h.synced_to)
                      == (p.new_len, sorted(p.frontier), p.synced_to),
                      f"doc {d}: the device plan's length or frontier "
                      "differs from the host plan's")
        t = time.perf_counter()
        replay = []
        for i, (s, p) in enumerate(zip(sessions, plans)):
            if not p.fits(s.cap):
                s.resync_for(p)
                stats["resyncs"] += 1
            elif p.n_ops == 0:
                s.commit_host(p)
            else:
                replay.append(i)
        stats["plan_s"] += plan_s + time.perf_counter() - t

        wide = w == cfg.wide_window
        for bucket in buckets_by_cap(sessions, replay,
                                     0 if wide else cfg.flush_docs):
            bs = [sessions[i] for i in bucket]
            bp = [plans[i] for i in bucket]
            if capture and (wide or w == 0):
                t = time.perf_counter()
                captured.append((w, len(bucket), ff.pack_bucket(bs, bp)))
                excluded += time.perf_counter() - t
            t = time.perf_counter()
            ok, _fence_s = ff.kernel_fused_replay(bs, bp)
            stats["replay_s"] += time.perf_counter() - t
            stats["buckets"] += 1
            stats["rows"] += sum(p.n_ops for p in bp)
            stats["fence_failures"] += ok.count(False)
        return excluded

    frontiers0 = []                # each session's frontier after window 0
    k1, k2 = kernels.apply_ops_window, kernels.xform_positions
    k1.launches = k2.launches = 0
    with Spy(xform, "resolve_positions") as resolve, \
            Spy(xform, "_assemble_plan") as assemble, \
            Spy(kernels, "xform_positions", keep=capture) as k2_calls:
        for w in range(cfg.windows):
            t = time.perf_counter()
            lv0 = sum(len(ol) for ol in ols)
            for ol, tip in zip(ols, tips):
                b1, b2 = fork(tip), fork(tip)
                for name, br in ((f"fork{w}a", b1), (f"fork{w}b", b2)):
                    k = int(rng.integers(cfg.edits_min, cfg.edits_max + 1))
                    random_edits(rng, ol, ol.get_or_create_agent_id(name),
                                 br, k, cfg)
                tip.merge(ol, ol.version)      # the first agent merges...
                random_edits(rng, ol, ol.get_or_create_agent_id("typist"),
                             tip, 1, cfg)      # ...and edits on top
            stats["lvs"] += sum(len(ol) for ol in ols) - lv0
            stats["edit_s"] += time.perf_counter() - t

            profiling = w == cfg.profile_window
            with (torch.profiler.profile(activities=PROFILED) if profiling
                  else contextlib.nullcontext()) as prof:
                t = time.perf_counter()    # the profiler's start and stop
                excluded = flush(w)        # stay outside the flush time
                stats["flush_s_per_window"].append(
                    time.perf_counter() - t - excluded)
            if profiling:
                stats["profile"] = device_share(
                    prof, stats["flush_s_per_window"][-1], w)
            if w == 0:
                frontiers0 = [list(s.frontier) for s in sessions]

            t = time.perf_counter()
            for d, (s, ol) in enumerate(zip(sessions, ols)):
                tip = ol.checkout_tip()
                check(s.text() == tip.snapshot(), f"window {w}: doc {d} "
                      "text differs from the host checkout")
                tips[d] = tip
            stats["verify_s"] += time.perf_counter() - t
    launches, k2_launches = k1.launches, k2.launches

    wins = stats["plan_windows"]
    resolves = sum(x["batches"] for x in wins)
    fallbacks = sum(x["fallbacks"] for x in wins)
    check(stats["fence_failures"] == 0,
          f"{stats['fence_failures']} fence failures on the main path")
    check(fallbacks == 0, f"{fallbacks} device plans fell back to the host")
    check(launches == stats["buckets"],
          f"K1 launched {launches} times for {stats['buckets']} buckets")
    check(k2_launches == resolves == len(resolve.seconds),
          f"K2 launched {k2_launches} times for {resolves} resolves")
    flush_s = stats["plan_s"] + stats["replay_s"]
    stats.update({"phase": "serve", "docs": cfg.n_docs,
                  "caps_at_build": caps0,
                  "caps_at_end": sorted({s.cap for s in sessions}),
                  "launches": launches, "k2_launches": k2_launches,
                  "resolves": resolves, "fallbacks": fallbacks,
                  "device_docs": sum(x["device_docs"] for x in wins),
                  "host_docs": sum(x["host_docs"] for x in wins),
                  "setup_s": setup_s,
                  "device_plan_ms": 1e3 * stats["plan_s"],
                  "replay_ms_per_bucket": 1e3 * stats["replay_s"]
                  / max(stats["buckets"], 1),
                  "flush_lv_per_s": stats["lvs"] / flush_s,
                  "flush_rows_per_s": stats["rows"] / flush_s})
    stats["captured"] = captured
    stats["k2_args"] = k2_calls.args
    return stats, ols, frontiers0


def device_share(prof, wall_s: float, window: int) -> dict:
    """Device time inside a profiled flush window (kernels, copies and
    sets on the card) against the window's wall time on the host clock,
    with the device events that took the most of it."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return {"window": window, "wall_ms": 1e3 * wall_s,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (1e3 * wall_s),
            "top": [[k[:80], ms, c] for k, ms, c in rows[:8]]}


def run_checkout(ols, frontiers0, device, n_merge: int = 16) -> dict:
    """The device checkout path: every document checked out on the card,
    grouped by pow2 cap, then `merge_device` of the first `n_merge`
    documents from their window-0 frontier. K3's launch count is set to 0
    just before the device calls and read just after them."""
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.gpu import merge_kernel as mk
    from diamond_types_tpu_torch.gpu.flush_fuse import _pow2

    t = time.perf_counter()
    docs = [mk.prepare_doc(ol) for ol in ols]
    prepare_s = time.perf_counter() - t
    groups: Dict[int, List[int]] = {}
    for i, d in enumerate(docs):
        groups.setdefault(_pow2(max(d.total_len, 1)), []).append(i)
    t = time.perf_counter()
    want = [ol.checkout_tip().snapshot() for ol in ols]
    verify_s = time.perf_counter() - t

    k3 = kernels.materialize_runs
    k3.launches = 0
    calls = []
    merge_s = []
    with Spy(kernels, "materialize_runs", keep=True) as k3_calls:
        for cap in sorted(groups):
            idx = groups[cap]
            t = time.perf_counter()
            texts = mk.checkout_batch_device([docs[i] for i in idx],
                                             cap=cap, device=device)
            calls.append({"cap": cap, "docs": len(idx),
                          "runs": max(len(docs[i].parent) for i in idx),
                          "ms": 1e3 * (time.perf_counter() - t)})
            for i, text in zip(idx, texts):
                check(text == want[i] and
                      sorted(docs[i].frontier) == sorted(ols[i].version),
                      f"checkout: doc {i} differs from the host checkout")
        for d in range(n_merge):
            ol = ols[d]
            t = time.perf_counter()
            text, frontier = mk.merge_device(ol, frontiers0[d],
                                             device=device)
            merge_s.append(time.perf_counter() - t)
            br = ol.checkout(frontiers0[d])
            br.merge(ol, ol.version)
            check(text == br.snapshot() and
                  sorted(frontier) == sorted(br.version),
                  f"merge_device: doc {d} differs from the host branch")
    launches = k3.launches
    n_calls = len(calls) + n_merge
    check(launches == n_calls,
          f"K3 launched {launches} times for {n_calls} device checkouts")
    breakdown = [checkout_breakdown([docs[i] for i in groups[cap]], cap,
                                    device) for cap in sorted(groups)]
    return {"phase": "checkout", "docs": len(docs), "launches": launches,
            "checkout_calls": calls, "merges": n_merge,
            "prepare_ms": 1e3 * prepare_s,
            "host_checkout_ms": 1e3 * verify_s,
            "merge_ms": [1e3 * s for s in merge_s],
            "breakdown_per_cap": breakdown,
            "k3_args": k3_calls.args}


def time_ms(fn, reps: int) -> float:
    """call_ms: mean milliseconds per call of `fn`, CUDA events around
    `reps` back-to-back calls after one warm-up call. Where the host work
    of a call is longer than its device work, this is the host's time."""
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


def device_ms(fn, reps: int) -> float:
    """device_ms: the card's own time per call of `fn`. `reps` calls are
    queued behind a sleep on the card (`torch.cuda._sleep`), so the card
    runs them back to back after the host has queued them all; CUDA events
    around them time the kernels and the card's own gaps between launches,
    not the host. The sleep must outlast the host's queueing (checked with
    events around it against the host clock); if it did not, it is
    lengthened and the calls run again. (`torch.profiler` was not used:
    on the H100 it has recorded no event at all in whole sessions.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t)
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.5 * host_ms + 0.5:
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 4
    raise SmokeFailure("the card's sleep never outlasted the host's queueing")


def timings(fn, call_reps: int, device_reps: int) -> dict:
    """call_ms and device_ms of `fn` (see `time_ms` and `device_ms`)."""
    return {"call_ms": time_ms(fn, call_reps),
            "device_ms": device_ms(fn, device_reps)}


def k1_ctas(b: int, cap: int):
    """CTAs one K1 launch uses at (b, cap) by the launcher's grid rule
    (`dt_apply_ops_window_ctas`): derived, not observed; None where the
    library has no such rule."""
    from diamond_types_tpu_torch.gpu import kernels
    fn = getattr(kernels._lib("apply_ops"), "dt_apply_ops_window_ctas", None)
    return None if fn is None else int(fn(b, cap))


def time_captured(captured, mi: int, wide_window: int) -> dict:
    """K1 at every captured main-path bucket: held exactly against its
    plain version on the same inputs, then its call_ms and device_ms; the
    widest bucket's plain version is timed too."""
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
        bp, cap = args[0].shape
        n = args[2].shape[1]
        row = {"window": w, "docs": b, "b": bp, "cap": cap, "n": n,
               "bound_ms": 1e3 * window_bytes(bp, n, cap, mi)
               / HBM_BYTES_PER_S}
        row.update(timings(lambda: kernels.apply_ops_window(*args, mi), 5, 20))
        row["ms"] = row["call_ms"]
        per["wide" if w == wide_window else "flush_docs"].append(row)
        if widest is None or bp * cap > widest[0]["b"] * widest[0]["cap"]:
            widest = (row, args)
    row, args = widest
    row["plain_ms"] = time_ms(
        lambda: kernels.apply_ops_window_plain(*args, mi), 1)
    return {"per_bucket": per, "widest": row, "max_abs_err": worst,
            "buckets_checked": len(captured)}


def time_k2(calls) -> dict:
    """K2 at every main-path resolve: held exactly against its plain
    version, then timed at the widest call (call_ms and device_ms) beside
    its plain version and the library yardstick `torch.cumsum(nv, 1)`."""
    from diamond_types_tpu_torch.gpu import kernels
    worst = max(k2_err(nv, ov) for nv, ov in calls)
    check(worst == 0, f"K2 differs from its plain version at a main-path "
          f"resolve: max abs err {worst}")
    nv, ov = max(calls, key=lambda a: a[0].numel())
    b, n = nv.shape
    out = {"max_abs_err": worst, "calls_checked": len(calls),
           "shape": {"b": b, "n": n},
           "plain_ms": time_ms(
               lambda: kernels.xform_positions_plain(nv, ov), 20),
           "library": timings(lambda: torch.cumsum(nv, 1), 50, 50),
           # nv and ov read once, pos written once, new_len and peak
           "bound_ms": 1e3 * 4 * (3 * b * n + 2 * b) / HBM_BYTES_PER_S}
    out.update(timings(lambda: kernels.xform_positions(nv, ov), 50, 50))
    out["ms"] = out["call_ms"]
    out["library_ms"] = out["library"]["call_ms"]
    return out


def cold_device_ms(fn, reps: int) -> float:
    """device_ms with the L2 cache cold: before each call a buffer of
    L2_FLUSH_BYTES is overwritten on the card, then a sleep on the card
    outlasts the host's queueing of the call; CUDA events around the call
    alone time it. The median of `reps` calls."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    fn()
    ms = []
    for k in range(reps):
        flush.fill_(k)
        torch.cuda._sleep(1 << 22)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(ms))


def k3_ctas(b: int, cap: int):
    """CTAs of one K3 gather launch at (b, cap) by the launcher's grid rule
    (`dt_materialize_runs_ctas`): derived, not observed; None where the
    library has no such rule."""
    from diamond_types_tpu_torch.gpu import kernels
    fn = getattr(kernels._lib("materialize"), "dt_materialize_runs_ctas",
                 None)
    return None if fn is None else int(fn(b, cap))


def k3_bound_ms(vis: torch.Tensor, cap: int) -> float:
    """K3's HBM bound: the run tables read once, the visible text read
    once, the text and the totals written once."""
    b, n = vis.shape
    totals = vis.long().sum(dim=1).clamp(max=cap)
    nbytes = 4 * (3 * b * n + int(totals.sum()) + b * cap + b)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def time_k3(calls, n_batch: int) -> dict:
    """K3 at every main-path checkout (the first n_batch calls are
    `checkout_batch_device` batches, the rest `merge_device`): held
    exactly against its plain version, then each call's call_ms and
    device_ms beside its bound and its gather CTAs (derived); at the
    widest call (b * cap) also device_ms with the L2 cold and the plain
    version's call_ms."""
    from diamond_types_tpu_torch.gpu import kernels, linearize
    worst = max(k3_err(list(args[:4]), args[4]) for args in calls)
    check(worst == 0, f"K3 differs from its plain version at a main-path "
          f"checkout: max abs err {worst}")
    per = []
    for k, (perm, vis, off, arena, cap) in enumerate(calls):
        b, n = perm.shape
        row = {"call": "batch" if k < n_batch else "merge", "b": b,
               "runs": n, "cap": cap, "bound_ms": k3_bound_ms(vis, cap),
               "gather_ctas_derived": k3_ctas(b, cap)}
        row.update(timings(lambda: kernels.materialize_runs(
            perm, vis, off, arena, cap), 20, 20))
        per.append(row)
    k = max(range(len(calls)),
            key=lambda i: calls[i][0].shape[0] * calls[i][4])
    perm, vis, off, arena, cap = calls[k]
    b, n = perm.shape
    out = {"max_abs_err": worst, "calls_checked": len(calls),
           "shape": {"b": b, "runs": n, "cap": cap, "pool": arena.shape[1]},
           "plain_ms": time_ms(lambda: linearize.materialize(
               perm, vis, off, arena, cap), 5),
           "library_ms": None, "bound_ms": per[k]["bound_ms"],
           "call_ms": per[k]["call_ms"], "device_ms": per[k]["device_ms"],
           "device_ms_cold_l2": cold_device_ms(
               lambda: kernels.materialize_runs(perm, vis, off, arena, cap),
               20),
           "per_call": per}
    out["ms"] = out["call_ms"]
    return out


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
    def rng(phase: int) -> np.random.Generator:
        return np.random.default_rng([args.seed, phase])

    device = torch.device("cuda")
    try:
        build = phase_build()
        build.update({"torch": torch.__version__, "cuda": torch.version.cuda})
        emit(build)
        t = time.perf_counter()
        kvp = phase_kernel_vs_plain(rng(1), device)
        kvp["seconds"] = time.perf_counter() - t
        emit(kvp)
        k2p = phase_k2_vs_plain(rng(2), device)
        emit(k2p)
        k3p = phase_k3_vs_plain(rng(3), device)
        emit(k3p)
        cfg = ServeConfig()
        serve, ols, frontiers0 = run_serve(rng(4), device, cfg, capture=True)
        timing = time_captured(serve.pop("captured"), cfg.max_ins,
                               cfg.wide_window)
        k2 = time_k2(serve.pop("k2_args"))
        per = timing["per_bucket"]
        serve["k1_flush_docs_buckets"] = [
            {k: r[k] for k in ("window", "docs", "cap", "n", "call_ms",
                               "device_ms")}
            for r in per["flush_docs"]]
        serve["k1_wide_buckets"] = per["wide"]
        serve["plain_ms_widest"] = timing["widest"]["plain_ms"]
        serve["buckets_checked_against_plain"] = timing["buckets_checked"]
        widest = timing["widest"]
        serve["k1_ctas_derived"] = {
            "rule": "b * ceil(cap / 512), the launcher's grid",
            "b8_cap32768": k1_ctas(8, 32768),
            "widest": k1_ctas(widest["b"], widest["cap"])}
        # K1's device time as a share of the window's flush wall time
        # (plan + replay + fence), for the two windows whose buckets were
        # all captured and timed
        flush_s = serve["flush_s_per_window"]
        serve["k1_share_of_flush"] = {
            "window0": sum(r["device_ms"] for r in per["flush_docs"])
            / (1e3 * flush_s[0]),
            "wide_window": sum(r["device_ms"] for r in per["wide"])
            / (1e3 * flush_s[cfg.wide_window])}
        emit(serve)
        checkout = run_checkout(ols, frontiers0, device)
        k3 = time_k3(checkout.pop("k3_args"),
                     len(checkout["checkout_calls"]))
        checkout["k3_per_call"] = k3.pop("per_call")
        checkout["k3_gather_ctas_rule"] = (
            "b * ceil(cap / 512), the launcher's grid; derived, not observed")
        emit(checkout)
        timed = ("ms", "call_ms", "device_ms", "plain_ms", "bound_ms",
                 "library_ms")
        kerns = [
            {"name": "apply_ops_window", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/apply_ops.cu",
             "replaces": "diamond_types_tpu/tpu/pallas_kernels.py:99",
             "launches": serve["launches"],
             "max_abs_err": max(kvp["max_abs_err"], timing["max_abs_err"]),
             "bound_by": "bytes", "library_ms": None,
             **{k: widest[k] for k in timed if k in widest},
             "shape": {k: widest[k] for k in ("b", "cap", "n")},
             "flush_docs_device_ms": [r["device_ms"]
                                      for r in per["flush_docs"]]},
            {"name": "xform_positions", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/xform_positions.cu",
             "replaces": "diamond_types_tpu/tpu/pallas_kernels.py:315",
             "launches": serve["k2_launches"],
             "max_abs_err": max(k2p["max_abs_err"], k2["max_abs_err"]),
             "bound_by": "bytes", **{k: k2[k] for k in timed},
             "shape": k2["shape"],
             "library": {"call": "torch.cumsum(nv, 1)", **k2["library"]}},
            {"name": "materialize_runs", "route": "cuda",
             "source": "diamond_types_tpu_torch/csrc/materialize.cu",
             "replaces": "diamond_types_tpu/tpu/pallas_kernels.py:211",
             "launches": checkout["launches"],
             "max_abs_err": max(k3p["max_abs_err"], k3["max_abs_err"]),
             "bound_by": "bytes", **{k: k3[k] for k in timed},
             "device_ms_cold_l2": k3["device_ms_cold_l2"],
             "shape": k3["shape"],
             "merge_device_ms": [r["device_ms"]
                                 for r in checkout["k3_per_call"]
                                 if r["call"] == "merge"]}]
        card = nvidia_smi_line()
        emit({"kernels": kerns})
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
