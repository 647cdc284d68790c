"""Device-time profiling: wall vs. device seconds per flush, and
host<->device transfer bytes.

A process-wide `PROFILER` singleton (disabled by default) keeps its
hooks (in gpu/, parallel/mesh.py and serve/) down to one attribute
check when profiling is off. serve/driver.py enables it
for its runs (`run_serve_bench`) so the report can say how much of each
flush was spent waiting on the device (the length fetch that fences a
replay, or a `torch.cuda.synchronize` after a per-doc sync) versus host
bookkeeping. The always-on per-phase times of a flush are ServeMetrics'
(`flush_phases`).
"""

from __future__ import annotations

import threading
from typing import Dict


class DeviceProfiler:
    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._shard: Dict[int, dict] = {}
        self.transfers = 0
        self.transfer_bytes = 0
        self._transfer_detail: Dict[tuple, list] = {}
        self._fused = {"device_calls": 0, "docs": 0,
                       "wall_s": 0.0, "device_s": 0.0}
        self._window = {"dispatches": 0, "docs": 0, "shards": 0,
                        "staged_bytes": 0,
                        "wall_s": 0.0, "device_s": 0.0}

    def reset(self) -> None:
        with self._lock:
            self._shard = {}
            self.transfers = 0
            self.transfer_bytes = 0
            self._transfer_detail = {}
            self._fused = {"device_calls": 0, "docs": 0,
                           "wall_s": 0.0, "device_s": 0.0}
            self._window = {"dispatches": 0, "docs": 0, "shards": 0,
                            "staged_bytes": 0,
                            "wall_s": 0.0, "device_s": 0.0}

    def observe_flush(self, shard: int, wall_s: float,
                      device_s: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            s = self._shard.setdefault(
                int(shard), {"flushes": 0, "wall_s": 0.0, "device_s": 0.0})
            s["flushes"] += 1
            s["wall_s"] += wall_s
            s["device_s"] += device_s

    def observe_fused(self, shard: int, wall_s: float, device_s: float,
                      n_docs: int) -> None:
        """One fused bucket replay: `wall_s` is the whole dispatch +
        commit, `device_s` the completion-fence wait (the length fetch)
        — the wall-vs-device attribution for the fused path. Also counts
        toward the shard's flush totals so per_shard rows stay comparable
        between fused and per-doc flushes."""
        if not self.enabled:
            return
        with self._lock:
            f = self._fused
            f["device_calls"] += 1
            f["docs"] += int(n_docs)
            f["wall_s"] += wall_s
            f["device_s"] += device_s
            s = self._shard.setdefault(
                int(shard), {"flushes": 0, "wall_s": 0.0, "device_s": 0.0})
            s["flushes"] += 1
            s["wall_s"] += wall_s
            s["device_s"] += device_s

    def observe_window(self, wall_s: float, device_s: float,
                       n_docs: int, n_shards: int,
                       staged_bytes: int = 0) -> None:
        """One mesh flush-window dispatch: `n_docs` docs from
        `n_shards` shards replayed in one K1 launch per device slice
        (scheduler._flush_window). `staged_bytes` is the host->device
        byte count the window's state staging actually paid (0 when
        the arena fast path or the device-side gather kept rows
        resident).
        Kept SEPARATE from the per-shard flush totals — a window is
        cross-shard by construction, so attributing its wall time to
        any one shard would double-count against the per_shard rows."""
        if not self.enabled:
            return
        with self._lock:
            w = self._window
            w["dispatches"] += 1
            w["docs"] += int(n_docs)
            w["shards"] += int(n_shards)
            w["staged_bytes"] += int(staged_bytes)
            w["wall_s"] += wall_s
            w["device_s"] += device_s

    def note_transfer(self, nbytes: int, rung: str = "",
                      purpose: str = "") -> None:
        """Count one host->device transfer. `rung` names the ladder
        rung that paid it (session/fused/mesh/pallas), `purpose` what
        moved: "stage" (resident doc state), "plan" (the window's op
        arrays — always host-built), or "warmup" (ahead-of-time
        compiles). Untagged calls keep the legacy totals working."""
        if not self.enabled:
            return
        with self._lock:
            self.transfers += 1
            self.transfer_bytes += int(nbytes)
            if rung or purpose:
                d = self._transfer_detail.setdefault(
                    (rung or "other", purpose or "other"), [0, 0])
                d[0] += 1
                d[1] += int(nbytes)

    def snapshot(self) -> dict:
        with self._lock:
            per_shard = {
                str(k): {"flushes": v["flushes"],
                         "wall_s": round(v["wall_s"], 6),
                         "device_s": round(v["device_s"], 6)}
                for k, v in sorted(self._shard.items())}
            wall = sum(v["wall_s"] for v in self._shard.values())
            dev = sum(v["device_s"] for v in self._shard.values())
            f = self._fused
            calls = f["device_calls"]
            fused = {"device_calls": calls, "docs": f["docs"],
                     "occupancy": round(f["docs"] / calls, 4)
                     if calls else 0.0,
                     "wall_s": round(f["wall_s"], 6),
                     "device_sync_s": round(f["device_s"], 6),
                     "device_fraction": round(
                         f["device_s"] / f["wall_s"], 4)
                     if f["wall_s"] else 0.0}
            w = self._window
            nw = w["dispatches"]
            window = {"dispatches": nw, "docs": w["docs"],
                      "docs_per_dispatch": round(w["docs"] / nw, 4)
                      if nw else 0.0,
                      "mean_shards": round(w["shards"] / nw, 4)
                      if nw else 0.0,
                      "staged_bytes": w["staged_bytes"],
                      "staged_bytes_per_window": round(
                          w["staged_bytes"] / nw, 2) if nw else 0.0,
                      "wall_s": round(w["wall_s"], 6),
                      "device_sync_s": round(w["device_s"], 6),
                      "device_fraction": round(
                          w["device_s"] / w["wall_s"], 4)
                      if w["wall_s"] else 0.0}
            detail = {f"{r}.{p}": {"transfers": v[0], "bytes": v[1]}
                      for (r, p), v
                      in sorted(self._transfer_detail.items())}
            return {"enabled": self.enabled,
                    "flush_wall_s": round(wall, 6),
                    "device_sync_s": round(dev, 6),
                    "device_fraction": round(dev / wall, 4) if wall else 0.0,
                    "transfers": self.transfers,
                    "transfer_bytes": self.transfer_bytes,
                    "transfer_detail": detail,
                    "fused": fused,
                    "mesh_window": window,
                    "per_shard": per_shard}


PROFILER = DeviceProfiler(enabled=False)


def note_transfer(nbytes: int, rung: str = "", purpose: str = "") -> None:
    if PROFILER.enabled:
        PROFILER.note_transfer(nbytes, rung=rung, purpose=purpose)
