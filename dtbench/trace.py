"""The traced run: device activity from torch.profiler, the host's threads
sampled beside it, and their reduction to busy time, kernel time by name,
and the longest idle gaps with what the host was doing in each.

Only device activity is traced (kernels, copies and sets on the card, and
the CUDA runtime calls that start them): tracing every host op would
multiply the window's wall time (as the port's `chip_smoke.py` found). What
the host was doing comes from a sampler thread instead, which every 5 ms
reads each thread's innermost frame inside the program's package. Both
clocks are the profiler's, `time.time_ns()`.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

PROGRAM = "diamond_types_tpu_torch"
SAMPLE_S = 0.005
# innermost frames of a thread that waits for work, not for a lock
_WAITING = {"threading": {"wait", "_wait_for_tstate_lock"},
            "queue": {"get"}}


class HostSampler:
    """Samples, for every live thread, the innermost frame in the program's
    package (or the harness's, else "python") as "module.function"."""

    def __init__(self, period_s: float = SAMPLE_S) -> None:
        self.period_s = period_s
        self.samples: List[Tuple[int, List[str]]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="dtbench-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.period_s):
            now = time.time_ns()
            labels = []
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                label = _label(frame)
                if label is not None:
                    labels.append(label)
            self.samples.append((now, labels))


def _label(frame) -> Optional[str]:
    """The innermost frame of the program (or of the harness) on a stack;
    None for a thread that is only waiting on a queue, an event or a
    condition."""
    if frame.f_globals.get("__name__") in _WAITING \
            and frame.f_code.co_name in _WAITING[frame.f_globals["__name__"]]:
        return None
    f, harness = frame, None
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith(PROGRAM):
            return f"{mod[len(PROGRAM) + 1:]}.{f.f_code.co_name}"
        if harness is None and mod.startswith("dtbench"):
            harness = f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return harness


class DeviceTrace:
    """torch.profiler over the window (device activity only) with the host
    sampler beside it."""

    def __init__(self) -> None:
        import torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.sampler = HostSampler()
        self.t0_ns = self.t1_ns = 0

    def __enter__(self) -> "DeviceTrace":
        self._prof.__enter__()
        self.sampler.start()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.sampler.stop()
        self._prof.__exit__(*exc)

    def device_events(self) -> List[Tuple[str, int, int]]:
        """(name, start_ns, end_ns) of every device event in the window."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            s = max(e.start_ns(), self.t0_ns)
            t = min(e.start_ns() + e.duration_ns(), self.t1_ns)
            if t > s:
                out.append((e.name(), s, t))
        return out

    def reduce(self, top: int = 10) -> dict:
        """busy_s and window_s, seconds by kernel name, and the breakdown:
        the device operations that took most time and the longest idle
        gaps, each named by what the host threads were doing in it."""
        events = self.device_events()
        window_s = (self.t1_ns - self.t0_ns) / 1e9
        busy = union(sorted((s, t) for _n, s, t in events))
        busy_s = sum(t - s for s, t in busy) / 1e9
        by_name: Dict[str, float] = collections.defaultdict(float)
        for name, s, t in events:
            by_name[name] += (t - s) / 1e9
        gaps = idle_gaps(busy, self.t0_ns, self.t1_ns)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[host_label(self.sampler.samples, s, t), (t - s) / 1e9]
                 for s, t in gaps[:top]]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        # the profiler's own sum by key, beside the union: the sum can only
        # exceed the union (overlapping streams), never fall short of it
        by_key = device_share(self._prof, window_s, 0)
        return {"busy_s": busy_s, "window_s": window_s,
                "busy_s_by_key": by_key["device_busy_ms"] / 1e3,
                "kernels": dict(by_name),
                "breakdown": {"device_ops": [[k[:120], v] for k, v in ops],
                              "idle_gaps": named}}


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge sorted (start, end) intervals into disjoint ones."""
    out: List[Tuple[int, int]] = []
    for s, t in intervals:
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def idle_gaps(busy: List[Tuple[int, int]], t0: int,
              t1: int) -> List[Tuple[int, int]]:
    """The stretches of [t0, t1] that no busy interval covers."""
    gaps, cur = [], t0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def idle_share(busy_s: float, window_s: float) -> float:
    """The share of the window, in %, with nothing on the device."""
    return 100.0 * (1.0 - busy_s / window_s)


def host_label(samples, s: int, t: int) -> str:
    """The host activity sampled most often inside [s, t], "host.idle"
    when only waiting threads were seen, "unsampled" for a gap between
    two samples."""
    count: Dict[str, int] = collections.Counter()
    seen = False
    for ts, labels in samples:
        if s <= ts <= t:
            seen = True
            count.update(labels)
    if not seen:
        return "unsampled"
    if not count:
        return "host.idle"
    return count.most_common(1)[0][0]


# Copied from the port's chip_smoke.py (`device_share`): device time by
# profiler key against the window's wall time, the top events beside it.
def device_share(prof, wall_s: float, window: int) -> dict:
    """Device time inside a profiled flush window (kernels, copies and
    sets on the card) against the window's wall time on the host clock,
    with the device events that took the most of it."""
    import torch
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return {"window": window, "wall_ms": 1e3 * wall_s,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (1e3 * wall_s),
            "top": [[k[:80], ms, c] for k, ms, c in rows[:8]]}
