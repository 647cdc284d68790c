"""Flight recorder: a bounded ring of structured events.

Counters say *how many* fencing rejections happened; the flight
recorder says *which docs, against which epochs, in what order* — the
last N interesting state transitions (lease moves, fencing rejections,
circuit opens, evictions, queue-bound violations) kept in memory and
dumped on demand via `GET /debug/events` or attached to a failing
soak/bench report. Events are tiny dicts with a monotone `seq` so a
dump is totally ordered even across readers.

Recording when disabled is a single flag check with no allocation —
the same zero-overhead contract as obs.trace.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional


class FlightRecorder:
    def __init__(self, capacity: int = 512, enabled: bool = True) -> None:
        self.capacity = max(int(capacity), 1)
        self.enabled = enabled
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._seq = 0
        self.recorded = 0

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._seq += 1
            self.recorded += 1
            ev = {"seq": self._seq,
                  "t": round(time.monotonic(), 6),
                  "kind": kind}
            ev.update(fields)
            self._buf.append(ev)

    def dump(self, n: Optional[int] = None) -> list:
        with self._lock:
            evs = list(self._buf)
        return evs[-n:] if n else evs

    def dump_since(self, since: int) -> list:
        """Events with seq > since — incremental tailing for
        `GET /debug/events?since=` / `obs-watch` polling. The ring may
        have dropped events between `since` and the oldest buffered
        one; callers detect the gap when the first returned seq is not
        since + 1."""
        with self._lock:
            return [ev for ev in self._buf if ev["seq"] > since]

    def tail(self, n: int = 50) -> list:
        return self.dump(n)

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "capacity": self.capacity,
                    "recorded": self.recorded,
                    "buffered": len(self._buf),
                    "dropped": self.recorded - len(self._buf)}
