"""Observability: structured counters around the merge kernel.

Capability mirror of the reference's thread-local op counters sketched in
the merge hot loops (reference: src/listmerge/merge.rs:311-314,
advance_retreat.rs:73-76). The tracker bumps `GLOBAL_COUNTERS`.
"""

from __future__ import annotations

import time
from collections import Counter
from contextlib import contextmanager
from typing import Dict


class MergeCounters:
    """Structured counters around the merge kernel."""

    def __init__(self) -> None:
        self.counts: Counter = Counter()
        self.timings: Dict[str, float] = {}

    def bump(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    @contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + \
                (time.perf_counter() - t0)

    def snapshot(self) -> Dict:
        return {"counts": dict(self.counts), "timings": dict(self.timings)}


GLOBAL_COUNTERS = MergeCounters()
