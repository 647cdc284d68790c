"""The merge tier (`tiers/merge_tier.py`) with every flush traced, for
`python3 -m dtbench.phases`: `MergeScheduler.trace_flushes` on, so each
flush opens its span as a forced root with its phases' `bank.*` spans under
it, and the tracer's ring sized to hold the window's spans. No
configuration names this tier; `dtbench.phases` puts it in a cell's place.

Configuration keys: merge_tier's, and trace_spans (0: no flush span, the
tier is merge_tier's as it is) and span_ring (the ring's capacity).
"""

from __future__ import annotations

from dtbench import phases
from dtbench.tiers.merge_tier import Tier as MergeTier


class Tier(MergeTier):
    def __init__(self, config: dict, device, on_commit) -> None:
        super().__init__(config, device, on_commit)
        self.trace_spans = bool(config.get("trace_spans", 1))
        if self.trace_spans:
            self.sched.trace_flushes = True
            self.obs.tracer.resize(config["span_ring"])
        phases.TIERS.append(self)
