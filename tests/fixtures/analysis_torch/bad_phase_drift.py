"""Seeded dt-lint fixture for the port: flush-phase drift.

Records a phase that serve.metrics.FLUSH_PHASES does not declare, once
through `record_phases` and once through the FlushClock's `enter_phase`
(record_phases would raise on it; the phase prom family never carries it).
Declared phases beside them pass. Never imported; parsed by the lint
engine only.
"""


class FixtureBank:
    def flush(self, clock):
        clock.enter_phase("extract")
        clock.enter_phase("replay")
        self.metrics.record_phases(0, {"pack": 0.1, "fence_wait": 0.2})
