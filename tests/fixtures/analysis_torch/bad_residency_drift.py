"""Seeded dt-lint fixture for the port: residency-timer drift.

Records a residency timer that serve.metrics.RESIDENCY_TIMERS does not
declare (record_residency would raise on it). The declared timers beside
it pass, and so does a timer held in a variable, which the rule cannot
see into. Never imported; parsed by the lint engine only.
"""


class FixtureStore:
    def save(self, timer, dt):
        self.metrics.record_residency("save", dt)
        self.metrics.record_residency("save_hold", dt)
        self.metrics.record_residency("compact", dt)
        self.metrics.record_residency(timer, dt)
