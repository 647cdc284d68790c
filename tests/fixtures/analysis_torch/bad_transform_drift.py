"""Seeded dt-lint fixture for the port: transform-counter drift.

Records a transform counter that serve.metrics.TRANSFORM_KEYS does not
declare (record_transform would raise on it; no prom family carries it).
The declared counters beside it pass, and so does a dict splat, which the
rule cannot see into. Never imported; parsed by the lint engine only.
"""


class FixtureBank:
    def resolve(self, st):
        self.metrics.record_transform(0, batches=1, linearized_kernel=1,
                                      linearized_plain=0)
        self.metrics.record_transform(0, linearized_gpu=1)
        self.metrics.record_transform(0, **st)
