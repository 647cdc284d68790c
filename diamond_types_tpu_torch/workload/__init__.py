"""Declarative workload programs + the scenario harness.

The bench/soak drivers each hard-code one traffic shape; this package
makes the shape data. A `Scenario` (spec.py) composes seeded arrival
processes (arrivals.py: Poisson, bursty/flash-crowd, ramp),
doc-popularity laws (popularity.py: Zipf, hot-set rotation), a
read:write mix, session churn, bulk imports behind interactive
traffic, multi-tenant namespaces, and an optional bank-churn lane (the
tiered-residency scale run). The runner (runner.py) drives
serve+replicate+read together against the live SLO engine and emits
one versioned scorecard (obs/scorecard.py) per run, so regressions are
one `cli scorecard-diff` away.

Everything is deterministic from the scenario seed: schedules are
generated on a virtual clock before any traffic flows, so the same
spec + seed replays the same event sequence byte-identically.
"""

from __future__ import annotations

from .arrivals import Bursty, Poisson, Ramp, make_arrivals
from .popularity import HotSetRotation, Uniform, Zipf, make_popularity
from .runner import run_scenario
from .spec import SCENARIOS, Scenario, get_scenario, register

__all__ = [
    "Poisson", "Bursty", "Ramp", "make_arrivals",
    "Zipf", "HotSetRotation", "Uniform", "make_popularity",
    "Scenario", "SCENARIOS", "get_scenario", "register",
    "run_scenario",
]
