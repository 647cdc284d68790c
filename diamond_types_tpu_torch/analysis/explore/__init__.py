"""Protocol model checker: exhaustive interleaving exploration of the
real lease/quorum/fencing code under a virtual scheduler.

Entry points:
  explore(scenario, depth=...)  -> report dict (violations minimized,
                                   replayable)
  replay_trace(trace_doc)       -> re-execute an emitted trace
  SCENARIOS / MUTATIONS         -> the bounded models and the seeded
                                   bugs that prove detection power
See CHECKING.md for the state model and the soundness boundary.
"""

from .engine import explore, last_report, publish_report, replay_trace
from .invariants import ALL_INVARIANTS, InvariantChecker, Violation
from .model import SCENARIOS, Action, Scenario, independent
from .mutations import MUTATIONS, Mutation
from .world import SimWorld

__all__ = [
    "explore", "replay_trace", "publish_report", "last_report",
    "SCENARIOS", "Scenario", "Action", "independent",
    "MUTATIONS", "Mutation",
    "ALL_INVARIANTS", "InvariantChecker", "Violation",
    "SimWorld",
]
