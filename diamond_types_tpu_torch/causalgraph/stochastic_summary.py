"""Probabilistic common-version discovery.

Capability mirror of the reference's stochastic summary sketch (reference:
src/list/stochastic_summary.rs:8-25): when two peers' histories are huge,
sending a full VersionSummary costs bandwidth proportional to the number of
agent runs. Instead, peers exchange a small random sample of their known
(agent, seq) versions per round; each round either finds common versions
(bounding the diff) or shrinks the candidate range — trading round-trips for
bandwidth.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

from .causal_graph import CausalGraph

Sample = List[Tuple[str, int]]  # [(agent_name, seq)]


def sample_versions(cg: CausalGraph, k: int = 16,
                    rng: Optional[random.Random] = None) -> Sample:
    """Uniformly sample k known versions, biased to include the frontier
    (the most likely useful anchors)."""
    rng = rng or random.Random(0)
    out: Sample = list(cg.local_to_remote_frontier(cg.version))
    n = len(cg)
    if n == 0:
        return out
    for _ in range(max(0, k - len(out))):
        lv = rng.randrange(n)
        agent, seq = cg.agent_assignment.local_to_agent_version(lv)
        out.append((cg.agent_assignment.get_agent_name(agent), seq))
    return out


def common_versions_from_sample(cg: CausalGraph, sample: Sample) -> List[int]:
    """Which of the remote's sampled versions do we know? Returns the
    dominator frontier of the known subset — a lower bound on the true
    common version that tightens with more rounds."""
    known = []
    for (name, seq) in sample:
        agent = cg.agent_assignment.try_get_agent(name)
        if agent is None:
            continue
        lv = cg.agent_assignment.try_agent_version_to_lv(agent, seq)
        if lv is not None:
            known.append(lv)
    return cg.graph.find_dominators(sorted(set(known)))


def estimate_common_frontier(local: CausalGraph, remote: CausalGraph,
                             rounds: int = 3, k: int = 16,
                             seed: int = 0) -> List[int]:
    """Simulated protocol: `rounds` sample exchanges, accumulating the best
    known lower bound of the common frontier."""
    rng = random.Random(seed)
    best: List[int] = []
    for _ in range(rounds):
        sample = sample_versions(remote, k, rng)
        found = common_versions_from_sample(local, sample)
        best = local.graph.find_dominators_2(best, found)
    return best
