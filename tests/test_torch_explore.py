"""The port's protocol model checker (`analysis/explore/`) against the JAX
package's.

The checker is a copy that drives the port's replication code (its
`ReplicaNode`, `LeaseManager`, quorum and anti-entropy); `world.py` reads
a node's text through the C++ tracker (`Branch.merge_reference`), where
JAX's calls `checkout_tip()`. Each of the six scenarios is explored once
per package at the CLI's default depth: both must be ok and complete with
the same state count. `--mutate` must detect 7 of 7 seeded bugs in both,
a minimised trace must replay in both, and the `dt-explore` exit codes
(0, 1, 2) must be JAX's.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import diamond_types_tpu.analysis.explore as jx
import diamond_types_tpu.tools.cli as jcli
import diamond_types_tpu_torch.analysis.explore as tx
import diamond_types_tpu_torch.tools.cli as tcli

pytestmark = pytest.mark.analysis

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = "diamond_types_tpu", "diamond_types_tpu_torch"
COPIED = ("analysis/explore/__init__.py", "analysis/explore/engine.py",
          "analysis/explore/invariants.py", "analysis/explore/model.py",
          "analysis/explore/mutations.py")
# the states each scenario reaches at depth 4 (the CLI's default), in both
# packages
STATES = {"crash-recovery": 295, "handoff": 5290, "migration": 2361,
          "renewal": 91, "tiebreak": 212, "writer-group": 1957}
# keys of a report that do not depend on the host's speed
STABLE = ("scenario", "depth", "states", "transitions", "dedup_hits",
          "sleep_skips", "complete", "truncated", "ok", "violations",
          "invariants", "mutation")


@pytest.mark.parametrize("rel", COPIED)
def test_explore_module_is_a_byte_identical_copy(rel):
    assert (REPO / PORT / rel).read_bytes() == (REPO / JAX / rel).read_bytes()


def test_world_differs_only_in_its_text_read():
    a = (REPO / JAX / "analysis/explore/world.py").read_text()
    b = (REPO / PORT / "analysis/explore/world.py").read_text()
    cut = "    def text_of("
    nxt = "    def frontier_of("
    assert b[:b.index(cut)] == a[:a.index(cut)]
    assert b[b.index(nxt):] == a[a.index(nxt):]
    mine = b[b.index(cut):b.index(nxt)]
    assert "merge_reference" in mine and "checkout" not in mine.replace(
        "checkout_tip()` may", "")


def test_scenarios_and_mutations_are_jaxs():
    assert sorted(tx.SCENARIOS) == sorted(jx.SCENARIOS) == sorted(STATES)
    assert sorted(tx.MUTATIONS) == sorted(jx.MUTATIONS)
    assert len(tx.MUTATIONS) == 7
    assert tx.ALL_INVARIANTS == jx.ALL_INVARIANTS


@pytest.mark.parametrize("scenario", sorted(STATES))
def test_scenario_explores_as_in_jax(scenario):
    j = jx.explore(scenario, depth=4)
    t = tx.explore(scenario, depth=4)
    assert t["ok"] and t["complete"], t["violations"]
    assert t["states"] == STATES[scenario]
    assert {k: t[k] for k in STABLE} == {k: j[k] for k in STABLE}


def test_text_reads_stay_on_the_host_after_the_policy_prefers_zone(
        monkeypatch):
    """Once the engine policy prefers the zone engine, `checkout_tip()`
    would merge on CUDA (and raise here, with no card); the explorer's
    text reads go through the C++ tracker and never ask the policy."""
    from diamond_types_tpu_torch.listmerge import policy
    from diamond_types_tpu_torch.text import branch

    def never(*_a, **_k):
        raise AssertionError("a checkout went to the merge engines")

    monkeypatch.setattr(policy.GLOBAL, "choose", lambda *_a: policy.ZONE)
    monkeypatch.setattr(branch.Branch, "merge", never)
    rep = tx.explore("renewal", depth=3)
    assert rep["ok"] and rep["complete"]


def test_mutate_detects_every_mutation_in_both(capsys):
    docs = []
    for cli in (jcli, tcli):
        assert cli.main(["dt-explore", "--mutate", "--json"]) == 0
        docs.append(json.loads(capsys.readouterr().out))
    j, t = docs
    assert t["detected"] == t["total"] == 7 and t["ok"]
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in t["results"]]
    assert strip == [{k: v for k, v in r.items() if k != "wall_s"}
                     for r in j["results"]]


@pytest.mark.parametrize("pkg", [jx, tx], ids=["jax", "port"])
def test_minimized_trace_replays(pkg):
    m = pkg.MUTATIONS["promise-persist-skip"]
    rep = pkg.explore(m.scenario, depth=m.depth, mutation=m)
    v = rep["violations"][0]
    doc = {"scenario": m.scenario, "invariants": rep["invariants"],
           "invariant": v["invariant"],
           "minimized_trace": v["minimized_trace"]}
    with_mut = pkg.replay_trace(doc, mutation=m)
    assert with_mut["ok"] and with_mut["invariant"] == v["invariant"]
    clean = pkg.replay_trace(doc)
    assert not clean["ok"] and not clean["violation"]


def test_exit_codes_are_jaxs(monkeypatch, capsys):
    """0 for a clean scenario, 1 for a mutation the checker misses, 2 for an
    unknown scenario or invariant; in-process through both CLIs (the
    reports they publish are put back after the test)."""
    import diamond_types_tpu.analysis.explore.engine as jengine
    import diamond_types_tpu_torch.analysis.explore.engine as tengine
    for engine in (jengine, tengine):
        monkeypatch.setattr(engine, "_last_report", engine._last_report)
    for cli, pkg in ((jcli, jx), (tcli, tx)):
        assert cli.main(["dt-explore", "--scenario", "tiebreak",
                         "--depth", "3"]) == 0
        assert cli.main(["dt-explore", "--scenario", "nope"]) == 2
        assert cli.main(["dt-explore", "--scenario", "renewal",
                         "--invariant", "no-such"]) == 2
        m = pkg.MUTATIONS["promise-persist-skip"]
        inert = pkg.Mutation(m.name, m.scenario, ("no-such-invariant",),
                             m.description, apply_node=m.apply_node,
                             apply_world=m.apply_world, depth=m.depth)
        monkeypatch.setattr(pkg, "MUTATIONS", {"inert": inert})
        assert cli.main(["dt-explore", "--mutate"]) == 1
    out = capsys.readouterr()
    assert out.err.count("unknown scenario 'nope'") == 2


def test_cli_subprocess_gate():
    r = subprocess.run([sys.executable, "-m", f"{PORT}.tools.cli",
                        "dt-explore", "--scenario", "renewal", "--depth",
                        "4", "--json"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["ok"] and doc["complete"] and doc["states"] == 91
