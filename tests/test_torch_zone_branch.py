"""`Branch.merge`'s engine selection in the port against the JAX package's.

For each environment (no switch, DT_TPU_ZONE, DT_TPU_NO_NATIVE,
DT_TPU_PLAN2) the same merges go through a JAX-package Branch and a port
Branch (device engines on `device="cpu"`): equal `last_merge_engine`,
text, version and collision count. With the native library the default is
the measured policy between the C++ tracker and the zone engine; both
packages pick the same engine for the same recorded rates. The port's
deliberate divergence is pinned: a policy-selected zone merge that fails
propagates, where the JAX package demotes the zone engine and falls back
to the tracker.
"""

import pytest
import torch

from diamond_types_tpu.listmerge import policy as jpolicy
from diamond_types_tpu.text.branch import Branch as JaxBranch
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import zone_kernel as tk
from diamond_types_tpu_torch.listmerge import policy as tpolicy
from diamond_types_tpu_torch.text.branch import Branch

from torch_parity import zone_history

ENVS = {"none": {}, "zone": {"DT_TPU_ZONE": "1"},
        "no_native": {"DT_TPU_NO_NATIVE": "1"}, "plan2": {"DT_TPU_PLAN2": "1"}}
ENGINE = {"none": "tracker", "zone": "zone", "no_native": "python",
          "plan2": "plan2"}


@pytest.fixture(autouse=True)
def _fresh_port_policy(monkeypatch):
    monkeypatch.setattr(tpolicy, "GLOBAL", tpolicy.EnginePolicy())


def _merge_both(jol, tol, start=None):
    """A branch in each package (fresh, or the `start` pair) merging the
    tip. `OpLog.checkout` merges with no device, so a start branch is made
    before a switch that selects a device engine is set."""
    jb, tb = start if start is not None else (JaxBranch(), Branch())
    jb.merge(jol, jol.version)
    tb.merge(tol, tol.version, device="cpu")
    return jb, tb


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("env", list(ENVS))
def test_branch_merge_engine_matches_jax(monkeypatch, env, seed):
    jol, tol = zone_history([JaxOpLog, OpLog], 600 + seed, n_edits=60,
                            agents=("alice", "bob", "carol"))
    mid = [len(tol) // 2]
    starts = [None, (jol.checkout(mid), tol.checkout(mid))]
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    for start in starts:
        jb, tb = _merge_both(jol, tol, start)
        assert tb.last_merge_engine == jb.last_merge_engine == ENGINE[env]
        assert tb.snapshot() == jb.snapshot()
        assert sorted(tb.version) == sorted(jb.version)
        assert tb.last_merge_collisions == jb.last_merge_collisions
        if env in ("none", "no_native"):
            assert tb.last_merge_collisions is not None
    # the oracle agrees with every engine
    monkeypatch.delenv("DT_TPU_ZONE", raising=False)
    monkeypatch.delenv("DT_TPU_PLAN2", raising=False)
    monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    assert tol.checkout_tip().snapshot() == tb.snapshot()


@pytest.mark.parametrize("zone_wins", [True, False])
def test_policy_selection_matches_jax(monkeypatch, zone_wins):
    """The same recorded rates make both packages pick the same engine;
    the tracker and zone runs feed the policy in both."""
    jol, tol = zone_history([JaxOpLog, OpLog], 31, n_edits=50,
                            agents=("pa", "pb"), max_branches=4)
    oracle = tol.checkout_tip().snapshot()
    jpolicy.GLOBAL = jpolicy.EnginePolicy()
    tpolicy.GLOBAL = tpolicy.EnginePolicy()
    fast, slow = (10_000, 0.001), (10_000, 1.0)
    for p in (jpolicy.GLOBAL, tpolicy.GLOBAL):
        p.record(tpolicy.TRACKER, *(slow if zone_wins else fast))
        p.record(tpolicy.ZONE, *(fast if zone_wins else slow))
    jb, tb = _merge_both(jol, tol)
    assert tb.last_merge_engine == jb.last_merge_engine == \
        ("zone" if zone_wins else "tracker")
    assert tb.snapshot() == jb.snapshot() == oracle
    # the run fed its engine's rate (measured times differ between the
    # packages, so later choices may too: only this first one is compared)
    assert tpolicy.GLOBAL.snapshot().keys() == jpolicy.GLOBAL.snapshot().keys()
    for _ in range(3):
        jb, tb = _merge_both(jol, tol)
        assert tb.snapshot() == jb.snapshot() == oracle


@pytest.mark.parametrize("zone_wins", [False, True])
@pytest.mark.parametrize("env", list(ENVS) + ["device"])
def test_merge_reference_ignores_switches_and_policy(monkeypatch, env,
                                                     zone_wins):
    """`Branch.merge_reference`, the parity checks' reference: whatever
    switch is set and whatever the policy would pick, it runs the C++
    tracker (the Python oracle under DT_TPU_NO_NATIVE), records no rate,
    and gives the JAX package's default merge, from [] and from a mid
    version."""
    jol, tol = zone_history([JaxOpLog, OpLog], 700, n_edits=60,
                            agents=("alice", "bob", "carol"))
    monkeypatch.setattr(jpolicy, "GLOBAL", jpolicy.EnginePolicy())
    mid = [len(tol) // 2]
    want = []
    for start in ([], mid):
        jb = JaxBranch()
        jb.merge(jol, start)
        jb.merge(jol, jol.version)
        assert jb.last_merge_engine == "tracker"
        want.append((jb.snapshot(), sorted(jb.version)))
    if zone_wins:
        tpolicy.GLOBAL.record(tpolicy.TRACKER, 10_000, 1.0)
        tpolicy.GLOBAL.record(tpolicy.ZONE, 10_000, 0.001)
    before = tpolicy.GLOBAL.snapshot()
    env_vars = dict(ENVS, device={"DT_TPU_DEVICE_MERGE": "1"})[env]
    for k, v in env_vars.items():
        monkeypatch.setenv(k, v)
    for start, (text, version) in zip(([], mid), want):
        tb = Branch()
        tb.merge_reference(tol, start)
        tb.merge_reference(tol, tol.version)
        assert tb.last_merge_engine == \
            ("python" if env == "no_native" else "tracker")
        assert (tb.snapshot(), sorted(tb.version)) == (text, version)
    assert tpolicy.GLOBAL.snapshot() == before


def test_unmeasured_policy_runs_the_tracker_and_records_it():
    _jol, tol = zone_history([JaxOpLog, OpLog], 32)
    b = Branch()
    b.merge(tol, tol.version)
    assert b.last_merge_engine == "tracker"
    assert tpolicy.GLOBAL.rate(tpolicy.TRACKER) is not None
    assert tpolicy.GLOBAL.rate(tpolicy.ZONE) is None


def test_failed_policy_zone_merge_propagates(monkeypatch):
    """The deliberate divergence: the port's Branch.merge does not catch a
    failed policy-selected zone merge; the JAX package warns, demotes the
    zone engine and runs the tracker."""
    jol, tol = zone_history([JaxOpLog, OpLog], 33)
    jpolicy.GLOBAL = jpolicy.EnginePolicy()
    for p in (jpolicy.GLOBAL, tpolicy.GLOBAL):
        p.record(tpolicy.TRACKER, 1000, 1.0)
        p.record(tpolicy.ZONE, 100_000, 1.0)

    def boom(*a, **k):
        raise RuntimeError("injected zone failure")

    import diamond_types_tpu.tpu.zone_kernel as jk
    monkeypatch.setattr(jk, "zone_checkout_device", boom)
    monkeypatch.setattr(tk, "zone_checkout_device", boom)
    with pytest.warns(RuntimeWarning, match="zone engine failed"):
        jb = JaxBranch()
        jb.merge(jol, jol.version)
    assert jb.last_merge_engine == "tracker"
    assert jpolicy.GLOBAL.rate(jpolicy.ZONE) is None    # demoted
    with pytest.raises(RuntimeError, match="injected"):
        Branch().merge(tol, tol.version, device="cpu")
    assert tpolicy.GLOBAL.rate(tpolicy.ZONE) is not None  # not demoted


def test_zone_merge_defaults_to_cuda(monkeypatch):
    """DT_TPU_ZONE without a device runs on CUDA, which must exist."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    monkeypatch.setenv("DT_TPU_ZONE", "1")
    _jol, tol = zone_history([JaxOpLog, OpLog], 34)
    with pytest.raises(RuntimeError, match="CUDA"):
        Branch().merge(tol, tol.version)
