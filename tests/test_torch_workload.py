"""The port's scenario harness (`workload/`) against the JAX package's.

`workload/arrivals.py`, `popularity.py`, `spec.py` and `__init__.py` are
byte-identical copies; `runner.py` differs only by its `device` keyword
and by dropping the figures JAX reads from its steer table (the port has
no jit cache and no steer table). The samplers draw
the same arrival times and documents as JAX's for the same seeds, and
`_build_events` gives the same tape for every registered scenario.

The `smoke` scenario runs through both packages (JAX's servers on the host
engine, the port's on `device="cpu"`: the fused device scheduler with the
device plan, K2 and K1 in their plain versions): the scorecards have the
same keys, and the counts the event tape fixes are equal. The port's
smoke also runs with `qos=True`, and killed after 3 ticks and resumed
from its checkpoint, giving the uninterrupted run's deterministic slice
(`tests/test_incident.py`'s kill-and-resume case). The crash-style
teardown of `stop_after_ticks` stops every scheduler's pump and leaves no
fault. The scorecard's `serve` block has JAX's keys but the two steer
figures, `jit_cache_hit_rate` and `steer_compiles`.
"""

import importlib
import json
import os
import shutil
from pathlib import Path

import pytest

pytestmark = pytest.mark.scenario

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = ROOTS = ("diamond_types_tpu", "diamond_types_tpu_torch")
COPIED = ("workload/__init__.py", "workload/arrivals.py",
          "workload/popularity.py", "workload/spec.py")
SCENARIO_NAMES = ("smoke", "churn", "flash-crowd", "ramp-bulk",
                  "chaos-churn", "bank-churn-1m")
# the `serve` figures JAX reads from its steer table; the port has none
JAX_STEER_KEYS = ("jit_cache_hit_rate", "steer_compiles")


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _run(root, name="smoke", **kw):
    if root == PORT:
        kw.setdefault("device", "cpu")
    sc = _mod(root, "workload").get_scenario(name) if name else None
    return _mod(root, "workload.runner").run_scenario(sc, **kw)


# ---- the copies ---------------------------------------------------------------

@pytest.mark.parametrize("rel", COPIED)
def test_module_is_a_byte_identical_copy(rel):
    assert (REPO / PORT / rel).read_bytes() == (REPO / JAX / rel).read_bytes()


def test_runner_differs_only_by_device_and_steer():
    import difflib
    a = (REPO / JAX / "workload/runner.py").read_text().splitlines()
    b = (REPO / PORT / "workload/runner.py").read_text().splitlines()
    removed, added = [], []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            a=a, b=b, autojunk=False).get_opcodes():
        if tag != "equal":
            removed += a[i1:i2]
            added += b[j1:j2]
    assert [ln.strip() for ln in removed] == [
        "stop_after_ticks: Optional[int] = None) -> dict:",
        'instead of a scorecard."""',
        "# shape-steer counters are process-global and unconditional; the",
        "# start snapshot turns them into per-run deltas for the scorecard",
        "from ..tpu.steer import STEER",
        "steer0 = STEER.snapshot()",
        "qos=qos)",
        "# staging + dispatch fan-in from the servers' ServeMetrics, jit",
        "# hit rate from the steer counters' per-run delta. Host-engine",
        "# runs never dispatch a device window, so the block stays None and",
        "# the serve.* bands skip (missing-path semantics) — exactly like",
        "# pre-steer baselines.",
        "steer1 = STEER.snapshot()",
        'looks = steer1["lookups"] - steer0["lookups"]',
        'warm_hits = (steer1["hits"] + steer1["padded"]',
        '- steer0["hits"] - steer0["padded"])',
        '"jit_cache_hit_rate": round(warm_hits / looks, 4)',
        "if looks else 1.0,",
        '"steer_compiles": steer1["compiles"] - steer0["compiles"],']
    assert not any("steer" in ln.lower() or "jit" in ln for ln in added)
    assert "    resolve_device(device)" in added
    assert any("qos=qos, device=device)" in ln for ln in added)


def test_package_exports_match():
    jw, tw = (_mod(r, "workload") for r in ROOTS)
    assert tw.__all__ == jw.__all__
    assert sorted(tw.SCENARIOS) == sorted(jw.SCENARIOS) \
        == sorted(SCENARIO_NAMES)
    for name in SCENARIO_NAMES:
        assert tw.SCENARIOS[name].to_dict() == jw.SCENARIOS[name].to_dict()


# ---- samplers and the event tape ---------------------------------------------------

ARRIVALS = [{"kind": "poisson", "rate_per_s": 50.0},
            {"kind": "bursty", "base_per_s": 10.0, "burst_x": 10.0,
             "every_s": 10.0, "burst_len_s": 2.0},
            {"kind": "ramp", "start_per_s": 0.0, "end_per_s": 50.0,
             "ramp_s": 50.0}]
POPULARITY = [{"kind": "uniform"}, {"kind": "zipf", "s": 1.1},
              {"kind": "hotset", "hot_k": 2, "hot_weight": 0.9,
               "rotate_every_s": 3.0}]


@pytest.mark.parametrize("spec", ARRIVALS, ids=lambda s: s["kind"])
@pytest.mark.parametrize("seed", [0, 5, 9])
def test_arrivals_equal_jax(spec, seed):
    got = {}
    for root in ROOTS:
        proc = _mod(root, "workload").make_arrivals(spec, seed=seed)
        got[root] = (proc.schedule(60.0), proc.to_dict(),
                     [proc.rate(t) for t in (0.0, 1.5, 11.0, 30.0)])
    assert got[PORT] == got[JAX]
    assert got[PORT][0] and got[PORT][0] == sorted(got[PORT][0])


@pytest.mark.parametrize("spec", POPULARITY, ids=lambda s: s["kind"])
@pytest.mark.parametrize("seed", [0, 4, 6])
def test_popularity_equal_jax(spec, seed):
    times = [0.01 * i for i in range(2_000)]
    got = {}
    for root in ROOTS:
        law = _mod(root, "workload").make_popularity(spec, 40, seed=seed)
        got[root] = (law.draws(times), law.to_dict())
    assert got[PORT] == got[JAX]
    assert len(set(got[PORT][0])) > 1


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_event_tapes_equal_jax(name):
    tapes = [_mod(r, "workload.runner")._build_events(
        _mod(r, "workload").SCENARIOS[name]) for r in ROOTS]
    assert tapes[1] == tapes[0]
    assert tapes[1] and tapes[1] == sorted(tapes[1], key=lambda e: (e[0],
                                                                   e[1]))


# ---- the smoke scenario ----------------------------------------------------------

def _key_paths(d, pre=""):
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(pre + str(k))
            # data-keyed maps: series names, per-peer rows, per-server
            # addresses, the timeline of incident ids
            if k not in ("lag", "timeline", "per_server"):
                out |= _key_paths(v, pre + str(k) + ".")
    return out


def _tape_counts(card):
    """What the event tape fixes on a healthy run: every write and read
    event made its call (reads either served or honestly refused), the
    bulk lane and the bank lane ran their tapes, sessions churned on
    their cadence."""
    t = card["totals"]
    return {"writes": t["writes"], "write_ops": t["write_ops"],
            "reads_attempted": t["reads"] + t["read_refusals"],
            "bulk_ops": t["bulk_ops"], "bank_edits": t["bank_edits"],
            "errors": t["errors"], "sheds": t["sheds"],
            "session_churns": card["extra"]["session_churns"],
            "bank": {k: card["extra"]["bank"][k] for k in (
                "docs", "warm_slots", "docs_touched", "edits")}}


@pytest.fixture(scope="module")
def smoke_cards():
    """The smoke scenario's scorecard in each package."""
    return {r: _run(r) for r in ROOTS}


def test_smoke_scorecard_matches_jax(smoke_cards):
    jc, tc = smoke_cards[JAX], smoke_cards[PORT]
    assert _key_paths(tc) == _key_paths(jc) - {
        f"serve.{k}" for k in JAX_STEER_KEYS}
    assert _tape_counts(tc) == _tape_counts(jc)
    tape = _mod(PORT, "workload.runner")._build_events(
        _mod(PORT, "workload").get_scenario("smoke"))
    assert tc["totals"]["writes"] == sum(1 for e in tape if e[1] == "write")
    assert tc["totals"]["reads"] + tc["totals"]["read_refusals"] == \
        sum(1 for e in tape if e[1] == "read")


def test_smoke_steer_deltas_diverge_from_jax(smoke_cards):
    """The scorecard's `serve` block: the port's has JAX's keys but the
    two figures JAX reads from its steer table (the port has no jit cache
    and no steer table). Neither smoke run stages a window's bytes."""
    jc, tc = smoke_cards[JAX], smoke_cards[PORT]
    shared = set(jc["serve"]) - set(JAX_STEER_KEYS)
    assert set(tc["serve"]) == shared == {
        "staged_bytes", "staged_bytes_per_window", "device_calls_per_window"}
    assert jc["serve"]["jit_cache_hit_rate"] == 1.0
    assert tc["serve"]["staged_bytes"] == jc["serve"]["staged_bytes"] == 0
    assert tc["serve"]["staged_bytes_per_window"] \
        == jc["serve"]["staged_bytes_per_window"] == 0


def test_smoke_scorecard_complete(smoke_cards):
    """`tests/test_workload.py`'s acceptance pins, on the port's card."""
    card = smoke_cards[PORT]
    SCORECARD_VERSION = _mod(PORT, "obs.scorecard").SCORECARD_VERSION
    assert card["version"] == SCORECARD_VERSION
    assert card["scenario"]["name"] == "smoke"
    assert card["throughput"]["ops_per_s"] > 0
    for k in ("flush", "read", "visibility"):
        assert isinstance(card["latency_p99_s"][k], float)
    assert card["latency_p99_s"]["read"] > 0
    for name in ("flush_p99", "read_staleness_p99", "visibility_p99"):
        assert card["burn_minutes"][name] == 0.0
    assert card["convergence"]["converged"] is True
    lags = [row for peers in card["convergence"]["lag"].values()
            for row in peers.values()]
    assert lags and all(r["n"] > 0 for r in lags)
    assert card["bytes_per_op"] > 0
    assert card["hydration"]["spills_to_snapshot"] > 0
    assert card["hydration"]["spill_bytes"] > 0
    assert card["totals"]["errors"] == 0
    assert card["ok"] is True


def test_smoke_scenario_with_qos_stamps_block():
    """`tests/test_qos.py`'s smoke case on the port."""
    card = _run(PORT, qos=True)
    assert card["ok"], card["slo"]
    qos = card["qos"]
    assert qos["schema_version"] == 1
    assert qos["classes"]["interactive"]["admitted"] > 0
    assert qos["classes"]["bulk"]["admitted"] > 0
    assert all(row["shed"] == 0 for row in qos["classes"].values())
    assert qos["sheds_observed"] == 0
    assert qos["controller"]["steps"] > 0


def _slice(card):
    """`tests/test_incident.py`'s deterministic slice of a scorecard."""
    totals = {k: v for k, v in card["totals"].items()
              if k != "bytes_received"}
    return json.dumps({
        "totals": totals,
        "scenario": card["scenario"],
        "incidents": card.get("incidents"),
        "session_churns": card.get("extra", {}).get("session_churns"),
        "converged": card.get("convergence", {}).get("converged"),
    }, sort_keys=True)


def test_kill_and_resume_equals_the_uninterrupted_run(smoke_cards,
                                                      monkeypatch):
    """Killed after 3 ticks (crash-style: every server torn down with its
    journals open), then resumed from the checkpoint: the scorecard's
    deterministic slice equals the uninterrupted run's. The teardown
    stops every scheduler's pump and leaves no scheduler fault."""
    server = _mod(PORT, "tools.server")
    booted = []
    real = server.serve

    def serve(*args, **kw):
        httpd = real(*args, **kw)
        booted.append(httpd)
        return httpd

    monkeypatch.setattr(server, "serve", serve)
    INCIDENT_KINDS = _mod(PORT, "obs.incident").INCIDENT_KINDS
    control = smoke_cards[PORT]
    assert control["ok"], control
    part = _run(PORT, checkpoint_every_s=1.0, stop_after_ticks=3)
    assert part.get("aborted") and part["tick"] == 3
    assert len(booted) == 2
    for h in booted:
        sched = h.store.scheduler
        assert sched.fault is None
        assert sched._pump_thread is None or not sched._pump_thread.is_alive()
    run_dir = part["resume_dir"]
    try:
        assert os.path.exists(os.path.join(run_dir, "checkpoint.json"))
        card = _run(PORT, name=None, resume_dir=run_dir)
        assert card["ok"] and card["extra"]["resumed"]
        assert card["convergence"]["converged"]
        assert card["incidents"]["by_kind"] == dict.fromkeys(
            INCIDENT_KINDS, 0) or card["incidents"]["count"] >= 0
        assert _slice(card) == _slice(control)
        assert len(booted) == 4
        assert all(h.store.scheduler.fault is None for h in booted)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


# ---- on the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_smoke_scenario_on_card_launches_its_kernels(monkeypatch):
    """The smoke scenario with every server merging on the card: its
    scorecard ok and converged, K1 launched for every fused call and
    per-doc replay of the servers' schedulers, K2 for every resolve."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch_parity import ServedLaunches
    served = ServedLaunches(monkeypatch)
    card = _run(PORT, device=None)
    assert card["ok"] and card["convergence"]["converged"]
    assert len(served.httpds) == 2
    got = served.check()
    assert got["k2"] > 0
