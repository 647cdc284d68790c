"""The port's static lint (`analysis/lint.py`, `analysis/rules/`) against
the JAX package's.

The rules are copies. `lint.py` walks `gpu/` where JAX's walks `tpu/`, and
`rules/locks.py`'s dispatch set adds the port's own dispatch names. Every
seeded fixture under `tests/fixtures/analysis/` goes through both
packages' `run_lint` and must give the same violations; the port's own
tree lints clean with JAX's rule keys; the port's dispatch names fire only
in the port (`tests/fixtures/analysis_torch/`); the `dt-lint` gate and
its exit codes hold through the port's CLI; and after a `dt-lint` and a
`dt-explore` run, both packages' `Observability.snapshot()`s carry the
same keys and their Prometheus text JAX's `dt_lint_*` and `dt_explore_*`
families.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import diamond_types_tpu.analysis.explore.engine as jexplore
import diamond_types_tpu.analysis.lint as jlint
import diamond_types_tpu.analysis.rules as jrules
import diamond_types_tpu.analysis.rules.locks as jlocks
import diamond_types_tpu_torch.analysis.explore.engine as texplore
import diamond_types_tpu_torch.analysis.lint as tlint
import diamond_types_tpu_torch.analysis.rules as trules
import diamond_types_tpu_torch.analysis.rules.locks as tlocks

pytestmark = pytest.mark.analysis

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = "diamond_types_tpu", "diamond_types_tpu_torch"
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
PORT_FIXTURE = REPO / "tests" / "fixtures" / "analysis_torch" / \
    "bad_kernel_under_oplog.py"
COPIED = ("analysis/rules/__init__.py", "analysis/rules/fencing.py",
          "analysis/rules/dataflow.py", "analysis/rules/jit_purity.py",
          "analysis/rules/metrics_schema.py")
# the port's dispatch names beyond JAX's (rules/locks.py DISPATCH_BASE)
PORT_DISPATCH = {"synchronize", "apply_ops_window", "xform_positions",
                 "materialize_runs", "zone_tape_run", "replay_batch_kernel",
                 "checkout_batch_device", "texts_at_versions"}


def _rows(report):
    return [(v["rule"], v["path"].replace(PORT, JAX), v["line"],
             v["severity"], v["message"]) for v in report["violations"]]


@pytest.fixture(scope="module")
def port_tree():
    return tlint.run_lint()


# ---- the copies ---------------------------------------------------------------

@pytest.mark.parametrize("rel", COPIED)
def test_rule_module_is_a_byte_identical_copy(rel):
    assert (REPO / PORT / rel).read_bytes() == (REPO / JAX / rel).read_bytes()


def test_lint_differs_only_in_its_package_list_and_docstrings():
    """The engine, its severities and its suppression grammar are JAX's;
    the walk names `gpu` for `tpu`."""
    assert tlint.SEVERITY == jlint.SEVERITY
    assert tlint._SUPPRESS_RE.pattern == jlint._SUPPRESS_RE.pattern
    assert tlint.DEFAULT_PACKAGES == tuple(
        "gpu" if p == "tpu" else p for p in jlint.DEFAULT_PACKAGES)
    assert Path(tlint.repo_root()) == REPO / PORT
    assert len(trules.RULES) == len(jrules.RULES)
    assert [f.__name__ for f in trules.RULES] == \
        [f.__name__ for f in jrules.RULES]
    a = (REPO / JAX / "analysis/lint.py").read_text().split('"""', 2)[2]
    b = (REPO / PORT / "analysis/lint.py").read_text().split('"""', 2)[2]
    diff = [(x, y) for x, y in zip(a.splitlines(), b.splitlines()) if x != y]
    assert len(a.splitlines()) == len(b.splitlines())
    assert [y.strip() for _x, y in diff] == [
        'DEFAULT_PACKAGES = ("serve", "replicate", "gpu", "parallel", '
        '"tools",',
        "by seeding with the dispatch names of rules/locks.py).",
        '"""The diamond_types_tpu_torch package directory."""']


def test_locks_differ_only_in_the_dispatch_set():
    assert tlocks.ORDER_LEVELS == jlocks.ORDER_LEVELS
    assert tlocks._DISPATCH_NAME_BLOCKLIST == jlocks._DISPATCH_NAME_BLOCKLIST
    assert tlocks.DISPATCH_BASE == jlocks.DISPATCH_BASE | PORT_DISPATCH
    assert "to" not in tlocks.DISPATCH_BASE
    start = "def _classify("
    a = (REPO / JAX / "analysis/rules/locks.py").read_text()
    b = (REPO / PORT / "analysis/rules/locks.py").read_text()
    assert b[b.index(start):] == a[a.index(start):]


# ---- the shared fixtures through both packages --------------------------------

@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.iterdir()
                                        if p.suffix == ".py"))
def test_fixture_lints_alike(name):
    path = [str(FIXTURES / name)]
    j, t = jlint.run_lint(paths=path), tlint.run_lint(paths=path)
    assert _rows(t) == _rows(j)
    assert t["by_rule"] == j["by_rule"]
    assert (t["ok"], t["errors"], t["warnings"], t["files"]) == \
        (j["ok"], j["errors"], j["warnings"], j["files"])


def test_fixture_directory_lints_alike():
    j = jlint.run_lint(paths=[str(FIXTURES)])
    t = tlint.run_lint(paths=[str(FIXTURES)])
    assert _rows(t) == _rows(j)
    assert tlint.render_human(t) == jlint.render_human(j)


def test_port_dispatch_names_fire_only_in_the_port():
    """A recorded divergence: the port's lint sees dispatches JAX's cannot
    (its kernel wrappers, the CUDA sync point, the batched checkouts)."""
    path = [str(PORT_FIXTURE)]
    assert jlint.run_lint(paths=path)["ok"]
    t = tlint.run_lint(paths=path)
    assert {v["rule"] for v in t["violations"]} == {"device-under-lock"}
    assert [v["line"] for v in t["violations"]] == \
        [19, 23, 27, 31, 35, 39, 43, 47]
    named = {v["message"].split("`")[1].split("(")[0]
             for v in t["violations"]}
    assert named == PORT_DISPATCH


# ---- the port's own tree ------------------------------------------------------

def test_port_tree_lints_clean(port_tree):
    from diamond_types_tpu_torch.analysis import render_human
    assert port_tree["ok"], render_human(port_tree)
    assert port_tree["files"] >= 80
    assert set(port_tree["by_rule"]) == set(
        jlint.run_lint(paths=[str(FIXTURES / "suppressed_ok.py")])["by_rule"])
    # no jax.jit, shard_map or jit cache in the port: both jit rules stay
    # at 0 there and still fire on the shared fixtures (above)
    assert port_tree["by_rule"]["jit-impurity"] == 0
    assert port_tree["by_rule"]["jit-cache-key"] == 0


@pytest.mark.parametrize("rel,line", [("serve/bank.py", "self.sync_doc("),
                                      ("tools/server.py",
                                       "snaps = doc_history_strip(")])
def test_the_two_findings_carry_named_suppressions(rel, line):
    """Without their suppressions the port's tree has exactly two
    device-under-lock findings: the window's serial rung (JAX carries the
    same suppression) and the device history strip under the store lock."""
    src = (REPO / PORT / rel).read_text()
    hit = [ln for ln in src.splitlines()
           if line in ln and "dt-lint: ignore[device-under-lock]" in ln]
    assert len(hit) == 1
    bare = src.replace("  # dt-lint: ignore[device-under-lock]", "")
    ctx = tlint.FileContext(rel, bare, rel=rel)
    summary = tlint.build_summary([ctx])
    summary.dispatchers |= {"sync_doc", "doc_history_strip"}
    found = [v for v in tlocks.check_locks(ctx, summary)
             if v.rule == "device-under-lock"]
    assert len(found) == 1 and line in bare.splitlines()[found[0].line - 1]


# ---- the dt-lint gate through the port's CLI ----------------------------------

def _cli(*argv):
    return subprocess.run([sys.executable, "-m", f"{PORT}.tools.cli",
                           "dt-lint", *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_cli_dt_lint_gate():
    clean = _cli("--fail-on", "warn")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 errors, 0 warnings" in clean.stdout
    bad = _cli("--fail-on", "warn", "--json", str(FIXTURES / "bad_lock_order.py"))
    assert bad.returncode == 1
    assert json.loads(bad.stdout)["by_rule"]["lock-order"] == 1
    warn_only = _cli("--fail-on", "error",
                     str(FIXTURES / "bad_jit_impurity.py"))
    assert warn_only.returncode == 0, warn_only.stdout
    assert _cli("--fail-on", "never").returncode == 2


# ---- the reports reach obs ----------------------------------------------------

def test_published_reports_give_both_snapshots_the_same_keys(monkeypatch,
                                                             capsys):
    import diamond_types_tpu.obs as jobs
    import diamond_types_tpu.obs.prom as jprom
    import diamond_types_tpu.tools.cli as jcli
    import diamond_types_tpu_torch.obs as tobs
    import diamond_types_tpu_torch.obs.prom as tprom
    import diamond_types_tpu_torch.tools.cli as tcli
    for mod, name in ((jlint, "_LAST_REPORT"), (tlint, "_LAST_REPORT"),
                      (jexplore, "_last_report"), (texplore, "_last_report")):
        monkeypatch.setattr(mod, name, None)
    texts = []
    for cli, obs, prom in ((jcli, jobs, jprom), (tcli, tobs, tprom)):
        assert obs.Observability(enabled=False).snapshot().keys() \
            .isdisjoint({"lint", "explore"})
        assert cli.main(["dt-lint", str(FIXTURES / "bad_lock_order.py")]) == 1
        assert cli.main(["dt-explore", "--scenario", "renewal",
                         "--depth", "3"]) == 0
        snap = obs.Observability(enabled=False).snapshot()
        assert {"lint", "explore"} <= set(snap)
        texts.append((snap, prom.render_metrics({"obs": snap})))
    capsys.readouterr()
    (js, jtext), (ts, ttext) = texts
    assert sorted(ts) == sorted(js)
    assert ts["lint"] == js["lint"]
    assert {k: v for k, v in ts["explore"].items()
            if k not in ("wall_s", "states_per_s")} == \
        {k: v for k, v in js["explore"].items()
         if k not in ("wall_s", "states_per_s")}

    def families(text, prefix):
        return sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE " + prefix)})

    for prefix in ("dt_lint_", "dt_explore_"):
        assert families(jtext, prefix) and \
            families(ttext, prefix) == families(jtext, prefix)
    lint_lines = [ln for ln in ttext.splitlines()
                  if ln.startswith("dt_lint_")]
    assert lint_lines == [ln for ln in jtext.splitlines()
                          if ln.startswith("dt_lint_")]
    assert 'dt_lint_violations_total{rule="lock-order"} 1' in lint_lines
