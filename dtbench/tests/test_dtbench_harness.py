"""The harness: its manifest, its refusal without a card, what it imports,
and a whole run rehearsed on the CPU (with the kernels' plain versions)."""

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT, SEED, tiny
from dtbench import metrics
from dtbench.run import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_names_files_and_readers():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    configs = {c["name"] for c in m["configs"]}
    cells = {w["name"] for w in m["workloads"]}
    for c in m["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(
            os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
    for w in m["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert os.path.exists(os.path.join(
            ROOT, "dtbench", "traffic", f"{w['traffic']}.json"))
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert callable(metrics.load(x["name"]))
        assert set(x.get("workloads", cells)) <= cells
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    e2e = {x["name"]: set(x.get("workloads", cells)) for x in m["end_to_end"]}
    for x in m["per_layer"]:
        # the metric it moves is reported in every cell that reports it
        assert set(x.get("workloads", cells)) <= e2e[x["moves"]], x["name"]
    for w in cells:       # every cell: setup_s, another e2e, a per-layer
        assert sum(w in x.get("workloads", cells)
                   for x in m["end_to_end"]) >= 2
        assert any(w in x.get("workloads", cells) for x in m["per_layer"])


def test_no_card_means_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "dtbench", "--workload", "fused-concurrent",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_harness_and_its_rehearsal_load_no_jax():
    """The harness's imports and a CPU rehearsal of a run, in a process of
    their own: no top-level module named jax, jaxlib, flax or
    diamond_types_tpu (compared whole: the port's name begins with it)."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.dirname(__file__)!r})
import dtbench.run, dtbench.tiers, dtbench.trace, dtbench.metrics
from conftest import tiny, SEED
cell, config, mix, specs = tiny("fused-concurrent", n_docs=4)
r = dtbench.run.run_cell(cell, config, mix, specs, SEED, 0.5, False, "cpu")
assert r["correct"], r
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "diamond_types_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "diamond_types_tpu"}


@pytest.mark.parametrize("cell_name", ["fused-concurrent", "fused-typing"])
def test_rehearsal_on_the_cpu_is_correct(cell_name):
    cell, config, mix, specs = tiny(cell_name)
    r = run_cell(cell, config, mix, specs, SEED, 1.5, False, "cpu")
    assert r["correct"], r["notes"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    for spec in specs:               # every metric of the cell but the trace's
        assert r["metrics"][spec["name"]]["value"] > 0, spec["name"]
    assert r["checks"]["checked_docs"]["value"] >= 1
