"""On the card: one short run of a cell through the command, as the check
runs it (skips without a card)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, SEED


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(cuda_card):
    out = subprocess.run(
        [sys.executable, "-m", "dtbench", "--workload", "fused-concurrent",
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["merged_ops_per_s"]["value"] > 0
