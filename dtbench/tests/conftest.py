"""Shared set-up of the benchmark's own tests (run them from the repository's
root: `python -m pytest dtbench/tests -q`)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2 ** 31 + 977            # larger than 32 signed bits hold


def tiny(cell_name: str, n_docs: int = 8):
    """A cell's configuration and mix cut to a size the CPU runs in
    seconds: `n_docs` documents of 150-400 chars, sessions for all of them,
    6 documents checked."""
    from dtbench.run import cell_metrics, load_cell
    manifest, cell, config, mix = load_cell(cell_name)
    mix["docs"].update(base_min=150, base_max=400, run_max=16)
    mix["docs"]["count"] = n_docs
    mix["check"]["docs"] = 6
    config["live_docs"] = n_docs
    config["max_sessions_per_shard"] = n_docs
    if mix["arrivals"]["kind"] == "fixed_interval":
        mix["arrivals"]["interval_s"] = 0.2
    specs = cell_metrics(manifest, cell_name, False) + [
        m for m in cell_metrics(manifest, cell_name, True)
        if m["source"] != "device_trace"]
    return cell, config, mix, specs


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is here (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")
