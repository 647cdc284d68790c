"""Find a part of the benchmark by its name: `dtbench/<folder>/<name>.py`.

Configurations name their tier (`dtbench/tiers/<tier>.py`), mixes name
their edit shape (`dtbench/traffic/edits/<kind>.py`) and their arrivals
(`dtbench/traffic/arrivals/<kind>.py`), and the manifest names each
metric (`dtbench/metrics/<name>.py`). A new part is a new file; no
existing file lists the parts."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(folder: str, name: str):
    """The module `dtbench/<folder>/<name>.py`, loaded from its file."""
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder} part named {name!r} ({path})")
    mod_name = f"dtbench.{folder.replace('/', '.')}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
