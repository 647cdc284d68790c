"""Import hygiene of the PyTorch port.

The port imports nothing of JAX and nothing of the JAX package, not even
its JAX-free modules, and its device entry points refuse to run on the
CPU unless the caller asks for it.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import diamond_types_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    pkg = diamond_types_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                        pkg.__name__ + "."))


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "diamond_types_tpu_torch.gpu.kernels" in mods
    assert "diamond_types_tpu_torch.gpu.flush_fuse" in mods
    for m in ("native.core", "native.build", "listmerge.columnar",
              "gpu.linearize", "gpu.xform", "gpu.merge_kernel", "gpu.steer",
              "serve.scheduler", "serve.bank", "serve.driver",
              "serve.admission", "serve.router", "serve.metrics",
              "serve.__main__", "qos.classes", "obs.hist", "text.trace",
              "parallel.mesh", "parallel.arena", "gpu.graph_kernels",
              "gpu.plan_kernels", "listmerge.plan2", "listmerge.dense",
              "listmerge.compose", "listmerge.zone_np", "listmerge.policy",
              "gpu.zone_kernel", "gpu.zone_session",
              "causalgraph.summary", "encoding.varint", "encoding.crc32c",
              "encoding.lz4", "encoding.decode", "encoding.encode",
              "analysis.witness", "replicate.peers", "storage.store",
              "storage.pages", "storage.tier", "storage.soak",
              "wire.frames", "wire.snapshot", "serve.hydrate",
              "core.unicount", "causalgraph.stochastic_summary",
              "causalgraph.subgraph", "listmerge.plan", "text.crdt",
              "text.ot", "utils.checkers", "utils.stats", "native.ingest",
              "db", "db.doc", "db.shelf", "obs.timeseries", "qos",
              "qos.classes", "qos.metrics", "qos.shed", "qos.controller",
              "obs", "obs.recorder", "obs.trace", "obs.devprof",
              "obs.exemplars", "obs.attrib", "obs.journey", "obs.slo",
              "obs.incident", "obs.scorecard", "obs.assemble", "obs.prom",
              "read", "read.metrics", "wire.channel", "replicate",
              "replicate.faults", "replicate.metrics",
              "replicate.membership", "replicate.ownership",
              "replicate.quorum", "replicate.writergroup",
              "replicate.rebalance", "replicate.antientropy",
              "replicate.node", "tools", "tools.server",
              "tools.web_assets", "tools.py2js", "tools.crdt_replay_src",
              "read.cache", "read.follower", "read.path", "read.bench",
              "replicate.soak", "replicate.rebalance_soak", "workload",
              "workload.arrivals", "workload.popularity", "workload.spec",
              "workload.runner", "analysis", "analysis.lint",
              "analysis.rules", "analysis.rules.locks",
              "analysis.rules.fencing", "analysis.rules.dataflow",
              "analysis.rules.jit_purity", "analysis.rules.metrics_schema",
              "analysis.explore", "analysis.explore.engine",
              "analysis.explore.world", "analysis.explore.model",
              "analysis.explore.invariants", "analysis.explore.mutations",
              "tools.cli", "tools.soak", "tools.device_soak",
              "tools.dump_columns"):
        assert f"diamond_types_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {['diamond_types_tpu_torch'] + mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'diamond_types_tpu',"
        " 'bench') or m.startswith(('jax.', 'jaxlib', 'diamond_types_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_public_api_imports_from_the_root():
    from diamond_types_tpu_torch import ListCRDT, load, merge_oplogs, save
    assert callable(load) and callable(save) and callable(merge_oplogs)
    assert ListCRDT().snapshot() == ""


def test_import_builds_nothing():
    """Kernels and the native library build at first use, never at
    import: a fresh process that imports every module of the port has
    loaded neither."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from diamond_types_tpu_torch.gpu import kernels\n"
        "from diamond_types_tpu_torch.native import core\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad = (kernels._libs or core._lib is not None or 'dt_core' in maps\n"
        "       or 'diamond_types_tpu_torch/_build' in maps)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_never_loads_the_jax_packages_native_library():
    """A native call loads the port's own build under `_build/`, never
    `native/libdt_core.so` (the JAX package's build output)."""
    code = (
        "from diamond_types_tpu_torch import OpLog\n"
        "from diamond_types_tpu_torch.native.core import get_native_ctx\n"
        "ol = OpLog()\n"
        "ol.add_insert(ol.get_or_create_agent_id('a'), 0, 'abc')\n"
        "print(get_native_ctx(ol).merge_to_string('', [], ol.version)[0])\n"
        "for ln in open('/proc/self/maps'):\n"
        "    if 'dt_core' in ln:\n"
        "        print(ln.split()[-1])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.split()
    assert lines[0] == "abc"
    libs = {Path(p).resolve() for p in lines[1:]}
    assert libs and all(p.parent == REPO / "diamond_types_tpu_torch" /
                        "_build" for p in libs), libs
    assert (REPO / "native" / "libdt_core.so").resolve() not in libs


def test_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from diamond_types_tpu_torch import OpLog
    from diamond_types_tpu_torch.gpu import batch, flush_fuse, kernels
    from diamond_types_tpu_torch.gpu import resolve_device
    ol = OpLog()
    ol.add_insert(ol.get_or_create_agent_id("a"), 0, "abc")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        flush_fuse.FusedDocSession(ol)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.replay_batch([[0]], [[0]], [[1]], [[[97]]], cap=256)
    assert resolve_device("cpu") == torch.device("cpu")
    s = flush_fuse.FusedDocSession(ol, device="cpu")
    assert s.text() == "abc" and s.docs.device.type == "cpu"
    assert isinstance(kernels.apply_ops_window.launches, int)


def test_device_entry_points_of_the_transform_and_checkout_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from diamond_types_tpu_torch import OpLog
    from diamond_types_tpu_torch.gpu import kernels, merge_kernel, xform
    ol = OpLog()
    ol.add_insert(ol.get_or_create_agent_id("a"), 0, "abc")
    doc = merge_kernel.prepare_doc(ol)
    for call in (lambda: xform.resolve_positions([]),
                 lambda: merge_kernel.checkout_batch_device([doc]),
                 lambda: merge_kernel.checkout_device(ol, doc),
                 lambda: merge_kernel.merge_device(ol, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert merge_kernel.checkout_device(ol, doc, device="cpu") == "abc"
    assert isinstance(kernels.xform_positions.launches, int)
    assert isinstance(kernels.materialize_runs.launches, int)


def test_device_entry_points_of_the_graph_and_history_paths_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import numpy as np

    from diamond_types_tpu_torch import OpLog
    from diamond_types_tpu_torch.gpu import graph_kernels, plan_kernels
    from diamond_types_tpu_torch.gpu import xform
    from diamond_types_tpu_torch.parallel import mesh
    ol = OpLog()
    ol.add_insert(ol.get_or_create_agent_id("a"), 0, "abc")
    z = np.zeros(1, np.int32)
    for call in (lambda: graph_kernels.pack_graph(ol.cg.graph),
                 lambda: graph_kernels.make_contains_fn(ol.cg.graph),
                 lambda: graph_kernels.make_diff_fn(ol.cg.graph),
                 lambda: xform.validate_prefix_frontier(ol, ol.version, 3),
                 lambda: plan_kernels.execute_tape(z, z, z, z, z, z, 1, 1, 1),
                 lambda: plan_kernels.snapshot_rows(ol, []),
                 lambda: plan_kernels.texts_at_versions(ol, [0]),
                 lambda: mesh.make_mesh(1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert xform.validate_prefix_frontier(ol, ol.version, 3, device="cpu")


@pytest.mark.parametrize("entry", [
    "workload.runner:run_scenario", "read.bench:run_read_bench",
    "replicate.soak:run_replicate_soak",
    "replicate.rebalance_soak:run_rebalance_soak",
    "replicate.rebalance_soak:run_split_soak",
    "tools.cli:main serve-bench", "tools.cli:main serve-bench --no-fused",
    "tools.cli:main serve-bench --real-device",
    "tools.cli:main scenario run --name smoke",
    "tools.cli:main replicate-soak --serve-shards 0",
    "tools.cli:main rebalance-soak",
    "tools.cli:main rebalance-soak --split-hot-doc",
    "tools.cli:main read-bench",
    "tools.device_soak:main --corpus missing.dt"])
def test_server_booting_entry_points_raise_without_cuda(entry):
    """Every entry point that boots servers takes `device` and passes it to
    `serve`; None means CUDA, so with no card it raises before it boots
    anything, never falling back to the CPU or the host engine. The soak
    raises even at `serve_shards=0`, where its servers merge nothing. The
    CLI's subcommands that boot a scheduler or a server, and the device
    soak, take `--device` with the same default (an entry given with its
    arguments is a `main` called on them)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import importlib
    import inspect
    import threading
    entry, *argv = entry.split()
    mod, name = entry.split(":")
    fn = getattr(importlib.import_module(f"diamond_types_tpu_torch.{mod}"),
                 name)
    args = ()
    if argv:
        args = (argv,)
    else:
        assert inspect.signature(fn).parameters["device"].default is None
    if name == "run_scenario":
        from diamond_types_tpu_torch.workload import get_scenario
        args = (get_scenario("smoke"),)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(*args)
    assert threading.active_count() == threads


def test_chip_smoke_fails_without_cuda():
    """The smoke test drives the card only: without one it exits nonzero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the smoke would run")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "CUDA" in r.stderr


def test_serve_readme_carries_every_cited_section():
    """Every section of `serve/README.md` that a port docstring cites by
    its quoted title is a heading of the port's copy, and the copy names
    no TPU module path and not JAX_PLATFORMS."""
    import re
    port = REPO / "diamond_types_tpu_torch"
    readme = (port / "serve" / "README.md").read_text()
    headings = [line.lstrip("#").strip() for line in readme.splitlines()
                if line.startswith("#")]
    cited = set()
    for path in port.rglob("*.py"):
        text = " ".join(path.read_text(encoding="utf-8").split())
        cited.update(re.findall(
            r'serve/README\.md (?:documents under )?"([^"]+)"', text))
    assert cited >= {"Tiered residency", "Concurrency invariants",
                     "Cross-host replication"}, cited
    for title in sorted(cited):
        assert any(h.startswith(title) for h in headings), title
    assert "JAX_PLATFORMS" not in readme
    assert not re.search(r"(?<![\w.])tpu/", readme)
