"""The port's `tools/`: the CLI (`tools/cli.py`), the seeded soak
(`tools/soak.py`), the device soak (`tools/device_soak.py`) and
`tools/dump_columns.py` against the JAX package's.

The `.dt` subcommands write byte-identical files and print the same
output in both packages. `serve-bench --dry-run` gives JAX's report but
its steer and jit keys, and the port's choices for `--pallas`, `--steer`,
`--device-stage` and `--real-device` are pinned. The subcommands that
boot servers (`scenario run`, `replicate-soak`, `rebalance-soak`,
`read-bench`) pass on `--device cpu`,
and `dt-trace` / `obs-watch` read a port server. The seeded soak gives
JAX's events, `dump_columns` JAX's bytes, and the device soak, on the CPU
with each package's module reading its own fake clock, JAX's event
sequence and final text; a fault of its device session is fail-stop.
"""

import importlib
import json
import random
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

import diamond_types_tpu.tools.cli as jcli
import diamond_types_tpu_torch.tools.cli as tcli

from torch_parity import FakeClock, FakeTime

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = "diamond_types_tpu", "diamond_types_tpu_torch"
CLIS = (jcli, tcli)


def _run(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def _both(argv_of, capsys):
    """Each package's CLI on its own argv (argv_of(pkg_index))."""
    return [_run(cli, argv_of(i), capsys) for i, cli in enumerate(CLIS)]


# ---- the .dt subcommands ------------------------------------------------------

def test_dt_subcommands_write_the_same_files(tmp_path, capsys):
    files = [tmp_path / "jax.dt", tmp_path / "port.dt"]
    steps = [["create", "{f}", "--content", "hello world", "--agent", "seph"],
             ["cat", "{f}"],
             ["set", "{f}", "--content", "hello brave world", "--agent",
              "seph"],
             ["set", "{f}", "--content", "brave new world", "--agent",
              "mike"],
             ["cat", "{f}"], ["version", "{f}"], ["log", "{f}"],
             ["log", "{f}", "--history"], ["log", "{f}", "--transformed"],
             ["cat", "{f}", "--version", "[0]"],
             ["repack", "{f}"], ["dot", "{f}"], ["export", "{f}"],
             ["create", "{f}", "--content", "x"]]
    for step in steps:
        outs = _both(lambda i: [a.format(f=files[i]) for a in step], capsys)
        assert outs[1] == outs[0], step
        assert files[1].read_bytes() == files[0].read_bytes(), step
    assert outs[0][0] == 1                  # create refuses to overwrite
    rc, out = _run(tcli, ["export", str(files[1])], capsys)
    assert json.loads(out)["endContent"] == "brave new world"


def test_git_import_writes_the_same_file(tmp_path, capsys):
    repo = tmp_path / "repo"
    repo.mkdir()

    def git(*args):
        subprocess.run(["git", "-C", str(repo)] + list(args), check=True,
                       capture_output=True,
                       env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@x",
                            "GIT_COMMITTER_NAME": "t",
                            "GIT_COMMITTER_EMAIL": "t@x",
                            "PATH": "/usr/bin:/bin:/usr/local/bin",
                            "HOME": str(tmp_path)})

    git("init", "-b", "main")
    (repo / "a.txt").write_text("one\n")
    git("add", "a.txt")
    git("commit", "-m", "c1")
    (repo / "a.txt").write_text("one\ntwo\n")
    git("commit", "-am", "c2")
    git("checkout", "-b", "side", "HEAD~1")
    (repo / "a.txt").write_text("zero\none\n")
    git("commit", "-am", "c3")
    git("checkout", "main")
    git("merge", "side", "-m", "merge")
    outs = [tmp_path / "j.dt", tmp_path / "p.dt"]
    res = _both(lambda i: ["git-import", "a.txt", "--repo", str(repo),
                           "--out", str(outs[i])], capsys)
    assert res[0][0] == res[1][0] == 0
    assert outs[1].read_bytes() == outs[0].read_bytes()
    cats = _both(lambda i: ["cat", str(outs[i])], capsys)
    assert cats[1] == cats[0]
    assert {"zero", "one", "two"} <= set(cats[1][1].split())


# ---- serve-bench --------------------------------------------------------------

# the serve-bench report's keys JAX reads from its steer table and jit
# caches: the port has neither
JAX_ONLY_KEYS = {"steer", "jit_hit_rate", "steady_jit_hit_rate",
                 "steady_jit_lookups"}


def _report(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _stable(r: dict) -> dict:
    """The report's keys that do not depend on the host's speed, but the
    port's own counters (the transform block's linearizer counts, which
    `test_serve_bench_counts_resolves_by_linearizer` checks)."""
    totals = {k: v for k, v in r["metrics"]["totals"].items()
              if k != "pallas_fallbacks"}
    transform = {k: v for k, v in r["transform"].items()
                 if not k.startswith("linearized_")}
    return {"parity_ok": r["parity_ok"], "slo_ok": r["slo_ok"],
            "total_ops": r["total_ops"], "transform": transform,
            "totals": totals,
            "fused_device_calls": r["fused_device_calls"],
            "parity_mismatches": r["parity_mismatches"]}


@pytest.mark.parametrize("flags", [[], ["--device-plan", "--mesh-window"],
                                   ["--device-plan", "--pallas",
                                    "--no-workers", "--steady-rounds", "0"]],
                         ids=["preset", "plan-window", "plan-pallas"])
def test_serve_bench_dry_run_matches_jax(flags, capsys):
    """The dry-run preset (host engine, 2 shards, 4 documents, 6 txns) on
    the CPU: JAX's report but its steer and jit keys, up to the config
    keys each driver has of its own (JAX's `pallas`/`steer`/
    `device_stage`, the port's `device`/`place_on_devices`)."""
    (jrc, jout), (trc, tout) = _both(
        lambda i: ["serve-bench", "--dry-run", "--json", *flags], capsys)
    assert jrc == trc == 0
    j, t = _report(jout), _report(tout)
    assert _stable(t) == _stable(j)
    assert sorted(t) == sorted(set(j) - JAX_ONLY_KEYS)
    jc = {k: v for k, v in j["config"].items()
          if k not in ("pallas", "steer", "device_stage")}
    tc = {k: v for k, v in t["config"].items()
          if k not in ("device", "place_on_devices")}
    assert tc == jc and t["config"]["engine"] == "host"
    (_, jhuman), (_, thuman) = _both(
        lambda i: ["serve-bench", "--dry-run", *flags], capsys)
    assert "parity OK" in thuman and "device calls/window" in thuman


def _device_bench(extra, capsys):
    rc, out = _run(tcli, ["serve-bench", "--device", "cpu", "--json",
                          "--shards", "2", "--docs", "8", "--max-sessions",
                          "8", "--mode", "concurrent", "--device-plan",
                          "--no-workers", *extra], capsys)
    assert rc == 0
    return _report(out)


def test_pallas_and_real_device_flags_change_nothing(capsys):
    """`--pallas` / `--no-pallas` and `--real-device` are accepted and
    change nothing: K1 is always the top rung, and the card is already the
    default device."""
    runs = []
    for extra in ([], ["--pallas"], ["--no-pallas"], ["--real-device"]):
        r = _device_bench(extra, capsys)
        # the K1 rung (fused calls) and K2 (device resolves) ran every time
        assert r["fused_device_calls"] > 0 and r["transform"]["batches"] > 0
        assert r["parity_ok"] and r["metrics"]["totals"]["host_fallbacks"] == 0
        runs.append((sorted(r), r["config"], r["total_ops"]))
    assert all(r == runs[0] for r in runs[1:])
    assert "pallas" not in runs[0][1]


def test_serve_bench_counts_resolves_by_linearizer(capsys):
    """The port's serve bench reports its resolves by the linearizer they
    ran: on the CPU, the plain chain every time."""
    t = _device_bench([], capsys)["transform"]
    assert t["batches"] > 0 and t["linearized_kernel"] == 0
    assert t["linearized_plain"] == t["batches"]


def test_steer_flag_maps_to_the_steering_switch(capsys):
    """`--steer`, `--no-steer` and `--no-device-stage` are accepted for the
    JAX package's command line and change nothing: the window's report is
    the one with no flag, apart from what the flush deadlines' timing
    moves, and the dry-run preset passes its parity gate with each."""
    runs = []
    for extra in ([], ["--steer"], ["--no-steer"], ["--no-device-stage"]):
        r = _device_bench(["--mesh-window", *extra], capsys)
        assert r["parity_ok"] and r["metrics"]["window"]["mesh_docs"] > 0
        assert not JAX_ONLY_KEYS & set(r)
        runs.append((sorted(r), r["config"], r["total_ops"],
                     sorted(r["metrics"]), sorted(r["metrics"]["window"]),
                     r["scorecard"]["scenario"],
                     sorted(r["scorecard"]["serve"])))
        rc, out = _run(tcli, ["serve-bench", "--dry-run", "--json", *extra],
                       capsys)
        assert rc == 0 and _report(out)["parity_ok"]
    assert all(r == runs[0] for r in runs[1:])


def test_serve_bench_zone_sessions_on_the_cpu(capsys):
    r = _device_bench(["--no-fused"], capsys)
    assert r["config"]["fused"] is False and r["parity_ok"]


# ---- the subcommands that boot servers ----------------------------------------

def test_scenario_run_and_scorecard_diff(tmp_path, capsys):
    assert _both(lambda i: ["scenario", "list"], capsys)[1] == \
        _both(lambda i: ["scenario", "list"], capsys)[0]
    card_path = tmp_path / "smoke.json"
    rc, out = _run(tcli, ["scenario", "run", "--name", "smoke", "--device",
                          "cpu", "--out", str(card_path)], capsys)
    assert rc == 0, out
    card = json.loads(out)
    assert card["ok"] and card["convergence"]["converged"]
    p = str(card_path)
    assert _run(tcli, ["scorecard-diff", p, p, "--gate"], capsys)[0] == 0
    card["totals"]["errors"] = 3
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(card))
    diffs = _both(lambda i: ["scorecard-diff", p, str(bad), "--gate"],
                  capsys)
    # JAX's bands have the jit-cache one too, which the port's card has no
    # figure for: it lists that band as not gated, and nothing else differs
    jax_only = "\n  (not gated — missing on one side: " \
        "serve.jit_cache_hit_rate)"
    assert jax_only in diffs[0][1]
    assert diffs[1] == (diffs[0][0], diffs[0][1].replace(jax_only, ""))
    assert diffs[1][0] == 1
    assert _run(tcli, ["scorecard-diff", p, str(bad)], capsys)[0] == 0
    assert _run(tcli, ["scenario", "run"], capsys)[0] == 2
    assert _run(tcli, ["scenario", "run", "--name", "nope", "--device",
                       "cpu"], capsys)[0] == 2


@pytest.mark.parametrize("argv,verdict", [
    (["replicate-soak", "--rounds", "8", "--serve-shards", "1"],
     "CONVERGED"),
    (["rebalance-soak"], "CONVERGED OK"),
    (["read-bench", "--reads-per-reader", "20"], ": OK")],
    ids=["replicate-soak", "rebalance-soak", "read-bench"])
def test_server_subcommands_pass_on_the_cpu(argv, verdict, capsys):
    rc, out = _run(tcli, argv + ["--device", "cpu"], capsys)
    assert rc == 0, out
    assert verdict in out


def _serve_port():
    from diamond_types_tpu_torch.tools.server import serve
    httpd = serve(port=0, serve_shards=2, device="cpu",
                  obs_opts={"sample_rate": 1.0})
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"127.0.0.1:{httpd.server_address[1]}"


def test_dt_trace_and_obs_watch_read_a_port_server(capsys):
    import time
    httpd, addr = _serve_port()
    try:
        req = urllib.request.Request(
            f"http://{addr}/doc/tdoc/edit",
            data=json.dumps({"agent": "t", "version": [],
                             "ops": [{"kind": "ins", "pos": 0,
                                      "text": "hello"}]}).encode("utf8"))
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.status == 200
        httpd.store.scheduler.drain()
        obs = httpd.store.obs
        tid = None
        deadline = time.monotonic() + 3.0
        while tid is None and time.monotonic() < deadline:
            tid = next((s["trace"] for s in obs.tracer.spans()
                        if s["name"] == "http.doc_edit"
                        and s["parent"] is None), None)
            time.sleep(0.01)
        assert tid is not None
        rc, out = _run(tcli, ["dt-trace", addr], capsys)
        assert rc == 0 and tid in out and "recent traces" in out
        rc, out = _run(tcli, ["dt-trace", addr, tid, "--json"], capsys)
        assert rc == 0
        assert json.loads(out)["traces"][0]["trace"] == tid
        obs.ts.observe("serve.flush", 0.01)
        rc, out = _run(tcli, ["obs-watch", addr, "--rounds", "1",
                              "--interval", "0"], capsys)
        assert rc == 0 and "== slo ==" in out and "== hot docs ==" in out
        rc, out = _run(tcli, ["obs-report", addr], capsys)
        assert rc == 0
        rc, out = _run(tcli, ["dt-incidents", addr], capsys)
        assert rc == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---- tools/soak.py ------------------------------------------------------------

def test_soak_gives_jaxs_events(tmp_path):
    from diamond_types_tpu.tools import soak as jsoak
    from diamond_types_tpu_torch.tools import soak as tsoak
    for seed in (1_000_000, 1_000_001):
        assert tsoak.run_seed(seed) == jsoak.run_seed(seed)
    events = []
    for i, mod in enumerate((jsoak, tsoak)):
        log = tmp_path / f"{i}.jsonl"
        assert mod.main(["--seed0", "7", "--count", "2",
                         "--log", str(log)]) == 0
        events.append([{k: v for k, v in json.loads(ln).items()
                        if k != "ts"}
                       for ln in log.read_text().splitlines()])
    assert events[1] == events[0]
    assert [e["event"] for e in events[1]] == ["soak_start", "soak_end"]


def test_soak_checkouts_stay_on_the_host(monkeypatch):
    """Once the engine policy prefers the zone engine, `OpLog.checkout`
    would merge on CUDA; the soak reads every text through the C++
    tracker and never asks the merge engines."""
    from diamond_types_tpu_torch.listmerge import policy
    from diamond_types_tpu_torch.text import branch
    from diamond_types_tpu_torch.tools import soak as tsoak

    def never(*_a, **_k):
        raise AssertionError("a checkout went to the merge engines")

    monkeypatch.setattr(policy.GLOBAL, "choose", lambda *_a: policy.ZONE)
    monkeypatch.setattr(branch.Branch, "merge", never)
    assert tsoak.run_seed(1_000_002)["ops"] > 0


def test_bench_gate_reads_the_pid_file(tmp_path, monkeypatch):
    """The port's copy of the repo-root bench gate: a live holder whose
    command line names bench, nothing else."""
    from diamond_types_tpu_torch.tools import soak as tsoak
    marker = tmp_path / ".bench_active"
    monkeypatch.setattr(tsoak, "BENCH_ACTIVE", str(marker))
    assert not tsoak.bench_is_active()
    marker.write_text("0")
    assert not tsoak.bench_is_active()
    p = subprocess.Popen([sys.executable, "-c",
                          "import sys, time; time.sleep(30)", "bench"])
    try:
        marker.write_text(str(p.pid))
        assert tsoak.bench_is_active()
    finally:
        p.kill()
        p.wait()
    assert not tsoak.bench_is_active()


# ---- tools/dump_columns.py ----------------------------------------------------

def _history(seed: int = 3, n: int = 60):
    """Two agents typing from their own heads, joined every 10 edits."""
    from diamond_types_tpu_torch.text.branch import Branch
    from diamond_types_tpu_torch.text.oplog import OpLog
    rng = random.Random(seed)
    ol = OpLog()
    a = ol.get_or_create_agent_id("alice")
    b = ol.get_or_create_agent_id("bob")
    heads, lens = {a: [], b: []}, {a: 0, b: 0}
    for i in range(n):
        ag = a if i % 2 == 0 else b
        pos = rng.randrange(lens[ag] + 1)
        heads[ag] = [ol.add_insert_at(ag, heads[ag], pos, "xy")]
        lens[ag] += 2
        if i % 10 == 9:
            v = list(ol.version)
            heads[a], heads[b] = v, list(v)
            br = Branch()
            br.merge_reference(ol, v)
            lens[a] = lens[b] = len(br.snapshot())
    return ol


def _dt_file(tmp_path) -> Path:
    from diamond_types_tpu_torch.encoding.encode import (ENCODE_FULL,
                                                         encode_oplog)
    path = tmp_path / "history.dt"
    path.write_bytes(encode_oplog(_history(), ENCODE_FULL))
    return path


def test_dump_columns_writes_jaxs_bytes(tmp_path, monkeypatch, capsys):
    src = _dt_file(tmp_path)
    outs = []
    for i, root in enumerate((JAX, PORT)):
        mod = importlib.import_module(f"{root}.tools.dump_columns")
        out = tmp_path / f"{i}.bin"
        monkeypatch.setattr(sys, "argv", ["dump_columns", str(src),
                                          str(out)])
        mod.main()
        outs.append(out.read_bytes())
    assert outs[1] == outs[0] and len(outs[0]) > 64
    assert capsys.readouterr().out.count("dumped 120 ops") == 2
    a = (REPO / JAX / "tools/dump_columns.py").read_text().split('"""', 2)
    b = (REPO / PORT / "tools/dump_columns.py").read_text().split('"""', 2)
    assert b[2] == a[2]


# ---- tools/device_soak.py -----------------------------------------------------

class TickClock(FakeClock):
    """A fake clock that moves one second at every read."""

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _device_soak(root, monkeypatch, path, log, hours="0.02"):
    """`root`'s device soak on the CPU, its module's `time` a TickClock;
    returns (rc, events without stamps, the last session's text)."""
    mod = importlib.import_module(f"{root}.tools.device_soak")
    monkeypatch.setattr(mod, "time", FakeTime(TickClock()))
    sess_mod = importlib.import_module(
        f"{root}.{'gpu' if root == PORT else 'tpu'}.zone_session")
    made = []

    class Kept(sess_mod.DeviceZoneSession):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(sess_mod, "DeviceZoneSession", Kept)
    argv = ["--corpus", str(path), "--hours", hours, "--log", str(log)]
    if root == PORT:
        argv += ["--device", "cpu"]
    rc = mod.main(argv)
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    return rc, events, made[-1].text() if made else None


def test_device_soak_gives_jaxs_events_and_text(tmp_path, monkeypatch):
    path = _dt_file(tmp_path)
    (jrc, jev, jtext), (trc, tev, ttext) = [
        _device_soak(root, monkeypatch, path, tmp_path / f"{root}.jsonl")
        for root in (JAX, PORT)]
    assert jrc == trc == 0
    assert tev == jev
    assert [e["event"] for e in tev] == ["soak_start", "session_built",
                                         "soak_end"]
    assert tev[-1]["syncs"] > 0 and tev[-1]["crashes"] == 0
    assert ttext == jtext and len(ttext) > 0


def test_device_soak_fault_is_fail_stop(tmp_path, monkeypatch):
    """A fault of the device session ends the run with exit 2 and a
    `device_crash` event; the JAX soak would rebuild the session and go
    on."""
    from diamond_types_tpu_torch.gpu import zone_session
    real = zone_session.DeviceZoneSession.sync
    calls = []

    def faulty(self):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted device fault")
        return real(self)

    monkeypatch.setattr(zone_session.DeviceZoneSession, "sync", faulty)
    rc, events, _text = _device_soak(PORT, monkeypatch, _dt_file(tmp_path),
                                     tmp_path / "fault.jsonl")
    assert rc == 2
    kinds = [e["event"] for e in events]
    assert kinds == ["soak_start", "session_built", "device_crash"]
    crash = events[-1]
    assert crash["fatal"] and crash["syncs"] == 2
    assert "planted device fault" in crash["error"]


def test_device_soak_reference_is_the_tracker(tmp_path, monkeypatch):
    """The expected text at every sync, and the heads' lengths, come from
    the C++ tracker: with `Branch.merge` (and so `OpLog.checkout`) unusable
    the soak still runs."""
    from diamond_types_tpu_torch.text import branch

    def never(*_a, **_k):
        raise AssertionError("a checkout went to the merge engines")

    monkeypatch.setattr(branch.Branch, "merge", never)
    rc, events, _ = _device_soak(PORT, monkeypatch, _dt_file(tmp_path),
                                 tmp_path / "ref.jsonl", hours="0.005")
    assert rc == 0 and events[-1]["syncs"] > 0


def test_main_module_runs():
    r = subprocess.run([sys.executable, "-m", f"{PORT}.tools.cli", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0
    jr = subprocess.run([sys.executable, "-m", f"{JAX}.tools.cli", "--help"],
                        cwd=REPO, capture_output=True, text=True, timeout=120,
                        env={**__import__("os").environ,
                             "JAX_PLATFORMS": "cpu"})
    sub = lambda t: t[t.index("{"):t.index("}") + 1]   # noqa: E731
    assert sub(r.stdout) == sub(jr.stdout)
