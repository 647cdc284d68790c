"""The port's observability layer (`obs/`, and `read/metrics.py`) against
the JAX package's.

The modules are copies: each file must equal the JAX package's byte for
byte but the lines the port rewrote or dropped (`EXTENDED`: among them
what reads or feeds a jit cache, which the port does not have), and
`obs/__init__.py` is JAX's without its jit-lookup hook (its `snapshot()`
carries the `lint` and `explore` lookups). Then both packages'
`Observability` bundles run one
seeded script
on clocks advanced alike (every obs module's `time` reads a `FakeClock`),
and everything they report must be equal: the tracer's sampling decisions
and span trees, the SLO rows and alert transitions under tight custom
objectives, the incidents and their evidence bundles (each package
writing its own directory), the journey's lag summary, the scorecards
and their diff, the Prometheus text for one document, and the keys of
`snapshot()`. Trace and span ids are random by design (they draw from the
process id and the clock's nanoseconds), so they are compared by their
order of appearance, not by value.
"""

import inspect
import json
import random
from dataclasses import astuple
from pathlib import Path
from types import SimpleNamespace

import pytest

import diamond_types_tpu.analysis.explore.engine as jexplore
import diamond_types_tpu.analysis.lint as jlint
import diamond_types_tpu.obs as jobs
import diamond_types_tpu.obs.prom as jprom
import diamond_types_tpu.obs.scorecard as jscore
import diamond_types_tpu.obs.slo as jslo
import diamond_types_tpu.obs.trace as jtrace
import diamond_types_tpu_torch.analysis.explore.engine as texplore
import diamond_types_tpu_torch.analysis.lint as tlint
import diamond_types_tpu_torch.obs as tobs
import diamond_types_tpu_torch.obs.prom as tprom
import diamond_types_tpu_torch.obs.scorecard as tscore
import diamond_types_tpu_torch.obs.slo as tslo
import diamond_types_tpu_torch.obs.trace as ttrace
from diamond_types_tpu_torch.read import READ_KEYS, ReadMetrics
from diamond_types_tpu_torch.serve.metrics import ServeMetrics

from torch_parity import FakeClock, clock_modules, span_forest

pytestmark = pytest.mark.obs

REPO = Path(__file__).resolve().parent.parent
COPIED = ("obs/hist.py", "obs/recorder.py", "obs/trace.py",
          "obs/devprof.py", "obs/exemplars.py", "obs/attrib.py",
          "obs/journey.py", "obs/slo.py", "obs/incident.py",
          "obs/scorecard.py", "obs/assemble.py", "read/metrics.py",
          "obs/prom.py")
JAX = SimpleNamespace(name="jax", root="diamond_types_tpu", obs=jobs,
                      slo=jslo, trace=jtrace, score=jscore, prom=jprom)
PORT = SimpleNamespace(name="port", root="diamond_types_tpu_torch", obs=tobs,
                       slo=tslo, trace=ttrace, score=tscore, prom=tprom)
PKGS = (JAX, PORT)


# ---- the copies ---------------------------------------------------------------

# copies the port extends for its flush timing: the tracer's `t0_ns`/`t1_ns`
# and `resize`, the phase families in prom, devprof's docstrings rewritten
# for the port; and copies that drop what reads or feeds a jit cache, which
# the port does not have: devprof's jit counts, prom's three jit families
# and the scorecard's `serve.jit_cache_hit_rate` band. Each keeps every line
# of JAX's file, in order, but lines of its docstrings and the code lines
# named here, which the port rewrote or dropped.
EXTENDED = {
    "obs/trace.py": ('"t0", "attrs", "_done")',),
    "obs/prom.py": (
        '# zero-fill the known jit families (the HYDRATION_KEYS idiom): the',
        '# "xform"/"pallas" rows exist from the first scrape, not only after',
        '# the first transform/Pallas dispatch seeds the cache',
        'jit: dict = {k: {} for k in ("fused", "mesh", "micro", "tip",',
        '"xform", "pallas")} if dp else {}',
        'jit.update(dp.get("jit_cache") or {})',
        'for cache, hm in sorted(jit.items()):',
        'lb = {"cache": cache}',
        'hits = hm.get("hits", 0)',
        'misses = hm.get("misses", 0)',
        'b.add("dt_devprof_jit_hits_total", "counter", hits, labels=lb)',
        'b.add("dt_devprof_jit_misses_total", "counter", misses,',
        'labels=lb)',
        '# zero-filled hit-rate gauge per cache (0.0 until a lookup)',
        'b.add("dt_devprof_jit_hit_rate", "gauge",',
        'round(hits / (hits + misses), 4) if hits + misses',
        'else 0.0, labels=lb)',
        '# jit-family idiom above — every stage row exists from the first',
    ),
    "obs/devprof.py": (
        'self._jit: Dict[str, list] = {}',
        'self._jit = {}',
        '',
        'def note_jit(self, cache: str, hit: bool) -> None:',
        'if not self.enabled:',
        'return',
        'with self._lock:',
        'c = self._jit.setdefault(cache, [0, 0])',
        'c[0 if hit else 1] += 1',
        'jit = {k: {"hits": v[0], "misses": v[1]}',
        'for k, v in sorted(self._jit.items())}',
        '"jit_cache": jit,',
        'def note_jit_lookup(cache: str, hit: bool) -> None:',
        'if PROFILER.enabled:',
        'PROFILER.note_jit(cache, hit)',
        '',
        '',
    ),
    "obs/scorecard.py": (
        '# device flush-pipeline block (shape steering + staging): jit',
        '# hit rate, staged bytes per mesh window, dispatch fan-in.',
        '# Absent on host-engine runs (and pre-steer baselines) so the',
        '# new bands skip instead of gating — missing-path semantics.',
        '# device flush pipeline (shape steering + device-resident staging,',
        '# scorecard `serve` block): hit rate must not drop more than 5',
        '# points; staged bytes per window must not grow past the band;',
        '# dispatch fan-in (device calls per window) must not balloon.',
        '# Absent entirely on host-engine scorecards — never gates there.',
        '# The staged band is sized to catch STATE-staging regressions',
        '# (losing device residency multiplies the figure ~5x), while',
        "# letting steering's padded plan arrays through — padding a window",
        '# up to a warm class grows the host-built plan upload by up to',
        '# `max_waste` (4x cells) by design, and that is the trade the',
        '# steer A/B makes on purpose (plan kilobytes for compile seconds).',
        '"serve.jit_cache_hit_rate": Band("higher", rel=0.0, abs_=0.05),',
    ),
}
# the band the port drops with the jit cache it does not have
JAX_ONLY_BANDS = ("serve.jit_cache_hit_rate",)


def _docstring_lines(src: str) -> set:
    """Line indexes (0-based) of every docstring in `src`."""
    import ast
    out = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) \
                    and isinstance(first.value, ast.Constant) \
                    and isinstance(first.value.value, str):
                out.update(range(first.lineno - 1, first.end_lineno))
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_module_is_a_byte_identical_copy(rel):
    jax_src = (REPO / "diamond_types_tpu" / rel).read_bytes()
    port_src = (REPO / "diamond_types_tpu_torch" / rel).read_bytes()
    if rel not in EXTENDED:
        assert port_src == jax_src
        return
    import difflib
    j = jax_src.decode("utf8").splitlines()
    t = port_src.decode("utf8").splitlines()
    docs = _docstring_lines(jax_src.decode("utf8"))
    ops = difflib.SequenceMatcher(a=j, b=t, autojunk=False).get_opcodes()
    dropped = [k for tag, i1, i2, _j1, _j2 in ops
               if tag in ("delete", "replace") for k in range(i1, i2)]
    assert tuple(j[k].strip() for k in dropped if k not in docs) \
        == EXTENDED[rel]
    assert any(tag in ("insert", "replace") for tag, *_r in ops)


def test_bundle_differs_only_by_the_lint_and_explore_lookups():
    """`obs/__init__.py`: once the port has `analysis/lint` and
    `analysis/explore`, the bundle differs from JAX's only by the jit-cache
    hook the port does not have: the file is JAX's without
    `note_jit_lookup` (and its docstring's "jit-cache hits"), and
    `snapshot()` carries both lookups."""
    rel = "obs/__init__.py"
    jsrc = (REPO / "diamond_types_tpu" / rel).read_text()
    assert (REPO / "diamond_types_tpu_torch" / rel).read_text() == \
        jsrc.replace(" note_jit_lookup,", "") \
        .replace(' "note_jit_lookup",', "").replace(", jit-cache hits", "")
    assert tobs.__all__ == [n for n in jobs.__all__
                            if n != "note_jit_lookup"]
    for name in tobs.__all__:
        assert hasattr(tobs, name), name
    jo, to = jobs.Observability, tobs.Observability
    assert inspect.signature(to.__init__) == inspect.signature(jo.__init__)
    tsrc = inspect.getsource(to.snapshot)
    assert "last_report" in tsrc and "explore" in tsrc


def test_read_package_exports_only_the_metrics():
    """The metrics came first (with this slice); since the read tier was
    ported, the package exports JAX's whole list, the metrics among it."""
    import diamond_types_tpu.read as jread
    import diamond_types_tpu_torch.read as tread
    assert tread.__all__ == jread.__all__
    assert {"READ_KEYS", "ReadMetrics"} <= set(tread.__all__)
    rm = ReadMetrics()
    assert set(rm.snapshot()["counters"]) == set(READ_KEYS)


# ---- one script through both bundles ------------------------------------------

def _objectives(slo):
    """Tight objectives (short windows, a 50 ms budget), so the script's
    slow stretch burns and the engine walks ok -> warning -> burning."""
    return [slo.Objective("flush_p99", "serve.flush", threshold_s=0.05,
                          target=0.9, fast_window_s=5.0,
                          slow_window_s=30.0, fast_burn=2.0, slow_burn=1.5),
            slo.Objective("queue_wait_p99", "serve.queue_wait",
                          threshold_s=0.2, target=0.95, fast_window_s=5.0,
                          slow_window_s=30.0)]


def _run_script(pkg, monkeypatch, tmp_path: Path) -> SimpleNamespace:
    """Drive one bundle through a seeded script and return what it
    reports. Every random choice comes from `random.Random(7)`."""
    clock = FakeClock()
    clock_modules(monkeypatch, pkg.root, clock)
    inc_dir = tmp_path / pkg.name
    obs = pkg.obs.Observability(
        sample_rate=0.35, seed=11, ts_window_s=1.0, ts_windows=120,
        objectives=_objectives(pkg.slo), incident_dir=str(inc_dir),
        incident_opts={"warmup_polls": 2, "cooldown_s": 4.0,
                       "rate_window_s": 3.0, "stall_after_s": 4.0,
                       "min_rate": 0.2})
    rng = random.Random(7)
    sampled, slo_rows, fired, headers = [], [], [], []
    for step in range(90):
        slow = 40 <= step < 60          # the burning stretch
        quiet = 70 <= step < 80         # serve.flush stalls
        root = obs.tracer.start("http.edit", attrs={"step": step})
        sampled.append(root.sampled)
        child = obs.tracer.start("serve.admit", parent=root.context(),
                                 attrs={"doc": f"d{step % 5}"})
        hdr = root.header()
        headers.append(hdr is not None and
                       pkg.trace.format_context(
                           pkg.trace.parse_header(hdr)) == hdr)
        remote = obs.tracer.start(
            "remote.apply", parent=pkg.trace.parse_header(hdr))
        clock.advance(0.01)
        remote.end(ok=True)
        child.end(outcome="queued")
        key = obs.journey.begin("alice", step, doc=f"d{step % 5}",
                                trace=root.trace_id if root.sampled
                                else None)
        for stage in ("queued", "planned", "device_replayed", "adopted"):
            clock.advance(0.002)
            obs.journey.stamp(key, stage)
        for peer in ("p1", "p2")[:1 + step % 2]:
            obs.journey.stamp(key, "ae_shipped", peer=peer)
            clock.advance(0.05 * (1 + step % 3))
            obs.journey.stamp(key, "applied_at_peer", peer=peer)
            obs.journey.stamp_doc(f"d{step % 5}", "advert_usable",
                                  peer=peer)
        if not quiet:
            for _ in range(1 + (80 if step == 11 else 0)):
                lat = (rng.uniform(0.06, 0.4) if slow
                       else rng.uniform(0.001, 0.02))
                obs.ts.observe("serve.flush", lat)
                obs.ts.inc("serve.flushed_ops", rng.randint(1, 9))
                if root.sampled:
                    obs.exemplars.note("serve.flush", lat, root.trace_id)
        obs.ts.observe("serve.queue_wait", rng.uniform(0.0, 0.3))
        obs.attrib.note("ops", doc=f"d{step % 5}", n=rng.randint(1, 5))
        obs.attrib.note("device_s", doc=f"d{step % 5}",
                        n=rng.uniform(0, 0.01))
        obs.hist.observe("http_request", rng.uniform(0, 0.1),
                         endpoint="/doc", method="POST")
        root.end()
        if step % 3 == 2:
            slo_rows.append(obs.slo.evaluate())
            fired.append(obs.incident_detector.poll())
        clock.advance(0.5)
    files = sorted(p.name for p in (inc_dir / "incidents").iterdir())
    bundles = [json.loads((inc_dir / "incidents" / f).read_text())
               for f in files]
    return SimpleNamespace(
        obs=obs, clock=clock, sampled=sampled, headers=headers,
        spans=span_forest(obs.tracer.spans()), slo_rows=slo_rows,
        fired=fired, files=files, bundles=bundles)


@pytest.fixture
def twins(monkeypatch, tmp_path):
    return [_run_script(pkg, monkeypatch, tmp_path) for pkg in PKGS]


def test_tracer_sampling_and_span_trees_match_jax(twins):
    j, t = twins
    assert t.sampled == j.sampled
    assert 0 < sum(t.sampled) < len(t.sampled)
    assert all(t.headers[i] for i, s in enumerate(t.sampled) if s)
    assert t.spans == j.spans
    assert {r[1] for r in t.spans} == {"http.edit", "serve.admit",
                                      "remote.apply"}
    assert t.obs.tracer.stats() == j.obs.tracer.stats()
    idx = [{k: v for k, v in row.items() if k != "trace"}
           for row in t.obs.tracer.index(limit=10)]
    assert idx == [{k: v for k, v in row.items() if k != "trace"}
                   for row in j.obs.tracer.index(limit=10)]


def test_slo_rows_and_alert_transitions_match_jax(twins):
    j, t = twins
    assert t.slo_rows == j.slo_rows
    states = [r["state"] for rows in t.slo_rows for r in rows
              if r["name"] == "flush_p99"]
    assert {"ok", "warning", "burning"} <= set(states)
    evs = [e for e in t.obs.recorder.dump() if e["kind"] == "slo_transition"]
    assert evs == [e for e in j.obs.recorder.dump()
                   if e["kind"] == "slo_transition"]
    assert t.obs.slo.verdict() == j.obs.slo.verdict()
    assert t.obs.recorder.dump() == j.obs.recorder.dump()


def test_incidents_and_evidence_bundles_match_jax(twins):
    j, t = twins
    assert t.fired == j.fired
    kinds = {k for f in t.fired for k, _s, _d in f}
    assert set(jobs.INCIDENT_KINDS) == kinds
    assert t.files == j.files and t.files
    for tb, jb in zip(t.bundles, j.bundles):
        assert sorted(tb) == sorted(jb)
        # trace ids are random; their count is not
        assert len(tb["traces"]) == len(jb["traces"])
        assert {k: v for k, v in tb.items() if k != "traces"} \
            == {k: v for k, v in jb.items() if k != "traces"}
    assert t.obs.incidents.index_json() == j.obs.incidents.index_json()
    assert t.obs.incident_detector.snapshot() \
        == j.obs.incident_detector.snapshot()


def test_journey_lag_summary_matches_jax(twins):
    j, t = twins
    lag = t.obs.journey.lag_summary()
    assert set(lag) == {"p1", "p2"} and lag["p1"]["n"] > 0
    assert lag == j.obs.journey.lag_summary()
    assert t.obs.journey.snapshot() == j.obs.journey.snapshot()


def test_snapshots_match_jax(twins, monkeypatch):
    """In a process where no dt-lint, dt-explore or scenario run has
    published a report (other tests in this worker may have: the reports
    are module globals), both snapshots have the same keys; once a lint
    and an explore report are published in each package, both gain
    `lint` and `explore`."""
    for mod, name in ((jlint, "_LAST_REPORT"), (jexplore, "_last_report"),
                      (tlint, "_LAST_REPORT"), (texplore, "_last_report"),
                      (jscore, "_LAST_SCENARIO"),
                      (tscore, "_LAST_SCENARIO")):
        monkeypatch.setattr(mod, name, None)
    j, t = twins
    js, ts = j.obs.snapshot(), t.obs.snapshot()
    assert sorted(ts) == sorted(js)
    for mod, name in ((jlint, "_LAST_REPORT"), (tlint, "_LAST_REPORT"),
                      (jexplore, "_last_report"), (texplore, "_last_report")):
        monkeypatch.setattr(mod, name, {"ok": True})
    assert set(j.obs.snapshot()) - set(js) == {"lint", "explore"}
    assert sorted(j.obs.snapshot()) == sorted(t.obs.snapshot())
    for key in ("recorder", "http", "timeseries", "slo", "hot", "journey",
                "incidents"):
        assert ts[key] == js[key], key
    mask = [{k: v for k, v in row.items() if k != "trace"}
            for row in ts["exemplars"]["families"]["serve.flush"]]
    assert mask == [{k: v for k, v in row.items() if k != "trace"}
                    for row in js["exemplars"]["families"]["serve.flush"]]
    json.dumps(ts)


def test_scorecards_and_their_diff_match_jax():
    def cards(score, bands=None):
        base = dict(scenario={"name": "s", "seed": 3}, virtual_s=0.0,
                    totals={"ops": 1000, "writes": 900, "reads": 100,
                            "errors": 0},
                    slo={"slo_ok": True, "burning": [], "warning": []},
                    serve={"jit_cache_hit_rate": None,
                           "staged_bytes_per_window": 512.0,
                           "device_calls_per_window": 1.5,
                           "steer_compiles": 3},
                    hydration={"hydrations": 4}, incidents={"count": 1})
        old = score.build_scorecard(wall_s=2.0,
                                    latency_p99_s={"flush": 0.02},
                                    **base)
        new = score.build_scorecard(wall_s=3.1,
                                    latency_p99_s={"flush": 0.09},
                                    **base)
        return old, new, score.diff_scorecards(old, new, bands)
    # the port's bands are JAX's but the jit-cache one; a stored card that
    # still carries the figure compares as before, through the rest
    jax_bands = {k: v for k, v in jscore.DEFAULT_BANDS.items()
                 if k not in JAX_ONLY_BANDS}
    assert {k: astuple(v) for k, v in tscore.DEFAULT_BANDS.items()} == \
        {k: astuple(v) for k, v in jax_bands.items()}
    assert cards(tscore) == cards(jscore, jax_bands)
    assert not cards(tscore)[2]["ok"]


# the port's own families, rendered from its `flush_phases` block
PORT_ONLY_FAMILIES = ("dt_serve_flush_phase_seconds",
                      "dt_serve_oplog_wait_seconds",
                      "dt_serve_linearize")
# JAX's jit-cache families: the port has no jit cache
JAX_ONLY_FAMILIES = ("dt_devprof_jit_",)


def _without_families(text: str, families) -> str:
    return "".join(
        ln for ln in text.splitlines(keepends=True)
        if not ln.replace("# TYPE ", "", 1).startswith(families))


def test_render_metrics_matches_jax(twins):
    """One /metrics document through both renderers: the port's serve
    metrics (with a recorded flush, its phases, window and hydration
    events), a QoS export and the port's obs snapshot. The port's text is
    JAX's plus its own families (`PORT_ONLY_FAMILIES`) and without JAX's
    jit-cache families (`JAX_ONLY_FAMILIES`); the new latency histograms
    render through the shared loop in both."""
    from diamond_types_tpu_torch.qos import QosController
    t = twins[1]
    m = ServeMetrics(2, 4, 64)
    m.ts = t.obs.ts
    m.bump(0, "submits", 3)
    m.record_flush(0, 2, 7, "size", dur_s=0.004)
    m.record_phases(0, {"extract": 0.001, "fence": 0.002}, 0.0005, [0.003])
    m.record_fused(0, 2)
    m.record_window(1, 2, 1, mesh_docs=2, padded_rows=2, staged_bytes=64)
    m.record_transform(0, device_docs=2, batches=1, linearized_kernel=1)
    m.record_hydration("hydrations", 2)
    m.observe_queue_wait(0.01)
    m.observe_admit_wait(0.008)
    doc = {"serve": m.snapshot(), "qos": QosController().export(),
           "obs": t.obs.snapshot()}
    for om in (False, True):
        text = tprom.render_metrics(doc, openmetrics=om)
        jtext = jprom.render_metrics(doc, openmetrics=om)
        assert _without_families(text, PORT_ONLY_FAMILIES) \
            == _without_families(jtext, JAX_ONLY_FAMILIES)
        assert "dt_devprof_jit_" in jtext and "dt_devprof_jit_" not in text
        assert 'dt_serve_flush_phase_seconds_total{phase="fence"} 0.002' \
            in text
        assert 'dt_serve_flush_phase_seconds_total{phase="serial"} 0' \
            in text
        assert "dt_serve_oplog_wait_seconds_total 0.0005" in text
        assert 'dt_serve_linearize_total{path="kernel"} 1' in text
        assert 'dt_serve_linearize_total{path="plain"} 0' in text
        assert "dt_oplog_hold_latency_seconds_count 1" in text
        assert "dt_admit_wait_latency_seconds_count 1" in text
        assert "dt_flush_latency_seconds_count" in text
        assert "dt_slo_state" in text and "dt_incident_open" in text
    assert tprom.CONTENT_TYPE == jprom.CONTENT_TYPE
