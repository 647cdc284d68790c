"""Unified observability for the serve scheduler and replication mesh.

One `Observability` bundle per server process ties together:

  trace.py      sampled spans with X-DT-Trace cross-host propagation
  hist.py       log-bucketed latency histograms (p50/p90/p99)
  recorder.py   flight recorder — bounded ring of structured events
  prom.py       Prometheus/OpenMetrics exposition of the /metrics JSON
  devprof.py    wall-vs-device flush timing, transfers
  timeseries.py windowed ring: live rate()/quantile() per family
  slo.py        multi-window burn-rate SLO engine (/debug/slo)
  exemplars.py  last sampled trace id per histogram bucket
  attrib.py     top-K hot-doc/agent sketch (/debug/hot)
  journey.py    edit-to-visibility stage stamps + convergence lag
  assemble.py   cross-host trace assembly (clock-aligned waterfall
                + critical path; consumed by `cli dt-trace`)
  scorecard.py  versioned per-scenario scorecards + tolerance-band
                diffs (consumed by `cli scenario` / `scorecard-diff`)

The bundle is attached as `DocStore.obs` by tools/server.serve() and
propagated from there: MergeScheduler.attach_obs() wires the tracer
and recorder into the admit→flush path, attach_replication() hands it
to ReplicaNode for lease/fencing/circuit events and proxy tracing.
Everything degrades to a no-op when the bundle is absent or disabled —
hot paths pay one branch, zero allocations.
"""

from __future__ import annotations

from .attrib import HotAttribution, SpaceSaving
from .devprof import PROFILER, DeviceProfiler, note_transfer
from .exemplars import ExemplarStore
from .hist import BOUNDS, Histogram, HistogramSet
from .incident import INCIDENT_KINDS, AnomalyDetector, IncidentStore
from .journey import STAGES as JOURNEY_STAGES
from .journey import OpJourney
from .prom import CONTENT_TYPE, OPENMETRICS_CONTENT_TYPE, render_metrics
from .recorder import FlightRecorder
from .scorecard import (SCORECARD_VERSION, build_scorecard,
                        diff_scorecards, last_scenario,
                        publish_scenario)
from .slo import Objective, SloEngine, default_objectives
from .timeseries import TimeSeries
from .trace import (NOOP_SPAN, TRACE_HEADER, Span, SpanContext, Tracer,
                    format_context, parse_header)

__all__ = [
    "Observability", "Tracer", "Span", "SpanContext", "NOOP_SPAN",
    "TRACE_HEADER", "format_context", "parse_header",
    "Histogram", "HistogramSet", "BOUNDS",
    "FlightRecorder",
    "CONTENT_TYPE", "OPENMETRICS_CONTENT_TYPE", "render_metrics",
    "PROFILER", "DeviceProfiler", "note_transfer",
    "TimeSeries", "SloEngine", "Objective", "default_objectives",
    "ExemplarStore", "HotAttribution", "SpaceSaving",
    "OpJourney", "JOURNEY_STAGES",
    "AnomalyDetector", "IncidentStore", "INCIDENT_KINDS",
    "SCORECARD_VERSION", "build_scorecard", "diff_scorecards",
    "publish_scenario", "last_scenario",
]


class Observability:
    """Per-server bundle: tracer + flight recorder + HTTP histograms.

    `sample_rate` head-samples trace roots (default 1%: cheap enough
    to leave on in soak runs); `enabled=False` turns the tracer and
    recorder into allocation-free no-ops while keeping the histograms
    (they are counters, not samples — always worth having).
    """

    def __init__(self, sample_rate: float = 0.01,
                 trace_capacity: int = 2048,
                 recorder_capacity: int = 512,
                 seed: int = 0, enabled: bool = True,
                 telemetry: bool = True,
                 ts_window_s: float = 10.0, ts_windows: int = 360,
                 objectives=None, attrib_k: int = 64,
                 journey: bool = True,
                 journey_capacity: int = 512,
                 incidents: bool = True,
                 incident_dir=None,
                 incident_opts=None) -> None:
        self.tracer = Tracer(sample_rate=sample_rate,
                             capacity=trace_capacity,
                             seed=seed, enabled=enabled)
        self.recorder = FlightRecorder(capacity=recorder_capacity,
                                       enabled=enabled)
        self.hist = HistogramSet()
        # live telemetry tier: windowed time-series + SLO burn rates +
        # exemplars + hot-key attribution. `telemetry=False` keeps the
        # cumulative tier while turning every live-tier write into a
        # single-branch no-op (the bench A/B toggle).
        live = enabled and telemetry
        self.ts = TimeSeries(window_s=ts_window_s, n_windows=ts_windows,
                             enabled=live)
        self.slo = SloEngine(self.ts, objectives=objectives,
                             recorder=self.recorder)
        self.exemplars = ExemplarStore(enabled=live)
        self.attrib = HotAttribution(k=attrib_k, enabled=live)
        # edit-to-visibility journey tracker: stamps ride the sampled
        # traces, so it follows the tracer's enablement; `journey=False`
        # is the bench A/B control arm (single-branch no-op stamps)
        self.journey = OpJourney(capacity=journey_capacity,
                                 ts=self.ts if live else None,
                                 enabled=enabled and journey)
        # incident engine: pull-driven anomaly detection over the live
        # tier + evidence-bundle capture. `incidents=False` is the
        # bench A/B control arm (poll() is a single-branch no-op); the
        # store stays constructed so /debug/incidents answers (empty)
        # and the prom families zero-fill either way.
        opts = dict(incident_opts or {})
        store_opts = {k: opts.pop(k) for k in ("capacity", "prefix")
                      if k in opts}
        self.incidents = IncidentStore(data_dir=incident_dir,
                                       **store_opts)
        self.incidents.attach(self)
        self.incident_detector = AnomalyDetector(
            self.ts, recorder=self.recorder, store=self.incidents,
            enabled=live and incidents, **opts)

    def snapshot(self) -> dict:
        # pull-driven detection (the SloEngine idiom): every snapshot
        # (== every /metrics scrape) re-evaluates the watched series
        self.incident_detector.poll()
        det = self.incident_detector.snapshot()
        sto = self.incidents.snapshot()
        out = {"trace": self.tracer.stats(),
               "recorder": self.recorder.stats(),
               "http": self.hist.snapshot(),
               "devprof": PROFILER.snapshot(),
               "timeseries": self.ts.snapshot(),
               "slo": self.slo.snapshot(),
               "exemplars": self.exemplars.snapshot(),
               "hot": self.attrib.snapshot(),
               "journey": self.journey.snapshot(),
               "incidents": {"version": 1, **sto, **det}}
        # concurrency-invariant tier (analysis/): the runtime lock
        # witness is always reported (enabled=False when off); the
        # lint block appears once a dt-lint run published a report in
        # this process
        from ..analysis import last_report, witness_snapshot
        out["witness"] = witness_snapshot()
        lint = last_report()
        if lint is not None:
            out["lint"] = lint
        # the model-checker verdict rides the same pattern: present
        # once a dt-explore run published in this process
        from ..analysis.explore import last_report as explore_report
        explore = explore_report()
        if explore is not None:
            out["explore"] = explore
        # the scenario runner's live snapshot (workload/runner.py
        # publishes each tick): present while/after a run in this
        # process — obs-watch renders it as the scenario panel
        scen = last_scenario()
        if scen is not None:
            out["scenario"] = scen
        return out
