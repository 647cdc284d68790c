"""Prometheus text exposition rendered from the /metrics JSON document.

`render_metrics(doc)` takes the exact dict `GET /metrics` already
serves ({"serve": ..., "replication": ..., "obs": ...}) and flattens
it to the text format (version 0.0.4) as `dt_*` metrics. Rendering
from the JSON snapshot — not from live objects — guarantees the two
formats can never disagree and keeps this module free of locks.

Naming scheme:
  dt_serve_<counter>_total            scheduler totals
  dt_serve_flush_reason_total{reason}
  dt_serve_shard_*{shard}             per-shard gauges/counters
  dt_serve_flush_phase_seconds_total{phase}  the bank flush's phases
                                      (zero-filled over FLUSH_PHASES)
  dt_serve_oplog_wait_seconds_total   blocked before taking the oplog
                                      lock (its holds: the oplog_hold
                                      latency histogram)
  dt_serve_linearize_total{path}      device-plan resolves by the
                                      linearizer they ran (zero-filled
                                      over LINEARIZE_PATHS)
  dt_repl_<group>_<key>_total         replication counters
  dt_rebalance_<counter>_total /      elastic-mesh migrations (zero-
  dt_rebalance_override_table_size    filled) + override-table gauge
  dt_writergroup_<counter>_total /    hot-doc write splitting (zero-
  dt_writergroup_{active_groups,      filled counters + point-in-time
                  member_entries}    table gauges)
  dt_wire_<key>_total{channel}        wire-tier transport accounting
                                      (bytes_sent, bytes_saved, frames,
                                      snapshot_ships per channel)
  dt_qos_<key>_total{class}           adaptive-admission per-class
                                      counters (admitted/shed/deferred,
                                      zero-filled over the class
                                      taxonomy) + the effective-deadline
                                      gauge and controller decisions
  dt_read_<counter>_total             follower-read tier counters
  dt_read_local_ratio /               local-serve ratio gauge +
  dt_read_staleness_seconds           staleness histogram
  dt_<name>_latency_seconds           histograms (flush, queue_wait,
                                      admit_wait, oplog_hold, handoff,
                                      quorum_round, probe,
                                      antientropy_round,
                                      rebalance_drain)
  dt_http_request_seconds{endpoint,method}
  dt_trace_* / dt_recorder_* / dt_devprof_*
  dt_slo_*{objective}                 burn-rate gauges + alert state
  dt_hot_*{dim,kind[,key]}            top-K attribution (bounded: the
                                      sketch caps key cardinality)
  dt_ts_*{series}                     live windowed rates / p99
  dt_journey_*{stage}                 edit-to-visibility stage stamps
                                      (zero-filled over journey.STAGES)
  dt_convergence_lag_*{peer}          per-peer admitted->advert lag
                                      rollup (+ the peer="all" row)
  dt_incident_opened_total{kind}      incident engine: bundles opened
                                      (zero-filled over INCIDENT_KINDS)
  dt_incident_suppressed_total        cooldown-deduped detections
  dt_incident_open                    unacknowledged-bundle gauge

Each metric name is declared exactly once (# TYPE line) no matter how
many labeled samples it carries; label values are escaped per the
exposition spec (backslash, double-quote, newline).

Known-at-registration families (`dt_read_*`, `dt_serve_hydration_*`)
are zero-filled whenever a serve block is present, so a scraper never
sees a series flicker into existence on first use.

`render_metrics(doc, openmetrics=True)` emits OpenMetrics 1.0 instead:
counter TYPE lines drop the `_total` suffix (samples keep it), the
output is terminated by `# EOF`, and histogram `_bucket` lines carry
trace exemplars (`# {trace_id="..."} value ts`) wherever the exemplar
store saw a sampled trace land in that bucket — the p99-outlier-to-
flight-recorder hop. tools/server.py negotiates the format from the
Accept header.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .incident import INCIDENT_KINDS
from .journey import STAGES as JOURNEY_STAGES

CONTENT_TYPE = "text/plain; version=0.0.4"
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"

# prom histogram family -> obs.timeseries family, for exemplar lookup
_EXEMPLAR_FAMILIES = {
    "dt_flush_latency_seconds": "serve.flush",
    "dt_queue_wait_latency_seconds": "serve.queue_wait",
    "dt_hydration_cold_start_latency_seconds":
        "serve.hydration_cold_start",
    "dt_quorum_round_latency_seconds": "repl.quorum_round",
    "dt_handoff_latency_seconds": "repl.handoff",
    "dt_read_staleness_seconds": "read.staleness",
    "dt_read_wait_latency_seconds": "read.read_wait",
}

_SLO_STATE_CODE = {"ok": 0, "warning": 1, "burning": 2}

_EMPTY_HIST = {"count": 0, "sum": 0.0, "buckets": [["+Inf", 0]]}


def escape_label_value(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(round(v, 9))
    return str(v)


def _fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Builder:
    """Accumulates samples grouped by metric family so every name gets
    exactly one # TYPE declaration. In OpenMetrics mode counter TYPE
    lines drop the `_total` suffix, `_bucket` samples may carry
    exemplars, and the output ends with `# EOF`."""

    def __init__(self, openmetrics: bool = False,
                 exemplars: Optional[dict] = None) -> None:
        self.openmetrics = openmetrics
        # metric family name -> {le_string -> {trace, value, ts}}
        self._exemplars = exemplars or {}
        self._order: List[str] = []
        self._fams: Dict[str, dict] = {}

    def add(self, name: str, mtype: str, value,
            labels: Optional[dict] = None,
            suffix: str = "", exemplar: str = "") -> None:
        fam = self._fams.get(name)
        if fam is None:
            fam = {"type": mtype, "lines": []}
            self._fams[name] = fam
            self._order.append(name)
        fam["lines"].append(
            f"{name}{suffix}{_fmt_labels(labels)} "
            f"{_fmt_value(value)}{exemplar}")

    def histogram(self, name: str, snap: dict,
                  labels: Optional[dict] = None) -> None:
        """Render one obs.hist.Histogram.snapshot() (with `buckets`)
        as a Prometheus histogram family."""
        fam_ex = self._exemplars.get(name) if self.openmetrics else None
        for le, cum in snap.get("buckets", []):
            bl = dict(labels or {})
            le_s = le if isinstance(le, str) else repr(float(le))
            bl["le"] = le_s
            ex = ""
            if fam_ex:
                row = fam_ex.get(le_s)
                if row:
                    ex = (f' # {{trace_id="'
                          f'{escape_label_value(row["trace"])}"}} '
                          f'{_fmt_value(row["value"])} '
                          f'{_fmt_value(row["ts"])}')
            self.add(name, "histogram", cum, labels=bl,
                     suffix="_bucket", exemplar=ex)
        self.add(name, "histogram", snap.get("sum", 0.0),
                 labels=labels, suffix="_sum")
        self.add(name, "histogram", snap.get("count", 0),
                 labels=labels, suffix="_count")

    def render(self) -> str:
        out: List[str] = []
        for name in self._order:
            fam = self._fams[name]
            tname = name
            if (self.openmetrics and fam["type"] == "counter"
                    and tname.endswith("_total")):
                tname = tname[:-len("_total")]
            out.append(f"# TYPE {tname} {fam['type']}")
            out.extend(fam["lines"])
        text = "\n".join(out) + "\n"
        if self.openmetrics:
            text += "# EOF\n"
        return text


def _render_serve(b: _Builder, serve: dict) -> None:
    for key, mtype in (("uptime_s", "gauge"),
                       ("batch_occupancy", "gauge"),
                       ("host_fallback_ratio", "gauge"),
                       ("max_depth_seen", "gauge")):
        if key in serve:
            b.add(f"dt_serve_{key}", mtype, serve[key])
    if "queue_bound_violations" in serve:
        b.add("dt_serve_queue_bound_violations_total", "counter",
              serve["queue_bound_violations"])
    for k, v in sorted((serve.get("totals") or {}).items()):
        b.add(f"dt_serve_{k}_total", "counter", v)
    # residency tier (metrics v7): cold->warm hydration + snapshot
    # eviction counters; the cold-start histogram rides the shared
    # latencies loop below as dt_hydration_cold_start_latency_seconds.
    # Zero-filled over HYDRATION_KEYS so the family exists from the
    # first scrape, not from the first hydration.
    from ..serve.metrics import HYDRATION_KEYS
    hyd = {k: 0 for k in HYDRATION_KEYS}
    hyd.update(serve.get("hydration") or {})
    for k, v in sorted(hyd.items()):
        b.add(f"dt_serve_hydration_{k}_total", "counter", v)
    for reason, n in sorted((serve.get("flush_reasons") or {}).items()):
        b.add("dt_serve_flush_reason_total", "counter", n,
              labels={"reason": reason})
    fused = serve.get("fused") or {}
    if fused:
        # fused_calls/fused_docs totals already render from "totals";
        # this block adds the occupancy gauge + histogram (docs folded
        # per vmapped device call)
        b.add("dt_serve_fused_occupancy", "gauge",
              fused.get("occupancy", 0.0))
        for docs, n in sorted((fused.get("occupancy_hist") or {})
                              .items(), key=lambda kv: int(kv[0])):
            b.add("dt_serve_fused_flush_total", "counter", n,
                  labels={"docs": str(docs)})
    window = serve.get("window") or {}
    if window:
        # the mesh flush-window block (metrics schema v6):
        # device_calls_per_window is the N-dispatches-to-1 signal,
        # mesh_occupancy the super-batch padding efficiency
        for key in ("windows", "device_windows", "dispatches", "docs",
                    "mesh_docs", "mesh_padded_rows"):
            if key in window:
                b.add(f"dt_serve_window_{key}_total", "counter",
                      window[key])
        # zero-filled (window.get default): the staging families exist
        # from the first scrape even against a pre-v13 snapshot
        b.add("dt_serve_window_transfer_bytes_total", "counter",
              window.get("staged_bytes", 0))
        b.add("dt_serve_window_staged_bytes_per_window", "gauge",
              window.get("staged_bytes_per_window", 0.0))
        for key in ("device_calls_per_window", "mesh_occupancy"):
            if key in window:
                b.add(f"dt_serve_window_{key}", "gauge", window[key])
        for shards, n in sorted((window.get("shards_hist") or {})
                                .items(), key=lambda kv: int(kv[0])):
            b.add("dt_serve_window_shards_total", "counter", n,
                  labels={"shards": str(shards)})
    for i, row in enumerate(serve.get("per_shard") or []):
        lb = {"shard": str(row.get("shard", i))}
        if "queue_depth" in row:
            b.add("dt_serve_shard_queue_depth", "gauge",
                  row["queue_depth"], labels=lb)
        if "footprint_slots" in row:
            b.add("dt_serve_shard_footprint_slots", "gauge",
                  row["footprint_slots"], labels=lb)
        if "flush_wall_s" in row:
            b.add("dt_serve_shard_flush_wall_seconds_total", "counter",
                  row["flush_wall_s"], labels=lb)
        if "device_sync_s" in row:
            b.add("dt_serve_shard_device_sync_seconds_total", "counter",
                  row["device_sync_s"], labels=lb)
    phases = serve.get("flush_phases")
    if phases is not None:
        # the flush's phases (ServeMetrics v5), zero-filled over
        # FLUSH_PHASES so every phase exists from the first scrape
        from ..serve.metrics import FLUSH_PHASES
        secs = dict.fromkeys(FLUSH_PHASES, 0.0)
        secs.update(phases.get("seconds") or {})
        for phase, v in secs.items():
            b.add("dt_serve_flush_phase_seconds_total", "counter", v,
                  labels={"phase": phase})
        b.add("dt_serve_oplog_wait_seconds_total", "counter",
              phases.get("oplog_wait_s", 0.0))
    transform = serve.get("transform")
    if transform is not None:
        # resolves by linearizer (ServeMetrics v6), zero-filled over
        # LINEARIZE_PATHS so both paths exist from the first scrape
        from ..serve.metrics import LINEARIZE_PATHS
        for path in LINEARIZE_PATHS:
            b.add("dt_serve_linearize_total", "counter",
                  transform.get(f"linearized_{path}", 0),
                  labels={"path": path})
    for name, snap in sorted((serve.get("latencies") or {}).items()):
        b.histogram(f"dt_{name}_latency_seconds", snap)


def _render_qos(b: _Builder, qos: dict) -> None:
    """The adaptive-admission block (QosController.export / the
    scorecard `qos` block). Zero-filled over QOS_CLASSES x
    QOS_CLASS_KEYS and QOS_CTL_KEYS (the HYDRATION_KEYS idiom): an
    idle controller still exports every series, so scrapers never see
    a class flicker into existence on its first shed."""
    from ..qos.classes import QOS_CLASSES
    from ..qos.metrics import QOS_CLASS_KEYS, QOS_CTL_KEYS
    b.add("dt_qos_enabled", "gauge", 1 if qos.get("enabled") else 0)
    classes = qos.get("classes") or {}
    names = sorted(set(QOS_CLASSES) | set(classes))
    for key in QOS_CLASS_KEYS:
        for cls in names:
            b.add(f"dt_qos_{key}_total", "counter",
                  (classes.get(cls) or {}).get(key, 0),
                  labels={"class": cls})
    for cls in names:
        b.add("dt_qos_deadline_seconds", "gauge",
              (classes.get(cls) or {}).get("deadline_s", 0.0),
              labels={"class": cls})
    ctl = qos.get("controller") or {}
    for key in QOS_CTL_KEYS:
        b.add("dt_qos_controller_total", "counter", ctl.get(key, 0),
              labels={"decision": key})
    shed = qos.get("shed") or {}
    if shed:
        b.add("dt_qos_mesh_state", "gauge",
              _SLO_STATE_CODE.get(shed.get("mesh_state", "ok"), 0))
        b.add("dt_qos_hot_tenants", "gauge",
              len(shed.get("hot_tenants") or []))
        b.add("dt_qos_retry_after_seconds", "gauge",
              shed.get("retry_after_s", 0.0))


def _render_read(b: _Builder, read: dict) -> None:
    """The follower-read tier (ServeMetrics v8 `read` block /
    top-level `read` key): READ_KEYS counters as dt_read_*_total, the
    local-serve ratio gauge, the staleness histogram, and the catch-up
    wait histogram (via the shared latency naming)."""
    from ..read.metrics import READ_KEYS
    counters = {k: 0 for k in READ_KEYS}
    counters.update(read.get("counters") or {})
    for k, v in sorted(counters.items()):
        b.add(f"dt_read_{k}_total", "counter", v)
    b.add("dt_read_local_ratio", "gauge",
          read.get("local_ratio") or 0.0)
    st = read.get("staleness")
    b.histogram("dt_read_staleness_seconds",
                st if isinstance(st, dict) and st else _EMPTY_HIST)
    lat = dict(read.get("latencies") or {})
    lat.setdefault("read_wait", _EMPTY_HIST)
    for name, snap in sorted(lat.items()):
        b.histogram(f"dt_{name}_latency_seconds", snap)


def _render_replication(b: _Builder, repl: dict) -> None:
    # elastic mesh: dedicated dt_rebalance_* families, zero-filled (the
    # snapshot always carries the group, so an idle mesh still exports
    # every series). override_table_size is a point-in-time gauge; the
    # rest are counters; the drain histogram rides the shared latency
    # loop below as dt_rebalance_drain_latency_seconds.
    rb = repl.get("rebalance")
    if isinstance(rb, dict):
        for k, v in sorted(rb.items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if k == "override_table_size":
                b.add("dt_rebalance_override_table_size", "gauge", v)
            else:
                b.add(f"dt_rebalance_{k}_total", "counter", v)
    # hot-doc write splitting: dedicated dt_writergroup_* families,
    # zero-filled like rebalance; the two table sizes are point-in-time
    # gauges, the rest are counters.
    wg = repl.get("writergroup")
    if isinstance(wg, dict):
        for k, v in sorted(wg.items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if k in ("active_groups", "member_entries"):
                b.add(f"dt_writergroup_{k}", "gauge", v)
            else:
                b.add(f"dt_writergroup_{k}_total", "counter", v)
    # wire tier: per-channel transport accounting as dedicated labeled
    # dt_wire_* families — the flat `{channel}_{key}` snapshot keys
    # split back into a channel label so dashboards can sum/stack the
    # four transport channels without regex gymnastics.
    wire = repl.get("wire")
    if isinstance(wire, dict):
        from ..wire.frames import WIRE_CHANNELS, WIRE_KEYS
        for ch in WIRE_CHANNELS:
            for key in WIRE_KEYS:
                v = wire.get(f"{ch}_{key}")
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                b.add(f"dt_wire_{key}_total", "counter", v,
                      labels={"channel": ch})
    for group, vals in sorted(repl.items()):
        if group in ("version", "self", "latencies") or \
                not isinstance(vals, dict):
            continue
        if group in ("per_peer", "membership_view", "quorum_view",
                     "faults", "rebalance", "wire", "writergroup"):
            # rebalance / wire / writergroup rendered above under their
            # own dt_rebalance_* / dt_wire_* / dt_writergroup_*
            # prefixes, not the generic dt_repl_* one
            continue
        for k, v in sorted(vals.items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if isinstance(v, float):
                b.add(f"dt_repl_{group}_{k}", "gauge", v)
            else:
                b.add(f"dt_repl_{group}_{k}_total", "counter", v)
    for name, snap in sorted((repl.get("latencies") or {}).items()):
        b.histogram(f"dt_{name}_latency_seconds", snap)


def _render_obs(b: _Builder, obs: dict) -> None:
    for name, series in sorted((obs.get("http") or {}).items()):
        for entry in series:
            b.histogram(f"dt_{name}_seconds", entry,
                        labels=entry.get("labels") or {})
    tr = obs.get("trace") or {}
    for k in ("started", "sampled_out", "finished"):
        if k in tr:
            b.add(f"dt_trace_spans_{k}_total", "counter", tr[k])
    rec = obs.get("recorder") or {}
    for k in ("recorded", "dropped"):
        if k in rec:
            b.add(f"dt_recorder_events_{k}_total", "counter", rec[k])
    dp = obs.get("devprof") or {}
    if dp:
        b.add("dt_devprof_flush_wall_seconds_total", "counter",
              dp.get("flush_wall_s", 0.0))
        b.add("dt_devprof_device_sync_seconds_total", "counter",
              dp.get("device_sync_s", 0.0))
        b.add("dt_devprof_transfer_bytes_total", "counter",
              dp.get("transfer_bytes", 0))
        # per-(rung, purpose) transfer split — stage vs plan vs warmup
        for key, row in sorted((dp.get("transfer_detail")
                                or {}).items()):
            rung, _, purpose = key.partition(".")
            lb = {"rung": rung, "purpose": purpose}
            b.add("dt_devprof_transfer_detail_total", "counter",
                  row.get("transfers", 0), labels=lb)
            b.add("dt_devprof_transfer_detail_bytes_total", "counter",
                  row.get("bytes", 0), labels=lb)
    wit = obs.get("witness") or {}
    if wit:
        # one gauge per observed class edge (small, bounded by the
        # canonical order's class count squared) + scalar summary
        b.add("dt_witness_enabled", "gauge",
              1 if wit.get("enabled") else 0)
        b.add("dt_witness_acquires_total", "counter",
              wit.get("acquires", 0))
        b.add("dt_witness_violations_total", "counter",
              wit.get("violation_count", 0))
        b.add("dt_witness_acyclic", "gauge",
              1 if wit.get("acyclic", True) else 0)
        for edge, n in sorted((wit.get("edges") or {}).items()):
            b.add("dt_witness_edges", "gauge", n,
                  labels={"edge": edge})
    lint = obs.get("lint") or {}
    if lint:
        for rule, n in sorted((lint.get("by_rule") or {}).items()):
            b.add("dt_lint_violations_total", "counter", n,
                  labels={"rule": rule})
        b.add("dt_lint_files", "gauge", lint.get("files", 0))
        b.add("dt_lint_ok", "gauge", 1 if lint.get("ok") else 0)
    explore = obs.get("explore") or {}
    if explore:
        lb = {"scenario": explore.get("scenario", "")}
        b.add("dt_explore_ok", "gauge",
              1 if explore.get("ok") else 0, labels=lb)
        b.add("dt_explore_complete", "gauge",
              1 if explore.get("complete") else 0, labels=lb)
        b.add("dt_explore_depth", "gauge",
              explore.get("depth", 0), labels=lb)
        b.add("dt_explore_states_total", "counter",
              explore.get("states", 0), labels=lb)
        b.add("dt_explore_states_per_second", "gauge",
              explore.get("states_per_s", 0.0), labels=lb)
        b.add("dt_explore_violations_total", "counter",
              explore.get("violations", 0), labels=lb)
    # live telemetry tier: SLO burn-rate gauges, windowed rates, and
    # the top-K hot-doc/agent attribution (all bounded cardinality)
    slo = obs.get("slo") or {}
    for row in slo.get("objectives") or []:
        lb = {"objective": row["name"]}
        b.add("dt_slo_state", "gauge",
              _SLO_STATE_CODE.get(row["state"], 0), labels=lb)
        b.add("dt_slo_burn_rate", "gauge", row["fast"]["burn"],
              labels=dict(lb, window="fast"))
        b.add("dt_slo_burn_rate", "gauge", row["slow"]["burn"],
              labels=dict(lb, window="slow"))
        b.add("dt_slo_transitions_total", "counter",
              row["transitions"], labels=lb)
    if slo:
        b.add("dt_slo_ok", "gauge", 1 if slo.get("ok", True) else 0)
    ts = obs.get("timeseries") or {}
    if ts:
        b.add("dt_ts_enabled", "gauge", 1 if ts.get("enabled") else 0)
        b.add("dt_ts_recorded_total", "counter", ts.get("recorded", 0))
        for series, row in sorted((ts.get("series") or {}).items()):
            lb = {"series": series}
            if "rate_60s" in row:
                b.add("dt_ts_rate", "gauge", row["rate_60s"],
                      labels=dict(lb, window="60s"))
            if "p99_300s" in row:
                b.add("dt_ts_p99_seconds", "gauge", row["p99_300s"],
                      labels=lb)
    # edit-to-visibility journey tier: zero-filled stage counters (the
    # HYDRATION_KEYS idiom: every stage row exists from the first
    # scrape) plus the per-peer convergence-lag rollup. The aggregate
    # peer="all" row keeps the lag family present before any peer has
    # adverted, so scrapers see a stable family set.
    jo = obs.get("journey") or {}
    if jo:
        b.add("dt_journey_enabled", "gauge",
              1 if jo.get("enabled") else 0)
        b.add("dt_journey_tracked", "gauge", jo.get("tracked", 0))
        b.add("dt_journey_stamps_total", "counter",
              jo.get("stamped", 0))
        b.add("dt_journey_dropped_total", "counter",
              jo.get("dropped", 0))
        stages = dict.fromkeys(JOURNEY_STAGES, 0)
        stages.update(jo.get("stages") or {})
        for stage in JOURNEY_STAGES:
            b.add("dt_journey_stage_total", "counter", stages[stage],
                  labels={"stage": stage})
        conv = jo.get("convergence") or {}
        all_n = sum(row.get("n", 0) for row in conv.values())
        all_sum = sum(row.get("n", 0) * row.get("mean_s", 0.0)
                      for row in conv.values())
        all_max = max([row.get("max_s", 0.0)
                       for row in conv.values()] or [0.0])
        for peer, row in [("all", {"n": all_n,
                                   "mean_s": all_sum / all_n
                                   if all_n else 0.0,
                                   "max_s": all_max})] \
                + sorted(conv.items()):
            lb = {"peer": peer}
            b.add("dt_convergence_lag_count", "counter",
                  row.get("n", 0), labels=lb)
            b.add("dt_convergence_lag_seconds_sum", "counter",
                  round(row.get("n", 0) * row.get("mean_s", 0.0), 6),
                  labels=lb)
            b.add("dt_convergence_lag_seconds_max", "gauge",
                  row.get("max_s", 0.0), labels=lb)
    # incident engine: zero-filled over INCIDENT_KINDS (the journey-
    # stage idiom) so every kind row exists from the first scrape even
    # on an idle server; the block itself is always present in the obs
    # snapshot, detector enabled or not.
    inc = obs.get("incidents")
    if isinstance(inc, dict):
        b.add("dt_incident_detector_enabled", "gauge",
              1 if inc.get("enabled") else 0)
        kinds = dict.fromkeys(INCIDENT_KINDS, 0)
        kinds.update(inc.get("by_kind") or {})
        for kind in INCIDENT_KINDS:
            b.add("dt_incident_opened_total", "counter", kinds[kind],
                  labels={"kind": kind})
        b.add("dt_incident_suppressed_total", "counter",
              inc.get("suppressed", 0))
        b.add("dt_incident_open", "gauge", inc.get("open", 0))
    hot = obs.get("hot") or {}
    for dim in ("doc", "agent"):
        for kind, block in sorted((hot.get(dim) or {}).items()):
            lb = {"dim": dim, "kind": kind}
            b.add("dt_hot_attributed_total", "counter",
                  block.get("total", 0.0), labels=lb)
            for key, count, _err in block.get("top") or []:
                b.add("dt_hot_top", "gauge", count,
                      labels=dict(lb, key=key))
    ex = obs.get("exemplars") or {}
    if ex:
        b.add("dt_exemplars_noted_total", "counter",
              ex.get("noted", 0))


def _exemplar_index(obs: dict) -> dict:
    """{prom family -> {le_string -> exemplar row}} from the exemplar
    store's snapshot (family names are TimeSeries series names)."""
    fams = (obs.get("exemplars") or {}).get("families") or {}
    out: Dict[str, dict] = {}
    for metric, series in _EXEMPLAR_FAMILIES.items():
        rows = fams.get(series)
        if not rows:
            continue
        out[metric] = {
            (r["le"] if isinstance(r["le"], str)
             else repr(float(r["le"]))): r
            for r in rows}
    return out


def render_metrics(doc: dict, openmetrics: bool = False) -> str:
    """Flatten the /metrics JSON document to Prometheus text format
    (or OpenMetrics 1.0 with exemplars when `openmetrics=True`)."""
    obs_doc = doc.get("obs")
    b = _Builder(openmetrics=openmetrics,
                 exemplars=_exemplar_index(obs_doc)
                 if openmetrics and isinstance(obs_doc, dict) else None)
    serve = doc.get("serve")
    if isinstance(serve, dict):
        _render_serve(b, serve)
    # adaptive admission: the qos block rides top-level in the /metrics
    # document (None/absent when no controller is attached — families
    # omitted entirely, like the wire block on a meshless server)
    qos = doc.get("qos")
    if isinstance(qos, dict):
        _render_qos(b, qos)
    # the read block rides either at top level (scheduler-less
    # servers) or inside the serve snapshot (ServeMetrics v8); render
    # whichever is present, once. A serving process with no read tier
    # yet still zero-fills the dt_read_* families (no series flicker).
    read = doc.get("read")
    if not isinstance(read, dict) and isinstance(serve, dict):
        read = serve.get("read")
    if isinstance(read, dict):
        _render_read(b, read)
    elif isinstance(serve, dict):
        _render_read(b, {})
    repl = doc.get("replication")
    if isinstance(repl, dict):
        _render_replication(b, repl)
    obs = doc.get("obs")
    if isinstance(obs, dict):
        _render_obs(b, obs)
    return b.render()
