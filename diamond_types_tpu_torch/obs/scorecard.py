"""Versioned per-scenario scorecards + one-diff regression detection.

`build_scorecard` normalizes a scenario run's raw collections into a
stable, versioned JSON document; `diff_scorecards` compares two of
them metric-by-metric against per-metric tolerance bands and is the
engine behind `cli scorecard-diff old new --gate` (exit non-zero on
regression), which is what makes BASELINE.md scenario rows
machine-checkable.

Band semantics: every gated metric declares a direction ("lower" or
"higher" is better). A change in the good direction always passes; a
change in the bad direction passes only while within BOTH the
relative band (`rel`, fraction of the old value) and the absolute
slack (`abs`, which keeps tiny-latency jitter from tripping
percentage bands). Metrics missing from either scorecard are reported
but never gate — new columns must not fail old baselines.

The module also parks the live run snapshot (`publish_scenario` /
`last_scenario`): the runner publishes each tick, Observability.
snapshot() embeds it as the `scenario` block, and `cli obs-watch`
renders it as the scenario panel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

SCORECARD_VERSION = 1


# ---- live snapshot (obs-watch scenario panel) ----------------------------

_LAST_SCENARIO: Optional[dict] = None


def publish_scenario(snap: Optional[dict]) -> None:
    """Park the runner's live snapshot (name, phase, progress, SLO
    verdict) for the obs pipeline; None clears it (run finished)."""
    global _LAST_SCENARIO
    _LAST_SCENARIO = dict(snap) if snap is not None else None


def last_scenario() -> Optional[dict]:
    return _LAST_SCENARIO


# ---- scorecard assembly --------------------------------------------------

def build_scorecard(*, scenario: dict, wall_s: float, virtual_s: float,
                    totals: Dict[str, float],
                    latency_p99_s: Dict[str, float],
                    latencies: Optional[dict] = None,
                    slo: Optional[dict] = None,
                    burn_minutes: Optional[Dict[str, float]] = None,
                    convergence: Optional[dict] = None,
                    hydration: Optional[Dict[str, int]] = None,
                    wire: Optional[Dict[str, Dict[str, float]]] = None,
                    per_server: Optional[List[dict]] = None,
                    ok: bool = True,
                    qos: Optional[dict] = None,
                    incidents: Optional[dict] = None,
                    serve: Optional[dict] = None,
                    extra: Optional[dict] = None) -> dict:
    """Assemble the stable scorecard document. Derived ratios
    (throughput, bytes/op) are computed here so every producer agrees
    on their definition."""
    ops = float(totals.get("ops", 0))
    reads = float(totals.get("reads", 0))
    writes = float(totals.get("writes", 0))
    bytes_total = float(totals.get("bytes_sent", 0)
                        + totals.get("bytes_received", 0))
    wall = max(float(wall_s), 1e-9)
    card = {
        "version": SCORECARD_VERSION,
        "scenario": dict(scenario),
        "wall_s": round(float(wall_s), 3),
        "virtual_s": round(float(virtual_s), 3),
        "totals": {k: totals[k] for k in sorted(totals)},
        "throughput": {
            "ops_per_s": round(ops / wall, 3),
            "writes_per_s": round(writes / wall, 3),
            "reads_per_s": round(reads / wall, 3),
        },
        "latency_p99_s": {k: (None if v is None else round(float(v), 6))
                          for k, v in sorted(latency_p99_s.items())},
        "slo": dict(slo or {}),
        "burn_minutes": {k: round(float(v), 4) for k, v in
                         sorted((burn_minutes or {}).items())},
        "convergence": dict(convergence or {}),
        "bytes_per_op": round(bytes_total / max(ops, 1.0), 2),
        "hydration": {k: int(v) for k, v in
                      sorted((hydration or {}).items())},
        "ok": bool(ok),
    }
    card["burn_minutes_total"] = round(
        sum(card["burn_minutes"].values()), 4)
    if wire is not None:
        # mesh-transport accounting per wire channel (raw counters
        # summed across servers by the runner); bytes_per_op derived
        # HERE so every producer divides by the same op count
        card["wire"] = {
            ch: {
                "bytes_sent": int(vals.get("bytes_sent", 0)),
                "bytes_saved": int(vals.get("bytes_saved", 0)),
                "frames": int(vals.get("frames", 0)),
                "snapshot_ships": int(vals.get("snapshot_ships", 0)),
                "bytes_per_op": round(
                    float(vals.get("bytes_sent", 0)) / max(ops, 1.0), 2),
            }
            for ch, vals in sorted(wire.items())
        }
    if qos is not None:
        # adaptive-admission block (merged QosMetrics snapshot). Absent
        # on static-admission runs so pre-QoS baselines diff clean; no
        # band gates on it — shed counts are policy, not regressions.
        card["qos"] = dict(qos)
    if incidents is not None:
        # incident engine rollup (count by kind, worst burn-minutes
        # bundle id, timeline). Absent from pre-incident baselines so
        # they diff clean; `incidents.count` is band-gated.
        card["incidents"] = dict(incidents)
    if serve is not None:
        # device flush-pipeline block (shape steering + staging): jit
        # hit rate, staged bytes per mesh window, dispatch fan-in.
        # Absent on host-engine runs (and pre-steer baselines) so the
        # new bands skip instead of gating — missing-path semantics.
        card["serve"] = dict(serve)
    if latencies is not None:
        card["latencies"] = latencies
    if per_server is not None:
        card["per_server"] = per_server
    if extra:
        card["extra"] = extra
    return card


# ---- tolerance bands -----------------------------------------------------

@dataclass(frozen=True)
class Band:
    """Tolerance band for one metric path. `better` names the good
    direction; `rel`/`abs_` bound how far the BAD direction may move
    before the gate trips (the larger of the two wins, so abs_ is the
    jitter floor for near-zero metrics)."""

    better: str          # "higher" | "lower"
    rel: float = 0.25
    abs_: float = 0.0

    def allows(self, old: float, new: float) -> bool:
        delta = new - old
        if self.better == "higher":
            delta = -delta          # normalize: positive = worse
        if delta <= 0:
            return True             # unchanged or improved
        return delta <= max(abs(old) * self.rel, self.abs_)


# Gated metric paths (dotted into the scorecard). Deliberately a
# curated list, not "every numeric leaf": config echoes, histograms
# and per-server detail are context, not gates.
DEFAULT_BANDS: Dict[str, Band] = {
    "throughput.ops_per_s": Band("higher", rel=0.30, abs_=5.0),
    "throughput.reads_per_s": Band("higher", rel=0.35, abs_=5.0),
    "throughput.writes_per_s": Band("higher", rel=0.35, abs_=2.0),
    "latency_p99_s.flush": Band("lower", rel=0.50, abs_=0.010),
    "latency_p99_s.read": Band("lower", rel=0.50, abs_=0.010),
    "latency_p99_s.visibility": Band("lower", rel=0.50, abs_=0.025),
    "burn_minutes_total": Band("lower", rel=0.0, abs_=1.0),
    "bytes_per_op": Band("lower", rel=0.30, abs_=128.0),
    "totals.errors": Band("lower", rel=0.0, abs_=0.0),
    "hydration.spills_to_snapshot": Band("lower", rel=1.0, abs_=32.0),
    "hydration.spill_bytes": Band("lower", rel=1.0, abs_=262144.0),
    "hydration.quarantined": Band("lower", rel=0.0, abs_=0.0),
    "hydration.flush_leaks": Band("lower", rel=0.0, abs_=0.0),
    # wire tier: per-channel transport cost. Absent from pre-wire (or
    # single-server) scorecards — missing paths report but never gate.
    "wire.antientropy.bytes_per_op": Band("lower", rel=0.30, abs_=16.0),
    "wire.proxy.bytes_per_op": Band("lower", rel=0.30, abs_=16.0),
    "wire.hydrate.bytes_per_op": Band("lower", rel=0.30, abs_=16.0),
    "wire.gossip.bytes_per_op": Band("lower", rel=0.30, abs_=16.0),
    # incident engine: more auto-captured incidents than the baseline
    # is a health regression even when the boolean gates still pass.
    # Generous absolute slack — a chaos tape legitimately opens a few.
    "incidents.count": Band("lower", rel=0.5, abs_=4.0),
    # device flush pipeline (shape steering + device-resident staging,
    # scorecard `serve` block): hit rate must not drop more than 5
    # points; staged bytes per window must not grow past the band;
    # dispatch fan-in (device calls per window) must not balloon.
    # Absent entirely on host-engine scorecards — never gates there.
    # The staged band is sized to catch STATE-staging regressions
    # (losing device residency multiplies the figure ~5x), while
    # letting steering's padded plan arrays through — padding a window
    # up to a warm class grows the host-built plan upload by up to
    # `max_waste` (4x cells) by design, and that is the trade the
    # steer A/B makes on purpose (plan kilobytes for compile seconds).
    "serve.jit_cache_hit_rate": Band("higher", rel=0.0, abs_=0.05),
    "serve.staged_bytes_per_window": Band("lower", rel=1.0,
                                          abs_=16384.0),
    "serve.device_calls_per_window": Band("lower", rel=0.50, abs_=1.0),
}

# Boolean invariants: must never flip good -> bad.
_BOOL_GATES = ("ok", "convergence.converged", "slo.slo_ok")


def _dig(doc: dict, path: str):
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def diff_scorecards(old: dict, new: dict,
                    bands: Optional[Dict[str, Band]] = None) -> dict:
    """Compare two scorecards. `ok` is False iff any gated metric
    moved in its bad direction past its band, or a boolean invariant
    flipped false. Metrics absent from either side are listed under
    `skipped` and never gate."""
    bands = bands if bands is not None else DEFAULT_BANDS
    rows: List[dict] = []
    skipped: List[str] = []
    for path, band in sorted(bands.items()):
        o, n = _dig(old, path), _dig(new, path)
        if not isinstance(o, (int, float)) or isinstance(o, bool) \
                or not isinstance(n, (int, float)) \
                or isinstance(n, bool):
            skipped.append(path)
            continue
        ok = band.allows(float(o), float(n))
        rows.append({
            "metric": path, "old": o, "new": n,
            "delta": round(float(n) - float(o), 6),
            "better": band.better,
            "band": {"rel": band.rel, "abs": band.abs_},
            "ok": ok,
        })
    for path in _BOOL_GATES:
        o, n = _dig(old, path), _dig(new, path)
        if not isinstance(o, bool) or not isinstance(n, bool):
            skipped.append(path)
            continue
        rows.append({"metric": path, "old": o, "new": n,
                     "delta": None, "better": "true",
                     "band": None, "ok": not (o and not n)})
    regressions = [r["metric"] for r in rows if not r["ok"]]
    return {
        "version": {"old": old.get("version"),
                    "new": new.get("version")},
        "scenario": {"old": _dig(old, "scenario.name"),
                     "new": _dig(new, "scenario.name")},
        "rows": rows,
        "skipped": skipped,
        "regressions": regressions,
        "ok": not regressions,
    }


def render_diff(diff: dict) -> str:
    """Human-readable diff table (the non-JSON CLI output)."""
    lines = [f"scorecard-diff: {diff['scenario']['old']} -> "
             f"{diff['scenario']['new']}  "
             f"[{'OK' if diff['ok'] else 'REGRESSION'}]"]
    for r in diff["rows"]:
        mark = "ok" if r["ok"] else "FAIL"
        lines.append(f"  [{mark:4}] {r['metric']:36} "
                     f"{r['old']} -> {r['new']}")
    if diff["skipped"]:
        lines.append("  (not gated — missing on one side: "
                     + ", ".join(diff["skipped"]) + ")")
    return "\n".join(lines)
