"""Declarative SLOs evaluated as multi-window burn rates.

An `Objective` says "target fraction of <series> events must finish
under <threshold_s>". The engine reads bad/total pairs from the
TimeSeries ring over two horizons (fast 5 m, slow 1 h) and computes
the classic burn rate

    burn = bad_fraction / error_budget,   error_budget = 1 - target

A burn of 1.0 spends the budget exactly at the sustainable pace; the
default thresholds (fast 14.4, slow 6.0) are the SRE-workbook pair for
a paged alert. The alert state machine is:

    burning   fast AND slow burn both over their thresholds
              (the AND suppresses one-window blips)
    warning   either horizon is eating budget faster than sustainable
              (burn >= 1.0) but the page condition has not met
    ok        otherwise

Transitions are recorded into the flight recorder (`slo_transition`
events) so `/debug/events?since=` tails them live, and `snapshot()`
feeds `GET /debug/slo`, the `dt_slo_*` prom gauges, and the serve-
bench / soak verdicts (a run that passes parity but leaves an
objective burning fails loudly — see serve/driver.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .timeseries import TimeSeries

STATES = ("ok", "warning", "burning")


@dataclass
class Objective:
    """One latency SLO over a TimeSeries latency family."""

    name: str                 # stable id, e.g. "flush_p99"
    series: str               # TimeSeries family, e.g. "serve.flush"
    threshold_s: float        # per-event latency budget
    target: float = 0.99      # fraction that must be under threshold
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn: float = 14.4   # page thresholds (SRE workbook defaults)
    slow_burn: float = 6.0

    def __post_init__(self) -> None:
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0,1): {self.target}")


def default_objectives() -> List[Objective]:
    """The serving stack's standing objectives. Thresholds are set
    from the CPU-simulated bench envelope (BENCH_r01-r05: fused flush
    p99 ~2 s, cold-start p99 well under a second) with generous
    headroom so healthy soaks stay `ok` — the seeded latency-injection
    test uses tight custom objectives instead."""
    return [
        Objective("flush_p99", "serve.flush", threshold_s=30.0),
        Objective("queue_wait_p99", "serve.queue_wait", threshold_s=30.0),
        Objective("read_staleness_p99", "read.staleness",
                  threshold_s=30.0),
        Objective("hydration_cold_start_p99",
                  "serve.hydration_cold_start", threshold_s=30.0),
        Objective("quorum_round_p99", "repl.quorum_round",
                  threshold_s=10.0),
        # edit-to-visibility: fed by obs/journey.py on advert_usable
        # stamps (admitted -> follower-advert-usable lag per peer)
        Objective("visibility_p99", "journey.visibility",
                  threshold_s=30.0),
    ]


@dataclass
class _AlertState:
    state: str = "ok"
    transitions: int = 0


class SloEngine:
    """Evaluates objectives against a TimeSeries and runs the per-
    objective alert state machines. Evaluation is pull-driven (every
    /debug/slo, /metrics scrape, or verdict embed re-evaluates) — no
    background thread, no timers."""

    def __init__(self, ts: TimeSeries,
                 objectives: Optional[Sequence[Objective]] = None,
                 recorder=None) -> None:
        self.ts = ts
        self.objectives: List[Objective] = list(
            objectives if objectives is not None else default_objectives())
        self.recorder = recorder
        self._alerts: Dict[str, _AlertState] = {
            o.name: _AlertState() for o in self.objectives}

    # ---- evaluation -------------------------------------------------------

    def _burn(self, o: Objective, window_s: float) -> dict:
        bad, total = self.ts.count_over(o.series, o.threshold_s,
                                        window_s)
        budget = 1.0 - o.target
        frac = (bad / total) if total else 0.0
        return {"bad": bad, "total": total,
                "bad_fraction": round(frac, 6),
                "burn": round(frac / budget, 4)}

    def evaluate(self) -> List[dict]:
        """Re-evaluate every objective, advance the state machines,
        and return the per-objective rows."""
        rows = []
        for o in self.objectives:
            fast = self._burn(o, o.fast_window_s)
            slow = self._burn(o, o.slow_window_s)
            if (fast["burn"] >= o.fast_burn
                    and slow["burn"] >= o.slow_burn
                    and fast["total"] > 0):
                state = "burning"
            elif fast["burn"] >= 1.0 or slow["burn"] >= 1.0:
                state = "warning"
            else:
                state = "ok"
            al = self._alerts[o.name]
            if state != al.state:
                al.transitions += 1
                if self.recorder is not None:
                    self.recorder.record(
                        "slo_transition", objective=o.name,
                        series=o.series, frm=al.state, to=state,
                        fast_burn=fast["burn"], slow_burn=slow["burn"])
                al.state = state
            rows.append({
                "name": o.name, "series": o.series,
                "threshold_s": o.threshold_s, "target": o.target,
                "state": state, "transitions": al.transitions,
                "fast": fast, "slow": slow,
                "fast_window_s": o.fast_window_s,
                "slow_window_s": o.slow_window_s,
                "fast_burn_threshold": o.fast_burn,
                "slow_burn_threshold": o.slow_burn,
            })
        return rows

    # ---- snapshot / verdicts ---------------------------------------------

    def snapshot(self) -> dict:
        rows = self.evaluate()
        by_state = {s: 0 for s in STATES}
        for r in rows:
            by_state[r["state"]] += 1
        return {"version": 1, "enabled": self.ts.enabled,
                "objectives": rows, "by_state": by_state,
                "ok": by_state["burning"] == 0}

    def verdict(self) -> dict:
        """Compact block for bench/soak reports: `slo_ok` is False iff
        any objective is burning — parity can pass while the latency
        budget is torched, and that must fail the run."""
        snap = self.snapshot()
        burning = [r["name"] for r in snap["objectives"]
                   if r["state"] == "burning"]
        warning = [r["name"] for r in snap["objectives"]
                   if r["state"] == "warning"]
        return {"slo_ok": snap["ok"], "burning": burning,
                "warning": warning}
