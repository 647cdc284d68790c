"""Measured merge-engine selection policy.

Copy of the JAX package's `listmerge/policy.py`. One difference lies at
its caller: the port's `Branch.merge` does not catch a failed
policy-selected zone merge (no demotion, no tracker fallback there); the
failure propagates. `forget` and the cooldown re-probe are kept as they
are for any caller that demotes.

`Branch.merge` keeps several interchangeable engines behind one seam
(reference: the listmerge/listmerge2 seam, src/list/merge.rs:63-96). The
tracker engine wins every single-doc host merge measured so far
(BASELINE.md); the zone engine wins when merges amortize over batched
replicas on a real accelerator. Rather than hard-coding that belief (or
hiding it behind env vars only), the policy CHOOSES from measured
throughput. Measurements are recorded at the ENGINES (zone rates inside
zone_checkout_device for FULL runs — whether started by a DT_TPU_ZONE
override, a bench, or the policy itself; precomputed-prep runs are not
recorded since they skip the dominant host cost — and tracker rates at
the Branch.merge seam), so the policy can bootstrap without env flips. Env overrides (DT_TPU_ZONE / DT_TPU_PLAN2 /
DT_TPU_DEVICE_MERGE / DT_TPU_NO_NATIVE) still force a specific engine —
they are development switches, not the policy.

The tracker stays the correctness oracle either way: the policy boundary
is differential-tested (tests/test_zone.py) so a selection flip can never
change merged text. A policy-selected zone merge reports
last_merge_collisions = None (the documented "engine doesn't report"
value — same as the plan2/device overrides); callers that need conflict
detection use OpLog.has_conflicts_when_merging.

Selection properties:
  * the TRACKER is chosen until BOTH engines have measurements — the
    zone engine is never started spontaneously, so a merge can never be
    the thing that first initializes an accelerator backend;
  * once both are measured, every PROBE_EVERY-th call runs the currently
    losing engine so both rates stay fresh and a flip self-corrects;
  * rates decay with WALL-CLOCK half-life HALF_LIFE_S, so a regression is
    not hidden under stale history;
  * a zone-engine failure demotes it on the spot (forget) and the merge
    falls back to the tracker.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

TRACKER = "tracker"
ZONE = "zone"


class EnginePolicy:
    PROBE_EVERY = 16
    HALF_LIFE_S = 300.0
    # After a failure-demotion (forget) the engine has no rate, and zone
    # rates are only recorded by zone runs — without a re-probe nothing
    # in-process could ever measure it again, so a transient accelerator
    # blip would disable the faster engine for the process lifetime
    # (ADVICE r4). One probe-sized retry is allowed per cooldown window.
    DEMOTION_COOLDOWN_S = 60.0

    def __init__(self) -> None:
        # engine -> [ops, seconds, last_record_wall_time]
        self._acc: Dict[str, list] = {}
        self._calls = 0
        self._last_probe = 0
        self._demoted_at: Dict[str, float] = {}
        # record()/choose() run concurrently in multi-threaded embedders
        # (tools/server.py merges from HTTP handler threads); unguarded,
        # _decayed's in-place rescale races with record() and can corrupt
        # rates or double-probe (ADVICE r4).
        self._lock = threading.Lock()

    def _decayed(self, engine: str):
        acc = self._acc.get(engine)
        if acc is None:
            return None
        dt = time.monotonic() - acc[2]
        if dt > 0:
            f = 0.5 ** (dt / self.HALF_LIFE_S)
            acc[0] *= f
            acc[1] *= f
            acc[2] = time.monotonic()
        return acc

    def record(self, engine: str, n_ops: int, seconds: float) -> None:
        if seconds <= 0 or n_ops <= 0:
            # 0-op timings (e.g. a fork merge whose frontier-top proxy
            # under-counts) would add pure denominator and corrupt the
            # rate; skip them
            return
        with self._lock:
            acc = self._decayed(engine)
            if acc is None:
                acc = self._acc[engine] = [0.0, 0.0, time.monotonic()]
            acc[0] += n_ops
            acc[1] += seconds
            # a successful measurement clears any standing demotion
            self._demoted_at.pop(engine, None)

    def forget(self, engine: str) -> None:
        """Drop an engine's measurements (e.g. it just failed): the
        policy stops choosing it until it is measured again — except the
        ZONE engine, which gets one probe-eligible re-try per
        DEMOTION_COOLDOWN_S (see choose(); the tracker is the default
        and never needs recovery, so cooldown bookkeeping is zone-only)."""
        with self._lock:
            self._acc.pop(engine, None)
            if engine == ZONE:
                self._demoted_at[engine] = time.monotonic()

    def _rate_locked(self, engine: str):
        """Decayed ops/sec for `engine`, or None unmeasured. Caller
        holds self._lock (the lock is not reentrant)."""
        acc = self._decayed(engine)
        if acc is None or acc[1] <= 0:
            return None
        return acc[0] / acc[1]

    def rate(self, engine: str):
        with self._lock:
            return self._rate_locked(engine)

    PROBE_MAX_OPS = 20_000

    def choose(self, n_ops_hint=None) -> str:
        """The engine with the best MEASURED rate; the tracker wherever
        evidence is missing (it is the oracle and the measured winner on
        every host workload to date). `n_ops_hint` bounds exploration:
        the loser-refresh probe only fires on merges KNOWN small (a
        fork merge's frontier-top delta can be tiny or negative while
        the merge is huge, so a non-positive hint counts as big), and a
        skipped probe stays due — it fires on the next small merge
        instead of being consumed, so big-merge-dominated workloads
        still refresh the loser."""
        # a missing hint counts as probe-eligible (same rule as the
        # loser-refresh probe below): hint-less embedder calls must not
        # be the one path where a demoted engine can never recover
        probe_eligible = n_ops_hint is None or \
            0 < n_ops_hint <= self.PROBE_MAX_OPS
        with self._lock:
            zr = self._rate_locked(ZONE)
            tr = self._rate_locked(TRACKER)
            if zr is None and tr is not None and probe_eligible:
                # demotion-cooldown re-probe: a forgotten (failed) zone
                # engine gets one probe-sized retry per cooldown window,
                # so a transient blip can't disable it for the process
                # lifetime. Re-arm the window now; a second failure just
                # waits out the next one, a success clears it (record()).
                demoted = self._demoted_at.get(ZONE)
                if demoted is not None and \
                        time.monotonic() - demoted >= self.DEMOTION_COOLDOWN_S:
                    self._demoted_at[ZONE] = time.monotonic()
                    return ZONE
            if zr is None or tr is None:
                return TRACKER
            self._calls += 1
            best = ZONE if zr > tr else TRACKER
            if self._calls - self._last_probe >= self.PROBE_EVERY \
                    and probe_eligible:
                self._last_probe = self._calls
                return TRACKER if best == ZONE else ZONE  # refresh loser
            return best

    def snapshot(self) -> dict:
        """Observability (reported in bench_report_full.json): measured
        ops/sec per engine."""
        with self._lock:
            return {e: round(a[0] / a[1])
                    for e, a in self._acc.items() if a[1] > 0}


GLOBAL = EnginePolicy()
