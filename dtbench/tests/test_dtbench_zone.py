"""The zone cell's parts: its readers on fabricated runs, X8's byte count
against the port's `chip_smoke.py` `zone_bounds`, a rehearsal of the cell
on the CPU (the zone sessions there run X8's plain version), and one short
run of it on the card (skips without one)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, SEED, tiny
from dtbench import metrics
from dtbench.roofline_zone import HBM_BYTES_PER_S, zone_bytes_from_counts
from dtbench.run import run_cell
from dtbench.traffic.clients import Sync

KERNEL = "void zone_tape_kernel<true>(Tape, Carry, int, int, int, int, " \
    "int, int, int)"


def _zone(**kw):
    from diamond_types_tpu_torch.gpu.zone_session import ZONE_COUNTS
    z = dict.fromkeys(ZONE_COUNTS, 0)
    z.update(kw)
    return z


def _ctx(before, after, kernels=None, phases=None, ops=(30, 70)):
    """A run that committed syncs of `ops` ops in its 2 s window, with the
    scheduler's `zone` block and flush phases before and after it (None
    leaves a block out, as a program without it would) and a trace holding
    `kernels` (None: an untraced run)."""
    syncs = []
    for i, n in enumerate(ops):
        s = Sync(f"doc{i}", 0.0, n)
        s.committed = 0.5
        syncs.append(s)
    snaps = []
    for z, ph in ((before, (phases or (None, None))[0]),
                  (after, (phases or (None, None))[1])):
        snap = {"totals": {}}
        if z is not None:
            snap["zone"] = z
        if ph is not None:
            snap["flush_phases"] = {"seconds": ph}
        snaps.append(snap)
    trace = None if kernels is None else {
        "kernels": kernels, "busy_s": 0.1, "window_s": 2.0}
    return {"syncs": syncs, "t_end": 1.0, "window_s": 2.0,
            "sched_before": snaps[0], "sched_after": snaps[1],
            "trace": trace}


def test_x8_us_per_op_reads_the_kernel_by_name():
    ctx = _ctx(_zone(), _zone(), kernels={KERNEL: 0.004, "other": 1.0})
    assert metrics.load("x8_us_per_op")(ctx) == pytest.approx(40.0)
    assert metrics.load("x8_us_per_op")(_ctx(_zone(), _zone())) is None


def test_x8_roofline_pct_is_the_windows_bytes_over_its_kernel_time():
    before = _zone(launches=3, chars=5, ranks_before=100, tape_bytes=64)
    after = _zone(launches=5, chars=25, ranks_before=1100, apply_snap=2,
                  snap_slots=4096, fork_slots=6144, max_slots=2048,
                  begin_slots=0, tape_bytes=2112, steps_fork=3)
    # the window: m 1,000 over its APPLY steps, n 20, snapshots 4,096
    # slots, forks 6,144, maxes 2,048, the tape 2,048 bytes
    want = (5 * 1000 + 8 * 1020 + 17 * 20 + 2 * 4096 + 2 * 6144
            + 3 * 2048 + 2048)
    s = 2e-6
    ctx = _ctx(before, after, kernels={KERNEL: s})
    got = metrics.load("x8_roofline_pct")(ctx)
    assert got == pytest.approx(100.0 * want / HBM_BYTES_PER_S / s)
    assert 0 < got <= 100
    # a parent without the counters, an untraced run, no launch: nothing
    read = metrics.load("x8_roofline_pct")
    assert read(_ctx(None, None, kernels={KERNEL: s})) is None
    assert read(_ctx(before, after)) is None
    assert read(_ctx(before, before, kernels={KERNEL: s})) is None


def test_zone_compose_us_per_op_reads_its_phase():
    ph = ({"extract": 0.0, "zone_compose": 0.25},
          {"extract": 1.0, "zone_compose": 0.251})
    ctx = _ctx(_zone(), _zone(), phases=ph)
    assert metrics.load("zone_compose_us_per_op")(ctx) == pytest.approx(10.0)
    # a program whose flush keeps no such phase (the parent of this cell)
    old = ({"extract": 0.0}, {"extract": 1.0})
    assert metrics.load("zone_compose_us_per_op")(
        _ctx(_zone(), _zone(), phases=old)) is None
    assert metrics.load("zone_compose_us_per_op")(_ctx(None, None)) is None


def test_zone_resync_pct_is_resynced_over_syncs_in_the_window():
    ctx = _ctx(_zone(syncs=10, resynced=5), _zone(syncs=50, resynced=7))
    assert metrics.load("zone_resync_pct")(ctx) == pytest.approx(5.0)
    assert metrics.load("zone_resync_pct")(_ctx(None, None)) is None
    assert metrics.load("zone_resync_pct")(
        _ctx(_zone(syncs=3), _zone(syncs=3))) is None


def test_x8_bytes_from_counts_equal_zone_bounds_on_a_tape(monkeypatch):
    """One small document's continued sync on the CPU: the counters the
    session takes for its one launch, turned into bytes here, equal the
    port's `chip_smoke.zone_bounds` on the same tape and carry."""
    import chip_smoke
    from diamond_types_tpu_torch import OpLog
    from diamond_types_tpu_torch.gpu import zone_kernel as zk
    from diamond_types_tpu_torch.gpu.zone_session import DeviceZoneSession
    from dtbench.tiers import append_sync
    from dtbench.traffic.generate import DocGen

    mix = json.load(open(os.path.join(ROOT, "dtbench", "traffic",
                                      "concurrent.json")))
    mix["docs"].update(base_min=150, base_max=300)
    gen = DocGen(SEED, 0, mix["docs"], mix["edits"])
    ol = OpLog()
    ids = {a: ol.get_or_create_agent_id(a) for a in gen.agents()}
    tip = append_sync(ol, ids, [], gen.syncs[0])
    sess = DeviceZoneSession(ol, headroom=16.0, device="cpu")
    tip = append_sync(ol, ids, tip, gen.next_sync())
    sess.sync()
    sess.take_counts()
    launched = []
    real = DeviceZoneSession._run_tape

    def keep(self, tape, *shape):
        launched.append((tape, self.carry._replace(m=self.carry.m.clone())))
        return real(self, tape, *shape)
    monkeypatch.setattr(DeviceZoneSession, "_run_tape", keep)
    append_sync(ol, ids, tip, gen.next_sync())
    sess.sync()
    counts = sess.take_counts()
    assert counts["continued"] == 1 and counts["launches"] == 1
    (tape, carry), = launched
    assert int(np.sum(tape.op == zk.OP_APPLY)) > 0
    xs = zk.tape_xs(tape, "cpu")
    want = chip_smoke.zone_bounds(zk, tape, xs, carry)["bound_step_bytes"]
    assert zone_bytes_from_counts(counts) == want


def _cpu_zone_scheduler(monkeypatch):
    """The tier builds its scheduler with the card's zone sessions; on the
    CPU they are asked for there (`session_opts`)."""
    from diamond_types_tpu_torch.serve import scheduler

    class CpuZone(scheduler.MergeScheduler):
        def __init__(self, *a, **kw):
            if not kw.get("fused", True):
                kw["session_opts"] = {"device": "cpu"}
            super().__init__(*a, **kw)
    monkeypatch.setattr(scheduler, "MergeScheduler", CpuZone)


def test_zone_rehearsal_on_the_cpu_is_correct(monkeypatch):
    """zone-concurrent cut to a CPU's size: correct, no failed sync, and
    its zone readers fed by the program's own counters."""
    _cpu_zone_scheduler(monkeypatch)
    cell, config, mix, specs = tiny("zone-concurrent")
    assert config["fused"] is False
    r = run_cell(cell, config, mix, specs, SEED, 1.5, False, "cpu")
    assert r["correct"], r["notes"]
    assert r["failed"] == 0 and r["attempted"] > 0
    got = r["metrics"]
    assert got["merged_ops_per_s"]["value"] > 0
    assert got["zone_compose_us_per_op"]["value"] > 0
    assert 0 <= got["zone_resync_pct"]["value"] <= 100
    assert r["notes"]["window_totals"]["syncs"] > 0


@pytest.mark.cuda
def test_zone_cell_runs_correct_on_the_card(cuda_card):
    out = subprocess.run(
        [sys.executable, "-m", "dtbench", "--workload", "zone-concurrent",
         "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    got = result["metrics"]
    assert 0 < got["x8_roofline_pct"]["value"] <= 100
    assert got["x8_us_per_op"]["value"] > 0
    assert got["zone_compose_us_per_op"]["value"] > 0
