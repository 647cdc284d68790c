"""Tracing on the zone-session path: the session's counters
(`DeviceZoneSession.take_counts`, `ZONE_COUNTS`), the metrics' `zone`
block they feed (`ServeMetrics.record_zone`), and the zone sync's phases
(`zone_compose`, `zone_tape`, `zone_resync`) on the bank flush's
`FlushClock`, with their `bank.*` spans in a traced flush.

As in `test_torch_flush_phases.py`, the scheduler, the metrics' clock and
the tracer run on a `FakeClock`, and the zone sync's work is costed:
each entry the Python composer composes, each micro-tape the native
composer and packer build, each rebuild's `prepare_zone` and each X8
launch advances the clock by a fixed amount, and nothing else takes time.
So each phase's seconds are exactly the costs of the calls made in it.
Sessions live on the CPU, where X8's plain version runs.
"""

import numpy as np
import pytest

from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu import zone_kernel as zk
from diamond_types_tpu_torch.gpu import zone_session as zs
from diamond_types_tpu_torch.native import native_enabled
from diamond_types_tpu_torch.native.core import MicroTapeContext
from diamond_types_tpu_torch.obs import Observability
from diamond_types_tpu_torch.serve import MergeScheduler
from diamond_types_tpu_torch.serve.metrics import ServeMetrics

from test_torch_flush_phases import SlowLock
from test_torch_zone_continued import Doc
from torch_parity import (PORT_ONLY_SPANS, FakeClock, clock_modules,
                          serve_docs, serve_round)

pytestmark = pytest.mark.serve

ROOT = "diamond_types_tpu_torch"
CPU = {"device": "cpu"}
COMPOSE_S = 0.002        # compose_entry an entry; the native pack a sync
PREP_S = 0.005           # prepare_zone, a rebuild
TAPE_S = 0.003           # kernels.zone_tape_run, a launch
ABS = 1e-5               # the snapshot rounds seconds to 1 us


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    clock_modules(monkeypatch, ROOT, c,
                  names=("serve.metrics", "serve.scheduler", "obs.trace"))
    calls = {"compose": 0, "prep": 0, "tape": 0}

    def cost(owner, name, key, seconds):
        real = getattr(owner, name)

        def costed(*args, **kw):
            c.advance(seconds)
            calls[key] += 1
            return real(*args, **kw)
        monkeypatch.setattr(owner, name, costed)

    cost(zs, "compose_entry", "compose", COMPOSE_S)
    cost(MicroTapeContext, "pack", "compose", COMPOSE_S)
    cost(zs, "prepare_zone", "prep", PREP_S)
    cost(kernels, "zone_tape_run", "tape", TAPE_S)
    c.calls = calls
    return c


def _sched(docs, clock, obs=None):
    s = MergeScheduler(2, resolve=lambda d: docs[d].oplogs[0],
                       fused=False, session_opts=CPU, flush_workers=False,
                       flush_docs=4, flush_deadline_s=0.05,
                       max_sessions_per_shard=16, sync_lock=SlowLock(clock))
    if obs is not None:
        s.attach_obs(obs)
    return s


def _round(sched, docs, clock, seed, rnd):
    for d, n in serve_round(docs, seed, rnd):
        sched.submit(d, n, now=clock())
        clock.advance(0.001)
    clock.advance(0.06)
    sched.pump(now=clock())
    sched.drain()


def test_zone_phases_are_the_costs_of_their_calls(clock):
    """Over rounds of concurrent edits: every entry composed, and every
    micro-tape composed and packed natively, is charged to
    `zone_compose`, every continued sync's launch to `zone_tape`, every
    rebuild (its `prepare_zone` and its launch) to `zone_resync`, and the
    first builds, which the bank runs before the sync, stay in `serial`.
    The zone block's counters agree with the calls and with the totals."""
    docs = serve_docs([OpLog], 10, 71, base_max=150)
    s = _sched(docs, clock)
    for rnd in range(5):
        _round(s, docs, clock, 71, rnd)
    snap = s.metrics_json()
    z, tot = snap["zone"], snap["totals"]
    builds = tot["builds"]
    assert builds > 0
    ph = snap["flush_phases"]["seconds"]
    resyncs = sum(z[f"resync_{c}"] for c in zs.RESYNC_CAUSES)
    assert resyncs == tot["resyncs"] == z["resynced"]
    assert z["syncs"] == z["continued"] + z["resynced"] > 0
    assert z["launches"] == clock.calls["tape"] \
        == builds + resyncs + z["continued"]
    assert clock.calls["prep"] == builds + resyncs
    assert clock.calls["compose"] >= z["continued"] > 0
    assert ph["zone_compose"] == pytest.approx(
        COMPOSE_S * clock.calls["compose"], abs=ABS)
    assert ph["zone_tape"] == pytest.approx(TAPE_S * z["continued"], abs=ABS)
    assert ph["zone_resync"] == pytest.approx(
        (PREP_S + TAPE_S) * resyncs, abs=ABS)
    # a session's first build runs in the flush's "build" phase, carved
    # out of the serial rung that asked for it
    assert ph["build"] == pytest.approx((PREP_S + TAPE_S) * builds,
                                        abs=ABS)
    for p in ("extract", "resolve", "plan", "pack", "fence", "adopt",
              "serial", "gate"):
        assert ph[p] == pytest.approx(0.0, abs=ABS)
    assert snap["flush_phases"]["count"]["zone_tape"] > 0
    # the shape counters cover every launch: each APPLY step is counted,
    # a continued sync forks at least once, and the widths add up
    assert z["steps_apply"] >= z["launches"] - builds - resyncs
    assert z["steps_fork"] >= z["continued"]
    assert z["width"] >= z["launches"] and z["tape_bytes"] > 0
    assert z["snap_slots"] == 0 or z["apply_snap"] > 0


def test_zone_phase_spans_in_a_traced_flush(clock):
    """With `trace_flushes` on, a zone flush's spans hold one leaf a phase
    stretch under its device sync: `bank.serial` and the zone sync's
    `bank.zone_compose` and `bank.zone_tape`, in order and inside their
    parent, each with its shard and document count."""
    docs = serve_docs([OpLog], 8, 73, base_max=150)
    obs = Observability(sample_rate=0.0)
    s = _sched(docs, clock, obs=obs)
    _round(s, docs, clock, 73, 0)
    assert obs.tracer.spans() == []
    s.trace_flushes = True
    _round(s, docs, clock, 73, 1)
    spans = obs.tracer.spans()
    by_id = {sp["span"]: sp for sp in spans}
    leaves = [sp for sp in spans if sp["name"] in PORT_ONLY_SPANS]
    assert {sp["name"] for sp in leaves} >= {
        "bank.serial", "bank.zone_compose", "bank.zone_tape"}
    for sp in leaves:
        assert by_id[sp["parent"]]["name"] == "serve.device_sync"
        assert sp["attrs"]["docs"] > 0 and "shard" in sp["attrs"]
        assert sp["t0_ns"] <= sp["t1_ns"]
    for parent_id in {sp["parent"] for sp in leaves}:
        kids = sorted((sp for sp in spans if sp["parent"] == parent_id),
                      key=lambda sp: sp["t0_ns"])
        assert by_id[parent_id]["t0_ns"] <= kids[0]["t0_ns"]
        assert kids[-1]["t1_ns"] <= by_id[parent_id]["t1_ns"]


def test_session_counts_match_its_tapes(monkeypatch):
    """The counters of a session's launches, taken again from the launched
    tapes and the carry itself: steps of each kind, snapshots, chars,
    the ranks placed before each APPLY step (the carry's `m` read before
    the launch), the slots row steps and snapshots sweep, widths and
    bytes. The host's copy of `m` is the carry's after every sync. Every
    continued sync's micro-tape is counted once, as built by the native
    path where the library is built."""
    want = dict.fromkeys(zs.ZONE_COUNTS, 0)
    real = kernels.zone_tape_run

    def spy(carry, xs, plen, **kw):
        op = xs["op"].numpy()
        n = np.where(op == zk.OP_APPLY, (xs["ch_slot"].numpy() >= 0)
                     .sum(1), 0)
        m = int(carry.m[0])
        W = carry.rank.shape[1]
        snaps = int(((op == zk.OP_APPLY) & (xs["snap"].numpy() == 1))
                    .sum())
        for k, kind in (("begin", zk.OP_BEGIN), ("fork", zk.OP_FORK),
                        ("max", zk.OP_MAX), ("apply", zk.OP_APPLY)):
            want[f"steps_{k}"] += int((op == kind).sum())
            if k != "apply":
                want[f"{k}_slots"] += W * int((op == kind).sum())
        want["launches"] += 1
        want["apply_snap"] += snaps
        want["snap_slots"] += W * snaps
        want["chars"] += int(n.sum())
        want["ranks_before"] += int((m + np.cumsum(n) - n)[
            op == zk.OP_APPLY].sum())
        want["width"] += W
        want["tape_bytes"] += sum(v.nbytes for v in xs.values())
        return real(carry, xs, plen, **kw)

    monkeypatch.setattr(kernels, "zone_tape_run", spy)
    doc = Doc(3, 4).through(0)
    sess = zs.DeviceZoneSession(doc.ol, **CPU)
    for _k in range(1, 9):
        doc.append(doc.next_sync())
        sess.sync()
        assert sess._m == int(sess.carry.m[0])
    got = sess.take_counts()
    assert got["syncs"] == 8 and got["resynced"] > 0
    assert got["prep_native"] + got["prep_python"] == got["continued"] > 0
    assert got["prep_native"] == (got["continued"] if native_enabled()
                                  else 0)
    for k in zs.ZONE_COUNTS[zs.ZONE_COUNTS.index("launches"):]:
        assert got[k] == want[k], k
    assert sess.take_counts() == dict.fromkeys(zs.ZONE_COUNTS, 0)


def test_record_zone_adds_counts_and_rejects_an_undeclared_key():
    """`record_zone` sums every shard's counts into the `zone` block; a key
    outside ZONE_COUNTS raises."""
    m = ServeMetrics(2, 4, 64)
    m.record_zone(0, {"syncs": 2, "continued": 2, "launches": 2,
                      "prep_native": 1, "prep_python": 1})
    m.record_zone(1, {"syncs": 1, "resynced": 1,
                      "resync_slot_capacity": 1, "launches": 1})
    m.record_zone(1, {"syncs": 1, "continued": 1, "prep_native": 1})
    z = m.snapshot()["zone"]
    assert set(z) == set(zs.ZONE_COUNTS)
    assert (z["syncs"], z["continued"], z["resynced"], z["launches"],
            z["resync_slot_capacity"]) == (4, 3, 1, 3, 1)
    assert (z["prep_native"], z["prep_python"]) == (2, 1)
    with pytest.raises(KeyError):
        m.record_zone(0, {"replays": 1})
