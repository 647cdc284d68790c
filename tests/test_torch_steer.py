"""The port's shape steering (`gpu/steer.py`) against the JAX package's.

Randomized `note_warm` / `snap` tapes go through a `ShapeSteer` of each
package: every return and every snapshot must be exactly equal, with the
JAX cache name "pallas" (the Pallas replay rung) mapped to the port's
"kernel" (K1's rung). The capacity floor, the warm-up batch classes and
the pow2 rounding must agree over a range.
"""

import numpy as np
import pytest

from diamond_types_tpu.serve.scheduler import MergeScheduler as JaxScheduler
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import steer as jsteer
from diamond_types_tpu.tpu.merge_kernel import _pow2 as jax_pow2
from diamond_types_tpu_torch.gpu import flush_fuse as tff
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import steer as tsteer
from diamond_types_tpu_torch.serve import MergeScheduler

from torch_parity import steer_tape

PORT_CACHE = {"fused": "fused", "pallas": "kernel"}


def _port_snapshot(snap: dict) -> dict:
    """A JAX snapshot with its cache names mapped to the port's."""
    out = dict(snap)
    out["warm_classes"] = {PORT_CACHE[k]: v
                           for k, v in snap["warm_classes"].items()}
    return out


def _run_tape(js, ts, tape, snapshot_every: int = 7):
    last = None
    for i, op in enumerate(tape):
        if op[0] == "note":
            _, cache, mi, cap, b, n = op
            js.note_warm(cache, mi, cap, b, n)
            ts.note_warm(PORT_CACHE[cache], mi, cap, b, n)
        elif op[0] == "snap":
            _, cache, bp0, n0, mi, cap = op
            got_j = js.snap(cache, bp0, n0, mi, cap)
            got_t = ts.snap(PORT_CACHE[cache], bp0, n0, mi, cap)
            assert got_t == got_j, (i, op)
            assert got_t[0] >= bp0 and got_t[1] >= n0
            last = (cache, mi, cap) + tuple(got_t)
        elif last is not None:             # launch: the class is warm now
            cache, mi, cap, b, n = last
            js.note_warm(cache, mi, cap, b, n)
            ts.note_warm(PORT_CACHE[cache], mi, cap, b, n)
        if i % snapshot_every == 0:
            assert ts.snapshot() == _port_snapshot(js.snapshot()), i
    assert ts.snapshot() == _port_snapshot(js.snapshot())


# (seed, tape length, note share, policy kwargs)
SCENARIOS = {
    "default": (1, 400, 0.4, {}),
    "tight_waste_slow_recur": (2, 400, 0.4,
                               {"max_waste": 1.5, "recur_threshold": 3}),
    "note_heavy": (3, 300, 0.7, {}),
    "cold_snaps": (4, 300, 0.05, {}),
    "first_sight_classes": (5, 300, 0.4, {"recur_threshold": 1}),
    "wide_waste": (6, 300, 0.3, {"max_waste": 16.0}),
    "disabled": (7, 200, 0.4, {"enabled": False}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_steer_tapes_match_jax(scenario):
    seed, n, note_share, kw = SCENARIOS[scenario]
    tape = steer_tape(seed, n, note_share)
    js, ts = jsteer.ShapeSteer(**kw), tsteer.ShapeSteer(**kw)
    _run_tape(js, ts, tape)
    snap = ts.snapshot()
    if kw.get("enabled", True):
        assert snap["lookups"] > 0
        if scenario == "default":
            # the tape reaches every branch of the policy
            assert snap["hits"] and snap["padded"] and snap["compiles"]
    else:
        assert snap["lookups"] == 0


@pytest.mark.parametrize("table", [True, False])
def test_reset_matches_jax(table):
    """`reset` clears the counters, and with table=True the warm set; the
    next tape then gives the same returns on both sides."""
    js, ts = jsteer.ShapeSteer(), tsteer.ShapeSteer()
    _run_tape(js, ts, steer_tape(11, 120))
    js.reset(table=table)
    ts.reset(table=table)
    assert ts.snapshot() == _port_snapshot(js.snapshot())
    _run_tape(js, ts, steer_tape(12, 120))


def test_capacity_class_and_warmup_batches_match_jax():
    caps = list(range(0, 1100)) + [int(x) for x in np.random.default_rng(
        5).integers(1100, 1 << 20, 500)]
    assert [tsteer.cap_class(c) for c in caps] == \
        [jsteer.cap_class(c) for c in caps]
    assert [tsteer._pow2(c) for c in caps] == [jax_pow2(c) for c in caps]
    for fd in range(0, 70):
        assert tsteer.warmup_batches(fd) == jsteer.warmup_batches(fd)
    # the session's capacity floor is steer's, as in the JAX package
    assert tff.cap_class is tsteer.cap_class


@pytest.mark.parametrize("flush_docs,mesh_window", [(4, False), (3, True)])
def test_warmup_warm_table_matches_jax(flush_docs, mesh_window):
    """A bank's warm-up notes the same warm classes as the JAX package's
    for the same options: K1's replay classes at their pow2 op classes
    under "kernel" and "fused" (JAX: "pallas" and "fused"), and the
    window's super-batch classes under "mesh"."""
    opts = {"cap": 256, "max_ins": 4}
    for st in (tsteer.STEER, jsteer.STEER):
        st.reset(table=True)
    try:
        jol = JaxOpLog()
        js = JaxScheduler(1, resolve=lambda d: jol, fused_opts=opts,
                          flush_docs=flush_docs, warmup=True, pallas=True,
                          mesh_window=mesh_window)
        js.banks[0].join_warmup(timeout=300)
        ol = OpLog()
        ts = MergeScheduler(1, resolve=lambda d: ol,
                            fused_opts=dict(opts, device="cpu"),
                            flush_docs=flush_docs, warmup=True,
                            mesh_window=mesh_window)
        ts.banks[0].join_warmup()
        want = {PORT_CACHE.get(k, k): v
                for k, v in jsteer.STEER._warm.items()}
        got = dict(tsteer.STEER._warm)
        assert got == want
        assert set(got) == ({"kernel", "fused", "mesh"} if mesh_window
                            else {"kernel", "fused"})
        assert {k[3] for k in got["kernel"]} == {2, 4, 8}
    finally:
        for st in (tsteer.STEER, jsteer.STEER):
            st.reset(table=True)
