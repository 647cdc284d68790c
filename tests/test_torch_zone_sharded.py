"""The zone engine's multi-device forms in the port against the JAX
package's: `execute_zone_batch(devices=)` against
`execute_zone_batch_jax(replica_sharding=)` and `DeviceZoneSession(devices=)`
against `DeviceZoneSession(row_sharding=)`.

JAX runs its forms on the tests' 8-device virtual CPU mesh
(`tests/conftest.py`); the port names the CPU k times, which runs its
split, placement and gathers but copies nothing between cards. Equality
is exact everywhere: ranks, `ever` planes and texts, and the sessions'
`resyncs`, `merges`, `n_rows_eff`, `footprint_slots()` and row registry
after every sync.

The JAX modules are imported inside the tests that use them, so the card
tests at the end run on a host without JAX:
`python -m pytest tests/test_torch_zone_sharded.py -m cuda -q`.
"""

import numpy as np
import pytest
import torch

from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu import zone_kernel as tk
from diamond_types_tpu_torch.gpu.zone_session import DeviceZoneSession
from diamond_types_tpu_torch.listmerge import policy as tpolicy
from diamond_types_tpu_torch.listmerge import zone_np as tzone
from diamond_types_tpu_torch.serve import SessionBank

from torch_parity import zone_history

# two agents on at most two concurrent branches: the plan needs 2 index
# rows, so the sessions' row counts (n_rows 2 or 4 rounded up to k) differ
HISTORY = dict(n_edits=120, agents=("sa", "sb"), max_branches=2)


@pytest.fixture(autouse=True)
def _fresh_port_policy(monkeypatch):
    monkeypatch.setattr(tpolicy, "GLOBAL", tpolicy.EnginePolicy())


def _rows_sharding(k: int):
    """JAX's sharding of a [rows, W] array's first axis over the first k
    devices of the virtual mesh."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    return NamedSharding(Mesh(np.array(jax.devices()[:k]), ("docs",)),
                         P("docs", None))


class Launches:
    """Stands in for `kernels.zone_tape_run`: calls it and keeps each
    call's replica count and device."""

    def __init__(self):
        self.real = kernels.zone_tape_run
        self.calls = []

    def __call__(self, carry, xs, plen, cluster=None):
        self.calls.append((carry.state.shape[0], carry.state.device,
                           xs["op"].device))
        return self.real(carry, xs, plen, cluster=cluster)


@pytest.fixture
def launches(monkeypatch):
    spy = Launches()
    monkeypatch.setattr(kernels, "zone_tape_run", spy)
    return spy


def _twin_tapes(seed: int):
    from diamond_types_tpu.listmerge import zone_np as jzone
    from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
    from diamond_types_tpu.tpu import zone_kernel as jk
    jol, tol = zone_history([JaxOpLog, OpLog], seed, **HISTORY)
    jp, tp = jzone.prepare_zone(jol), tzone.prepare_zone(tol)
    return jk, jp, tp, jk.pack_zone_tape(jp), tk.pack_zone_tape(tp)


# ---- the replica form --------------------------------------------------------

@pytest.mark.parametrize("k, batch", [(1, 4), (2, 8), (4, 8), (3, 6)])
def test_replica_form_matches_jax(k, batch, launches):
    """B replicas over k devices: one X8 call a device over its block of
    B / k replicas, each device with its own tape columns; every
    replica's rank and ever equal the JAX form's on a k-device mesh (and
    the one-device run's)."""
    jk, jp, tp, jt, tt = _twin_tapes(9100 + k)
    jr, je = jk.execute_zone_batch_jax(jt, jp.agent_k, jp.seq_k, batch,
                                       replica_sharding=_rows_sharding(k))
    assert len(jr.sharding.device_set) == k
    rank, ever = tk.execute_zone_batch(tt, tp.agent_k, tp.seq_k, batch,
                                       devices=["cpu"] * k)
    cpu = torch.device("cpu")
    assert launches.calls == [(batch // k, cpu, cpu)] * k
    assert rank.shape == ever.shape == (batch, tt.W)
    assert np.array_equal(rank.numpy(), np.asarray(jr))
    assert np.array_equal(ever.numpy(), np.asarray(je))
    r1, e1 = tk.execute_zone_batch(tt, tp.agent_k, tp.seq_k, 1,
                                   device="cpu")
    assert torch.equal(rank, r1.expand(batch, -1))
    assert torch.equal(ever, e1.expand(batch, -1))


@pytest.mark.parametrize("k, batch", [(4, 6), (3, 8)])
def test_replica_form_rejects_an_uneven_split_as_jax(k, batch, launches):
    """A batch that does not divide over the devices raises ValueError in
    both packages, the port's before any launch."""
    jk, jp, tp, jt, tt = _twin_tapes(9200)
    with pytest.raises(ValueError):
        jk.execute_zone_batch_jax(jt, jp.agent_k, jp.seq_k, batch,
                                  replica_sharding=_rows_sharding(k))
    with pytest.raises(ValueError, match="does not divide"):
        tk.execute_zone_batch(tt, tp.agent_k, tp.seq_k, batch,
                              devices=["cpu"] * k)
    with pytest.raises(ValueError, match="no device"):
        tk.execute_zone_batch(tt, tp.agent_k, tp.seq_k, batch, devices=[])
    assert launches.calls == []


def test_replica_form_uses_a_given_tape_on_its_device(launches,
                                                      monkeypatch):
    """A given `xs` is the first device's columns: a split over that
    device named twice uploads the tape for neither block."""
    _jk, _jp, tp, _jt, tt = _twin_tapes(9300)
    xs = tk.tape_xs(tt, "cpu")

    def no_upload(*a, **kw):
        raise AssertionError("the tape was uploaded again")
    monkeypatch.setattr(tk, "tape_xs", no_upload)
    rank, _ever = tk.execute_zone_batch(tt, tp.agent_k, tp.seq_k, 4,
                                        xs=xs, devices=["cpu"] * 2)
    assert len(launches.calls) == 2 and rank.shape == (4, tt.W)


# ---- the row form ------------------------------------------------------------

def _twin_sessions(seed: int, k: int, n_rows: int, **kw):
    from test_torch_zone_session import TwinSessions
    return TwinSessions(seed, jax_kw={"row_sharding": _rows_sharding(k)},
                        port_kw={"devices": ["cpu"] * k}, n_rows=n_rows,
                        **kw)


def _assert_row_blocks(sess, k: int) -> None:
    """Between syncs the state rows rest in k equal blocks, in device
    order, and the rest of the carry on the first device."""
    assert sess.carry.state is None
    assert sess.n_rows_eff % k == 0
    blocks = sess.state_blocks
    assert len(blocks) == k
    assert [b.device for b in blocks] == sess.devices
    assert all(b.shape == (1, sess.n_rows_eff // k, sess.W_cap)
               for b in blocks)
    assert all(t.device == sess.device
               for t in sess.carry if t is not None)


def _check_twins(tw, k: int, where) -> None:
    tw.sync_and_check(where)
    _assert_row_blocks(tw.sessions[1], k)


@pytest.mark.parametrize("n_rows", [2, 4])
@pytest.mark.parametrize("k", [2, 3])
def test_row_form_realtime_fuzz_matches_jax(k, n_rows):
    """The realtime fuzz of `test_torch_zone_session.py` with the rows over
    k devices: after every sync the texts equal each other and the
    tracker's, and the counters and row registries are equal."""
    tw = _twin_sessions(8800 + 10 * k + n_rows, k, n_rows, max_chars=32)
    _check_twins(tw, k, "build")
    for step in range(30):
        tw.step()
        _check_twins(tw, k, f"k {k} n_rows {n_rows} step {step}")


@pytest.mark.parametrize("n_rows", [2, 4])
@pytest.mark.parametrize("k", [2, 3])
def test_row_form_resync_drills_match_jax(k, n_rows):
    """The JAX package's sharded-session drills on a `random_edit`
    history: concurrent edits, forks past the row count and a revisit of
    an evicted frontier, a bulk insert just past the slot headroom, a new
    agent.
    Each forced drill raises `resyncs` in both packages; after every
    sync both sessions agree with the tracker and each other."""
    from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
    from diamond_types_tpu.tpu.zone_session import \
        DeviceZoneSession as JaxSession
    ols = zone_history([JaxOpLog, OpLog], 9400 + k, **HISTORY)
    sess = [JaxSession(ols[0], n_rows=n_rows,
                       row_sharding=_rows_sharding(k)),
            DeviceZoneSession(ols[1], n_rows=n_rows, devices=["cpu"] * k)]
    ids = [[ol.get_or_create_agent_id(n) for n in HISTORY["agents"]]
           for ol in ols]

    def edit(fn):
        """Apply `fn(ol, agents)` to both oplogs; returns its results."""
        return [fn(ol, ag) for ol, ag in zip(ols, ids)]

    def parity(tag):
        for s in sess:
            s.sync()
        want = ols[1].checkout_tip().snapshot()
        assert ols[0].checkout_tip().snapshot() == want, tag
        js, ts = sess
        assert js.text() == ts.text() == want, tag
        assert (ts.resyncs, ts.merges, ts.n_rows_eff, ts.footprint_slots(),
                ts.W_cap, ts.W_used) == (js.resyncs, js.merges,
                                         js.n_rows_eff, js.footprint_slots(),
                                         js.W_cap, js.W_used), tag
        assert ts.row_of == js.row_of, tag
        _assert_row_blocks(ts, k)

    parity("build")
    assert sess[1].n_rows_eff == -(-max(n_rows, sess[1].prep.plan
                                        .indexes_used) // k) * k

    def concurrent(ol, ag):
        tip = list(ol.version)
        v1 = ol.add_insert_at(ag[0], tip, 0, "sharded! ")
        v2 = ol.add_insert_at(ag[1], tip, 0, "concurrent! ")
        ol.add_delete_at(ag[0], [v1, v2], 0, 4, None)
    edit(concurrent)
    parity("concurrent edits")

    # more live branches than rows: JAX's drill forks n_devices + 3 times
    # at n_rows = n_devices; n_rows_eff + 3 forks evict at any row count
    base = sess[1].resyncs
    n_forks = sess[1].n_rows_eff + 3

    def forks(ol, ag):
        tip = list(ol.version)
        return [ol.add_insert_at(ag[i % 2], tip, 0, f"[f{i}]")
                for i in range(n_forks)]
    firsts = [f[0] for f in edit(forks)]
    parity("row-exhaustion forks")
    for ol, ag, f in zip(ols, ids, firsts):
        ol.add_insert_at(ag[0], [f], 0, "revisit-evicted ")
    parity("evicted-frontier revisit")
    assert sess[1].resyncs > base

    base = sess[1].resyncs
    overflow = sess[1].W_cap - sess[1].W_used + 64
    edit(lambda ol, ag: ol.add_insert_at(ag[0], list(ol.version), 0,
                                         "#" * overflow))
    parity("slot-capacity overflow")
    assert sess[1].resyncs > base

    base = sess[1].resyncs
    edit(lambda ol, ag: ol.add_insert_at(
        ol.get_or_create_agent_id("a-fresh-agent"), list(ol.version), 0,
        "epoch! "))
    parity("agent-epoch change")
    assert sess[1].resyncs > base


def test_row_form_runs_each_tape_on_the_first_device(launches):
    """A build, a continuation and a resync each make one X8 call over
    the whole gathered carry on the first device."""
    ol, = zone_history([OpLog], 9500, **HISTORY)
    sess = DeviceZoneSession(ol, n_rows=2, devices=["cpu"] * 3)
    assert len(launches.calls) == 1
    ag = ol.get_or_create_agent_id("sa")
    ol.add_insert_at(ag, list(ol.version), 0, "x")
    sess.sync()
    assert sess.resyncs == 0 and len(launches.calls) == 2
    ol.add_insert_at(ol.get_or_create_agent_id("new"), list(ol.version), 0,
                     "y")
    sess.sync()
    assert sess.resyncs == 1 and len(launches.calls) == 3
    cpu = torch.device("cpu")
    assert launches.calls == [(1, cpu, cpu)] * 3
    assert sess.text() == ol.checkout_tip().snapshot()


def test_row_form_device_and_devices_are_exclusive():
    ol, = zone_history([OpLog], 9600, n_edits=8, agents=("sa",))
    with pytest.raises(ValueError, match="mutually exclusive"):
        DeviceZoneSession(ol, device="cpu", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="no device"):
        DeviceZoneSession(ol, devices=[])
    sess = DeviceZoneSession(ol, devices=["cpu"] * 2)
    assert sess.device == torch.device("cpu")
    assert sess.text() == ol.checkout_tip().snapshot()


def test_bank_passes_devices_through():
    """`SessionBank(fused=False)` hands `session_opts["devices"]` to each
    zone session unchanged; the bank's device is their first."""
    ol, = zone_history([OpLog], 9700, **HISTORY)
    bank = SessionBank(0, engine="device", fused=False,
                       session_opts={"devices": ["cpu"] * 2, "n_rows": 2})
    assert bank.device == torch.device("cpu")
    sess = bank.session("d", ol)
    assert sess.devices == [torch.device("cpu")] * 2
    assert sess.text() == ol.checkout_tip().snapshot()
    _assert_row_blocks(sess, 2)


# ---- on the card -------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no "
                    "interpret mode")


@pytest.mark.cuda
def test_replica_form_on_the_card():
    """B 8 over the card named four times: four X8 launches of two
    replicas, every replica equal to B 1 on the card and to the CPU."""
    _need_card()
    ol, = zone_history([OpLog], 9800, **HISTORY)
    prep = tzone.prepare_zone(ol)
    tape = tk.pack_zone_tape(prep)
    kernels.zone_tape_run.launches = 0
    rank, ever = tk.execute_zone_batch(tape, prep.agent_k, prep.seq_k, 8,
                                       devices=["cuda:0"] * 4)
    torch.cuda.synchronize()
    assert kernels.zone_tape_run.launches == 4
    r1, e1 = tk.execute_zone_batch(tape, prep.agent_k, prep.seq_k, 1)
    assert rank.device.type == "cuda" and rank.shape == (8, tape.W)
    assert torch.equal(rank, r1.expand(8, -1))
    assert torch.equal(ever, e1.expand(8, -1))
    rc, _ec = tk.execute_zone_batch(tape, prep.agent_k, prep.seq_k, 1,
                                    device="cpu")
    assert torch.equal(r1.cpu(), rc)
    kernels.zone_tape_run.launches = 0
    with pytest.raises(ValueError, match="does not divide"):
        tk.execute_zone_batch(tape, prep.agent_k, prep.seq_k, 6,
                              devices=["cuda:0"] * 4)
    assert kernels.zone_tape_run.launches == 0


@pytest.mark.cuda
def test_row_form_on_the_card():
    """A session with its rows over the card named three times against
    the same session on the CPU named three times, after every sync."""
    _need_card()
    import random

    from test_zone import random_edit
    ols = zone_history([OpLog, OpLog], 9900, **HISTORY)
    sess = [DeviceZoneSession(ols[0], n_rows=4, devices=["cuda:0"] * 3),
            DeviceZoneSession(ols[1], n_rows=4, devices=["cpu"] * 3)]
    rngs = [random.Random(5), random.Random(5)]
    tip = ols[0].checkout_tip()
    heads = [{n: (list(tip.version), tip.snapshot()) for n in ("sa", "sb")}
             for _ in ols]
    kernels.zone_tape_run.launches = 0
    for step in range(20):
        name = ("sa", "sb")[step % 2]
        for i, ol in enumerate(ols):
            heads[i][name] = random_edit(rngs[i], ol,
                                         ol.get_or_create_agent_id(name),
                                         *heads[i][name])
        for s in sess:
            s.sync()
        want = ols[1].checkout_tip().snapshot()
        assert sess[0].text() == sess[1].text() == want, step
        assert (sess[0].resyncs, sess[0].merges, sess[0].n_rows_eff) == \
            (sess[1].resyncs, sess[1].merges, sess[1].n_rows_eff), step
        _assert_row_blocks(sess[0], 3)
    assert kernels.zone_tape_run.launches == \
        sess[0].resyncs + sess[0].merges > 0
