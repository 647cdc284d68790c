"""The port's device transform (tail planning) against the JAX package's.

K2's plain version against the Pallas kernel `xform_positions_pallas` in
interpret mode, across its 512-lane chunk boundary; then
`plan_tails_device` on twin `FusedDocSession` buckets (the JAX side with
`DT_TPU_PALLAS=1`, so its resolve runs the interpreted K2): every
document's `TailPlan` and the stats dict must be exactly equal, and the
port's device plans, replayed through `fused_replay` on the CPU, must give
the host checkout's text. Tolerance 0 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import flush_fuse as jff
from diamond_types_tpu.tpu import xform as jxf
from diamond_types_tpu.tpu.pallas_kernels import xform_positions_pallas
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import flush_fuse as tff
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu import xform as txf

from torch_parity import UNICODE, TwinDocs

pytestmark = pytest.mark.fused

AGENTS = ("alice", "bob", "carol")
OPTS = {"cap": 256, "max_ins": 4}
PLAN_FIELDS = ("pos", "dlen", "ilen", "chars", "n_ops", "new_len",
               "max_len", "frontier", "synced_to")


def _columns(rng, b, n):
    nv = rng.integers(0, 9, (b, n))
    ov = rng.integers(0, 9, (b, n))
    ov[-1] = nv[-1] + rng.integers(1, 4, n)    # prefix sum negative throughout
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (nv, ov)]


@pytest.mark.parametrize("n", [1, 2, 511, 512, 513, 1100])
def test_k2_plain_matches_pallas_interpreted(n):
    nv, ov = _columns(np.random.default_rng(n), 3, n)
    launches = kernels.xform_positions.launches
    pos, new_len, peak = kernels.xform_positions(nv, ov)
    assert kernels.xform_positions.launches == launches   # plain on CPU
    assert pos.dtype == new_len.dtype == peak.dtype == torch.int32
    assert int(peak[-1]) == 0
    for r in range(3):
        wp, wl, wk = xform_positions_pallas(jnp.asarray(nv[r].numpy()),
                                            jnp.asarray(ov[r].numpy()),
                                            interpret=True)
        np.testing.assert_array_equal(pos[r].numpy(), np.asarray(wp))
        assert (int(new_len[r]), int(peak[r])) == (int(wl), int(wk))


def test_k2_plain_on_empty_rows_and_bad_inputs():
    z = torch.zeros((3, 0), dtype=torch.int32)
    pos, new_len, peak = kernels.xform_positions(z, z)
    assert pos.shape == (3, 0) and new_len.tolist() == peak.tolist() == [0] * 3
    with pytest.raises(ValueError, match="one \\[b, n\\] shape"):
        kernels.xform_positions(z, torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        kernels.xform_positions(z.long(), z.long())


def test_k2_wrapper_rejects_devices_it_does_not_run_on():
    """The wrapper refuses a device that is neither the CPU nor CUDA, and
    columns on two devices."""
    m = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    c = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.xform_positions(m, m)
    with pytest.raises(ValueError, match="expected"):
        kernels.xform_positions(c, m)


def _twins(bases, seed, alphabet):
    twins = []
    for i, n in enumerate(bases):
        tw = TwinDocs([JaxOpLog(), OpLog()], seed * 100 + i, alphabet)
        tw.type_base("alice", n)
        tw.fork(AGENTS)
        twins.append(tw)
    return twins


def _assert_plans_equal(jp, tp):
    for f in PLAN_FIELDS:
        a, b = getattr(jp, f), getattr(tp, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert b == a, f


def _replay_window(sessions, plans):
    """Resync what does not fit, commit empty plans, replay the rest in
    one bucket per cap; returns the fence results."""
    by_cap, oks = {}, []
    for i, (s, p) in enumerate(zip(sessions, plans)):
        if not p.fits(s.cap):
            s.resync_for(p)
        elif p.n_ops == 0:
            s.commit_host(p)
        else:
            by_cap.setdefault(s.cap, []).append(i)
    for idx in by_cap.values():
        ok, _ = tff.fused_replay([sessions[i] for i in idx],
                                 [plans[i] for i in idx])
        oks += ok
    return oks


@pytest.mark.parametrize("seed,alphabet", [(1, "abcdefgh"), (2, UNICODE)])
def test_plan_tails_device_matches_jax(monkeypatch, seed, alphabet):
    monkeypatch.setenv("DT_TPU_PALLAS", "1")
    twins = _twins([40, 90, 150, 70, 120], seed, alphabet)
    js = [jff.FusedDocSession(tw.oplogs[0], **OPTS) for tw in twins]
    ts = [tff.FusedDocSession(tw.oplogs[1], device="cpu", **OPTS)
          for tw in twins]
    device_docs = 0
    for w in range(3):
        for i, tw in enumerate(twins):
            if i != 4 or w == 1:             # doc 4 idles: an empty tail
                tw.concurrent_round(AGENTS, 3)
        jplans, jstats = jxf.plan_tails_device(js)
        tplans, tstats = txf.plan_tails_device(ts)
        assert tstats == jstats
        assert tstats["fallbacks"] == 0
        device_docs += tstats["device_docs"]
        for jp, tp in zip(jplans, tplans):
            _assert_plans_equal(jp, tp)
        assert all(_replay_window(ts, tplans))
        for i, (s, p) in enumerate(zip(js, jplans)):   # keep the JAX side
            if not p.fits(s.cap):                      # in step
                s.resync_for(p)
            elif p.n_ops == 0:
                s.commit_host(p)
            else:
                ok, _ = jff.fused_replay([s], [p])
                assert ok == [True]
        for s, tw in zip(ts, twins):
            assert s.text() == tw.oplogs[1].checkout_tip().snapshot()
    assert device_docs >= 8


def test_length_disagreement_is_the_only_host_rung(monkeypatch):
    """A device length that disagrees with the host visibility sum sends
    that document to the host plan (counted as a fallback); any other
    fault in the resolve propagates instead of hiding as a host plan."""
    twins = _twins([50, 80], 9, "abc")
    ts = [tff.FusedDocSession(tw.oplogs[1], device="cpu", **OPTS)
          for tw in twins]
    for tw in twins:
        tw.concurrent_round(AGENTS, 3)
    want = [s.plan_tail() for s in ts]
    real = kernels.xform_positions

    def off_by_one(nv, ov):
        pos, new_len, peak = real(nv, ov)
        return pos, new_len + torch.tensor([1, 0], dtype=torch.int32), peak

    monkeypatch.setattr(kernels, "xform_positions", off_by_one)
    plans, stats = txf.plan_tails_device(ts)
    assert stats == {"device_docs": 1, "host_docs": 0, "fallbacks": 1,
                     "batches": 1}
    _assert_plans_equal(want[0], plans[0])

    def broken(nv, ov):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(kernels, "xform_positions", broken)
    with pytest.raises(RuntimeError, match="kernel fault"):
        txf.plan_tails_device(ts)
