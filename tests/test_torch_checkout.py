"""The port's device checkout against the JAX package's and the host.

`prepare_doc` must build the same `DeviceDoc` tables; `checkout_batch_device`
(one `fugue_linearize` and one K3 call for the batch; K3's plain version on
the CPU) must give the JAX package's texts (with `DT_TPU_PALLAS=1`, its
interpreted Pallas K3) and the host checkout's; `merge_device` from an
older frontier must give the same (text, frontier) as the JAX package and
as a host `Branch` checked out there that merges the tip. Tolerance 0.
"""

import numpy as np
import pytest

from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import merge_kernel as jmk
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu import merge_kernel as tmk

from torch_parity import UNICODE, TwinDocs

AGENTS = ("alice", "bob", "carol")
DOC_FIELDS = ("parent", "side", "key_pos", "key_agent", "key_seq",
              "vis_len", "char_off", "chars")


def _twins(seed, alphabet):
    """Four concurrent histories, the frontier each had before its two
    concurrent rounds, and one purely linear history (no conflict zone:
    the one-pseudo-run document)."""
    twins, marks = [], []
    for i in range(4):
        tw = TwinDocs([JaxOpLog(), OpLog()], seed * 10 + i, alphabet)
        tw.type_base("alice", 30 + 20 * i)
        marks.append(list(tw.oplogs[1].version))
        tw.fork(AGENTS)
        for _ in range(2):
            tw.concurrent_round(AGENTS, 4)
        twins.append(tw)
    tw = TwinDocs([JaxOpLog(), OpLog()], seed * 10 + 9, alphabet)
    tw.type_base("alice", 25)
    tw.edits("alice", 6)
    marks.append(list(tw.oplogs[1].version)[:1])
    twins.append(tw)
    return twins, marks


@pytest.mark.parametrize("seed,alphabet", [(3, "abcdefgh"), (4, UNICODE)])
def test_checkout_batch_matches_jax_and_host(monkeypatch, seed, alphabet):
    monkeypatch.setenv("DT_TPU_PALLAS", "1")
    twins, _ = _twins(seed, alphabet)
    jdocs = [jmk.prepare_doc(tw.oplogs[0]) for tw in twins]
    tdocs = [tmk.prepare_doc(tw.oplogs[1]) for tw in twins]
    for jd, td in zip(jdocs, tdocs):
        for f in DOC_FIELDS:
            a, b = getattr(jd, f), getattr(td, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        assert (td.total_len, td.frontier) == (jd.total_len, jd.frontier)
    assert len(tdocs[-1].parent) == 1          # the linear history
    host = [tw.oplogs[1].checkout_tip().snapshot() for tw in twins]
    got = tmk.checkout_batch_device(tdocs, device="cpu")
    assert got == jmk.checkout_batch_device(jdocs) == host
    # a cap below the longest document truncates the same way
    cap = 64
    assert tmk.checkout_batch_device(tdocs, cap=cap, device="cpu") == \
        jmk.checkout_batch_device(jdocs, cap=cap) == [t[:cap] for t in host]
    assert tmk.checkout_device(twins[0].oplogs[1], device="cpu") == host[0]


def test_merge_device_matches_jax_and_host_branch(monkeypatch):
    monkeypatch.setenv("DT_TPU_PALLAS", "1")
    twins, marks = _twins(5, "abcdef")
    for tw, frm in zip(twins, marks):
        jo, to = tw.oplogs
        launches = kernels.materialize_runs.launches
        got = tmk.merge_device(to, frm, device="cpu")
        assert kernels.materialize_runs.launches == launches
        assert got == jmk.merge_device(jo, frm)
        br = to.checkout(frm)
        br.merge(to, to.version)
        assert got[0] == br.snapshot()
        assert sorted(got[1]) == sorted(br.version)
