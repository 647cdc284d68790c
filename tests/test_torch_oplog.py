"""Host layer parity: the port's OpLog against the JAX package's.

The same seeded multi-agent concurrent edit script goes into both oplogs;
versions, transformed-op streams and checkouts must be exactly equal.
`oplog_from_columns` must rebuild a JAX-package oplog's history from its
exported columns alone.
"""

import numpy as np
import pytest

from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu_torch import OpLog, oplog_from_columns
from diamond_types_tpu_torch.text.op import DEL

from torch_parity import ASCII, UNICODE, TwinDocs, export_columns, xf_rows

AGENTS = ("alice", "bob", "carol")


def _history(seed: int, alphabet: str) -> TwinDocs:
    tw = TwinDocs([JaxOpLog(), OpLog()], seed, alphabet)
    tw.type_base("alice", 40)
    for _ in range(3):
        tw.concurrent_round(AGENTS, 6)
    return tw


@pytest.mark.parametrize("seed,alphabet", [(1, ASCII), (2, UNICODE),
                                           (3, UNICODE)])
def test_version_xf_and_checkout_match(seed, alphabet):
    tw = _history(seed, alphabet)
    jol, pol = tw.oplogs
    assert len(jol) == len(pol)
    assert jol.version == pol.version
    # frontiers: empty, each agent's branch version, a mid-history LV
    froms = [[], [len(jol) // 2]]
    froms += [list(tw.branches[0][a].version) for a in AGENTS]
    assert sum(len(xf_rows(jol, frm, jol.version)) > 0
               for frm in froms) >= 3
    for frm in froms:
        assert xf_rows(pol, frm, pol.version) == \
            xf_rows(jol, frm, jol.version)
    assert pol.checkout_tip().snapshot() == jol.checkout_tip().snapshot()
    for a in AGENTS:
        v = tw.branches[1][a].version
        assert pol.checkout(v).snapshot() == jol.checkout(v).snapshot()


def test_reverse_delete_runs_carry_over():
    """Backspace runs are stored as reversed delete runs in both op
    stores, and transform and check out identically."""
    tw = _history(4, UNICODE)
    jol, pol = tw.oplogs
    rev = [(r.lv, r.start, r.end) for r in pol.ops.runs
           if r.kind == DEL and not r.fwd]
    assert rev, "the script made no backspace run"
    assert rev == [(r.lv, r.start, r.end) for r in jol.ops.runs
                   if r.kind == DEL and not r.fwd]
    assert pol.checkout_tip().snapshot() == jol.checkout_tip().snapshot()


def test_conflict_count_matches(monkeypatch):
    """Two agents fork at one version and insert into the same gap: both
    packages see the collision, and the JAX package's Python engine
    counts exactly what the port counts."""
    tw = _history(5, ASCII)
    jol, pol = tw.oplogs
    tw.merge_tip("bob")
    tw.merge_tip("carol")
    tw.insert("bob", 5, "BBB")
    tw.insert("carol", 5, "CC")
    v = list(tw.branches[0]["bob"].version)
    assert jol.has_conflicts_when_merging(v)
    assert pol.has_conflicts_when_merging(v)
    monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    assert pol.count_conflicts_when_merging(v) == \
        jol.count_conflicts_when_merging(v)


@pytest.mark.parametrize("seed,alphabet", [(6, ASCII), (7, UNICODE)])
def test_oplog_from_columns_reproduces_history(seed, alphabet):
    jol = _history(seed, alphabet).oplogs[0]
    cols = export_columns(jol)
    assert isinstance(cols["lv_start"], np.ndarray)
    pol = oplog_from_columns(cols)
    assert len(pol) == len(jol)
    assert pol.version == jol.version
    assert pol.checkout_tip().snapshot() == jol.checkout_tip().snapshot()
    mid = [len(jol) // 3]
    assert pol.checkout(mid).snapshot() == jol.checkout(mid).snapshot()
    assert xf_rows(pol, mid, pol.version) == xf_rows(jol, mid, jol.version)


def test_oplog_from_columns_rejects_gaps():
    jol = _history(8, ASCII).oplogs[0]
    cols = export_columns(jol)
    cols["lv_start"] = cols["lv_start"] + 1
    with pytest.raises(ValueError):
        oplog_from_columns(cols)
