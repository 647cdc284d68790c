"""The port's fork/join plan compiler (`listmerge/plan2.py`) and dense
executor (`listmerge/dense.py`) against the JAX package's, and the two
engine selections of the port's `Branch.merge` (`DT_TPU_PLAN2`,
`DT_TPU_DEVICE_MERGE`).

Histories: `torch_parity.TwinDocs` (the same calls into both packages'
oplogs) and `tests/test_encode.py::build_random_oplog` seeds carried into
the port with `oplog_from_columns`. Plans, transformed-op streams' texts
and frontiers are compared exactly; the host checkout (the Python engine)
is the oracle.
"""

import numpy as np
import pytest

from diamond_types_tpu.listmerge import dense as jdense
from diamond_types_tpu.listmerge.plan2 import compile_plan2 as jcompile
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu_torch import Branch, OpLog, oplog_from_columns
from diamond_types_tpu_torch.listmerge import dense as tdense
from diamond_types_tpu_torch.listmerge import plan2 as tplan2

from test_encode import build_random_oplog
from torch_parity import UNICODE, TwinDocs, export_columns

AGENTS = ("alice", "bob", "carol")


def plan_key(plan):
    return (plan.actions, plan.indexes_used, plan.ff_spans,
            sorted(plan.final_frontier), sorted(plan.common),
            [(e.span, e.parents, e.emit, e.num_children)
             for e in plan.entries], plan.pinned_rows)


def twin_history(seed, rounds=4, alphabet="abcdefgh"):
    tw = TwinDocs([JaxOpLog(), OpLog()], seed, alphabet)
    tw.type_base("alice", 30)
    tw.fork(AGENTS)
    for _ in range(rounds):
        tw.concurrent_round(AGENTS, 3)
    return tw.oplogs


def random_history(seed):
    jol = build_random_oplog(seed, steps=40)
    return jol, oplog_from_columns(export_columns(jol))


def histories():
    return ([("twin", s) for s in range(3)]
            + [("random", s) for s in range(6)])


def history(kind, seed):
    if kind == "twin":
        return twin_history(seed, alphabet=UNICODE if seed == 2 else
                            "abcdefgh")
    return random_history(seed)


def frontiers(ol, seed):
    """(from, merge) pairs: the whole history, a mid version to the tip,
    and two concurrent mid versions."""
    rng = np.random.default_rng(seed)
    n = len(ol)
    g = ol.cg.graph
    a, b = sorted(int(x) for x in rng.integers(0, n, 2))
    return [([], list(ol.version)), ([a], list(ol.version)),
            (list(g.find_dominators([a])), list(g.find_dominators([b]))),
            (list(ol.version), list(ol.version))]


@pytest.mark.parametrize("kind,seed", histories())
def test_compile_plan2_matches_jax(kind, seed):
    jol, tol = history(kind, seed)
    assert list(jol.version) == list(tol.version)
    for frm, to in frontiers(tol, seed):
        jp = jcompile(jol.cg.graph, list(frm), list(to))
        tp = tplan2.compile_plan2(tol.cg.graph, list(frm), list(to))
        assert plan_key(tp) == plan_key(jp), (frm, to)
        tplan2.validate_plan2(tp)
    whole = tplan2.compile_plan2(tol.cg.graph, [], list(tol.version))
    assert len(whole.entries) > 1            # a conflict zone, not linear


@pytest.mark.parametrize("kind,seed", histories())
def test_merge_via_plan2_matches_jax_and_host(kind, seed):
    jol, tol = history(kind, seed)
    for frm, to in frontiers(tol, seed):
        jrows, jfinal = jdense.merge_via_plan2(jol, frm, to)
        trows, tfinal = tdense.merge_via_plan2(tol, frm, to, validate=True)
        assert sorted(tfinal) == sorted(jfinal)
        assert [(lv, op.kind, len(op), pos) for lv, op, pos in trows] == \
            [(lv, op.kind, len(op), pos) for lv, op, pos in jrows]
        base = tol.checkout(frm).snapshot()
        text = tdense.apply_xf_stream(tol, base, trows)
        assert text == jdense.apply_xf_stream(jol, base, jrows)
        host = tol.checkout(frm)
        host.merge(tol, to)
        assert text == host.snapshot()


@pytest.mark.parametrize("kind,seed", histories())
def test_dense_executor_journal_matches_jax(kind, seed):
    jol, tol = history(kind, seed)
    jp = jcompile(jol.cg.graph, [], list(jol.version))
    tp = tplan2.compile_plan2(tol.cg.graph, [], list(tol.version))
    jex = jdense.DenseExecutor(jp, jol.cg.agent_assignment, jol.ops,
                               journal=True)
    tex = tdense.DenseExecutor(tp, tol.cg.agent_assignment, tol.ops,
                               journal=True)
    jout = [(lv, pos) for lv, _op, pos in jex.run()]
    tout = [(lv, pos) for lv, _op, pos in tex.run()]
    assert tout == jout
    assert tex.journal == jex.journal
    assert [s.ids for s in tex.slots] == [s.ids for s in jex.slots]
    assert list(tex.order) == list(jex.order)
    assert np.array_equal(tex.S, jex.S)


@pytest.mark.parametrize("seed", [3, 11])
def test_branch_merge_plan2_engine(monkeypatch, seed):
    """DT_TPU_PLAN2=1 selects the fork/join engine behind Branch.merge."""
    jol, ol = twin_history(400 + seed, rounds=5)
    oracle = ol.checkout_tip()
    # the default engine is the JAX package's for the same environment
    assert oracle.last_merge_engine == jol.checkout_tip().last_merge_engine
    monkeypatch.setenv("DT_TPU_PLAN2", "1")
    b = ol.checkout([])          # the trivial [] -> [] merge, also plan2
    assert b.last_merge_engine == "plan2"
    b.merge(ol, ol.version)
    assert b.last_merge_engine == "plan2"
    assert b.last_merge_collisions is None
    assert b.snapshot() == oracle.snapshot()
    assert sorted(b.version) == sorted(oracle.version)


@pytest.mark.parametrize("seed", [3, 11])
def test_branch_merge_device_engine(monkeypatch, seed):
    """DT_TPU_DEVICE_MERGE=1 selects the device merge (here on the CPU,
    where K3 runs its plain version), from the start and from a mid
    version."""
    _jol, ol = twin_history(500 + seed, rounds=5)
    oracle = ol.checkout_tip()
    mid = ol.checkout([len(ol) // 2])
    monkeypatch.setenv("DT_TPU_DEVICE_MERGE", "1")
    for b in (Branch(), mid):
        b.merge(ol, ol.version, device="cpu")
        assert b.last_merge_engine == "device"
        assert b.last_merge_collisions is None
        assert b.snapshot() == oracle.snapshot()
        assert sorted(b.version) == sorted(oracle.version)


def test_branch_merge_device_engine_needs_a_card_unless_asked(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _jol, ol = twin_history(7, rounds=1)
    monkeypatch.setenv("DT_TPU_DEVICE_MERGE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        Branch().merge(ol, ol.version)
