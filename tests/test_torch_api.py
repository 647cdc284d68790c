"""The port's public host API against the JAX package's.

Each test feeds the same seeded inputs (numpy generators, or one
`random.Random` seed per package) to a JAX module and its port and
requires equal outputs: UTF-16 position conversions and the wchar entry
points of `Branch` on astral text, `ListCRDT` and `merge_oplogs`, the
package root's `load` / `save` (byte-identical, full and as a patch),
the OT bridge on generated traversal ops (`tests/test_ot.py`'s golden
vectors are not in the repo), subgraph projection and the stochastic
summary, the plan engine (`listmerge/plan.py`) against JAX's plan and
the tracker, the invariant checkers, and the oplog statistics.
"""

import io
import random
from contextlib import redirect_stdout

import numpy as np
import pytest

import diamond_types_tpu as jpkg
import diamond_types_tpu_torch as tpkg
from diamond_types_tpu.causalgraph import stochastic_summary as jstoch
from diamond_types_tpu.causalgraph import subgraph as jsub
from diamond_types_tpu.core import unicount as juni
from diamond_types_tpu.encoding import encode as jenc
from diamond_types_tpu.listmerge import plan as jplan
from diamond_types_tpu.text import ot as jot
from diamond_types_tpu.utils import checkers as jchk
from diamond_types_tpu.utils import stats as jstats
from diamond_types_tpu_torch.causalgraph import stochastic_summary as tstoch
from diamond_types_tpu_torch.causalgraph import subgraph as tsub
from diamond_types_tpu_torch.core import unicount as tuni
from diamond_types_tpu_torch.listmerge import plan as tplan
from diamond_types_tpu_torch.text import ot as tot
from diamond_types_tpu_torch.text.oplog import oplog_from_columns
from diamond_types_tpu_torch.utils import checkers as tchk
from diamond_types_tpu_torch.utils import stats as tstats
from tests.test_encode import build_random_oplog
from tests.test_subgraph import random_graph
from tests.torch_parity import UNICODE, TwinDocs, export_columns, rand_text

ASTRAL = "a😀b𝔘c🎉中ש\U0001F600\U00010000\U0010FFFFé"


def _pair_random(seed: int, steps: int = 40):
    """A JAX `build_random_oplog` and the same history in the port."""
    jol = build_random_oplog(seed, steps=steps)
    return jol, oplog_from_columns(export_columns(jol))


def _pair_twin(seed: int, rounds: int = 3, alphabet: str = UNICODE):
    tw = TwinDocs([jpkg.OpLog(), tpkg.OpLog()], seed, alphabet=alphabet)
    tw.type_base("alice", 40)
    names = ("alice", "bob", "carol")
    for _ in range(rounds):
        tw.fork(names)
        tw.concurrent_round(names, 4)
    return tw.oplogs


def _mid_version(ol):
    return ol.cg.graph.find_dominators([max(len(ol) // 2, 1) - 1])


# ---- unicount and the wchar entry points ------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_unicount_conversions_match_jax(seed):
    rng = np.random.default_rng(seed)
    s = rand_text(rng, int(rng.integers(0, 40)), ASTRAL)
    assert tuni.count_utf16(s) == juni.count_utf16(s) \
        == len(s.encode("utf-16-le")) // 2
    for c in range(len(s) + 1):
        w = tuni.chars_to_wchars(s, c)
        assert w == juni.chars_to_wchars(s, c)
        assert tuni.wchars_to_chars(s, w) == juni.wchars_to_chars(s, w) == c
        assert tuni.chars_to_bytes(s, c) == juni.chars_to_bytes(s, c)
        b = tuni.chars_to_bytes(s, c)
        assert tuni.bytes_to_chars(s, b) == juni.bytes_to_chars(s, b) == c
    # positions inside a surrogate pair or past the end raise in both
    for w in range(tuni.count_utf16(s) + 2):
        outs = []
        for mod in (juni, tuni):
            try:
                outs.append(mod.wchars_to_chars(s, w))
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", range(4))
def test_wchar_entry_points_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    ols = [jpkg.OpLog(), tpkg.OpLog()]
    brs = [jpkg.Branch(), tpkg.Branch()]
    agents = [ol.get_or_create_agent_id("w") for ol in ols]
    for _ in range(40):
        text = brs[0].snapshot()
        n_w = juni.count_utf16(text)
        # a wchar boundary: a char boundary mapped to UTF-16
        c0 = int(rng.integers(0, len(text) + 1))
        w0 = juni.chars_to_wchars(text, c0)
        if text and rng.random() < 0.4:
            c1 = min(len(text), c0 + int(rng.integers(1, 4)))
            if c1 == c0:
                continue
            w1 = juni.chars_to_wchars(text, c1)
            lvs = [b.delete_at_wchar(ol, a, w0, w1)
                   for ol, b, a in zip(ols, brs, agents)]
        else:
            ins = rand_text(rng, int(rng.integers(1, 6)), ASTRAL)
            lvs = [b.insert_at_wchar(ol, a, w0, ins)
                   for ol, b, a in zip(ols, brs, agents)]
        assert lvs[0] == lvs[1]
        assert brs[0].snapshot() == brs[1].snapshot()
        assert n_w == juni.count_utf16(text)
    assert jpkg.save(ols[0]) == tpkg.save(ols[1])
    assert ols[1].checkout_tip().snapshot() == brs[1].snapshot()
    # a position inside a surrogate pair is refused by both
    text = brs[0].snapshot()
    inside = next((juni.chars_to_wchars(text, i) + 1
                   for i, ch in enumerate(text) if ord(ch) >= 0x10000), None)
    if inside is not None:
        for ol, b, a in zip(ols, brs, agents):
            with pytest.raises(ValueError, match="surrogate"):
                b.insert_at_wchar(ol, a, inside, "x")


# ---- ListCRDT and merge_oplogs ------------------------------------------------

def _crdt_script(pkg, seed: int):
    """Three ListCRDT replicas editing concurrently and syncing with
    merge_data_and_ff, all decisions from one numpy generator."""
    rng = np.random.default_rng(seed)
    reps = [pkg.ListCRDT() for _ in range(3)]
    ids = [c.get_or_create_agent_id(f"agent{i}") for i, c in enumerate(reps)]
    for step in range(30):
        i = int(rng.integers(0, 3))
        c = reps[i]
        n = len(c)
        if n and rng.random() < 0.35:
            s = int(rng.integers(0, n))
            c.delete(ids[i], s, min(n, s + int(rng.integers(1, 5))))
        else:
            c.insert(ids[i], int(rng.integers(0, n + 1)),
                     rand_text(rng, int(rng.integers(1, 7)), UNICODE))
        if rng.random() < 0.3:
            j = int(rng.integers(0, 3))
            if j != i:
                c.merge_data_and_ff(reps[j])
    for c in reps:
        for d in reps:
            if c is not d:
                c.merge_data_and_ff(d)
    return reps


@pytest.mark.parametrize("seed", range(4))
def test_list_crdt_and_merge_oplogs_match_jax(seed):
    jreps, treps = _crdt_script(jpkg, seed), _crdt_script(tpkg, seed)
    texts = {c.snapshot() for c in jreps + treps}
    assert len(texts) == 1                    # every replica converged
    for jc, tc in zip(jreps, treps):
        assert len(jc) == len(tc)
        assert jc.branch.version == tc.branch.version
        assert jpkg.save(jc.oplog) == tpkg.save(tc.oplog)
        # each package loads the other's state to the same text
        assert tpkg.load(jpkg.save(jc.oplog)).checkout_tip().snapshot() \
            == jc.snapshot()
    # merge_oplogs into a fresh oplog of each package
    jdst, tdst = jpkg.OpLog(), tpkg.OpLog()
    jpkg.merge_oplogs(jdst, jreps[1].oplog)
    tpkg.merge_oplogs(tdst, treps[1].oplog)
    assert jpkg.save(jdst) == tpkg.save(tdst)
    assert tdst.checkout_tip().snapshot() == treps[0].snapshot()


# ---- the package root: load and save ------------------------------------------

def test_root_exports_match_jax():
    assert tpkg.__all__ == jpkg.__all__
    for name in ("ListCRDT", "merge_oplogs", "load", "save"):
        assert callable(getattr(tpkg, name))


@pytest.mark.parametrize("kind,seed", [("random", s) for s in range(3)]
                         + [("twin", s) for s in (1, 2)])
def test_root_load_save_byte_identical(kind, seed):
    jol, tol = _pair_random(seed) if kind == "random" else _pair_twin(seed)
    full = jpkg.save(jol)
    assert tpkg.save(tol) == full
    assert full == jenc.encode_oplog(jol, jenc.ENCODE_FULL)
    frm = _mid_version(jol)
    patch = jpkg.save(jol, patch_since=frm)
    assert tpkg.save(tol, patch_since=frm) == patch
    # the port loads the JAX file to the oplog JAX loads from it (the file
    # numbers agents and ops in its own order): same text, version, graph
    # and agents, and it saves the same bytes again
    back, jback = tpkg.load(full), jpkg.load(full)
    assert isinstance(back, tpkg.OpLog)
    assert back.checkout_tip().snapshot() == jol.checkout_tip().snapshot()
    assert back.version == jback.version
    assert [a.tolist() for a in back.cg.graph.as_arrays()] \
        == [a.tolist() for a in jback.cg.graph.as_arrays()]
    assert list(back.cg.agent_assignment.agent_names) \
        == list(jback.cg.agent_assignment.agent_names)
    bfrm = _mid_version(jback)
    assert tpkg.save(back) == jpkg.save(jback)
    assert tpkg.save(back, patch_since=bfrm) \
        == jpkg.save(jback, patch_since=bfrm)


# ---- the OT bridge --------------------------------------------------------------

def _rand_traversal(rng, doc_len: int) -> list:
    """A random traversal op over a document of `doc_len` chars: retains,
    inserts and deletes, never past the end."""
    op, pos = [], 0
    while True:
        r = rng.random()
        left = doc_len - pos
        if r < 0.3 and left:
            k = int(rng.integers(1, left + 1))
            op.append(k)
            pos += k
        elif r < 0.55 and left:
            k = int(rng.integers(1, min(left, 5) + 1))
            op.append({"d": k})
            pos += k
        elif r < 0.85:
            op.append(rand_text(rng, int(rng.integers(1, 5)), UNICODE))
        else:
            break
    return op


@pytest.mark.parametrize("seed", range(8))
def test_ot_on_generated_ops_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(20):
        doc = rand_text(rng, int(rng.integers(0, 30)), UNICODE)
        raw_a = _rand_traversal(rng, len(doc))
        raw_b = _rand_traversal(rng, len(doc))
        # compose and transform take normalized ops (adjacent components
        # of one kind merged, no trailing retain)
        a, b = tot.normalize(raw_a), tot.normalize(raw_b)
        assert (a, b) == (jot.normalize(raw_a), jot.normalize(raw_b))
        assert tot.apply(doc, raw_a) == tot.apply(doc, a)
        da, db = tot.apply(doc, a), tot.apply(doc, b)
        assert (da, db) == (jot.apply(doc, a), jot.apply(doc, b))
        # compose: b' applies after a
        c = tot.normalize(_rand_traversal(rng, len(da)))
        ac = tot.compose(a, c)
        assert ac == jot.compose(a, c)
        assert tot.apply(doc, ac) == tot.apply(da, c)
        # transform: both orders converge (TP1)
        for side in ("left", "right"):
            assert tot.transform(a, b, side) == jot.transform(a, b, side)
        b2 = tot.transform(b, a, "right")
        a2 = tot.transform(a, b, "left")
        assert tot.apply(da, b2) == tot.apply(db, a2)


@pytest.mark.parametrize("seed", range(3))
def test_xf_stream_to_traversal_matches_jax(seed):
    jol, tol = _pair_twin(seed)
    jt = jot.xf_stream_to_traversal(jol.iter_xf_operations())
    tt = tot.xf_stream_to_traversal(tol.iter_xf_operations())
    assert tt == jt
    assert tot.apply("", tt) == tol.checkout_tip().snapshot()
    frm = _mid_version(tol)
    jt = jot.xf_stream_to_traversal(jol.iter_xf_operations_from(frm,
                                                                jol.version))
    tt = tot.xf_stream_to_traversal(tol.iter_xf_operations_from(frm,
                                                                tol.version))
    assert tt == jt
    assert tot.apply(tol.checkout(frm).snapshot(), tt) \
        == tol.checkout_tip().snapshot()


# ---- subgraph projection and the stochastic summary ---------------------------

def _graph_pair(seed: int):
    """The same random graph in both packages (one random.Random stream
    each)."""
    from diamond_types_tpu.causalgraph.graph import Graph as JGraph

    from diamond_types_tpu_torch.causalgraph.graph import Graph as TGraph
    jg, n = random_graph(random.Random(seed))
    tg = TGraph()
    for i in range(len(jg)):
        tg.push(list(jg.parents[i]), jg.starts[i], jg.ends[i])
    assert isinstance(jg, JGraph)
    return jg, tg, n


@pytest.mark.parametrize("seed", range(10))
def test_subgraph_projection_matches_jax(seed):
    jg, tg, n = _graph_pair(seed)
    rng = random.Random(500 + seed)
    for _ in range(5):
        spans, pos = [], 0
        while pos < n:
            a = pos + rng.randint(0, 3)
            if a >= n:
                break
            b = min(n, a + rng.randint(1, 4))
            spans.append((a, b))
            pos = b + rng.randint(0, 2)
        frontier = jg.find_dominators(
            sorted(rng.sample(range(n), rng.randint(1, min(3, n)))))
        assert tsub.project_onto_subgraph(tg, spans, frontier) \
            == jsub.project_onto_subgraph(jg, spans, frontier)
        tsg, tproj = tsub.subgraph(tg, spans, frontier)
        jsg, jproj = jsub.subgraph(jg, spans, frontier)
        assert tproj == jproj
        assert [a.tolist() for a in tsg.as_arrays()] \
            == [a.tolist() for a in jsg.as_arrays()]


@pytest.mark.parametrize("seed", range(4))
def test_stochastic_summary_matches_jax(seed):
    # two replicas that share a prefix and then diverge
    j_local, t_local = _pair_twin(seed, rounds=2)
    j_remote, t_remote = _pair_twin(seed, rounds=4)
    for k in (4, 16):
        js = jstoch.sample_versions(j_remote.cg, k, random.Random(seed))
        ts = tstoch.sample_versions(t_remote.cg, k, random.Random(seed))
        assert ts == js
        assert tstoch.common_versions_from_sample(t_local.cg, ts) \
            == jstoch.common_versions_from_sample(j_local.cg, js)
    for rounds in (1, 3):
        got = tstoch.estimate_common_frontier(t_local.cg, t_remote.cg,
                                              rounds=rounds, seed=seed)
        assert got == jstoch.estimate_common_frontier(
            j_local.cg, j_remote.cg, rounds=rounds, seed=seed)


# ---- the plan engine ------------------------------------------------------------

def _rows(xs):
    return [(lv, op.kind, op.start, op.end, op.fwd, pos)
            for (lv, op, pos) in xs]


@pytest.mark.parametrize("seed", range(6))
def test_plan_matches_jax_plan_and_the_tracker(seed):
    jol, tol = _pair_random(seed, steps=45)
    for frm in ([], _mid_version(jol)):
        jrows, jfinal = jplan.merge_via_plan(jol, frm, jol.version)
        trows, tfinal = tplan.merge_via_plan(tol, frm, tol.version)
        assert _rows(trows) == _rows(jrows)
        assert tfinal == jfinal
        xf = tol.get_xf_operations_full(frm, tol.version)
        assert _rows(trows) == _rows(xf)
        assert tfinal == xf.next_frontier
    jp = jplan.compile_plan(jol.cg.graph, [], jol.version)
    tp = tplan.compile_plan(tol.cg.graph, [], tol.version)
    assert tp.num_ops() == jp.num_ops() == len(tol)
    assert tp.ff_spans == jp.ff_spans
    assert [(s.retreat, s.advance, s.consume, s.emit) for s in tp.steps] \
        == [(s.retreat, s.advance, s.consume, s.emit) for s in jp.steps]


# ---- the checkers ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_checkers_match_jax(seed):
    jol, tol = _pair_twin(seed)
    for deep in (False, True):
        jchk.check_oplog(jol, deep)
        tchk.check_oplog(tol, deep)
        tchk.check_cg(tol.cg, deep)
        tchk.check_graph(tol.cg.graph, deep)
    # a corrupted op table fails the same assertion in both
    for ol, chk in ((jol, jchk), (tol, tchk)):
        ol.ops.runs[0].lv += 1
    msgs = []
    for ol, chk in ((jol, jchk), (tol, tchk)):
        with pytest.raises(AssertionError) as ei:
            chk.check_oplog(ol)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# ---- oplog statistics -------------------------------------------------------------

@pytest.mark.parametrize("seed", (1, 2))
def test_oplog_stats_match_jax(seed):
    # the twin histories: one sequence of calls into both packages, so the
    # run-length encodings (which `oplog_from_columns` does not rebuild
    # run for run) are the same too
    jol, tol = _pair_twin(seed)
    for enc in (False, True):
        assert tstats.oplog_stats(tol, include_encoded_sizes=enc) \
            == jstats.oplog_stats(jol, include_encoded_sizes=enc)
    outs = []
    for mod, ol in ((jstats, jol), (tstats, tol)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.print_stats(ol)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "num_ops" in outs[1]
    result, peak = tstats.peak_memory_probe(lambda: tpkg.save(tol))
    assert result == jpkg.save(jol) and peak > 0
