"""The port's causal-graph kernels (`gpu/graph_kernels.py`, X6) against the
JAX package's (`tpu/graph_kernels.py`) and the host `Graph` queries.

The same DAGs (`tests/test_subgraph.py::random_graph`, a small fan-in and
the empty graph) are pushed into both packages' `Graph`s; the port runs on
the CPU (`device="cpu"`), the JAX kernels as the JAX package's own tests
run them. Every output is an integer or a boolean: all comparisons are
exact. Frontiers carry -1 padding, targets include -1 (ROOT), and the
fixed point's flag is read every round (k = 1) and every 16 rounds.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_types_tpu.causalgraph.graph import Graph as JaxGraph
from diamond_types_tpu.tpu import graph_kernels as jgk
from diamond_types_tpu_torch import Graph
from diamond_types_tpu_torch.gpu import graph_kernels as tgk

from test_subgraph import random_graph

KS = (1, 16)


def twin(runs):
    """The same runs ((parents, start, end), ...) in both packages."""
    jg, tg = JaxGraph(), Graph()
    for parents, s, e in runs:
        jg.push(list(parents), s, e)
        tg.push(list(parents), s, e)
    return jg, tg


def random_twin(seed, n_runs=30, max_run=5):
    g, n = random_graph(random.Random(seed), n_runs=n_runs, max_run=max_run)
    return (*twin(zip(g.parents, g.starts, g.ends)), n)


def fanin_twin(n_roots=16, run_len=4, chain=6):
    """`n_roots` concurrent root runs, one run naming every root's tip,
    then a chain of runs, each forking from the LV before its
    predecessor's last (so each is a run of its own)."""
    runs = [((), i * run_len, (i + 1) * run_len) for i in range(n_roots)]
    lv = n_roots * run_len
    runs.append((tuple((i + 1) * run_len - 1 for i in range(n_roots)), lv,
                 lv + run_len))
    for _ in range(chain):
        runs.append(((lv + run_len - 2,), lv + run_len, lv + 2 * run_len))
        lv += run_len
    return (*twin(runs), lv + run_len)


def cases():
    out = [("random", s) for s in range(8)] + [("fanin", 0)]
    return out


def build(kind, seed):
    return random_twin(seed) if kind == "random" else fanin_twin()


def frontiers_targets(seed, n, q=24, k=3):
    rng = np.random.default_rng(seed)
    fr = np.full((q, k), -1, np.int32)
    for i in range(q):
        w = int(rng.integers(0, k + 1))
        fr[i, :w] = rng.integers(0, n, w)
    return fr, rng.integers(-1, n, q).astype(np.int32)


@pytest.mark.parametrize("kind,seed", cases())
def test_pack_graph_matches_jax(kind, seed):
    jg, tg, _n = build(kind, seed)
    jp, tp = jgk.pack_graph(jg), tgk.pack_graph(tg, "cpu")
    assert (jp["n"], jp["m"]) == (tp["n"], tp["m"])
    for key in ("starts", "ends", "edge_src", "edge_plv", "edge_prun"):
        assert tp[key].dtype == torch.int32
        assert np.array_equal(np.asarray(jp[key]), tp[key].numpy()), key


@pytest.mark.parametrize("kind,seed", cases())
def test_reach_and_contains_match_jax_and_host(kind, seed, monkeypatch):
    jg, tg, n = build(kind, seed)
    jp, tp = jgk.pack_graph(jg), tgk.pack_graph(tg, "cpu")
    fr, targets = frontiers_targets(seed, n, q=12)
    # one compile per graph for the JAX side
    jseed = jax.jit(lambda f: jgk.seed_from_frontier(jp, f))
    jreach_fn = jax.jit(lambda f: jgk.reach_fixed_point(
        jp, jgk.seed_from_frontier(jp, f)))
    jcontains = jax.jit(lambda f, t: jgk.frontier_contains_lv(jp, f, t))
    for f in fr:
        jreach = np.asarray(jreach_fn(jnp.asarray(f)))
        seed0 = tgk.seed_from_frontier(tp, torch.from_numpy(f))
        assert np.array_equal(np.asarray(jseed(jnp.asarray(f))),
                              seed0.numpy())
        for k in KS:
            monkeypatch.setattr(tgk, "CHECK_EVERY", k)
            reach = tgk.reach_fixed_point(tp, seed0)
            assert reach.dtype == torch.int32
            assert np.array_equal(jreach, reach.numpy())
        jgot = np.asarray(jcontains(jnp.asarray(f), jnp.asarray(targets)))
        got = tgk.frontier_contains_lv(tp, torch.from_numpy(f),
                                       torch.from_numpy(targets)).numpy()
        assert np.array_equal(jgot, got)
        live = [int(x) for x in f if x >= 0]
        assert list(got) == [tg.frontier_contains_version(live, int(t))
                             for t in targets]


@pytest.mark.parametrize("kind,seed", cases())
def test_batched_contains_matches_jax_and_host(kind, seed, monkeypatch):
    jg, tg, n = build(kind, seed)
    fr, targets = frontiers_targets(seed + 100, n, q=64)
    want = np.asarray(jgk.make_contains_fn(jg)(jnp.asarray(fr),
                                               jnp.asarray(targets)))
    for k in KS:
        monkeypatch.setattr(tgk, "CHECK_EVERY", k)
        fn = tgk.make_contains_fn(tg, "cpu")
        got = fn(fr, targets)
        assert got.dtype == torch.bool
        assert np.array_equal(want, got.numpy())
        assert fn.stats["syncs"] >= 1 and fn.stats["rounds"] >= k
    host = [tg.frontier_contains_version([int(x) for x in f if x >= 0],
                                         int(t))
            for f, t in zip(fr, targets)]
    assert list(want) == host


@pytest.mark.parametrize("kind,seed", cases())
def test_diff_matches_jax_and_host(kind, seed, monkeypatch):
    jg, tg, n = build(kind, seed)
    rng = np.random.default_rng(seed + 7)
    jfn = jgk.make_diff_fn(jg)
    for _ in range(6):
        a = [int(x) for x in rng.integers(0, n, int(rng.integers(0, 3)))]
        b = [int(x) for x in rng.integers(0, n, int(rng.integers(1, 3)))]
        a_p = np.array(a + [-1] * (3 - len(a)), np.int32)
        b_p = np.array(b + [-1] * (3 - len(b)), np.int32)
        ja, jb = jfn(jnp.asarray(a_p), jnp.asarray(b_p))
        for k in KS:
            monkeypatch.setattr(tgk, "CHECK_EVERY", k)
            ra, rb = tgk.make_diff_fn(tg, "cpu")(a_p, b_p)
            assert np.array_equal(np.asarray(ja), ra.numpy())
            assert np.array_equal(np.asarray(jb), rb.numpy())
        only_a, only_b = tgk.diff_to_spans(tg, ra, rb)
        want_a, want_b = tg.diff(tg.find_dominators(a), tg.find_dominators(b))
        assert (only_a, only_b) == (list(want_a), list(want_b))
        assert tgk.reach_to_spans(tg, ra) == jgk.reach_to_spans(
            jg, np.asarray(ja))


def test_empty_graph():
    jg, tg = twin([])
    tp = tgk.pack_graph(tg, "cpu")
    assert tp["n"] == tp["m"] == 0
    none = np.array([-1], np.int32)
    ja, jb = jgk.make_diff_fn(jg)(jnp.asarray(none), jnp.asarray(none))
    ra, rb = tgk.make_diff_fn(tg, "cpu")(none, none)
    assert ra.shape == rb.shape == np.asarray(ja).shape == (0,)
    assert tgk.diff_to_spans(tg, ra, rb) == ([], [])
    # ROOT is in every frontier; no LV is in an empty graph (the host's
    # answer; the JAX kernel's gather has no row to read there)
    got = tgk.make_contains_fn(tg, "cpu")(np.array([[-1], [-1]], np.int32),
                                          np.array([-1, 0], np.int32))
    assert got.tolist() == [True, False]
    assert [tg.frontier_contains_version([], t) for t in (-1, 0)] == \
        [True, False]


def test_fixed_point_rounds_do_not_depend_on_check_every(monkeypatch):
    """A chain needs one round per run; reading the flag every 16 rounds
    runs at most 15 more and syncs about 16 times less."""
    jg, tg, n = fanin_twin(n_roots=4, chain=40)
    tp = tgk.pack_graph(tg, "cpu")
    seed0 = tgk.seed_from_frontier(tp, torch.tensor([n - 1],
                                                    dtype=torch.int32))
    s1, s16 = {}, {}
    monkeypatch.setattr(tgk, "CHECK_EVERY", 1)
    r1 = tgk.reach_fixed_point(tp, seed0, stats=s1)
    monkeypatch.setattr(tgk, "CHECK_EVERY", 16)
    r16 = tgk.reach_fixed_point(tp, seed0, stats=s16)
    assert torch.equal(r1, r16)
    assert s1["rounds"] == s1["syncs"] >= 41
    assert s1["rounds"] <= s16["rounds"] < s1["rounds"] + 16
    assert s16["syncs"] == s16["rounds"] // 16
    monkeypatch.setattr(tgk, "CHECK_EVERY", 0)
    with pytest.raises(ValueError):
        tgk.reach_fixed_point(tp, seed0)


def test_pack_graph_refuses_int32_overflow():
    g = Graph()
    g.push([], 2**31 - 4, 2**31)
    with pytest.raises(ValueError):
        tgk.pack_graph(g, "cpu")
