"""The port's sharded merge step (`parallel/mesh.py`: `pad_edges`,
`sharded_replay`, `sharded_reach_fixed_point`, `multichip_merge_step`) and
the log-prefix-frontier check (`gpu/xform.validate_prefix_frontier`,
`DT_XFORM_VALIDATE`) against the JAX package's.

The JAX side runs on a one-device CPU mesh (`make_mesh(1)`), as on one
H100; the port on `[cpu]`, where K1 runs its plain version, and on a mesh
that names the CPU three times, so the split into device slices and the
maximum over the slices' contributions run too. Inputs are
`__graft_entry__._example_batch` and fan-in graphs; every comparison is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch
from diamond_types_tpu.causalgraph.graph import Graph as JaxGraph
from diamond_types_tpu.parallel import mesh as jmesh
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import graph_kernels as jgk
from diamond_types_tpu.tpu import xform as jxf
from diamond_types_tpu_torch import Graph, OpLog
from diamond_types_tpu_torch.gpu import graph_kernels as tgk
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu import xform as txf
from diamond_types_tpu_torch.parallel import mesh as tmesh
from diamond_types_tpu_torch.serve import MergeScheduler

from torch_parity import TwinDocs, serve_docs, serve_round

CPU = torch.device("cpu")
MESHES = {"one": [CPU], "three_slices": [CPU, CPU, CPU]}


def fanin(n_roots, run_len=8, chain=0):
    """Both packages' Graph: `n_roots` root runs, one run naming every
    root's tip, then `chain` runs, each forking from the LV before its
    predecessor's last. Returns (jax graph, port graph, tip LV)."""
    jg, tg = JaxGraph(), Graph()
    runs = [((), i * run_len, (i + 1) * run_len) for i in range(n_roots)]
    lv = n_roots * run_len
    runs.append(([(i + 1) * run_len - 1 for i in range(n_roots)], lv,
                 lv + run_len))
    for _ in range(chain):
        runs.append(([lv + run_len - 2], lv + run_len, lv + 2 * run_len))
        lv += run_len
    for g in (jg, tg):
        for parents, s, e in runs:
            g.push(list(parents), s, e)
    return jg, tg, lv + run_len - 1


@pytest.mark.parametrize("n_devices", [1, 3, 8])
@pytest.mark.parametrize("shape", [(16, 0), (5, 3), (1, 0)])
def test_pad_edges_matches_jax(n_devices, shape):
    jg, tg, _tip = fanin(shape[0], chain=shape[1])
    want = jmesh.pad_edges(jgk.pack_graph(jg), n_devices)
    got = tmesh.pad_edges(tgk.pack_graph(tg, "cpu"), n_devices)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        assert np.array_equal(g, w)
    assert len(got[0]) % n_devices == 0 and len(got[0]) >= n_devices


def _reach_inputs(jg, tg, tip, n_devices):
    jp, tp = jgk.pack_graph(jg), tgk.pack_graph(tg, "cpu")
    n = tp["n"]
    reach0 = np.full((n,), -1, dtype=np.int32)
    reach0[n - 1] = tip
    return jp, tp, reach0, tmesh.pad_edges(tp, n_devices)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("k", [1, 16])
def test_sharded_reach_matches_jax_and_covers_the_roots(mesh, k,
                                                        monkeypatch):
    n_roots = 64
    jg, tg, tip = fanin(n_roots, chain=5)
    devs = MESHES[mesh]
    jp, tp, reach0, (src, plv, prun) = _reach_inputs(jg, tg, tip, len(devs))
    jsrc, jplv, jprun = jmesh.pad_edges(jp, 1)
    want = np.asarray(jmesh.sharded_reach_fixed_point(
        jmesh.make_mesh(1), jp["starts"], jnp.asarray(jsrc),
        jnp.asarray(jplv), jnp.asarray(jprun), jnp.asarray(reach0)))
    stats = {}
    monkeypatch.setattr(tgk, "CHECK_EVERY", k)
    got = tmesh.sharded_reach_fixed_point(devs, tp["starts"], src, plv,
                                          prun, reach0, stats=stats)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy()[:n_roots] == np.arange(1, n_roots + 1) * 8 - 1).all()
    # on one device it is X6 itself
    x6 = tgk.reach_fixed_point(tp, torch.from_numpy(reach0))
    assert torch.equal(got, x6)
    assert stats["rounds"] >= 7 and stats["syncs"] * k == stats["rounds"]


def test_sharded_reach_refuses_unpadded_edges():
    jg, tg, tip = fanin(5)
    _jp, tp, reach0, (src, plv, prun) = _reach_inputs(jg, tg, tip, 1)
    assert len(src) % 2 == 1
    with pytest.raises(ValueError, match="pad_edges"):
        tmesh.sharded_reach_fixed_point([CPU, CPU], tp["starts"], src, plv,
                                        prun, reach0)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("b,n_ops,mi,cap", [(8, 12, 4, 256),
                                            (5, 20, 8, 512)])
def test_multichip_merge_step_matches_jax(mesh, b, n_ops, mi, cap):
    devs = MESHES[mesh]
    pos, dlen, ilen, chars = _example_batch(b, n_ops, mi)
    jg, tg, tip = fanin(2 * b, chain=3)
    jp, tp, reach0, (src, plv, prun) = _reach_inputs(jg, tg, tip, len(devs))
    jsrc, jplv, jprun = jmesh.pad_edges(jp, 1)
    jd, jl, jr = jmesh.multichip_merge_step(
        jmesh.make_mesh(1), pos, dlen, ilen, chars, cap, jp["starts"],
        jnp.asarray(jsrc), jnp.asarray(jplv), jnp.asarray(jprun),
        jnp.asarray(reach0))
    kernels.apply_ops_window.launches = 0
    td, tl, tr = tmesh.multichip_merge_step(devs, pos, dlen, ilen, chars,
                                            cap, tp["starts"], src, plv,
                                            prun, reach0)
    assert kernels.apply_ops_window.launches == 0     # CPU: plain version
    assert td.shape == (b, cap) and tl.shape == (b,)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy()[:2 * b] == np.arange(1, 2 * b + 1) * 8 - 1).all()


@pytest.mark.parametrize("as_tensors", [False, True])
def test_sharded_replay_poisons_the_batch_as_jax_does(as_tensors):
    """Numpy input and tensor input (padded with torch, where they lie)
    give the JAX package's docs and poisoned lengths."""
    pos, dlen, ilen, chars = _example_batch(4, 6, 4)
    ilen = ilen.copy()
    ilen[2, 3] = 9                           # past max_ins
    jd, jl = jmesh.sharded_replay(jmesh.make_mesh(1), pos, dlen, ilen,
                                  chars, 64)
    args = [pos, dlen, ilen, chars]
    if as_tensors:
        args = [torch.from_numpy(np.asarray(a)) for a in args]
    td, tl = tmesh.sharded_replay([CPU, CPU, CPU], *args, 64)
    assert tl.tolist() == np.asarray(jl).tolist() == [-1] * 4
    assert np.array_equal(td.numpy(), np.asarray(jd))


def test_make_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(1)


# ---- the log-prefix-frontier check -------------------------------------------

def _twin_oplogs(seed):
    tw = TwinDocs([JaxOpLog(), OpLog()], seed)
    tw.type_base("alice", 40)
    tw.fork(["alice", "bob", "carol"])
    for _ in range(3):
        tw.concurrent_round(["alice", "bob", "carol"], 3)
    return tw.oplogs


@pytest.mark.parametrize("seed", range(4))
def test_validate_prefix_frontier_matches_jax(seed):
    jol, tol = _twin_oplogs(seed)
    rng = np.random.default_rng(seed)
    cuts = sorted({0, len(tol), *rng.integers(1, len(tol), 4).tolist()})
    for cut in cuts:
        # the oplog version at log length `cut`: a true prefix frontier
        fr = list(tol.cg.graph.find_dominators(list(range(cut))))
        assert fr == list(jol.cg.graph.find_dominators(list(range(cut))))
        for synced in {cut, max(cut - 1, 0), cut + 1}:
            want = jxf.validate_prefix_frontier(jol, fr, synced)
            got = txf.validate_prefix_frontier(tol, fr, synced, device="cpu")
            assert got == want
            if synced <= len(tol):     # past the log every LV is below it
                assert got == (synced == cut)
    # a sample of targets, and a forged threshold
    n = len(tol)
    targets = np.arange(0, n, 3, dtype=np.int32)
    fr = list(tol.version)
    assert txf.validate_prefix_frontier(tol, fr, n, targets, device="cpu")
    assert not txf.validate_prefix_frontier(tol, fr, n - 5, device="cpu")
    assert txf.validate_prefix_frontier(OpLog(), [], 0, device="cpu")
    assert not txf.validate_prefix_frontier(OpLog(), [], 1, device="cpu")


def test_scheduler_round_under_validate(monkeypatch):
    """DT_XFORM_VALIDATE=1: every device-planned tail is proved on the
    session's device and the rounds stay exact; a failed proof raises out
    of the flush instead of planning."""
    monkeypatch.setenv("DT_XFORM_VALIDATE", "1")
    docs = serve_docs([OpLog], 6, 5, base_min=10, base_max=80)
    ols = {d: tw.oplogs[0] for d, tw in docs.items()}
    calls = []
    real = txf.validate_prefix_frontier

    def spy(*args, **kw):
        calls.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(txf, "validate_prefix_frontier", spy)
    ts = MergeScheduler(2, resolve=ols.__getitem__,
                        fused_opts={"cap": 256, "max_ins": 4,
                                    "device": "cpu"},
                        engine="device", fused=True, flush_docs=4,
                        flush_deadline_s=10.0, flush_workers=False,
                        device_plan=True)
    for rnd in range(2):
        for d, n in serve_round(docs, 5, rnd):
            assert ts.submit(d, n_ops=n)["accepted"]
        ts.pump()
        ts.drain()
        for d in docs:
            assert ts.text(d) == ols[d].checkout_tip().snapshot()
    assert calls, "no tail was device-planned"

    monkeypatch.setattr(txf, "validate_prefix_frontier",
                        lambda *a, **k: False)
    for d, n in serve_round(docs, 5, 2, share=1.0):
        ts.submit(d, n_ops=n)
    with pytest.raises(AssertionError, match="log-prefix-frontier"):
        ts.pump()
        ts.drain()
