"""The device plan's one-buffer resolve, on the CPU.

`csrc/linearize.cu` runs only on a card (tests/test_torch_cuda.py holds it
against its plain version there, through `kernels.resolve_rows` on a
buffer). Here that plain version, the CPU path of `resolve_rows`
(`fugue_linearize`, two gathers, K2's plain version), is held against the
host's own Fugue-tree walk (`linearize._doc_order_np`) and position sums
over the grid the card tests run; so are the width rule that sizes the
kernel's scratch, the one-buffer packing that both devices share, and the
transform counters that say which path ran. Every output is integer: the
tolerance is 0.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from diamond_types_tpu_torch.gpu import flush_fuse as ff
from diamond_types_tpu_torch.gpu import kernels, xform
from diamond_types_tpu_torch.gpu.linearize import _doc_order_np
from diamond_types_tpu_torch.serve import bank
from diamond_types_tpu_torch.serve.metrics import ServeMetrics

from torch_parity import (LINEARIZE_KINDS, concurrent_tails, flat_extract,
                          linearize_cols)

SHAPES = [(b, n) for b in (1, 3, 8) for n in (1, 2, 255, 256, 1024, 4096)]


def _host_resolve(cols: np.ndarray):
    """(perm, pos, new_len, peak) of [7, b, n] columns, row by row: the
    host's DFS order, then the doc-order position sums in numpy."""
    _, b, n = cols.shape
    perm = np.stack([_doc_order_np(*cols[:5, r]) for r in range(b)])
    nv = np.take_along_axis(cols[5], perm, 1).astype(np.int64)
    ov = np.take_along_axis(cols[6], perm, 1).astype(np.int64)
    cum = np.cumsum(nv, 1)
    peak = np.maximum(np.cumsum(nv - ov, 1).max(1), 0)
    return perm, cum - nv, cum[:, -1], peak


def _buffer(cols: np.ndarray, fill: int = -7) -> torch.Tensor:
    _, b, n = cols.shape
    buf = torch.full((kernels.resolve_words(b, n),), fill,
                     dtype=torch.int32)
    buf[:cols.size].copy_(torch.from_numpy(cols.ravel()))
    return buf


@pytest.mark.parametrize("kind", LINEARIZE_KINDS)
@pytest.mark.parametrize("b,n", SHAPES)
def test_plain_resolve_matches_the_host_walk(kind, b, n):
    """The plain chain the card's kernel is held against orders every row
    as the host's DFS of the Fugue tree does (heterogeneous right-origin
    keys, ties broken by index, underwater spines, all-padding rows), and
    its positions, new lengths and peaks are the doc-order sums."""
    cols = linearize_cols(kind, b, n)
    buf = _buffer(cols)
    assert kernels.resolve_rows(buf, b, n) == "plain"
    for g, w in zip(kernels.resolve_results(buf, b, n),
                    _host_resolve(cols)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_width_rule():
    """Rows up to LINEARIZE_MAX_N take no scratch (one block's shared
    memory); a wider row takes its keys, sort slots and two copies of its
    tour's cells, which grow the resolve buffer past its outputs."""
    assert [kernels.linearize_scratch_words(n)
            for n in (1, 256, 4096)] == [0, 0, 0]
    assert kernels.linearize_scratch_words(4097) == \
        4 * 4097 + 8192 + 12 * 4098
    assert kernels.linearize_scratch_words(8192) == \
        4 * 8192 + 8192 + 12 * 8193
    for b, n in ((1, 4096), (3, 4097), (8, 8192)):
        assert kernels.resolve_words(b, n) == \
            11 * b * n + 2 * b + b * kernels.linearize_scratch_words(n)


def test_resolve_rows_on_the_cpu_launches_nothing():
    cols = linearize_cols("mixed", 3, 255)
    launches = (kernels.resolve_rows.launches,
                kernels.xform_positions.launches)
    assert kernels.resolve_rows(_buffer(cols), 3, 255) == "plain"
    assert (kernels.resolve_rows.launches,
            kernels.xform_positions.launches) == launches
    meta = torch.empty(kernels.resolve_words(3, 255), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.resolve_rows(meta, 3, 255)


@pytest.mark.parametrize("b,n", [(1, 2), (3, 255), (8, 256), (2, 4097)])
def test_resolve_rows_fills_its_buffer(b, n):
    """The plain path of `resolve_rows` writes the linearizer's and K2's
    outputs where `resolve_results` reads them, and leaves the columns and
    the kernel's scratch (rows wider than LINEARIZE_MAX_N)."""
    cols = linearize_cols("underwater", b, n)
    buf = _buffer(cols)
    kernels.resolve_rows(buf, b, n)
    perm, nv_doc, ov_doc = kernels.linearize_rows_plain(
        torch.from_numpy(cols))
    want = (perm, *kernels.xform_positions_plain(nv_doc, ov_doc))
    for g, w in zip(kernels.resolve_results(buf, b, n), want):
        assert torch.equal(g, w)
    bn = b * n
    assert torch.equal(buf[:cols.size], torch.from_numpy(cols.ravel()))
    assert torch.equal(buf[8 * bn:10 * bn].view(2, b, n),
                       torch.stack([nv_doc, ov_doc]))
    assert not (buf[:11 * bn + 2 * b] == -7).any()
    assert (buf[11 * bn + 2 * b:] == -7).all()
    assert buf[11 * bn + 2 * b:].numel() == \
        b * kernels.linearize_scratch_words(n)


def test_pack_columns_pads_by_the_contract():
    sess, = concurrent_tails(["cpu"], n_docs=2, rounds=1)
    exs = [xform.extract_tail(s) for s in sess]
    assert all(isinstance(e, xform.TailExtract) for e in exs)
    bp, n = xform.xform_shape_class(exs + exs[:1])
    buf = np.full(kernels.resolve_words(bp, n), -7, np.int32)
    xform.pack_columns(exs, buf, bp, n)
    cols = buf[:7 * bp * n].reshape(7, bp, n)
    for i, ex in enumerate(exs):
        k = ex.n
        want = (np.where(ex.parent == k, n, ex.parent), ex.side, ex.key_pos,
                ex.key_agent, ex.key_seq, ex.new_vis, ex.old_vis)
        for c, w in enumerate(want):
            np.testing.assert_array_equal(cols[c, i, :k], w)
        assert (cols[:, i, k:].T == [n, 1] + [2**31 - 1] * 3
                + [0, 0]).all()
    assert (cols[:, len(exs):].reshape(7, -1).T
            == [n, 1] + [2**31 - 1] * 3 + [0, 0]).all()
    assert (buf[7 * bp * n:] == -7).all()


def test_one_buffer_resolve_reaches_plan_tails_text():
    """resolve_positions on the CPU (the shared packing, then the plain
    chain on the buffer) gives every concurrent-mix tail a plan with
    plan_tail()'s new length that, replayed, reaches the host tracker's
    text. (The device plan edits in document order, the host's in causal
    order, so the rows themselves differ.)"""
    sess, = concurrent_tails(["cpu"])
    exs = [xform.extract_tail(s) for s in sess]
    assert all(isinstance(e, xform.TailExtract) for e in exs)
    assert max(e.n for e in exs) > 128
    plans, path = xform.resolve_positions(exs, device="cpu")
    assert path == "plain"
    for s, p in zip(sess, plans):
        want = s.plan_tail()
        assert (p.frontier, p.synced_to, p.new_len) == \
            (want.frontier, want.synced_to, want.new_len)
        if not p.fits(s.cap):
            s.resync_for(p)
        else:
            assert ff.kernel_fused_replay([s], [p])[0] == [True]
        assert s.text() == s.oplog.checkout_tip().snapshot()


def test_resolve_windows_counts_resolves_by_linearizer():
    """On the CPU every resolve runs the plain chain: `linearized_plain`
    counts each call beside `batches`, `linearized_kernel` stays 0."""
    m = ServeMetrics(2, 8, 64)
    banks = [SimpleNamespace(device_plan=True, device=torch.device("cpu"),
                             shard_id=i, metrics=m) for i in range(2)]
    wins = [{"bank": bk, "clock": None,
             "planned": [[None, None, flat_extract(k)]]}
            for bk, k in zip(banks, (5, 300))]
    assert bank.resolve_windows(wins) == 1
    assert all(w["planned"][0][2].n_ops == 0 for w in wins)
    t = m.snapshot()["transform"]
    assert (t["batches"], t["linearized_plain"], t["linearized_kernel"]) \
        == (1, 1, 0)
    assert t["device_docs"] == 2 and m.snapshot()["version"] == 8
