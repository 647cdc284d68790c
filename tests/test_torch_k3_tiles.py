"""K3's design, a row scan and a tiled output gather, modelled in numpy.

`csrc/materialize.cu` assembles a batch of document texts in two kernels.
The row scan gives each row one CTA: each thread owns 4 consecutive runs
of a step, gathers their lengths and arena bases through perm, and a
shuffle scan in each warp plus one across the warps' sums place them, the
carry passing from step to step. It writes a scratch row of (start, base)
pairs (starts[n] = total), for each segment of a warp's outputs the run
that holds the segment's first output (seg_first), and last the run that
holds the row's last output. The gather gives each CTA a tile of outputs
of one row, each warp a segment and each thread 4 consecutive outputs; a
segment's outputs lie in the runs from its seg_first to the next one's.
Where those are few, each live run among them marks its first output in
the segment and a running max of the marks gives every output its run;
else each thread finds the run of its first output by an upper-bound
binary search of the starts (the last run whose start is <= j, so a
zero-length run that shares a live run's start is never chosen) and
searches again from the current run where a later output crosses a run
end.

This file models both passes step by step, with a small gather (warps of
2 threads: segments of 8 outputs, tiles of 16, at most 4 runs marked,
where the kernel has 128, 512 and 256) so that segment and tile edges and
both of the gather's paths are cheap to reach, and holds the model exactly
against K3's plain version (`linearize.materialize`), the JAX package's
`materialize_jax` (vmapped) and, on small in-contract tables, its Pallas
kernel `materialize_pallas` interpreted, on seeded tables that cover every
hazard of the design. Two mutations must fail: a lower-bound search, and
marks that let a zero-length run win; both can choose a zero-length run.
The model is test code only; the card runs the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_types_tpu.tpu.linearize import materialize_jax
from diamond_types_tpu.tpu.pallas_kernels import materialize_pallas
from diamond_types_tpu_torch.gpu.linearize import materialize

LANES, PER = 32, 4            # lanes per warp; runs (scan), outputs (gather)
SCAN_THREADS = 512            # the scan's CTA, as in the kernel
STEP = SCAN_THREADS * PER     # runs per scan step
GATHER_LANES = 2              # a gather warp in the model (the kernel's: 32)
SEG = GATHER_LANES * PER      # outputs per segment (the kernel's: 128)
TILE = 2 * SEG                # outputs per gather CTA (the kernel's: 512)
MARK_RUNS = 4                 # runs a segment may mark (the kernel's: 256)
UNWRITTEN = 0x5EED            # what seg_first holds where no run wrote
M32 = 0xFFFFFFFF

_jax_materialize = jax.jit(jax.vmap(materialize_jax, in_axes=(0, 0, 0, 0,
                                                              None)),
                           static_argnums=4)


def _i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >= 1 << 31 else x


def _warp_incl_scan(x):
    """The shuffle-up scan over the last axis (32 lanes), step by step, in
    uint32."""
    lane = np.arange(LANES)
    x = x.astype(np.uint32)
    for o in (1, 2, 4, 8, 16):
        up = np.roll(x, o, axis=-1)
        x = np.where(lane >= o, x + up, x).astype(np.uint32)
    return x


def scan_row(perm, vis, off, cap, seg=SEG):
    """Pass 1 for one row, as its CTA writes it: (starts [n + 1] int32,
    bases [n] int32, seg_first [ceil(cap / seg) + 1]); starts[n] is the
    total, seg_first's last entry the last live run that starts before cap
    (the run of the row's last output), -1 if none."""
    n = perm.shape[0]
    segs = -(-cap // seg)
    starts = np.zeros(n + 1, np.uint32)
    bases = np.zeros(n, np.int32)
    seg_first = np.full(segs + 1, UNWRITTEN, np.int64)
    last_live = -1
    carry = 0
    idx = np.arange(STEP).reshape(SCAN_THREADS, PER)  # thread t: [4t, 4t + 4)
    for c0 in range(0, n, STEP):
        i = c0 + idx
        ok = i < n
        p = np.clip(perm[np.minimum(i, n - 1)], 0, n - 1)
        v = np.where(ok, vis[p], 0).astype(np.uint32)
        a = np.where(ok, off[p], 0)
        own = v.sum(axis=1, dtype=np.uint32)
        inc = _warp_incl_scan(own.reshape(-1, LANES)).reshape(-1)
        warp_sum = np.zeros(LANES, np.uint32)   # lanes past the warps: 0
        warp_sum[:SCAN_THREADS // LANES] = inc[LANES - 1::LANES]
        wi = _warp_incl_scan(warp_sum)
        before = np.repeat((wi - warp_sum)[:SCAN_THREADS // LANES], LANES)
        first = (np.uint32(carry) + before + inc - own).astype(np.uint32)
        within = np.cumsum(v, axis=1, dtype=np.uint32) - v
        st = (first[:, None] + within).astype(np.uint32)
        starts[i[ok]] = st[ok]
        bases[i[ok]] = a[ok]
        for k, s0, ln in zip(i[ok], st[ok].view(np.int32), v[ok]):
            if ln == 0 or not 0 <= s0 < cap:
                continue
            last_live = max(last_live, int(k))
            for g in range(-(-int(s0) // seg),
                           min(-(-(int(s0) + int(ln)) // seg), segs)):
                seg_first[g] = k
        carry = (carry + int(wi[SCAN_THREADS // LANES - 1])) & M32
    starts[n] = carry
    seg_first[segs] = last_live
    return starts.view(np.int32), bases, seg_first


def upper_bound(s, lo, hi, j):
    """The kernel's search: first u in [lo, hi) with s[u] > j, else hi."""
    while lo < hi:
        mid = (lo + hi) >> 1
        if s[mid] <= j:
            lo = mid + 1
        else:
            hi = mid
    return lo


def lower_bound(s, lo, hi, j):
    """A mutation of the search: the first u with s[u] >= j, and the run
    that starts AT j when there is one (returned as u + 1, so the caller's
    `- 1` lands on it). It can choose a zero-length run."""
    hi0 = hi
    while lo < hi:
        mid = (lo + hi) >> 1
        if s[mid] < j:
            lo = mid + 1
        else:
            hi = mid
    return lo + 1 if lo < hi0 and s[lo] == j else lo


def mark_runs(starts, lo, hi, seg0, seg, mark_empty=False):
    """The warp's marks: each live run in (lo, hi] that starts inside the
    segment writes its index at its start; then the running max from lo
    is each output's run. mark_empty (a mutation) marks zero-length runs
    too, the first writer of a slot keeping it."""
    marks = np.full(seg, -1, np.int64)
    for i in range(lo + 1, hi + 1):
        st = int(starts[i])
        live = int(starts[i + 1]) > st
        if (live or mark_empty) and seg0 <= st < seg0 + seg:
            if mark_empty and marks[st - seg0] >= 0:
                continue
            marks[st - seg0] = i
    return np.maximum(np.maximum.accumulate(marks), lo)


def gather_row(starts, bases, seg_first, arena, cap, counts,
               search=upper_bound, mark_empty=False, seg=SEG, tile=TILE):
    """Pass 2 for one row: every tile of `tile` outputs, every warp's
    segment, every thread's 4 outputs. `counts` tallies tiles that stored
    zeros only, segments resolved by marks, and the threads' first-output
    searches and searches after crossing a run end."""
    n = bases.shape[0]
    pool = arena.shape[0]
    segs = seg_first.shape[0] - 1
    total = int(starts[n])
    lim = min(max(total, 0), cap)
    out = np.full(cap, -7, np.int64)              # every slot must be set
    for t0 in range(0, cap, tile):
        if t0 >= lim:
            counts["zero_tiles"] += 1
        for seg0 in range(t0, t0 + tile, seg):
            g = seg0 // seg
            f0 = int(seg_first[min(g, segs - 1)])
            f1 = int(seg_first[min(g + 1, segs)])
            f_last = int(seg_first[segs])
            run = np.zeros(seg, np.int64)
            if seg0 < lim:
                lo = min(max(f0, 0), n - 1)
                hi = min(max(f1 if (g + 1) * seg < lim else f_last, 0),
                         n - 1)
                if hi - lo < MARK_RUNS:
                    counts["mark"] += 1
                    run = mark_runs(starts, lo, hi, seg0, seg, mark_empty)
                else:
                    for t in range(0, seg, PER):      # a thread's outputs
                        cur, end = -1, 0
                        for k in range(PER):
                            j = seg0 + t + k
                            if cur < 0 or j >= end:
                                counts["search" if cur < 0 else "step"] += 1
                                u = search(starts,
                                           lo + 1 if cur < 0 else cur + 1,
                                           hi + 1, j)
                                cur = min(max(u - 1, lo), hi)
                                end = int(starts[cur + 1])
                            run[t + k] = cur
            for p in range(seg):
                j = seg0 + p
                if j >= cap:
                    continue
                val = 0
                if j < lim:
                    r = int(run[p])
                    src = _i32(int(bases[r]) + (j - int(starts[r])))
                    val = int(arena[min(max(src, 0), pool - 1)])
                out[j] = val
    assert (out != -7).all()
    return out.astype(np.int32), total


def _row(buf, r, stride, width):
    """Row r of a buffer read with a row stride, as the kernel's pointer
    `buf + r * stride` does: stride 0 reads the one shared row."""
    flat = buf.reshape(-1)
    return flat[r * stride:r * stride + width]


def tiles_model(perm, vis, off, arena, cap, search=upper_bound,
                mark_empty=False, strides=None):
    """The whole call on a batch: (text [b, cap], total [b], counts).
    `strides` (perm, arena_off, arena) are the row strides the wrapper
    passes: by default each array's own row length; 0 for a shared row
    ([1, n] or [1, pool]) that every row of vis reads."""
    counts = {"zero_tiles": 0, "mark": 0, "search": 0, "step": 0}
    b, n = vis.shape
    pool = arena.shape[1]
    ps, os_, as_ = strides or (n, n, pool)
    rows = []
    for r in range(b):
        starts, bases, seg_first = scan_row(_row(perm, r, ps, n), vis[r],
                                            _row(off, r, os_, n), cap)
        rows.append(gather_row(starts, bases, seg_first,
                               _row(arena, r, as_, pool), cap, counts,
                               search, mark_empty))
    return (np.stack([t for t, _ in rows]),
            np.array([x for _, x in rows], np.int32), counts)


def plain(cols, cap):
    t, n = materialize(*map(torch.from_numpy, cols), cap)
    return t.numpy(), n.numpy()


def _doc_order(rng, b, n, vl_doc, pool, off_doc=None):
    """Run tables whose runs, in perm order, have the lengths vl_doc [b, n]
    and the arena offsets off_doc (default: each run's chars inside the
    pool, as in contract): each row's perm is a random permutation and
    vis/off are scattered through it."""
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    if off_doc is None:
        longest = int(vl_doc.max()) if vl_doc.size else 0
        off_doc = rng.integers(0, max(pool - longest, 1), (b, n))
    vis = np.zeros((b, n), np.int64)
    off = np.zeros((b, n), np.int64)
    for r in range(b):
        vis[r, perm[r]] = vl_doc[r]
        off[r, perm[r]] = off_doc[r]
    arena = rng.integers(1, 0x10FFFF, (b, pool))
    return [np.ascontiguousarray(x, np.int32)
            for x in (perm, vis, off, arena)]


def table(name, seed):
    """The seeded run table of one hazard: (cols, cap)."""
    rng = np.random.default_rng(seed)
    if name == "random_truncated":            # cap < total, runs past cap
        b, n, cap, pool = 3, 300, 256, 900
        vl = rng.integers(0, 6, (b, n)) * (rng.random((b, n)) < 0.7)
    elif name == "zero_fill":                 # cap > total
        b, n, cap, pool = 3, 40, 512, 200
        vl = rng.integers(0, 6, (b, n)) * (rng.random((b, n)) < 0.7)
    elif name == "cap_not_tile_multiple":
        b, n, cap, pool = 2, 900, 4100, 5000
        vl = rng.integers(0, 9, (b, n)) * (rng.random((b, n)) < 0.7)
    elif name == "cap_odd":                   # ragged row end: scalar stores
        b, n, cap, pool = 2, 100, 387, 800
        vl = rng.integers(0, 9, (b, n))
    elif name == "b1_cap_65536":
        b, n, cap, pool = 1, 3000, 65536, 70000
        vl = rng.integers(0, 40, (b, n)) * (rng.random((b, n)) < 0.8)
    elif name == "total_zero":
        b, n, cap, pool = 2, 50, 300, 64
        vl = np.zeros((b, n), np.int64)
    elif name == "one_run_spans_every_tile":
        b, n, cap, pool = 2, 6, 4100, 9000
        vl = np.zeros((b, n), np.int64)
        vl[:, 0] = cap + 100
        vl[1, 0], vl[1, 1] = 0, cap + 3       # behind a zero-length run
    elif name == "zero_length_runs_then_live_run":
        # a live run, then 3 tiles' worth of zero-length runs sharing its
        # end as their start, then live runs: in row 0 the shared start is
        # the next tile's first output (seg_first skips the empty runs), in
        # row 1 it lies inside a thread's 4 outputs (the search after the
        # run end must skip them); then short runs with empty ones between
        b, n, pool = 2, 4 * TILE + 24, 600
        cap = 8 * TILE
        vl = np.zeros((b, n), np.int64)
        vl[:, 0] = TILE
        vl[1, 0] = TILE - 2
        vl[:, 3 * TILE + 1] = 5
        vl[:, 3 * TILE + 2:] = rng.integers(0, 3, (b, n - 3 * TILE - 2))
        vl[1, 3 * TILE + 1] = 2 * TILE
    elif name == "arena_off_past_pool":       # clamped to [0, pool - 1]
        b, n, cap, pool = 3, 64, 512, 100
        vl = rng.integers(0, 12, (b, n))
        off = rng.integers(0, pool, (b, n))
        off[0] = rng.integers(pool, pool + 5000, n)
        off[1, ::2] = -rng.integers(1, 5000, (n + 1) // 2)
        return _doc_order(rng, b, n, vl, pool, off), cap
    elif name == "runs_past_one_step":        # several 1,024-run steps
        b, n, cap, pool = 2, 2500, 8192, 10000
        vl = rng.integers(0, 7, (b, n)) * (rng.random((b, n)) < 0.6)
    elif name == "no_runs":
        b, n, cap, pool = 2, 0, 64, 8
        vl = np.zeros((b, n), np.int64)
    else:
        raise KeyError(name)
    return _doc_order(rng, b, n, vl, pool), cap


HAZARDS = ["random_truncated", "zero_fill", "cap_not_tile_multiple",
           "cap_odd", "b1_cap_65536", "total_zero",
           "one_run_spans_every_tile", "zero_length_runs_then_live_run",
           "arena_off_past_pool", "runs_past_one_step", "no_runs"]


@pytest.mark.parametrize("name", HAZARDS)
def test_tiles_model_matches_plain(name):
    cols, cap = table(name, HAZARDS.index(name) + 1)
    before = [c.copy() for c in cols]
    got_t, got_n, counts = tiles_model(*cols, cap)
    want_t, want_n = plain(cols, cap)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_n, want_n)
    for c, c0 in zip(cols, before):               # inputs never written
        np.testing.assert_array_equal(c, c0)
    b = cols[0].shape[0]
    tiles = -(-cap // TILE)
    if name in ("total_zero", "no_runs"):
        assert counts["zero_tiles"] == b * tiles
        assert counts["mark"] == counts["search"] == 0
    if name == "one_run_spans_every_tile":      # one run per segment
        assert counts["zero_tiles"] == counts["search"] == 0
        assert counts["mark"] == b * -(-cap // SEG)
    if name == "zero_fill":
        assert counts["zero_tiles"] > 0
    if name in ("zero_length_runs_then_live_run", "random_truncated",
                "runs_past_one_step"):           # both of the gather's paths
        assert counts["mark"] > 0 and counts["search"] > 0


@pytest.mark.parametrize("name", [h for h in HAZARDS if h != "no_runs"])
def test_tiles_model_matches_materialize_jax(name):
    cols, cap = table(name, HAZARDS.index(name) + 1)
    want_t, want_n = _jax_materialize(*map(jnp.asarray, cols), cap)
    got_t, got_n, _ = tiles_model(*cols, cap)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_n, np.asarray(want_n))


# small in-contract tables (arena_off inside the pool), interpreted Pallas
PALLAS = ["zero_fill", "cap_odd", "total_zero", "one_run_spans_every_tile",
          "zero_length_runs_then_live_run"]


@pytest.mark.parametrize("name", PALLAS)
def test_tiles_model_matches_pallas_interpreted(name):
    cols, cap = table(name, HAZARDS.index(name) + 1)
    got_t, got_n, _ = tiles_model(*cols, cap)
    for r in range(cols[0].shape[0]):
        want_t, want_n = materialize_pallas(
            *(jnp.asarray(c[r]) for c in cols), cap, interpret=True)
        np.testing.assert_array_equal(got_t[r], np.asarray(want_t))
        assert int(got_n[r]) == int(want_n)


@pytest.mark.parametrize("mutation,name", [
    ("lower_bound_search", "zero_length_runs_then_live_run"),
    ("lower_bound_search", "random_truncated"),
    ("marks_empty", "random_truncated"), ("marks_empty", "zero_fill")])
def test_choosing_a_zero_length_run_fails(mutation, name):
    """The mutation checks: the same model with a lower-bound search, or
    with marks that a zero-length run sharing a live run's start can win,
    picks that run and differs from the plain version; the kernel's rules
    do not."""
    cols, cap = table(name, HAZARDS.index(name) + 1)
    want_t, _ = plain(cols, cap)
    kw = ({"search": lower_bound} if mutation == "lower_bound_search"
          else {"mark_empty": True})
    bad_t, _, _ = tiles_model(*cols, cap, **kw)
    good_t, _, _ = tiles_model(*cols, cap)
    assert not np.array_equal(bad_t, want_t)
    np.testing.assert_array_equal(good_t, want_t)


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 2047, 2048, 2049, 5000])
def test_scan_model_is_the_exclusive_prefix_sum(n):
    """The CTA's scan at the edges of its warps and of its 2,048-run
    steps, with lengths that wrap int32: starts are the exclusive prefix
    sum of vis[perm] in wrapping int32, bases are arena_off[perm]."""
    rng = np.random.default_rng(n)
    perm = rng.permutation(n).astype(np.int32)
    vis = rng.integers(0, 1 << 24, n).astype(np.int32)
    vis[: n // 2] = rng.integers(1 << 28, 1 << 30, n // 2)   # wraps
    off = rng.integers(-100, 1 << 20, n).astype(np.int32)
    starts, bases, _ = scan_row(perm, vis, off, 64)
    cum = np.cumsum(vis[perm].astype(np.int64)) & M32
    want = np.concatenate([[0], cum]).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(starts, want)
    np.testing.assert_array_equal(bases, off[perm])


@pytest.mark.parametrize("name", ["random_truncated", "cap_odd",
                                  "zero_length_runs_then_live_run",
                                  "one_run_spans_every_tile"])
def test_seg_first_holds_each_segments_first_output(name):
    """seg_first[g] is the live run whose chars hold output g * SEG, for
    every segment that starts inside the text and inside cap; its last
    entry is the run that holds output min(total, cap) - 1."""
    cols, cap = table(name, HAZARDS.index(name) + 1)
    perm, vis, off, _ = cols
    for r in range(perm.shape[0]):
        starts, _, seg_first = scan_row(perm[r], vis[r], off[r], cap)
        vl = vis[r][perm[r]]
        lim = min(int(starts[-1]), cap)
        held = [(g, g * SEG) for g in range(seg_first.shape[0] - 1)]
        for g, j in held + [(-1, lim - 1)]:
            if not 0 <= j < lim:
                continue
            k = int(seg_first[g])
            assert vl[k] > 0 and starts[k] <= j < starts[k] + vl[k]


def test_scan_model_clamps_perm():
    """perm entries out of [0, n) are clamped before they index."""
    perm = np.array([5, -3, 1, 2], np.int32)
    vis = np.array([1, 2, 3, 4], np.int32)
    off = np.array([10, 20, 30, 40], np.int32)
    starts, bases, _ = scan_row(perm, vis, off, 64)
    np.testing.assert_array_equal(starts, [0, 4, 5, 7, 10])
    np.testing.assert_array_equal(bases, [40, 10, 20, 30])


# ---- shared rows: the history path's versions ---------------------------------

def shared_table(name, seed):
    """Versions of one history as K3 sees them: ONE perm, one arena_off
    row and one arena ([1, n], [1, pool]) and b rows of visibility, each
    version showing a subset of the runs (the rest zero-length). Returns
    (perm, vis, off, arena, cap)."""
    rng = np.random.default_rng(seed)
    b, n, pool = 6, 400, 1500
    vl_doc = rng.integers(1, 7, n)
    cap = 256 if name == "versions_truncated" else 2048
    if name == "versions_zero_length_runs":
        # a tile's worth of runs that no version shows, behind a live run
        vl_doc[1:TILE + 1] = 0
    [perm], _v, [off], [arena] = _doc_order(rng, 1, n, vl_doc[None], pool)
    shown = rng.random((b, n)) < np.linspace(0.2, 1.0, b)[:, None]
    if name == "versions_zero_length_runs":
        shown[:, 0] = True
    vis_doc = np.where(shown, vl_doc[None], 0)
    vis = np.zeros((b, n), np.int64)
    vis[:, perm] = vis_doc
    return (perm[None], np.ascontiguousarray(vis, np.int32), off[None],
            arena[None], cap)


SHARED = ["versions_truncated", "versions_zero_fill",
          "versions_zero_length_runs"]


@pytest.mark.parametrize("name", SHARED)
def test_tiles_model_walks_shared_rows(name):
    """Stride-0 rows through both passes equal the plain version on the
    shared rows, on the rows expanded, and the JAX package's vmapped
    materialize_jax."""
    perm, vis, off, arena, cap = shared_table(name, SHARED.index(name))
    b, n = vis.shape
    got_t, got_n, counts = tiles_model(perm, vis, off, arena, cap,
                                       strides=(0, 0, 0))
    want_t, want_n = plain((perm, vis, off, arena), cap)
    expanded = [np.ascontiguousarray(np.broadcast_to(x, (b, x.shape[1])))
                for x in (perm, off, arena)]
    exp_t, exp_n = plain((expanded[0], vis, expanded[1], expanded[2]), cap)
    jt, jn = _jax_materialize(*(jnp.asarray(x) for x in
                                (expanded[0], vis, expanded[1],
                                 expanded[2])), cap)
    for t, nn in ((want_t, want_n), (exp_t, exp_n),
                  (np.asarray(jt), np.asarray(jn))):
        np.testing.assert_array_equal(got_t, t)
        np.testing.assert_array_equal(got_n, nn)
    # the same model with each row expanded and read at its own stride
    e_t, e_n, _ = tiles_model(expanded[0], vis, expanded[1], expanded[2],
                              cap)
    np.testing.assert_array_equal(e_t, got_t)
    np.testing.assert_array_equal(e_n, got_n)
    if name == "versions_truncated":
        assert (got_n > cap).all()
    if name == "versions_zero_fill":
        assert counts["zero_tiles"] > 0
    if name == "versions_zero_length_runs":
        assert counts["search"] > 0
