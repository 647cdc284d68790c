"""K1's design, the window as an index map, modelled in numpy.

`csrc/apply_ops.cu` replays a window without applying any op to the row:
every output element walks the op tape backwards to its source (a row
element or one op's chars). A warp's outputs walk as one run while every op
moves them alike, a lane's run once the warp's splits, and single elements
once the lane's splits; a run past every op of a staged tile jumps over the
tile in one step. This file models that kernel step by step (op tiles
staged from the last, their jumps, runs of 32 lanes x 4 elements, the same
split rules)
and holds it exactly against K1's plain version, `apply_ops_window_plain`,
on seeded windows that cover every hazard of the design, and against the
JAX package's Pallas replay body (interpret mode) where both packages agree
on the contract. The model is test code only; the card runs the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_types_tpu.tpu import flush_fuse as jff
from diamond_types_tpu_torch.gpu import kernels

LANES, PER = 32, 4            # lanes per warp, consecutive outputs per lane
WARP_RUN = LANES * PER
OP_TILE = 8                   # small, so tapes past one staging tile are cheap
SKIP = 0x7FFFFFFF


def _walk(o, w, k, ops, cap, mi):
    """The kernel's `walk`: run [o, o + w) back through ops k .. 0 of the
    staged tile. Returns (o, k): k == -1 when done (o < 0: resolved to
    chars), else the op that splits the run, o its index after that op."""
    while k >= 0:
        p, dl, il, kk = ops[k]
        if o + w <= p:
            k -= 1
            continue
        ins_end = p + il
        if o >= ins_end:
            s = o - il + dl
            if s >= cap:
                s -= cap
            elif s + w > cap:
                return o, k
            o = s
            k -= 1
            continue
        if o >= p and o + w <= ins_end:
            return -(1 + kk * mi + (o - p)), -1
        return o, k
    return o, k


def _jumps(ops, cap):
    """The kernel's `stage_jumps`, by its definition: for each staged op j,
    (lo, hi, d) such that a run [o, o + w) with lo <= o and o + w <= hi is
    shifted wholly, without a wrap, by every op j .. 0 (skipped ops keep
    it), to o + d. Python ints, clamped to int32 as the kernel clamps."""
    out, d, mx, mn = [], 0, None, 0
    for p, dl, il, _ in ops:
        mn = min(mn, d)                    # min of D[i - 1] over i <= j
        d += dl - il
        if p != SKIP:
            mx = p + il + d if mx is None else max(mx, p + il + d)
        lo = -2**31 if mx is None else mx - d
        hi = cap + mn - d
        out.append((max(-2**31, min(2**31 - 1, lo)),
                    max(-2**31, min(2**31 - 1, hi)), d))
    return out


def _jump(o, w, k, jumps):
    """(o, k) after ops k .. 0 when the run jumps them, else None."""
    lo, hi, d = jumps[k]
    return (o + d, -1) if o >= lo and o + w <= hi else None


def _walk_each(o, valid, k, ops, cap, mi):
    """The kernel's `walk_each`: single elements in step, never split."""
    for j in range(k, -1, -1):
        p, dl, il, kk = ops[j]
        for e in range(valid):
            x = o[e]
            if x < p:
                continue
            if x < p + il:
                o[e] = -(1 + kk * mi + (x - p))
            else:
                s = x - il + dl
                o[e] = s - cap if s >= cap else s


def _expand(o0):
    return [o0 - e if o0 < 0 else o0 + e for e in range(PER)]


def indexmap_row(doc, length, pos, dlen, ilen, chars, mi, counts):
    """One row of the window through the kernel's algorithm. Returns
    (out row, out length); `counts` tallies warp, lane and element walks."""
    cap = doc.shape[0]
    n = pos.shape[0]
    bad = (dlen > mi) | (ilen > mi) | (dlen < 0) | (ilen < 0) | (pos < 0)
    keep = ~bad
    total = (int(length) + int(np.sum(ilen[keep].astype(np.int64)
                                      - dlen[keep]))) & 0xFFFFFFFF
    out_len = -1 if bad.any() else int(np.uint32(total).view(np.int32))
    flat_chars = chars.reshape(-1)
    out = np.empty(cap, np.int64)
    for warp_lo in range(0, cap, WARP_RUN):
        warp_w = min(WARP_RUN, cap - warp_lo)
        warp_run, wo = True, warp_lo
        lanes = []
        for lane in range(LANES):
            lo = warp_lo + lane * PER
            lanes.append([_expand(lo), max(0, min(PER, cap - lo)), lo])
        k1 = ((n - 1) // OP_TILE) * OP_TILE if n else 0
        while k1 >= 0:
            m = min(OP_TILE, n - k1)
            rows = []
            for j in range(m):
                k = k1 + j
                p, dl, il = int(pos[k]), int(dlen[k]), int(ilen[k])
                if bad[k] or (dl == 0 and il == 0) or p >= cap:
                    rows.append((SKIP, 0, 0, k))
                else:
                    rows.append((p, dl, il, k))
            ops = rows
            jumps = _jumps(ops, cap)
            k1 -= OP_TILE
            k = m - 1
            if warp_run:
                counts["warp"] += 1
                if k >= 0 and _jump(wo, warp_w, k, jumps):
                    counts["jump"] += 1
                    wo, k = _jump(wo, warp_w, k, jumps)
                    continue
                wo, k = _walk(wo, warp_w, k, ops, cap, mi)
                if k < 0 and wo >= 0:
                    continue
                for st in lanes:
                    off = st[2] - warp_lo
                    st[0] = _expand(wo - off if wo < 0 else wo + off)
                warp_run = False
                if k < 0:
                    continue
                counts["split"] += 1
            if k < 0:
                continue
            for st in lanes:
                o, valid, _ = st
                kl = k
                if valid and o[0] >= 0 and all(o[e] == o[0] + e
                                               for e in range(1, valid)):
                    counts["lane"] += 1
                    jumped = _jump(o[0], valid, kl, jumps)
                    o0, kl = jumped or _walk(o[0], valid, kl, ops, cap, mi)
                    o = _expand(o0)
                if kl >= 0:
                    counts["element"] += 1
                    _walk_each(o, valid, kl, ops, cap, mi)
                st[0] = o
        for o, valid, lo in lanes:
            if warp_run:
                o = _expand(wo + lo - warp_lo)
            for e in range(valid):
                out[lo + e] = doc[o[e]] if o[e] >= 0 else \
                    flat_chars[-1 - o[e]]
    return out.astype(np.int32), out_len


def indexmap_window(docs, lens, pos, dlen, ilen, chars, mi):
    counts = {"warp": 0, "split": 0, "lane": 0, "element": 0, "jump": 0}
    rows = [indexmap_row(docs[r], lens[r], pos[r], dlen[r], ilen[r],
                         chars[r], mi, counts) for r in range(docs.shape[0])]
    return (np.stack([d for d, _ in rows]),
            np.array([x for _, x in rows], np.int32), counts)


def plain(args, mi):
    d, l = kernels.apply_ops_window_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], mi)
    return d.numpy(), l.numpy()


def window(seed, b, n, cap, mi, *, near_end=0.25, poison=(), negative=(),
           padding=(), beyond=0.05, wrap_len=False):
    """Ops of every kind: inserts, deletes, replacements and no-ops at
    random positions; a share at the buffer's end (deletes there pull the
    roll's wrap-around in, inserts there clip at cap); a share at
    [cap, cap + 3) (length moves, row does not)."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(1, 0x10FFFF, (b, cap)).astype(np.int32)
    lens = rng.integers(0, cap, b).astype(np.int32)
    if wrap_len:
        lens[:] = np.int32(2**31 - 5)
    shape = (b, n)
    pos = rng.integers(0, cap, shape)
    pos = np.where(rng.random(shape) < near_end,
                   cap - rng.integers(1, mi + 2, shape), pos)
    pos = np.where(rng.random(shape) < beyond,
                   cap + rng.integers(0, 3, shape), pos)
    pos = np.maximum(pos, 0)
    kind = rng.integers(0, 4, shape)
    dlen = np.where((kind == 1) | (kind == 2), rng.integers(1, mi + 1, shape), 0)
    ilen = np.where((kind == 0) | (kind == 2), rng.integers(1, mi + 1, shape), 0)
    if wrap_len:
        dlen[:] = 0
        ilen[:] = mi
    chars = rng.integers(1, 0x10FFFF, shape + (mi,))
    for r in poison:
        dlen[r, int(rng.integers(0, n))] = mi + 1
    for r in negative:
        field = (pos, dlen, ilen)[int(rng.integers(0, 3))]
        field[r, int(rng.integers(0, n))] = -1 - int(rng.integers(0, 4))
    for r in padding:
        lens[r] = -1
        pos[r] = dlen[r] = ilen[r] = 0
        chars[r] = 0
    return [docs, lens, pos.astype(np.int32), dlen.astype(np.int32),
            ilen.astype(np.int32), chars.astype(np.int32)]


# (name, seed, b, n, cap, mi, options): one case per hazard of the design
CASES = [
    ("wrap_deletes_at_end", 1, 3, 24, 256, 8, dict(near_end=0.8)),
    ("insert_clipped_at_cap", 2, 2, 16, 256, 16, dict(near_end=0.9)),
    ("pos_past_cap", 3, 2, 20, 256, 8, dict(beyond=0.5)),
    ("poisoned_row_others_apply", 4, 4, 16, 256, 8, dict(poison=(1, 2))),
    ("negative_fields_poison", 5, 3, 16, 256, 8, dict(negative=(0, 2))),
    ("padding_rows", 6, 4, 12, 256, 8, dict(padding=(2, 3))),
    ("cap_not_tile_multiple", 7, 2, 24, 4100, 16, {}),
    ("cap_odd", 8, 2, 16, 387, 8, {}),
    ("cap_equals_max_ins", 9, 3, 16, 16, 16, dict(near_end=0.5)),
    ("single_op", 10, 3, 1, 512, 8, {}),
    ("tape_past_one_staging_tile", 11, 2, 3 * OP_TILE + 5, 512, 8, {}),
    ("rows_past_one_tile", 12, 2, 32, 1536, 16, {}),
    ("length_wraps_int32", 13, 2, 8, 256, 8, dict(wrap_len=True)),
    ("empty_tape", 14, 2, 0, 256, 8, {}),
]


@pytest.mark.parametrize("name,seed,b,n,cap,mi,opts", CASES,
                         ids=[c[0] for c in CASES])
def test_indexmap_matches_plain(name, seed, b, n, cap, mi, opts):
    args = window(seed, b, n, cap, mi, **opts)
    before = [a.copy() for a in args]
    got_d, got_l, counts = indexmap_window(*args, mi)
    want_d, want_l = plain(args, mi)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_l, want_l)
    for a, a0 in zip(args, before):
        np.testing.assert_array_equal(a, a0)
    if opts.get("poison") or opts.get("negative"):
        rows = opts.get("poison", ()) or opts.get("negative", ())
        assert all(got_l[r] == -1 for r in rows)
    for r in opts.get("padding", ()):
        assert got_l[r] == -1
        np.testing.assert_array_equal(got_d[r], args[0][r])
    if n:
        assert counts["warp"] > 0


def test_indexmap_splits_few_runs_on_a_sparse_window():
    """A few ops over a long row leave most warps on the uniform path: the
    design's premise, counted on the model."""
    args = window(21, 2, 8, 8192, 16, near_end=0.0, beyond=0.0)
    got_d, got_l, counts = indexmap_window(*args, 16)
    want_d, want_l = plain(args, 16)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_l, want_l)
    warps = 2 * (8192 // WARP_RUN)
    assert 0 < counts["split"] < warps // 2
    assert counts["element"] < counts["lane"]


def test_indexmap_whole_row_in_one_insert_lane():
    """A run resolved to chars at the warp level: an insert as wide as the
    row at position 0 (cap == max_ins) replaces every element."""
    cap = mi = 4 * LANES * PER // 4
    rng = np.random.default_rng(3)
    docs = rng.integers(1, 1000, (1, cap)).astype(np.int32)
    lens = np.array([cap], np.int32)
    pos = np.zeros((1, 2), np.int32)
    dlen = np.array([[0, cap]], np.int32)
    ilen = np.array([[0, cap]], np.int32)
    chars = rng.integers(1, 1000, (1, 2, mi)).astype(np.int32)
    args = [docs, lens, pos, dlen, ilen, chars]
    got_d, got_l, counts = indexmap_window(*args, mi)
    np.testing.assert_array_equal(got_d[0], chars[0, 1])
    want_d, want_l = plain(args, mi)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_l, want_l)
    assert counts["lane"] == 0


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_jump_equals_the_walk_it_replaces(seed):
    """Wherever a run may jump ops k .. 0, walking them op by op ends at
    the same index with nothing split or resolved; and runs past every op
    do jump."""
    rng = np.random.default_rng(seed)
    cap, mi = 300, 8
    args = window(seed, 1, OP_TILE, cap, mi, near_end=0.3, beyond=0.2)
    pos, dlen, ilen = args[2][0], args[3][0], args[4][0]
    ops = [(SKIP, 0, 0, k) if (dl == 0 and il == 0) or p >= cap
           else (int(p), int(dl), int(il), k)
           for k, (p, dl, il) in enumerate(zip(pos, dlen, ilen))]
    jumps = _jumps(ops, cap)
    jumped = 0
    for _ in range(3000):
        k = int(rng.integers(0, OP_TILE))
        w = int(rng.integers(1, WARP_RUN + 1))
        o = int(rng.integers(0, cap - w + 1))
        got = _jump(o, w, k, jumps)
        if got is not None:
            jumped += 1
            assert _walk(o, w, k, ops, cap, mi) == got and got[0] >= 0
    assert jumped > 0


def test_indexmap_jumps_the_text_past_every_op():
    """Edits in the first quarter of a long row: the warps past them jump
    each staged tile in one step, and the row is still exact."""
    cap, mi, n = 4096, 16, 3 * OP_TILE
    args = window(44, 2, n, cap, mi, near_end=0.0, beyond=0.0)
    args[2] = (args[2] // 4).astype(np.int32)
    got_d, got_l, counts = indexmap_window(*args, mi)
    want_d, want_l = plain(args, mi)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_l, want_l)
    tail_warps = 2 * (cap // 2 // WARP_RUN)
    assert counts["jump"] >= tail_warps * (n // OP_TILE)


@pytest.mark.parametrize("seed,b,n,cap,mi", [(31, 2, 8, 64, 4),
                                             (32, 3, 12, 128, 8),
                                             (33, 2, 6, 48, 16)])
def test_indexmap_matches_pallas_replay_body(seed, b, n, cap, mi):
    """In-contract windows with ops past max_ins (both packages poison
    those) against the JAX package's Pallas replay body, interpreted."""
    args = window(seed, b, n, cap, mi, poison=(0,), padding=(b - 1,))
    want_d, want_l = jax.jit(jff.make_pallas_replay_body(mi, True))(
        *[jnp.asarray(a) for a in args])
    got_d, got_l, _ = indexmap_window(*args, mi)
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    np.testing.assert_array_equal(got_l, np.asarray(want_l))
