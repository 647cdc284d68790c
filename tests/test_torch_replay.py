"""K1 and X1 parity: the port's replay against the JAX package's.

K1 is the Pallas kernel `apply_op_block` (run here in interpret mode) and
its window body `make_pallas_replay_body`; the port's counterparts are the
per-op step `batch._apply_ops_batched` and `kernels.apply_ops_window`
(which runs `apply_ops_window_plain` on CPU tensors). X1 is the XLA replay in
`tpu/batch.py` and the fused-rung body `make_replay_body`, whose
counterpart is `kernels.apply_ops_window_plain` itself. The whole-trace
replay `replay_batch_pallas` (a scan of `apply_op_block` from empty rows)
is held against `kernels.replay_batch_kernel` on in-contract traces, and
its deliberate divergence on ops out of contract is pinned. Every
comparison is exact over the full `[b, cap]` buffers, wrap-around slack
included, and the lengths.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_types_tpu.tpu import batch as jbatch
from diamond_types_tpu.tpu import flush_fuse as jff
from diamond_types_tpu.tpu.pallas_kernels import apply_op_block
from diamond_types_tpu_torch.gpu import batch as tbatch
from diamond_types_tpu_torch.gpu import kernels


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(t, a):
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def random_ops(rng, shape, cap, mi):
    """pos/dlen/ilen/chars for ops of every kind: inserts, deletes,
    replacements, no-ops; positions past the doc end and at the buffer
    end (deletes that reach it wrap the roll)."""
    pos = rng.integers(0, cap + 3, shape)
    near_end = rng.random(shape) < 0.25
    pos = np.where(near_end, cap - rng.integers(1, mi + 2, shape), pos)
    kind = rng.integers(0, 4, shape)          # ins, del, replace, no-op
    dlen = np.where((kind == 1) | (kind == 2),
                    rng.integers(1, mi + 1, shape), 0)
    ilen = np.where((kind == 0) | (kind == 2),
                    rng.integers(1, mi + 1, shape), 0)
    chars = rng.integers(1, 0x10FFFF, shape + (mi,))
    return (pos.astype(np.int32), dlen.astype(np.int32),
            ilen.astype(np.int32), chars.astype(np.int32))


def random_window(seed, b, n, cap, mi, poison=(), padding=()):
    rng = np.random.default_rng(seed)
    docs = rng.integers(1, 0x10FFFF, (b, cap)).astype(np.int32)
    lens = rng.integers(0, cap, b).astype(np.int32)
    pos, dlen, ilen, chars = random_ops(rng, (b, n), cap, mi)
    for r in poison:                 # one op past max_ins poisons the row
        k = int(rng.integers(0, n))
        if rng.random() < 0.5:
            dlen[r, k] = mi + 1 + int(rng.integers(0, 3))
        else:
            ilen[r, k] = mi + 1
    for r in padding:                # inert padding: -1 length, zero ops
        lens[r] = -1
        pos[r] = dlen[r] = ilen[r] = 0
        chars[r] = 0
    return docs, lens, pos, dlen, ilen, chars


@pytest.mark.parametrize("b,cap,mi", [(1, 64, 2), (5, 64, 4), (8, 256, 16),
                                      (11, 128, 8)])
def test_op_step_matches_pallas_apply_op_block(b, cap, mi):
    rng = np.random.default_rng(b * 1000 + cap)
    step_fn = jax.jit(functools.partial(apply_op_block, interpret=True))
    for _ in range(4):
        doc = rng.integers(1, 1 << 20, (b, cap)).astype(np.int32)
        lens = rng.integers(0, cap, b).astype(np.int32)
        pos, dlen, ilen, chars = random_ops(rng, (b,), cap, mi)
        want_d, want_l = step_fn(
            jnp.asarray(pos), jnp.asarray(dlen), jnp.asarray(ilen),
            jnp.asarray(chars), jnp.asarray(doc), jnp.asarray(lens))
        got_d, got_l = tbatch._apply_ops_batched(
            _t(doc), _t(lens), _t(pos), _t(dlen), _t(ilen), _t(chars))
        _eq(got_d, want_d)
        _eq(got_l, want_l)


@pytest.mark.parametrize("b,n,cap,mi", [(1, 2, 64, 2), (4, 8, 64, 4),
                                        (8, 16, 256, 16), (16, 8, 128, 4)])
def test_window_matches_pallas_and_fused_bodies(b, n, cap, mi):
    poison = (1,) if b > 2 else ()
    padding = tuple(range(b // 2 + 1, b)) if b > 2 else ()
    args = random_window(b + n + cap, b, n, cap, mi, poison, padding)
    jargs = [jnp.asarray(a) for a in args]
    want_d, want_l = jax.jit(jff.make_pallas_replay_body(mi, True))(*jargs)
    x1_d, x1_l = jax.jit(jff.make_replay_body(mi))(*jargs)
    np.testing.assert_array_equal(np.asarray(x1_d), np.asarray(want_d))
    np.testing.assert_array_equal(np.asarray(x1_l), np.asarray(want_l))
    targs = [_t(a) for a in args]
    before = kernels.apply_ops_window.launches
    got_d, got_l = kernels.apply_ops_window(*targs, mi)
    assert kernels.apply_ops_window.launches == before   # CPU: plain only
    _eq(got_d, want_d)
    _eq(got_l, want_l)
    f_d, f_l = kernels.apply_ops_window_plain(*targs, mi)
    _eq(f_d, want_d)
    _eq(f_l, want_l)
    if poison:
        assert int(got_l[1]) == -1
    for r in padding:
        assert int(got_l[r]) == -1
    # the wrapper never writes its inputs
    _eq(targs[0], args[0])


def test_window_long_deletes_split_to_max_ins():
    """A delete longer than max_ins arrives as max_ins-sized pieces at
    one position (the planner's split), including pieces that reach the
    end of the buffer."""
    cap, mi = 64, 4
    docs = np.arange(1, cap + 1, dtype=np.int32)[None].repeat(2, 0)
    lens = np.array([cap, 40], np.int32)
    pos = np.array([[60, 60, 60, 10], [30, 30, 30, 0]], np.int32)
    dlen = np.array([[4, 4, 4, 3], [4, 4, 2, 0]], np.int32)
    ilen = np.array([[0, 0, 0, 2], [0, 0, 0, 4]], np.int32)
    chars = np.full((2, 4, mi), 7, np.int32)
    args = (docs, lens, pos, dlen, ilen, chars)
    want_d, want_l = jax.jit(jff.make_pallas_replay_body(mi, True))(
        *[jnp.asarray(a) for a in args])
    got_d, got_l = kernels.apply_ops_window(*[_t(a) for a in args], mi)
    _eq(got_d, want_d)
    _eq(got_l, want_l)


def test_window_rejects_bad_shapes_and_types():
    args = [_t(a) for a in random_window(0, 2, 2, 64, 4)]
    with pytest.raises(ValueError):
        kernels.apply_ops_window(*args, 8)          # chars width != mi
    bad = list(args)
    bad[2] = bad[2].long()
    with pytest.raises(TypeError):
        kernels.apply_ops_window(*bad, 4)
    with pytest.raises(ValueError):
        kernels.apply_ops_window(args[0][:, :2], *args[1:], 4)  # mi > cap


# ---- X1: tpu/batch.py ------------------------------------------------------

TXNS = [[(0, 0, "hello world")], [(5, 6, "")], [(5, 0, ", there")],
        [(0, 1, "H")], [(12, 0, "!")]]
LONG_DEL_TXNS = [[(0, 0, "hello there world")], [(5, 9, "")],
                 [(0, 0, ">>")], [(2, 7, "")], [(0, 0, "ab")]]


@pytest.mark.parametrize("txns,max_ins", [(TXNS, 16), (TXNS, 3),
                                          (LONG_DEL_TXNS, 2),
                                          (LONG_DEL_TXNS, 4)])
def test_encode_and_replay_batch_match(txns, max_ins):
    want = jbatch.encode_trace_ops(txns, max_ins)
    got = tbatch.encode_trace_ops(txns, max_ins)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    pos, dl, il, chars = want
    b = 3
    tiled = (np.tile(pos, (b, 1)), np.tile(dl, (b, 1)), np.tile(il, (b, 1)),
             np.tile(chars, (b, 1, 1)))
    jd, jl = jbatch.replay_batch(*[jnp.asarray(a) for a in tiled], cap=64)
    td, tl = tbatch.replay_batch(*tiled, cap=64, device="cpu")
    _eq(td, jd)
    _eq(tl, jl)
    assert tbatch.docs_to_strings(td, tl) == \
        jbatch.docs_to_strings(np.asarray(jd), np.asarray(jl))


def test_replay_batch_out_of_contract_poisons_batch():
    pos = np.zeros((2, 2), np.int32)
    il = np.asarray([[4, 0], [1, 0]], np.int32)
    dl = np.asarray([[0, 9], [0, 0]], np.int32)   # 9 > max_ins = 4
    chars = np.zeros((2, 2, 4), np.int32)
    chars[:, 0] = [104, 105, 33, 33]
    jd, jl = jbatch.replay_batch(jnp.asarray(pos), jnp.asarray(dl),
                                 jnp.asarray(il), jnp.asarray(chars), cap=16)
    td, tl = tbatch.replay_batch(pos, dl, il, chars, cap=16, device="cpu")
    _eq(tl, jl)
    assert tl.tolist() == [-1, -1]
    _eq(td, jd)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_ops_batched_matches_including_out_of_range_shifts(seed):
    """The XLA step leaves the buffer unshifted for a shift outside
    [-max_ins, max_ins] and writes only max_ins insert lanes; the port's
    gather form keeps both."""
    rng = np.random.default_rng(seed)
    b, cap, mi = 6, 32, 3
    docs = rng.integers(1, 1000, (b, cap)).astype(np.int32)
    lens = rng.integers(0, cap, b).astype(np.int32)
    pos = rng.integers(0, cap + 2, b).astype(np.int32)
    dl = rng.integers(0, 2 * mi + 2, b).astype(np.int32)
    il = rng.integers(0, 2 * mi + 2, b).astype(np.int32)
    chars = rng.integers(1, 1000, (b, mi)).astype(np.int32)
    args = (docs, lens, pos, dl, il, chars)
    jd, jl = jbatch._apply_ops_batched(*[jnp.asarray(a) for a in args])
    td, tl = tbatch._apply_ops_batched(*[_t(a) for a in args])
    _eq(td, jd)
    _eq(tl, jl)
    sd, sl = jbatch.apply_op_step(*[jnp.asarray(a[0]) for a in args])
    pd, pl = tbatch.apply_op_step(*[_t(a[0]) for a in args])
    _eq(pd, sd)
    _eq(pl, sl)


def test_replay_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    pos, dl, il, chars = tbatch.encode_trace_ops(TXNS, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.replay_batch(pos[None], dl[None], il[None], chars[None],
                            cap=64)


# ---- replay_batch_pallas and its counterpart, replay_batch_kernel ------------

def trace_rows(seed, b, cap, mi, n_txns=12):
    """In-contract replays, as `tests/test_tpu_kernels.py`'s replay tests
    build them: per row a random edit trace over a document that starts
    empty and stays within `cap` (inserts and deletes of up to 3 * mi
    chars, so `encode_trace_ops` splits them at max_ins), encoded by the
    JAX package's `encode_trace_ops`; rows padded to one length with
    no-ops (0, 0, 0). Returns (pos, dlen, ilen, chars) and the texts."""
    rng = np.random.default_rng(seed)
    rows, texts = [], []
    for _ in range(b):
        doc, txns = "", []
        for _ in range(n_txns):
            pos = int(rng.integers(0, len(doc) + 1))
            nd = int(rng.integers(0, min(3 * mi, len(doc) - pos) + 1)) \
                if rng.random() < 0.4 else 0
            room = cap - (len(doc) - nd)
            k = int(rng.integers(0, min(3 * mi, room) + 1))
            ins = "".join(chr(int(c)) for c in rng.integers(97, 123, k))
            txns.append([(pos, nd, ins)])
            doc = doc[:pos] + ins + doc[pos + nd:]
        rows.append(jbatch.encode_trace_ops(txns, mi))
        texts.append(doc)
    n = max(len(r[0]) for r in rows)
    out = [np.zeros((b, n), np.int32) for _ in range(3)] \
        + [np.zeros((b, n, mi), np.int32)]
    for i, r in enumerate(rows):
        for a, src in zip(out, r):
            a[i, :len(src)] = src
    return out, texts


@pytest.mark.parametrize("seed,b,cap,mi", [(0, 4, 64, 16), (1, 3, 256, 4),
                                           (2, 8, 128, 8)])
def test_replay_batch_kernel_matches_replay_batch_pallas(seed, b, cap, mi):
    from diamond_types_tpu.tpu.pallas_kernels import replay_batch_pallas
    args, texts = trace_rows(seed, b, cap, mi)
    jd, jl = replay_batch_pallas(*[jnp.asarray(a) for a in args], cap=cap,
                                 interpret=True)
    kernels.apply_ops_window.launches = 0
    td, tl = kernels.replay_batch_kernel(*[_t(a) for a in args], cap=cap)
    _eq(td, jd)
    _eq(tl, jl)
    assert tbatch.docs_to_strings(td.numpy(), tl.numpy()) == texts
    pd, pl = kernels.replay_batch_plain(*[_t(a) for a in args], cap=cap)
    assert torch.equal(pd, td) and torch.equal(pl, tl)
    # CPU tensors ran the plain version: nothing launched
    assert kernels.apply_ops_window.launches == 0


def test_replay_batch_kernel_out_of_contract_diverges_from_jax():
    """A deliberate divergence (ROADMAP §3): an op with dlen or ilen past
    the chars width, or a negative field, poisons K1's row to length -1;
    `replay_batch_pallas` applies it (a delete of any length; an insert
    whose chars past the width are zeros; lengths by plain arithmetic)."""
    from diamond_types_tpu.tpu.pallas_kernels import replay_batch_pallas
    mi, cap = 4, 64
    args, _texts = trace_rows(7, 5, cap, mi, n_txns=4)
    pos, dlen, ilen, chars = args
    n = pos.shape[1]
    # row: (op, pos, dlen, ilen) of the one op out of contract
    bad = {1: (0, 0, mi + 2, 0), 2: (n - 1, 0, 0, mi + 3),
           3: (n - 1, -1, 0, 0), 4: (n - 1, 0, -1, 0)}
    for row, (k, p, d, i) in bad.items():
        pos[row, k], dlen[row, k], ilen[row, k] = p, d, i
    jd, jl = replay_batch_pallas(*[jnp.asarray(a) for a in args], cap=cap,
                                 interpret=True)
    td, tl = kernels.replay_batch_kernel(*[_t(a) for a in args], cap=cap)
    jl, tl = np.asarray(jl), tl.numpy()
    # in-contract row 0 is equal; every bad row is -1 in the port only
    _eq(td[0], np.asarray(jd)[0])
    assert tl[0] == jl[0]
    for row in bad:
        assert tl[row] == -1 and jl[row] != -1, row
    # JAX's length is the arithmetic of every op, the bad one included
    want = np.where((ilen == 0) & (dlen == 0), 0, ilen - dlen).sum(1)
    assert (jl[1:] == want[1:]).all()
