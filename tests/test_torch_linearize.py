"""The port's linearizer and text assembly against the JAX package's.

`fugue_linearize` (plain PyTorch, batched over [b, n]) against
`fugue_linearize_jax` vmapped over the batch, on random Fugue trees with
padding rows; `materialize` against `materialize_jax`; and K3's plain
version (`kernels.materialize_runs` on CPU tensors) against the Pallas
kernel `materialize_pallas` in interpret mode. Every output is integer:
the tolerance is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_types_tpu.tpu.linearize import (fugue_linearize_jax,
                                             materialize_jax)
from diamond_types_tpu.tpu.pallas_kernels import materialize_pallas
from diamond_types_tpu_torch.gpu import kernels
from diamond_types_tpu_torch.gpu.linearize import (_doc_order_np,
                                                   fugue_linearize,
                                                   materialize)

INT32_MAX = np.iinfo(np.int32).max


def _trees(rng, b, n):
    """b random Fugue trees padded to n nodes: row 0 is full, the others
    hold k <= n real nodes (any of them may be 0) at shuffled indices,
    the rest are padding (parent n, side 1, INT32_MAX keys)."""
    parent = np.full((b, n), n, np.int32)
    side = np.ones((b, n), np.int32)
    keys = [np.full((b, n), INT32_MAX, np.int32) for _ in range(3)]
    for r in range(b):
        k = n if r == 0 else int(rng.integers(0, n + 1))
        label = rng.permutation(n)[:k]
        for t, i in enumerate(label):
            root = t == 0 or rng.random() < 0.2
            parent[r, i] = n if root else label[rng.integers(0, t)]
            side[r, i] = rng.integers(0, 2)
            for key in keys:                  # ties in every key
                key[r, i] = rng.integers(0, 4)
    return (parent, side, *keys)


_jax_linearize = jax.jit(jax.vmap(fugue_linearize_jax))
_jax_materialize = jax.jit(jax.vmap(materialize_jax, in_axes=(0, 0, 0, 0,
                                                              None)),
                           static_argnums=4)


@pytest.mark.parametrize("n", [1, 2, 3, 127, 128, 129, 1000])
def test_fugue_linearize_matches_jax(n):
    rng = np.random.default_rng(n)
    cols = _trees(rng, 4, n)
    want = np.asarray(_jax_linearize(*map(jnp.asarray, cols)))
    got = fugue_linearize(*map(torch.from_numpy, cols))
    assert got.dtype == torch.int32 and got.shape == (4, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the host DFS agrees on the full row
    np.testing.assert_array_equal(got[0].numpy(), _doc_order_np(*(
        c[0].astype(np.int64) for c in cols)))


def _run_table(rng, b, n, pool):
    perm = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32)
    vis = rng.integers(0, 6, (b, n)) * (rng.random((b, n)) < 0.7)
    off = rng.integers(0, pool, (b, n))
    arena = rng.integers(1, 0x10FFFF, (b, pool))
    return [np.ascontiguousarray(a, np.int32)
            for a in (perm, vis, off, arena)]


@pytest.mark.parametrize("n,cap,pool", [(1, 4, 8), (5, 4, 16),
                                        (32, 64, 100), (200, 128, 600),
                                        (200, 2048, 600),
                                        (9000, 4096, 20000)])
def test_materialize_matches_jax(n, cap, pool):
    """Includes cap < total (truncation, and runs that start past cap),
    cap > total (zero fill), and 9,000 runs: past the Pallas kernel's
    8,192-run table bound, so against materialize_jax only."""
    rng = np.random.default_rng(n + cap)
    cols = _run_table(rng, 3, n, pool)
    want_t, want_n = _jax_materialize(*map(jnp.asarray, cols), cap)
    got_t, got_n = materialize(*map(torch.from_numpy, cols), cap)
    assert got_t.dtype == got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    kt, kn = kernels.materialize_runs(*map(torch.from_numpy, cols), cap)
    assert torch.equal(kt, got_t) and torch.equal(kn, got_n)


@pytest.mark.parametrize("n,cap", [(1, 8), (24, 16), (48, 256)])
def test_k3_plain_matches_pallas_interpreted(n, cap):
    rng = np.random.default_rng(7 * n + cap)
    perm, vis, off, arena = _run_table(rng, 2, n, 300)
    vis[0, :3] = 0                             # empty runs
    launches = kernels.materialize_runs.launches
    got_t, got_n = kernels.materialize_runs(
        *map(torch.from_numpy, (perm, vis, off, arena)), cap)
    assert kernels.materialize_runs.launches == launches  # plain on CPU
    for r in range(2):
        want_t, want_n = materialize_pallas(
            jnp.asarray(perm[r]), jnp.asarray(vis[r]), jnp.asarray(off[r]),
            jnp.asarray(arena[r]), cap, interpret=True)
        np.testing.assert_array_equal(got_t[r].numpy(), np.asarray(want_t))
        assert int(got_n[r]) == int(want_n)


def test_materialize_runs_checks_its_inputs():
    z = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="one \\[b, n\\] shape"):
        kernels.materialize_runs(z, z[:, :3], z, z, 8)
    # one shared arena row is the history path's form; 3 rows for b 2, or
    # an empty pool, is no form
    with pytest.raises(ValueError, match="arena"):
        kernels.materialize_runs(z, z, z, torch.zeros((3, 4),
                                                      dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="arena"):
        kernels.materialize_runs(z, z, z, z[:, :0], 8)
    with pytest.raises(ValueError, match="cap"):
        kernels.materialize_runs(z, z, z, z, 0)
    with pytest.raises(TypeError, match="int32"):
        kernels.materialize_runs(z.long(), z, z, z, 8)
