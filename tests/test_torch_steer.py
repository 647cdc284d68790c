"""The port's shape classes (`gpu/steer.py`) against the JAX package's.

The capacity floor, the warm-up batch classes and the pow2 rounding must
agree over a range, and a bank's warm-up must launch K1 at exactly the
classes the JAX package's warm-up notes warm.
"""

import numpy as np
import pytest

from diamond_types_tpu.serve.scheduler import MergeScheduler as JaxScheduler
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu.tpu import steer as jsteer
from diamond_types_tpu.tpu.merge_kernel import _pow2 as jax_pow2
from diamond_types_tpu_torch.gpu import flush_fuse as tff
from diamond_types_tpu_torch.gpu import steer as tsteer

from torch_parity import port_warmup_classes


def test_capacity_class_and_warmup_batches_match_jax():
    caps = list(range(0, 1100)) + [int(x) for x in np.random.default_rng(
        5).integers(1100, 1 << 20, 500)]
    assert [tsteer.cap_class(c) for c in caps] == \
        [jsteer.cap_class(c) for c in caps]
    assert [tsteer._pow2(c) for c in caps] == [jax_pow2(c) for c in caps]
    for fd in range(0, 70):
        assert tsteer.warmup_batches(fd) == jsteer.warmup_batches(fd)
    # the session's capacity floor is steer's, as in the JAX package
    assert tff.cap_class is tsteer.cap_class


@pytest.mark.parametrize("flush_docs,mesh_window", [(4, False), (3, True)])
def test_warmup_warm_table_matches_jax(monkeypatch, flush_docs,
                                       mesh_window):
    """A bank's warm-up launches K1 once at each class the JAX package's
    warm-up notes warm for the same options: the per-shard replay classes
    at their pow2 op classes (JAX: under "pallas" and "fused"), and the
    window's super-batch classes (JAX: under "mesh")."""
    opts = {"cap": 256, "max_ins": 4}
    jsteer.STEER.reset(table=True)
    try:
        jol = JaxOpLog()
        js = JaxScheduler(1, resolve=lambda d: jol, fused_opts=opts,
                          flush_docs=flush_docs, warmup=True, pallas=True,
                          mesh_window=mesh_window)
        js.banks[0].join_warmup(timeout=300)
        want = {k: sorted(v) for k, v in jsteer.STEER._warm.items()}
    finally:
        jsteer.STEER.reset(table=True)
    got = port_warmup_classes(monkeypatch, fused_opts=dict(opts,
                                                           device="cpu"),
                              flush_docs=flush_docs, mesh_window=mesh_window)
    assert set(want) == ({"pallas", "fused", "mesh"} if mesh_window
                         else {"pallas", "fused"})
    assert sorted(got["shard"]) == want["pallas"] == want["fused"]
    assert sorted(got["mesh"]) == want.get("mesh", [])
    assert {k[3] for k in got["shard"]} == {2, 4, 8}
