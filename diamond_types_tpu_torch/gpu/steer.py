"""Shape classes of the replay rungs: the pow2 rounding, the capacity floor
and the batch and op classes a bank's warm-up launches.

K1 is one kernel for every shape, so a launch runs at the pow2 floor of its
batch and op counts; the module keeps the JAX package's name and layout
(`tpu/steer.py`) and only the helpers the rungs share.
"""

from __future__ import annotations

# ops-per-doc classes a bank's warm-up launches (batch classes derive from
# flush_docs, see warmup_batches)
WARMUP_SHAPE_CLASSES = (1, 2, 4, 8)


def _pow2(x: int) -> int:
    return 1 << max(1, (int(x) - 1)).bit_length()


def cap_class(cap: int) -> int:
    """The capacity class a session lands on: pow2, floored at 256."""
    return _pow2(max(int(cap), 256))


def warmup_batches(flush_docs: int):
    """Batch shape classes a bank configured with `flush_docs` can emit
    on the per-shard rungs: 1 plus every pow2 up to flush_docs."""
    return sorted({1} | {_pow2(k) for k in range(2, max(int(flush_docs),
                                                        1) + 1)})
