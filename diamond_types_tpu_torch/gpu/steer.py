"""Batch-shape steering: the shape classes a flush window would be snapped
onto.

Port of the JAX package's `tpu/steer.py`, unchanged in policy. The replay
rungs pad a window to a `(b, n, max_ins, cap)` shape class: pow2 rounding
keeps the class count O(log^2), and steering snaps a window's pow2-floored
`(bp0, n0)` onto a WARM class:

  * `ShapeSteer` tracks the warm set per cache name (`"kernel"` for K1's
    rung, the counterpart of the JAX package's `"pallas"`; `"fused"` for
    the per-doc sync; `"mesh"` for the flush window), fed by `note_warm`
    after each snap.
  * `snap()` maps `(bp0, n0)` to a class: an exact warm class as-is; a
    cold shape pads UP to the cheapest warm class whose cell waste
    `(bw*nw)/(bp0*n0)` stays under `max_waste`; a cold shape with no
    affordable warm neighbor pads anyway on first sight and gets its own
    class once it recurs (`recur_threshold`).

In the JAX package a warm class is a compiled jit entry, and padding a
window onto one saves a compile. The port has no compile to save, so
`flush_fuse` only records the class `snap` picks (the table and counters
then match the JAX package's, which the tests hold) and launches at the
pow2 floor; a CUDA-graph capture keyed by these classes would be the first
thing to launch them.

`cap_class()` and `warmup_batches()` are the single source of capacity
flooring and warm-up batch enumeration. Everything here is host-side dict
bookkeeping.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set, Tuple

# pad up to a warm class while the padded cell count stays under this
# multiple of the floored cell count; beyond it a recurring shape earns
# its own class instead of paying the waste every window
DEFAULT_MAX_WASTE = 4.0
# a cold shape seen this many times gets its exact class (first sight
# never does: one-off shapes borrow a warm neighbor)
DEFAULT_RECUR_THRESHOLD = 2
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


class ShapeSteer:
    """Warm-class table + snap policy (see module doc). Keys are
    `(max_ins, cap, b, n)` per cache name. All state lives behind one
    lock, which never acquires anything itself."""

    def __init__(self, max_waste: float = DEFAULT_MAX_WASTE,
                 recur_threshold: int = DEFAULT_RECUR_THRESHOLD,
                 enabled: bool = True) -> None:
        self.enabled = enabled
        self.max_waste = float(max_waste)
        self.recur_threshold = int(recur_threshold)
        self._lock = threading.Lock()
        self._warm: Dict[str, Set[Tuple[int, int, int, int]]] = {}
        self._cold_seen: Dict[Tuple, int] = {}
        self._counts = {"lookups": 0, "hits": 0, "padded": 0,
                        "forced_pads": 0, "compiles": 0}

    def reset(self, table: bool = False) -> None:
        with self._lock:
            self._counts = {"lookups": 0, "hits": 0, "padded": 0,
                            "forced_pads": 0, "compiles": 0}
            if table:
                self._warm = {}
                self._cold_seen = {}

    def note_warm(self, cache: str, mi: int, cap: int, b: int,
                  n: int) -> None:
        """Record a shape class as warm in `cache`."""
        with self._lock:
            self._warm.setdefault(cache, set()).add(
                (int(mi), int(cap), int(b), int(n)))

    def snap(self, cache: str, bp0: int, n0: int, mi: int, cap: int,
             multiple: int = 1) -> Tuple[int, int]:
        """Steer a window's pow2-floored shape `(bp0, n0)` onto a class.
        `multiple` constrains the batch axis of a padded-to class (the
        flush window passes its device count). Returns `(bp, n)` with
        `bp >= bp0, n >= n0`. A new exact class is counted under
        `compiles`, the JAX package's name for it."""
        if not self.enabled:
            return bp0, n0
        with self._lock:
            self._counts["lookups"] += 1
            warm = self._warm.get(cache, ())
            if (mi, cap, bp0, n0) in warm:
                self._counts["hits"] += 1
                return bp0, n0
            floor_cells = bp0 * n0
            best: Optional[Tuple[int, int]] = None
            best_cells = 0
            for (wmi, wcap, bw, nw) in warm:
                if wmi != mi or wcap != cap or bw < bp0 or nw < n0:
                    continue
                if multiple > 1 and bw % multiple:
                    continue
                cells = bw * nw
                if best is None or cells < best_cells:
                    best, best_cells = (bw, nw), cells
            if best is not None \
                    and best_cells <= self.max_waste * floor_cells:
                self._counts["padded"] += 1
                return best
            ckey = (cache, mi, cap, bp0, n0)
            seen = self._cold_seen.get(ckey, 0) + 1
            self._cold_seen[ckey] = seen
            if best is not None and seen < self.recur_threshold:
                # one-off out-of-bound shape: borrow the warm neighbor
                self._counts["forced_pads"] += 1
                return best
            self._counts["compiles"] += 1
            self._cold_seen.pop(ckey, None)
            return bp0, n0

    def snapshot(self) -> dict:
        with self._lock:
            c = dict(self._counts)
            looks = c["lookups"]
            pads = c["padded"] + c["forced_pads"]
            return {"enabled": self.enabled,
                    "max_waste": self.max_waste,
                    "lookups": looks,
                    "hits": c["hits"],
                    "padded": pads,
                    "forced_pads": c["forced_pads"],
                    "compiles": c["compiles"],
                    "hit_rate": round((c["hits"] + pads) / looks, 4)
                    if looks else 0.0,
                    "warm_classes": {k: len(v) for k, v
                                     in sorted(self._warm.items())}}


STEER = ShapeSteer()
