"""Doc-popularity laws: which doc does the next event touch?

A law maps (virtual time, seeded rng stream) -> doc index in
[0, n_docs). Like the arrival processes, laws are deterministic from
their constructor arguments — `draws()` returns the same sequence on
every call — so a scenario's full event schedule is replayable.

`Zipf` is the steady skew (rank-r doc drawn with weight 1/r^s);
`HotSetRotation` models trending topics: a small hot set absorbs most
traffic and rotates to a different seeded subset every
`rotate_every_s` of virtual time, which is what keeps warm caches and
hot-doc attribution honest.
"""

from __future__ import annotations

import bisect
import random
from typing import Dict, List


class PopularityLaw:
    kind = "base"

    def __init__(self, n_docs: int, seed: int = 0) -> None:
        self.n_docs = max(int(n_docs), 1)
        self.seed = seed

    def _rng(self) -> random.Random:
        return random.Random(f"{self.kind}:{self.seed}:{self.n_docs}")

    def draws(self, times: List[float]) -> List[int]:
        """Doc index per virtual arrival time (same length/order)."""
        raise NotImplementedError  # pragma: no cover - abstract

    def to_dict(self) -> Dict:
        raise NotImplementedError  # pragma: no cover - abstract


class Uniform(PopularityLaw):
    kind = "uniform"

    def draws(self, times: List[float]) -> List[int]:
        rng = self._rng()
        return [rng.randrange(self.n_docs) for _ in times]

    def to_dict(self) -> Dict:
        return {"kind": self.kind}


class Zipf(PopularityLaw):
    """Rank-r doc drawn with weight 1/r^s (s ~ 1.1 is the web's
    classic skew). Rank order IS doc-index order: doc 0 is the head."""

    kind = "zipf"

    def __init__(self, n_docs: int, s: float = 1.1,
                 seed: int = 0) -> None:
        super().__init__(n_docs, seed)
        self.s = float(s)
        acc, cdf = 0.0, []
        for r in range(1, self.n_docs + 1):
            acc += 1.0 / (r ** self.s)
            cdf.append(acc)
        self._cdf = [c / acc for c in cdf]

    def weight(self, rank: int) -> float:
        """Normalized probability of the rank-`rank` doc (0-based)."""
        lo = self._cdf[rank - 1] if rank else 0.0
        return self._cdf[rank] - lo

    def draws(self, times: List[float]) -> List[int]:
        rng = self._rng()
        return [bisect.bisect_left(self._cdf, rng.random())
                for _ in times]

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "s": self.s}


class HotSetRotation(PopularityLaw):
    """`hot_weight` of traffic lands uniformly on a `hot_k`-doc hot
    set; the set is a seeded sample that rotates every
    `rotate_every_s` of virtual time. The cold remainder is uniform
    over all docs."""

    kind = "hotset"

    def __init__(self, n_docs: int, hot_k: int = 2,
                 hot_weight: float = 0.8,
                 rotate_every_s: float = 5.0, seed: int = 0) -> None:
        super().__init__(n_docs, seed)
        self.hot_k = max(min(int(hot_k), self.n_docs), 1)
        self.hot_weight = float(hot_weight)
        self.rotate_every_s = max(float(rotate_every_s), 1e-9)

    def hot_set(self, t: float) -> List[int]:
        epoch = int(t / self.rotate_every_s)
        rng = random.Random(f"{self.kind}:{self.seed}:{epoch}")
        return rng.sample(range(self.n_docs), self.hot_k)

    def draws(self, times: List[float]) -> List[int]:
        rng = self._rng()
        out = []
        for t in times:
            if rng.random() < self.hot_weight:
                out.append(rng.choice(self.hot_set(t)))
            else:
                out.append(rng.randrange(self.n_docs))
        return out

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "hot_k": self.hot_k,
                "hot_weight": self.hot_weight,
                "rotate_every_s": self.rotate_every_s}


_KINDS = {"uniform": Uniform, "zipf": Zipf, "hotset": HotSetRotation}


def make_popularity(spec: Dict, n_docs: int,
                    seed: int = 0) -> PopularityLaw:
    spec = dict(spec)
    kind = spec.pop("kind")
    try:
        cls = _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown popularity kind: {kind!r}") from None
    return cls(n_docs, seed=spec.pop("seed", seed), **spec)
