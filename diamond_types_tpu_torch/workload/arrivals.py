"""Seeded arrival processes on a virtual clock.

Each process turns (seed, duration) into a sorted list of virtual
arrival timestamps BEFORE any traffic flows — `schedule()` is a pure
function of the constructor arguments, so the same spec replays the
same event sequence byte-identically (the determinism contract the
sampler tests pin). Non-homogeneous shapes (bursty, ramp) use Lewis &
Shedler thinning against the peak rate: candidate points arrive at
`rate_max` and survive with probability `rate(t)/rate_max`, which
keeps one rng stream per schedule and an exact target intensity.
"""

from __future__ import annotations

import random
from typing import Dict, List


class ArrivalProcess:
    """Base: subclasses define `rate(t)` (events/virtual-second) and
    `rate_max`; `schedule()` thins a homogeneous Poisson stream."""

    kind = "base"
    rate_max: float = 0.0

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed

    def rate(self, t: float) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def schedule(self, duration_s: float) -> List[float]:
        """Sorted virtual arrival times in [0, duration_s). A fresh
        rng per call: two calls on one instance are identical."""
        rng = random.Random(f"{self.kind}:{self.seed}")
        peak = self.rate_max
        out: List[float] = []
        if peak <= 0.0 or duration_s <= 0.0:
            return out
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= duration_s:
                return out
            if rng.random() * peak < self.rate(t):
                out.append(t)

    def to_dict(self) -> Dict:
        raise NotImplementedError  # pragma: no cover - abstract


class Poisson(ArrivalProcess):
    """Homogeneous Poisson: exponential inter-arrivals at a flat
    rate — the steady interactive-traffic floor."""

    kind = "poisson"

    def __init__(self, rate_per_s: float, seed: int = 0) -> None:
        super().__init__(seed)
        self.rate_per_s = float(rate_per_s)
        self.rate_max = self.rate_per_s

    def rate(self, t: float) -> float:
        return self.rate_per_s

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "rate_per_s": self.rate_per_s}


class Bursty(ArrivalProcess):
    """Flash crowd: a Poisson floor at `base_per_s` with periodic
    windows (`every_s` apart, `burst_len_s` long) where the rate
    multiplies by `burst_x` — the hot-doc admission stressor."""

    kind = "bursty"

    def __init__(self, base_per_s: float, burst_x: float = 10.0,
                 every_s: float = 10.0, burst_len_s: float = 2.0,
                 seed: int = 0) -> None:
        super().__init__(seed)
        self.base_per_s = float(base_per_s)
        self.burst_x = float(burst_x)
        self.every_s = float(every_s)
        self.burst_len_s = float(burst_len_s)
        self.rate_max = self.base_per_s * max(self.burst_x, 1.0)

    def in_burst(self, t: float) -> bool:
        return (t % self.every_s) < self.burst_len_s

    def rate(self, t: float) -> float:
        return self.rate_max if self.in_burst(t) else self.base_per_s

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "base_per_s": self.base_per_s,
                "burst_x": self.burst_x, "every_s": self.every_s,
                "burst_len_s": self.burst_len_s}


class Ramp(ArrivalProcess):
    """Linear ramp from `start_per_s` to `end_per_s` over `ramp_s`
    (then flat at `end_per_s`) — the scale-up / bulk-import shape."""

    kind = "ramp"

    def __init__(self, start_per_s: float, end_per_s: float,
                 ramp_s: float, seed: int = 0) -> None:
        super().__init__(seed)
        self.start_per_s = float(start_per_s)
        self.end_per_s = float(end_per_s)
        self.ramp_s = max(float(ramp_s), 1e-9)
        self.rate_max = max(self.start_per_s, self.end_per_s)

    def rate(self, t: float) -> float:
        if t >= self.ramp_s:
            return self.end_per_s
        frac = t / self.ramp_s
        return self.start_per_s + (self.end_per_s
                                   - self.start_per_s) * frac

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "start_per_s": self.start_per_s,
                "end_per_s": self.end_per_s, "ramp_s": self.ramp_s}


_KINDS = {"poisson": Poisson, "bursty": Bursty, "ramp": Ramp}


def make_arrivals(spec: Dict, seed: int = 0) -> ArrivalProcess:
    """Build a process from its declarative spec dict (the `kind` key
    selects the class; the rest are constructor kwargs)."""
    spec = dict(spec)
    kind = spec.pop("kind")
    try:
        cls = _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown arrival kind: {kind!r}") from None
    return cls(seed=spec.pop("seed", seed), **spec)
