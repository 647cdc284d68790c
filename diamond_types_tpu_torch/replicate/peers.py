"""Retry pacing for outbound calls and the residency tier.

`Backoff` and `call_with_retries`, copied from the JAX package's
`replicate/peers.py`; the Hydrator's load ladder paces its retries with
`Backoff`. The rest of that module (the peer table, its health tracking
and circuit breaker) needs `replicate/faults` and `replicate/metrics` and
waits for the replicate layer.
"""

from __future__ import annotations

import random
import time
import urllib.error
from typing import Callable, Optional


class Backoff:
    """Jittered exponential backoff: delay(attempt) grows as
    base * 2**attempt, capped, with deterministic jitter in
    [0.5, 1.0) of the nominal delay (seeded so tests replay)."""

    def __init__(self, base_s: float = 0.05, cap_s: float = 5.0,
                 seed: int = 0, key: str = "") -> None:
        self.base_s = base_s
        self.cap_s = cap_s
        self._rng = random.Random(f"{seed}:{key}")

    def delay(self, attempt: int) -> float:
        # the exponent is bounded: 2**attempt overflows float conversion
        # near attempt=1025
        nominal = min(self.base_s * (2 ** min(max(attempt, 0), 20)),
                      self.cap_s)
        return nominal * (0.5 + 0.5 * self._rng.random())


def call_with_retries(fn: Callable, retries: int = 3,
                      backoff: Optional[Backoff] = None,
                      sleep: Callable[[float], None] = time.sleep):
    """Run `fn()` with up to `retries` retries on transient transport
    errors (connection failures, timeouts, HTTP 5xx). Client errors
    (HTTP 4xx) are NOT transient — retrying a rejected patch can't
    succeed — so they raise immediately."""
    backoff = backoff or Backoff()
    attempt = 0
    while True:
        try:
            return fn()
        except urllib.error.HTTPError as e:
            if e.code < 500 or attempt >= retries:
                raise
        except OSError:
            # URLError, ConnectionError, socket.timeout
            if attempt >= retries:
                raise
        sleep(backoff.delay(attempt))
        attempt += 1
