"""Counters + histograms for the follower-read tier.

``ReadMetrics`` is the ServeMetrics v8 ``read`` block: attached to a
node's :class:`~diamond_types_tpu.read.path.ReadPath` and exported both
through ``GET /metrics`` (top-level ``read`` key) and, when a scheduler
is present, inside the ServeMetrics snapshot — ``obs/prom.py`` renders
either as ``dt_read_*`` families.

``READ_KEYS`` is the full counter surface, exported as a tuple for the
same reason ``serve/metrics.py`` exports ``HYDRATION_KEYS``: the prom
renderer and the tests import it, so the three surfaces cannot drift.
"""

from ..analysis import make_lock
from ..obs.hist import Histogram

# Every counter the read path can bump. Groups:
#   serve outcome:  reads, local, proxied_staleness, proxied_min_version,
#                   proxied_forced (X-DT-Proxied arrivals served locally
#                   on the owner side of a proxy hop), refused
#   cache:          cache_hits / cache_misses / cache_coalesced /
#                   cache_evictions / cache_wait_timeouts
#   invalidation:   flush_invalidations (owner, flush completion),
#                   ae_invalidations (follower, anti-entropy apply),
#                   invalidated_entries (cache entries actually dropped)
#   catch-up:       catchup_waits (entered the bounded wait),
#                   catchup_satisfied, catchup_timeouts
#   index feed:     adverts (owner frontier advertisements folded),
#                   reconciles (completed anti-entropy reconciles noted)
#   elastic mesh:   proxied_steered (staleness proxies redirected to a
#                   lightly loaded follower instead of the owner),
#                   warmed_on_hydrate (checkout-cache entries
#                   pre-materialized when hydration finished)
READ_KEYS = (
    "reads",
    "local",
    "proxied_staleness",
    "proxied_min_version",
    "proxied_forced",
    "refused",
    "cache_hits",
    "cache_misses",
    "cache_coalesced",
    "cache_evictions",
    "cache_wait_timeouts",
    "flush_invalidations",
    "ae_invalidations",
    "invalidated_entries",
    "catchup_waits",
    "catchup_satisfied",
    "catchup_timeouts",
    "adverts",
    "reconciles",
    "proxied_steered",
    "warmed_on_hydrate",
)


class ReadMetrics:
    """Thread-safe counters for the follower-read tier.

    Keys are FIXED (``READ_KEYS``): ``bump`` raises on an unknown key so
    a typo in the read path fails loudly in tests instead of silently
    minting a family the renderer never expected (same contract as
    ``ReplicationMetrics._GROUPS``).
    """

    # v1 -> v2: elastic mesh — proxied_steered + warmed_on_hydrate
    SCHEMA_VERSION = 2

    def __init__(self):
        self._lock = make_lock("read.metrics", "leaf")
        self._c = {k: 0 for k in READ_KEYS}
        # Staleness of every locally-served follower read (seconds of
        # proven-catch-up age; owners record 0.0).
        self.staleness = Histogram()
        # Wall time spent in the bounded catch-up wait, satisfied or not.
        self.wait = Histogram()
        # live-telemetry double-write target (obs TimeSeries), wired by
        # read.attach_follower_reads when the store has an obs bundle
        self.ts = None

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[key] += n
        if self.ts is not None:
            self.ts.inc(f"read.{key}", n)

    def observe_staleness(self, seconds: float) -> None:
        s = max(0.0, seconds)
        self.staleness.record(s)
        if self.ts is not None:
            self.ts.observe("read.staleness", s)

    def observe_wait(self, seconds: float) -> None:
        s = max(0.0, seconds)
        self.wait.record(s)
        if self.ts is not None:
            self.ts.observe("read.read_wait", s)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._c)
        reads = counters["reads"]
        proxied = (counters["proxied_staleness"]
                   + counters["proxied_min_version"])
        return {
            "version": self.SCHEMA_VERSION,
            "counters": counters,
            "proxied": proxied,
            "local_ratio": (counters["local"] / reads) if reads else None,
            "staleness": self.staleness.snapshot(),
            "latencies": {"read_wait": self.wait.snapshot()},
        }
