"""Sampled trace spans with cross-host propagation.

A span is (trace_id, span_id, parent_id, name, t0, dur, attrs). The
tracer head-samples at the root: a root span is either sampled (real
`Span`) or not (the shared `NOOP_SPAN` singleton) and every descendant
inherits that decision, so one slow edit either produces a complete
admit→queue→flush→device-sync tree or nothing. Crossing an HTTP hop
(proxied write, lease grant, quorum propose, anti-entropy pull) the
context rides the `X-DT-Trace` header as `trace_id-span_id-flags`; the
receiving server parses it and parents its own request span on the
remote caller, stitching both hosts into one trace.

Disabled tracers are a hard no-op: `start()` checks one flag and
returns `NOOP_SPAN` without allocating (verified by a tracemalloc test
in tests/test_obs.py), so the serve hot path pays a single branch when
observability is off.

Finished spans land in a bounded ring (deque) — this is a flight
recorder for traces, not an exporter; scrape via Tracer.spans().
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time
from typing import Optional

TRACE_HEADER = "X-DT-Trace"


class SpanContext:
    """The wire-portable third of a span: enough to parent a child on
    another thread or another host."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled


def format_context(ctx: SpanContext) -> str:
    return f"{ctx.trace_id}-{ctx.span_id}-{'1' if ctx.sampled else '0'}"


def parse_header(value: Optional[str]) -> Optional[SpanContext]:
    """Parse an `X-DT-Trace` header; malformed values are ignored (a
    bad header must never fail a request)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 3:
        return None
    trace_id, span_id, flags = parts
    if not trace_id or not span_id or len(trace_id) > 32 or len(span_id) > 32:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id, span_id, flags == "1")


class _NoopSpan:
    """Shared do-nothing span. All tracer call sites can treat their
    span uniformly; `sampled` is the one flag to branch on when
    creating children costs anything."""

    __slots__ = ()
    sampled = False

    def context(self):
        return None

    def header(self):
        return None

    def annotate(self, **_kw):
        return None

    def end(self, **_kw):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "attrs", "_done")
    sampled = True

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 attrs: dict) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._done = False
        self.t0 = time.monotonic()

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, True)

    def header(self) -> str:
        return format_context(self.context())

    def annotate(self, **kw) -> None:
        self.attrs.update(kw)

    def end(self, **kw) -> None:
        if self._done:
            return
        self._done = True
        if kw:
            self.attrs.update(kw)
        self._tracer._finish(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, _exc, _tb):
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.end()
        return False


class Tracer:
    """Head-sampling tracer with a bounded finished-span ring."""

    def __init__(self, sample_rate: float = 0.01, capacity: int = 2048,
                 seed: int = 0, enabled: bool = True) -> None:
        self.enabled = enabled
        self.sample_rate = float(sample_rate)
        self._lock = threading.Lock()
        self._rng = random.Random((seed << 16) ^ 0x7ace)
        # ids draw from a separate, per-tracer-unique stream: every
        # server defaults to seed=0, so id'ing from the (deterministic)
        # sampling rng would make all hosts mint IDENTICAL span-id
        # sequences — merged cross-host traces (obs/assemble.py) would
        # cross-link colliding ids into parent cycles
        self._id_rng = random.Random(
            ((seed << 16) ^ 0x7ace)
            ^ (os.getpid() << 48) ^ id(self)
            ^ time.monotonic_ns())
        self._spans: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1))
        self.started = 0
        self.sampled_out = 0
        self.finished = 0

    def start(self, name: str, parent: Optional[SpanContext] = None,
              attrs: Optional[dict] = None, force: bool = False):
        """Open a span. `parent` is a SpanContext (from Span.context()
        or parse_header) — its sampling decision is inherited. Roots
        sample at `sample_rate` unless `force`."""
        if not self.enabled:
            return NOOP_SPAN
        with self._lock:
            self.started += 1
            if parent is not None:
                if not parent.sampled:
                    self.sampled_out += 1
                    return NOOP_SPAN
                trace_id = parent.trace_id
                parent_id = parent.span_id
            else:
                if not force and self._rng.random() >= self.sample_rate:
                    self.sampled_out += 1
                    return NOOP_SPAN
                trace_id = "%016x" % self._id_rng.getrandbits(64)
                parent_id = None
            span_id = "%016x" % self._id_rng.getrandbits(64)
        return Span(self, name, trace_id, span_id, parent_id,
                    dict(attrs) if attrs else {})

    def _finish(self, span: Span) -> None:
        rec = {"name": span.name,
               "trace": span.trace_id,
               "span": span.span_id,
               "parent": span.parent_id,
               "t0": round(span.t0, 6),
               "dur_s": round(time.monotonic() - span.t0, 6),
               "attrs": span.attrs}
        with self._lock:
            self.finished += 1
            self._spans.append(rec)

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def find(self, trace_id: str) -> list:
        return [s for s in self.spans() if s["trace"] == trace_id]

    def index(self, limit: int = 50) -> list:
        """Recent sampled traces, newest first: trace id, root span
        name (the earliest span without an in-ring parent), wall time
        and span count. Backs `GET /debug/traces`."""
        traces: dict = {}
        order: list = []
        for s in self.spans():
            tid = s["trace"]
            if tid not in traces:
                traces[tid] = []
                order.append(tid)
            traces[tid].append(s)
        out = []
        for tid in reversed(order):
            spans = traces[tid]
            ids = {s["span"] for s in spans}
            roots = [s for s in spans
                     if not s["parent"] or s["parent"] not in ids]
            root = min(roots or spans, key=lambda s: s["t0"])
            out.append({"trace": tid, "root": root["name"],
                        "t0": root["t0"], "dur_s": root["dur_s"],
                        "spans": len(spans)})
            if len(out) >= max(int(limit), 1):
                break
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "sample_rate": self.sample_rate,
                    "started": self.started,
                    "sampled_out": self.sampled_out,
                    "finished": self.finished,
                    "buffered": len(self._spans)}
