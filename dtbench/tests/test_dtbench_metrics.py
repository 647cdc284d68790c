"""The metrics' arithmetic: tails over every sample, the scheduler's
bucketed histograms, and the idle share and gaps from synthetic events."""

import statistics

import pytest

from dtbench import metrics
from dtbench.trace import host_label, idle_gaps, idle_share, union
from dtbench.traffic.clients import Sync


def ctx_with(latencies_ms, commit_late=()):
    syncs = []
    for i, ms in enumerate(latencies_ms):
        s = Sync(f"doc{i}", 0.0, 10)
        s.committed = ms / 1e3
        syncs.append(s)
    for i in commit_late:
        syncs[i].committed = None
    return {"syncs": syncs, "t_end": 1e9, "window_s": 2.0}


def test_tails_are_taken_over_every_sample():
    lat = [float(x) for x in range(1, 1001)]
    ctx = ctx_with(lat)
    p95 = metrics.load("visible_p95_ms")(ctx)
    p50 = metrics.load("visible_p50_ms")(ctx)
    assert p50 == statistics.median(lat)
    assert p95 == pytest.approx(950.05)
    # one slow sync among many moves the tail, not the median
    lat[-60:] = [1e5] * 60
    ctx = ctx_with(lat)
    assert metrics.load("visible_p95_ms")(ctx) == 1e5
    assert metrics.load("visible_p50_ms")(ctx) == statistics.median(lat)


def test_rate_counts_only_commits_inside_the_window():
    ctx = ctx_with([100.0, 200.0, 300.0])
    ctx["t_end"] = 0.25             # the third commits in the drain
    assert metrics.load("merged_ops_per_s")(ctx) == 20 / 2.0
    # ...but its latency still counts
    assert len(metrics.latencies_ms(ctx)) == 3


def test_histogram_window_matches_the_programs_quantile():
    from diamond_types_tpu_torch.obs.hist import Histogram
    before, after = Histogram(), Histogram()
    warm = [0.5, 0.7, 3.0]
    window = [0.001 * (1 + i % 37) for i in range(500)] + [2.5]
    for v in warm:
        before.record(v)
        after.record(v)
    alone = Histogram()
    for v in window:
        after.record(v)
        alone.record(v)
    counts = metrics.hist_window({"latencies": {"f": before.snapshot()}},
                                 {"latencies": {"f": after.snapshot()}}, "f")
    assert sum(counts) == len(window)
    for q in (0.5, 0.9, 0.95, 0.99):
        assert metrics.hist_quantile(counts, q) == pytest.approx(
            alone.quantile(q))


def test_idle_share_and_gaps_from_synthetic_events():
    ms = 1_000_000
    events = [(0 * ms, 2 * ms), (1 * ms, 3 * ms), (10 * ms, 11 * ms),
              (30 * ms, 31 * ms)]
    busy = union(sorted(events))
    assert busy == [(0, 3 * ms), (10 * ms, 11 * ms), (30 * ms, 31 * ms)]
    busy_s = sum(t - s for s, t in busy) / 1e9
    assert idle_share(busy_s, 0.040) == pytest.approx(87.5)
    gaps = idle_gaps(busy, 0, 40 * ms)
    assert gaps == [(3 * ms, 10 * ms), (11 * ms, 30 * ms),
                    (31 * ms, 40 * ms)]
    samples = [(12 * ms, ["serve.bank.extract_window", "gpu.xform.x"]),
               (20 * ms, ["serve.bank.extract_window"]),
               (5 * ms, []), (35 * ms, [])]
    assert host_label(samples, 11 * ms, 30 * ms) == \
        "serve.bank.extract_window"
    assert host_label(samples, 3 * ms, 10 * ms) == "host.idle"
    assert host_label(samples, 0, ms) == "unsampled"


def test_per_layer_readers_return_nothing_without_a_trace():
    ctx = ctx_with([10.0])
    ctx["trace"] = None
    for name in ("k2_us_per_op", "k1_us_per_op", "device_idle_pct"):
        assert metrics.load(name)(ctx) is None
    ctx["trace"] = {"busy_s": 0.5, "window_s": 2.0,
                    "kernels": {"void apply_ops_window_kernel<true>(...)":
                                1e-3}}
    assert metrics.load("k1_us_per_op")(ctx) == pytest.approx(100.0)
    assert metrics.load("k2_us_per_op")(ctx) is None
    assert metrics.load("device_idle_pct")(ctx) == pytest.approx(75.0)


def test_a_variant_is_read_by_its_base_reader():
    for base in ("visible_p50_ms", "visible_p95_ms"):
        variant = metrics.load(f"{base}.typing")
        assert variant.__code__.co_filename == \
            metrics.load(base).__code__.co_filename
    with pytest.raises(FileNotFoundError):
        metrics.load("no_such_metric.typing")
