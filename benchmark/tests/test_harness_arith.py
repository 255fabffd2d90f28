"""The rate, percentile, busy, idle and roofline arithmetic, and the metric
readers, on hand-made stamps."""

from __future__ import annotations

import math

import pytest

from benchmark import arith, reference
from benchmark.devtrace import Kernel, TraceSummary, label_gaps, short_name
from benchmark.harness import RunRecord
from benchmark.manifest import Manifest

from .tiny import REPO

H100 = "NVIDIA H100 80GB HBM3"


def reader(name):
    return Manifest(REPO).reader(name).read


def record(**kw) -> RunRecord:
    base = dict(arrival="closed", t0=10.0, t_end=12.0,
                setup_s=3.5, handed=[], due=None, arrived={}, stages={},
                engine_calls=0, launches={}, trace=None, traced_calls=0,
                work=None, card={"name": H100, "power_limit": "700.00 W"})
    base.update(kw)
    return RunRecord(**base)


def test_rate_counts_the_window_only():
    assert arith.rate([10.0, 10.5, 11.0, 12.0, 12.01], 10.0, 12.0) == 2.0


def test_percentile_is_nearest_rank_with_missing_last():
    xs = list(range(1, 101))
    assert arith.percentile(xs, 50) == 50
    assert arith.percentile(xs, 95) == 95
    assert arith.percentile([3.0], 95) == 3.0
    assert arith.percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert arith.percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf
    with pytest.raises(ValueError):
        arith.percentile([], 50)


def test_busy_is_the_union_and_gaps_its_complement():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert arith.merge_intervals(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert arith.busy_seconds(iv) == 4.0
    assert arith.idle_gaps(iv, -1.0, 8.0) == [(-1.0, 0.0), (3.0, 5.0),
                                               (6.0, 8.0)]
    assert arith.idle_pct(1.0, 4.0) == 75.0


def test_roofline_takes_the_larger_bound():
    # 67e9 flops: 1 ms by operations; 3.35e6 bytes: 1 µs by bytes
    assert arith.least_seconds(67e9, 3.35e6, H100) == (1e-3, "operations")
    assert arith.least_seconds(67e6, 3.35e9, H100) == (1e-3, "bytes")
    assert arith.roofline_pct(67e9, 0, 4e-3, H100) == pytest.approx(25.0)
    assert arith.roofline_pct(67e9, 0, 4e-3, "some other card") is None
    assert arith.roofline_pct(67e9, 0, 0.0, H100) is None


def test_scans_per_s_reader():
    run = record(arrived={0: 10.2, 1: 10.4, 2: 11.9, 3: 12.5})
    assert reader("scans_per_s")(run) == 1.5
    assert reader("scans_per_s")(record(arrival="open", due=[])) is None


def test_latency_readers_count_a_missing_frame_as_late():
    due = [0.0, 0.1, 0.2, 0.3]
    run = record(arrival="open", due=due, handed=due,
                 arrived={0: 0.105, 1: 0.2, 2: 0.31})
    assert reader("latency_p50_ms")(run) == pytest.approx(105.0)
    assert reader("latency_p95_ms")(run) is None          # frame 3 missing
    run.arrived[3] = 0.35
    assert reader("latency_p95_ms")(run) == pytest.approx(110.0)
    assert reader("latency_p50_ms")(record()) is None


def test_stage_and_counter_readers():
    run = record(stages={"h2d": {"p50_ms": 1.5, "count": 4},
                         "engine": {"p50_ms": 7.25, "count": 4}},
                 engine_calls=4, launches={"level": 4, "seg_sum": 4,
                                           "fit_level": 0})
    assert reader("node_h2d_ms.offline")(run) == 1.5
    assert reader("engine_host_ms.offline")(run) == 7.25
    assert reader("engine_launches.offline")(run) == 2.0
    assert reader("setup_s")(run) == 3.5


def _trace():
    kernels = [Kernel("void pw_fit_level_kernel<false, true>(PwFitArgs)",
                      0.004, 2),
               Kernel("void pw_r1_kernel(float const*)", 0.001, 2),
               Kernel("void pw_fit_level_kernel<false, false>(PwFitArgs)",
                      0.003, 1),
               Kernel("void pw_seg_sum_kernel(float const*)", 0.0005, 2),
               Kernel("Memcpy HtoD (Pageable -> Device)", 0.002, 2)]
    return TraceSummary(kernels, busy_s=0.01, window_s=0.04, gaps=[])


def test_trace_readers():
    run = record(trace=_trace(), traced_calls=2)
    assert reader("device_idle_pct.offline")(run) == pytest.approx(75.0)
    assert reader("device_busy_ms.live")(run) is None
    live = record(arrival="open", trace=_trace(), traced_calls=4)
    assert reader("device_busy_ms.live")(live) == pytest.approx(2.5)
    assert reader("level_path_device_ms.live")(live) == pytest.approx(1.25)
    assert reader("level_path_device_ms.live")(run) is None
    assert reader("device_idle_pct.offline")(live) is None
    assert reader("level_path_device_ms.offline")(run) == pytest.approx(2.5)
    assert reader("generic_path_device_ms.offline")(run) == pytest.approx(1.5)
    run.trace = TraceSummary([Kernel("x", 1.0, 1)], 1.0, 2.0, [])
    assert reader("level_path_device_ms.offline")(run) is None


def test_fit_roofline_reader():
    work = reference.FitWork(dist_points=10**9, fit_points=10**9,
                             resid_points=0, level_points=10**6, scans=8)
    run = record(trace=_trace(), traced_calls=2, work=work)
    flops = 11 * 10**9 + 18 * 10**9
    want = 100.0 * (flops / 67e12) / 0.007          # two fit kernel rows
    assert reader("fit_roofline.offline")(run) == pytest.approx(want)
    run.card = {"name": "unknown"}
    assert reader("fit_roofline.offline")(run) is None
    run.card, run.work = {"name": H100}, None
    assert reader("fit_roofline.offline")(run) is None


def test_gaps_are_named_by_what_the_host_did():
    host = [("node.engine", 0.0, 100.0), ("aten::item", 40.0, 60.0),
            ("bench.wait_due", 100.0, 300.0)]
    gaps = [(45.0, 55.0), (150.0, 250.0), (400.0, 410.0)]
    got = label_gaps(gaps, host)
    assert got[0] == ("bench.wait_due", pytest.approx(100e-6))
    assert dict(got) == pytest.approx({"bench.wait_due": 100e-6,
                                       "python": 10e-6,
                                       "node.engine > aten::item": 10e-6})
    assert short_name("void pw_r1_kernel(float const*, int)") == "pw_r1_kernel"
