"""The port's spans (``core/timing``): the span primitive on a fake clock,
the engine's span tree and host-read count on both paths, the node's
per-frame spans in both modes, and the spans as ``torch.profiler`` ranges.
CPU only."""

from __future__ import annotations

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched, node
from patchwork_tpu_torch.core import timing
from patchwork_tpu_torch.io.synthetic import (split_terrain_cloud,
                                              velodyne_like_cloud)
from patchwork_tpu_torch.segment import engine

READ = timing.READ


@pytest.fixture
def fake_clock(monkeypatch):
    """The spans' clock reads 0, 1, 2, ... s, one tick a reading."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(timing, "_clock", lambda: float(next(ticks)))


def test_span_nesting_parents_and_self_time(fake_clock):
    st = timing.StageTimes()
    assert timing.span("x").__enter__() is None       # no span open
    with st.time("root", (3, 4)) as root:             # 0 .. 7
        with timing.span("a") as a:                   # 1 .. 4
            with timing.span("a.b") as ab:            # 2 .. 3
                assert timing.current() is ab
            assert timing.current() is a
        with pytest.raises(ValueError):
            with timing.span("c"):                    # 5 .. 6
                raise ValueError
        assert timing.current() is root
    assert timing.current() is None
    by = {s.name: s for s in st.spans}
    assert [s.name for s in st.spans] == ["a.b", "a", "c", "root"]
    assert (by["a.b"].parent, by["a"].parent, by["c"].parent,
            by["root"].parent) == (a, root, root, None)
    assert by["root"].frames == (3, 4) and by["a"].frames == ()
    assert [(s.start, s.end) for s in st.spans] == [(2, 3), (1, 4), (5, 6),
                                                    (0, 7)]
    s = st.summary()
    assert s["root"]["total_ms"] == 7000.0 and s["root"]["self_ms"] == 3000.0
    assert s["a"]["total_ms"] == 3000.0 and s["a"]["self_ms"] == 2000.0
    assert s["a.b"]["self_ms"] == s["a.b"]["total_ms"] == 1000.0
    assert set(s["a"]) == {"count", "mean_ms", "p50_ms", "p95_ms", "max_ms",
                           "total_ms", "self_ms"}
    assert "self" in st.report().splitlines()[0]


def test_open_spans_overlap_and_are_never_current(fake_clock):
    st = timing.StageTimes()
    first = st.open("frame", (0,))                     # 0
    second = st.open("frame", (1,), start=-5.0)
    with st.time("engine", (1,)):                     # 1 .. 2
        assert timing.current().name == "engine"
    first.close()                                     # 3
    assert timing.current() is None
    with timing.span("orphan"):                       # no span open
        pass
    second.close(10.0)
    assert [(s.name, s.start, s.end, s.parent) for s in st.spans] == [
        ("engine", 1, 2, None), ("frame", 0, 3, None),
        ("frame", -5.0, 10.0, None)]
    st.add("d", 0.5)
    assert st.summary()["d"]["max_ms"] == pytest.approx(500.0)


def test_a_thread_starts_with_no_span():
    st = timing.StageTimes()
    seen = []

    def other():
        seen.append(timing.current())
        with timing.span("x"):                        # records nothing
            pass

    with st.time("root"):
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
        assert timing.current().name == "root"
    assert seen == [None] and [s.name for s in st.spans] == ["root"]


def _bools(monkeypatch):
    """Record the span open at every ``bool`` of a tensor."""
    seen = []
    real = torch.Tensor.__bool__

    def counted(t):
        seen.append(timing.current())
        return real(t)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    return seen


def _levels(monkeypatch, name):
    """Count the calls of ``engine.<name>``, one a level run."""
    calls = []
    real = getattr(engine, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(engine, name, counted)
    return calls


@pytest.mark.parametrize("impl, level_fn, generic", [
    (None, "level", False),              # the level path (adaptive seeds)
    ("pallas", "_level_body", True),     # the generic path
])
def test_engine_span_tree_and_reads(monkeypatch, impl, level_fn, generic):
    xyz = torch.from_numpy(np.stack([split_terrain_cloud(8192, seed=s)
                                     for s in range(2)]))
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool)
    cfg = PatchworkConfig(segment_impl=impl)
    levels = _levels(monkeypatch, level_fn)
    bools = _bools(monkeypatch)
    st = timing.StageTimes()
    with st.time("engine") as root:
        filter_ground_batched(xyz, valid, cfg)
    n = len(levels)
    assert n >= 3                        # split terrain recurses
    kids = Counter((s.name, s.parent.name) for s in st.spans
                   if s.parent is not None)
    assert kids["engine.binning", "engine"] == 1
    assert kids["engine.level", "engine"] == n
    assert kids["engine.level.fit", "engine.level"] == n
    assert kids["engine.level.remap", "engine.level"] == n - 1
    assert kids["engine.level.seeds", "engine.level"] == (n if generic else 0)
    # one read a loop test: the level loop's, below the engine span
    tests = n - 1 + (n < cfg.effective_levels)
    assert kids[READ, "engine"] == tests
    # the binning's copies in: the ring and sector edges and 2 pi
    assert kids[READ, "engine.binning"] == 3
    # every bool of a tensor is a read, and every read outside binning and
    # the median's sort is one bool
    assert bools and all(s is not None and s.name == READ for s in bools)
    per_read = Counter(id(s) for s in bools)
    for s in st.spans:
        if s.name == READ and s.parent.name not in ("engine.binning",
                                                    "engine.level.remap"):
            assert per_read[id(s)] == 1
    assert sum(kids[READ, p] for p in ("engine.level.fit",
                                       "engine.level.seeds")) \
        == len(bools) - tests
    # a remap level's medians: the sort sizes its histogram (on the card
    # the level path takes kernel #2 there, which reads nothing)
    assert kids[READ, "engine.level.remap"] == n - 1
    assert all(s.times is st and s.end <= root.end for s in st.spans)
    assert root.child_s == pytest.approx(sum(
        s.seconds for s in st.spans if s.parent is root), abs=1e-12)


def _scans(k, n0=3000):
    return [velodyne_like_cloud(n0 + 100 * i, seed=i) for i in range(k)]


def _node(batch_size=1):
    return node.PatchworkNode(
        node.NodeParams(max_iterations=30),
        PatchworkConfig(max_levels=2), capacity=4096, batch_size=batch_size,
        device="cpu")


def _by_frame(spans, name):
    out = {}
    for s in spans:
        if s.name == name:
            for f in s.frames:
                assert f not in out
                out[f] = s
    return out


def test_single_scan_frame_is_its_stages():
    n = _node()
    scans = _scans(4)
    scans[2] = scans[2][:50]             # below min_points: no frame
    res = n.run(scans, pipeline_depth=2)
    assert [r.index for r in res] == [0, 1, 3]
    spans = n.times.spans
    stage = {k: _by_frame(spans, k)
             for k in ("h2d", "engine", "hold", "d2h", "frame")}
    for k, got in stage.items():
        assert sorted(got) == [0, 1, 3], k
    for r in res:
        i = r.index
        parts = sum(stage[k][i].seconds for k in ("h2d", "engine", "hold",
                                                  "d2h"))
        assert stage["frame"][i].seconds == pytest.approx(parts, rel=1e-12)
        assert r.latency_s == stage["frame"][i].seconds
        # the hold runs from its engine call's return to its drain
        assert stage["hold"][i].start == stage["engine"][i].end
        assert stage["hold"][i].end == stage["d2h"][i].start
    # with two in flight, a frame's hold covers the next frame's stages
    assert stage["hold"][0].end > stage["engine"][1].end
    assert Counter(s.name for s in spans)["hold"] == 3
    assert all(s.parent is None for s in spans
               if s.name in ("h2d", "engine", "hold", "d2h", "frame"))
    kids = {s.name for s in spans if s.parent is not None}
    assert {"h2d.pad", "h2d.copy", "engine.binning", "engine.level",
            "engine.level.fit", "engine.counts", READ} <= kids


def test_batched_latency_is_each_frames_own():
    n = _node(batch_size=2)

    def paced():
        for pts in _scans(4):
            yield pts
            time.sleep(0.05)

    res = n.run(paced())
    frame = _by_frame(n.times.spans, "frame")
    engine_of = _by_frame(n.times.spans, "engine")
    d2h = _by_frame(n.times.spans, "d2h")
    assert "hold" not in n.times.summary()
    assert [s.frames for s in n.times.spans if s.name == "engine"] == [
        (0, 1), (2, 3)]
    for r in res:
        f = frame[r.index]
        assert r.latency_s == f.seconds and f.end == d2h[r.index].end
        assert f.start < engine_of[r.index].start
    lat = {r.index: r.latency_s for r in res}
    for a, b in ((0, 1), (2, 3)):
        # the first frame of a batch waited for the second one
        assert lat[a] - lat[b] > 0.04


def _paced(scans, asked, fast=0, period=0.04):
    """``scans`` one by one, the first ``fast`` at once and each later one
    ``period`` s after it is asked for, as a sensor hands them over;
    ``asked`` gets the moment of each pull."""
    for k, pts in enumerate(scans):
        asked.append(time.perf_counter())
        if k >= fast:
            time.sleep(period)
        yield pts


def _most_in_flight(spans):
    """The most frames in flight at once, each from its engine call's end
    to its drain (its hold's end), in the order the spans closed."""
    most = now = 0
    for s in spans:
        now += (s.name == "engine") - (s.name == "hold")
        most = max(most, now)
    return most


def test_a_paced_source_gets_each_frame_before_the_next_pull():
    scans = _scans(6)
    n = _node()
    asked, sunk = [], {}
    res = n.run(_paced(scans, asked),
                [lambda pts, r: sunk.setdefault(r.index, time.perf_counter())],
                pipeline_depth=2)
    assert [r.index for r in res] == list(range(6))
    spans = n.times.spans
    hold = _by_frame(spans, "hold")
    # the first frame waits for the second, as no pull before it waited;
    # every later one reaches the sink before the next scan is asked for
    assert sunk[0] > asked[1]
    for k in range(1, 5):
        assert sunk[k] < asked[k + 1], k
    for k in range(1, 6):
        assert hold[k].seconds < 5e-3, k
    paced = [s for s in spans if s.name == "drain.paced"]
    assert sorted(_by_frame(spans, "drain.paced")) == list(range(1, 6))
    assert all(s.seconds == 0.0 and s.parent is None for s in paced)
    assert n.times.summary()["drain.paced"]["count"] == 5
    assert _most_in_flight(spans) == 2
    # the same results as over a list and one scan at a time, bit for bit
    listed = _node().run(scans, pipeline_depth=2)
    alone = _node()
    for r, pts in zip(res, scans):
        for other in (listed[r.index], alone.process(pts, r.index)):
            assert other.index == r.index
            np.testing.assert_array_equal(other.ground_mask, r.ground_mask)
            np.testing.assert_array_equal(other.valid_mask, r.valid_mask)
            assert (other.num_ground, other.num_obstacles) == (
                r.num_ground, r.num_obstacles)


def test_a_source_that_turns_paced_switches_regimes(monkeypatch):
    # the node's clock stands still but for the source's waits: the first
    # four pulls take no time, each later one 40 ms, as a sensor's do
    now = [0.0]
    monkeypatch.setattr(timing, "_clock", lambda: now[0])
    events = []

    def source():
        for k, pts in enumerate(_scans(8)):
            events.append(("pull", k))
            if k >= 4:
                now[0] += 0.04
            yield pts

    n = _node()
    res = n.run(source(), [lambda pts, r: events.append(("sink", r.index))],
                pipeline_depth=3)
    assert [r.index for r in res] == list(range(8))
    spans = n.times.spans
    closed = {(s.name, f): k for k, s in enumerate(spans) for f in s.frames}
    # fast pulls: three in flight, each frame held past the next two
    # frames' engine calls
    for k in range(3):
        assert closed["hold", k] > closed["engine", k + 2], k
    assert _most_in_flight(spans) == 3
    # the frames pulled and not yet at a sink, as each scan is asked for:
    # two held while pulls are fast; the first pull that waits (scan 4)
    # releases what is in flight, and from then on every frame reaches its
    # sink before the next pull
    held, sunk = [], 0
    for kind, k in events:
        if kind == "sink":
            sunk += 1
        else:
            held.append(k - sunk)
    assert held == [0, 1, 2, 2, 2, 0, 0, 0]
    assert sorted(_by_frame(spans, "drain.paced")) == [3, 4, 5, 6, 7]
    # only the two frames in flight when the source turned wait out a pull
    hold = _by_frame(spans, "hold")
    assert [hold[k].seconds for k in range(8)] == pytest.approx(
        [0, 0, 0.04, 0.04, 0, 0, 0, 0])


def test_spans_follow_a_swap_of_the_nodes_times():
    n = _node()
    old = n.times
    scans = _scans(5)

    def source():
        for i, pts in enumerate(scans):
            if i == 2:
                n.times = timing.StageTimes()      # as a harness does
            yield pts

    res = n.run(source(), pipeline_depth=2)
    new = n.times
    assert new is not old and len(res) == 5
    for f in (2, 3, 4):                  # pulled after the swap: all new
        for k in ("h2d", "engine", "hold", "d2h", "frame"):
            assert f in _by_frame(new.spans, k), (f, k)
    engines = [s for s in new.spans if s.name == "engine"]
    assert [s.frames for s in engines] == [(2,), (3,), (4,)]
    for s in new.spans:                  # the engine's spans went there too
        if s.parent is not None:
            assert s.times is new and s.parent.times is new
    assert all(s.times is old for s in old.spans)
    names = Counter(s.name for s in old.spans + new.spans)
    for k in ("h2d", "engine", "hold", "d2h", "frame"):
        assert names[k] == 5


def test_spans_are_profiler_ranges():
    n = _node()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        n.run(_scans(3), pipeline_depth=2)
    events = sorted((e for e in prof.events() if e.name.startswith("node.")),
                    key=lambda e: e.time_range.start)
    spans = sorted(n.times.spans, key=lambda s: s.start)
    assert Counter(e.name for e in events) == Counter(
        "node." + s.name for s in spans)
    assert len(spans) > 20
    # the k-th span of a name is the k-th range of that name
    ranges = {}
    for e in events:
        ranges.setdefault(e.name, []).append(e)
    seen = Counter()
    event_of = {}
    for s in spans:
        event_of[id(s)] = ranges["node." + s.name][seen[s.name]]
        seen[s.name] += 1
    for s in spans:
        if s.parent is not None:
            e, p = event_of[id(s)], event_of[id(s.parent)]
            assert p.time_range.start <= e.time_range.start
            assert e.time_range.end <= p.time_range.end


def test_no_range_is_made_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler range with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    n = _node()
    res = n.run(_scans(2), pipeline_depth=2)
    assert len(res) == 2 and len(n.times.spans) > 10
