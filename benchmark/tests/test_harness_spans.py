"""The readers of the program's own spans and host-read count
(``node.times``): on hand-made stage summaries, and in one traced CPU run
of each tiny cell."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.manifest import Manifest

from .test_harness_arith import reader, record
from .tiny import tiny_root

LIVE = ("node_hold_ms.live",)
OFFLINE = ("node_pad_ms.offline", "binning_host_ms.offline",
           "engine_read_wait_ms.offline", "engine_host_reads.offline")


def _stages(calls: int) -> dict:
    def stage(p50, count, total):
        return {"p50_ms": p50, "count": count, "total_ms": total}

    return {"h2d": stage(20.0, calls, 80.0), "h2d.pad": stage(9.5, calls, 38),
            "engine": stage(16.0, calls, 64.0),
            "engine.binning": stage(2.25, calls, 9.0),
            "engine.read": stage(0.01, 17 * calls, 6.0),
            "hold": stage(99.5, 20, 1990.0), "frame": stage(106.0, 20, 2120)}


def test_span_readers():
    off = record(stages=_stages(4), engine_calls=4)
    assert reader("node_pad_ms.offline")(off) == 9.5
    assert reader("binning_host_ms.offline")(off) == 2.25
    assert reader("engine_read_wait_ms.offline")(off) == 1.5
    assert reader("engine_host_reads.offline")(off) == 17.0
    live = record(arrival="open", due=[], stages=_stages(20),
                  engine_calls=20)
    assert reader("node_hold_ms.live")(live) == 99.5
    # the wrong arrival, a program without the span, no engine call
    bare = {"h2d": {"p50_ms": 1.0, "count": 4, "total_ms": 4.0},
            "engine": {"p50_ms": 1.0, "count": 4, "total_ms": 4.0}}
    for name in OFFLINE:
        assert reader(name)(live) is None
        assert reader(name)(record(stages=bare, engine_calls=4)) is None
    for name in LIVE:
        assert reader(name)(off) is None
        assert reader(name)(record(arrival="open", due=[], stages=bare,
                                   engine_calls=4)) is None
    for name in ("engine_read_wait_ms.offline", "engine_host_reads.offline"):
        assert reader(name)(record(stages=_stages(4))) is None


@pytest.mark.parametrize("cell, mine, other", [
    ("tiny.urban.offline", OFFLINE, LIVE),
    ("tiny.urban.live", LIVE, OFFLINE),
])
def test_a_traced_run_reports_the_spans(tmp_path, monkeypatch, cell, mine,
                                        other):
    records = []
    made = harness.RunRecord

    def kept(*a, **kw):
        records.append(made(*a, **kw))
        return records[-1]

    monkeypatch.setattr(harness, "RunRecord", kept)
    bench = Manifest(tiny_root(tmp_path))
    line = harness.run_cell(bench, cell, 2**31 + 55, 1.0, True,
                            torch.device("cpu"), 0.0, {"name": "cpu"})
    assert line["correct"] is True
    for name in mine:
        assert line["metrics"][name]["value"] > 0, name
    (run,) = records
    for name in other:
        assert name not in line["metrics"]
        assert bench.reader(name).read(run) is None
    assert run.stages["engine.read"]["count"] >= 4 * run.engine_calls
