"""The reader of the node's early drains (``drain.paced`` over ``frame`` in
``node.times``): on hand-made stage summaries, and in traced CPU runs of
the tiny cells."""

from __future__ import annotations

import json

import torch

from benchmark import harness
from benchmark.manifest import Manifest

from .test_harness_arith import reader, record
from .tiny import tiny_root

PACED = "node_paced_drain_pct.live"


def _stages(frames: int, paced: int | None) -> dict:
    def stage(p50, count, total):
        return {"p50_ms": p50, "count": count, "total_ms": total}

    stages = {"engine": stage(5.0, frames, 5.0 * frames),
              "hold": stage(0.02, frames, 0.02 * frames),
              "frame": stage(7.0, frames, 7.0 * frames)}
    if paced is not None:
        stages["drain.paced"] = stage(0.0, paced, 0.0)
    return stages


def test_paced_drain_reader():
    pct = reader(PACED)
    assert pct(record(arrival="open", due=[], stages=_stages(20, 19))) == 95.0
    # a program that keeps no such span; a closed loop; no frame
    assert pct(record(arrival="open", due=[], stages=_stages(20, None))) is None
    assert pct(record(stages=_stages(20, 19))) is None
    assert pct(record(arrival="open", due=[], stages={
        "drain.paced": _stages(20, 19)["drain.paced"]})) is None


def test_the_offline_cell_reports_no_early_drains(tmp_path):
    """Batched mode drains no frame early, so the metric stays out of the
    line; what this run compares is not the subject here."""
    line = harness.run_cell(Manifest(tiny_root(tmp_path)),
                            "tiny.urban.offline", 2**31 + 57, 1.0, True,
                            torch.device("cpu"), 0.0, {"name": "cpu"})
    assert line["metrics"]
    assert PACED not in line["metrics"]


def test_a_paced_live_run_reports_its_early_drains(tmp_path):
    """The tiny live cell at a quarter of the sensor's rate, which the CPU
    keeps up with: the node drains every frame but the window's first
    before its next pull, and the hold is gone."""
    root = tiny_root(tmp_path)
    mix = root / "benchmark/mixes/tiny.urban.live.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   realtime_factor=0.25)))
    line = harness.run_cell(Manifest(root), "tiny.urban.live", 2**31 + 56,
                            2.0, True, torch.device("cpu"), 0.0,
                            {"name": "cpu"})
    assert line["correct"] is True and line["attempted"] == 5
    assert line["metrics"][PACED]["value"] == 80.0
    assert line["metrics"]["node_hold_ms.live"]["value"] < 5.0
