"""The open loop's hand-over on time, and the live cell's deadline."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness, traffic
from benchmark.manifest import Manifest

from .test_harness_arith import reader, record
from .tiny import tiny_root

POOL = [np.zeros((1, 3), np.float32)]


def test_the_open_loop_hands_every_frame_over_on_time():
    """50 frames at 100 Hz: none before its due time, the median under
    0.2 ms late."""
    t0 = time.perf_counter() + 0.02
    src = traffic.OpenLoop(POOL, t0, 0.01, 50)
    assert len(list(src)) == 50
    late = [h - d for h, d in zip(src.handed, src.due)]
    assert min(late) >= 0.0
    assert np.median(late) < 0.2e-3


@pytest.mark.parametrize("ahead_s, sleeps", [(0.05, True), (0.001, False)])
def test_the_wait_sleeps_to_its_margin_and_spins_the_rest(monkeypatch,
                                                          ahead_s, sleeps):
    slept, sleep = [], time.sleep
    monkeypatch.setattr(traffic.time, "sleep",
                        lambda s: (slept.append(s), sleep(s)))
    due = time.perf_counter() + ahead_s
    traffic.wait_until(due)
    assert time.perf_counter() >= due
    if sleeps:
        assert len(slept) == 1
        assert slept[0] == pytest.approx(ahead_s - traffic.MARGIN_S,
                                         abs=0.005)
    else:
        assert slept == []


def test_the_open_loop_waits_only_for_a_due_time_to_come():
    waits = []
    src = traffic.OpenLoop(POOL, time.perf_counter() - 1.0, 0.01, 5,
                           wait=waits.append)
    assert len(list(src)) == 5 and waits == []


@pytest.mark.parametrize("cell, waits", [("tiny.urban.live", True),
                                         ("tiny.urban.offline", False)])
def test_only_an_open_loop_waits(tmp_path, monkeypatch, cell, waits):
    """The live cell runs at a quarter of the sensor's rate, which the CPU
    keeps up with, so its frames after the first wait for their due times;
    a closed loop never waits."""
    called, real = [], traffic.wait_until
    monkeypatch.setattr(traffic, "wait_until",
                        lambda due: (called.append(due), real(due)))
    root = tiny_root(tmp_path)
    if waits:
        path = root / f"benchmark/mixes/{cell}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        realtime_factor=0.25)))
    line = harness.run_cell(Manifest(root), cell, 2**31 + 61, 1.2, False,
                            torch.device("cpu"), 0.0, {"name": "cpu"})
    assert line["correct"] is True
    assert bool(called) == waits


def test_the_deadline_is_the_next_frames_due_time():
    """Frame 1 arrives 110 ms after its due time, past the 100 ms period;
    frame 3 never arrives: 2 of 4 frames met the deadline."""
    due = [0.0, 0.1, 0.2, 0.3]
    run = record(arrival="open", due=due, handed=due,
                 arrived={0: 0.005, 1: 0.21, 2: 0.2999})
    assert reader("deadline_met_pct")(run) == pytest.approx(50.0)
    run.arrived.update({1: 0.199, 3: 0.31})
    assert reader("deadline_met_pct")(run) == pytest.approx(100.0)
    assert reader("deadline_met_pct")(record()) is None
