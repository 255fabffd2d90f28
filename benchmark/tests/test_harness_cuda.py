"""On the card: a run of each cell correct, and the control at the cell's
own size not correct, on three seeds.  Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _last_json(stdout: str) -> list:
    return [json.loads(x) for x in stdout.strip().splitlines()
            if x.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_on_the_card(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2**31 + 101), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = _last_json(out.stdout)[-1]
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.control", "--workload", cell,
         "--seeds", ",".join(str(2**31 + s) for s in (201, 202, 203)),
         "--seconds", "3", "--control", "bf16"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    recs = _last_json(out.stdout)
    assert len(recs) == 3 and not any(r["correct"] for r in recs)
