"""The check that decides ``correct``, driven through a whole run on the
CPU with the timed path broken underneath: an answer altered where it is
produced, half of the batch left out, and the control (the reference in
bfloat16) in the program's place.  Each must come out not correct; the
unbroken program must come out correct."""

from __future__ import annotations

import pytest
import torch

from benchmark import reference
from benchmark.control import bf16_step, patched_step
from benchmark.harness import algorithm_values, run_cell
from benchmark.manifest import Manifest
from patchwork_tpu_torch.node import PatchworkNode

from .tiny import tiny_root

ORIGINAL = PatchworkNode._step


def altered(node, xyz, valid):
    """The answer for the batch's first scan altered where it is made: its
    ground and obstacle labels swapped."""
    g, v, ng, no = ORIGINAL(node, xyz, valid)
    g = g.clone()
    g[0] = v[0] & ~g[0]
    return g, v, g.sum(-1), (v & ~g).sum(-1)


def half_batch(node, xyz, valid):
    """The engine on the first half of the batch; the rest left empty."""
    b = xyz.shape[0]
    h = max(b // 2, 1)
    g, v, ng, no = ORIGINAL(node, xyz[:h], valid[:h])
    pad = torch.zeros((b - h, xyz.shape[1]), dtype=torch.bool)
    zero = torch.zeros(b - h, dtype=ng.dtype)
    return (torch.cat([g, pad]), torch.cat([v, pad]),
            torch.cat([ng, zero]), torch.cat([no, zero]))


def _run(tmp_path, cell: str, seed: int = 2**31 + 33) -> dict:
    bench = Manifest(tiny_root(tmp_path))
    return run_cell(bench, cell, seed, 1.0, False, torch.device("cpu"), 0.0,
                    {"name": "cpu"})


@pytest.mark.parametrize("cell", ["tiny.urban.offline", "tiny.urban.live"])
def test_an_altered_answer_is_not_correct(tmp_path, cell):
    with patched_step(altered):
        line = _run(tmp_path, cell)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["count_ppm"]["value"] > checks["count_ppm"]["limit"]
    assert checks["patch_ppm"]["value"] > checks["patch_ppm"]["limit"]


def test_half_the_batch_left_out_is_not_correct(tmp_path):
    with patched_step(half_batch):
        line = _run(tmp_path, "tiny.urban.offline")
    assert line["correct"] is False
    assert line["checks"]["valid_bits"]["value"] > 0
    checks = line["checks"]
    assert checks["count_ppm"]["value"] > checks["count_ppm"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.urban.offline", "tiny.urban.live"])
def test_the_bf16_control_is_not_correct(tmp_path, cell):
    bench = Manifest(tiny_root(tmp_path))
    conf = bench.config(bench.cell(cell).config)
    alg = reference.Algorithm.from_dict(algorithm_values(conf))
    with patched_step(bf16_step(alg)):
        line = run_cell(bench, cell, 2**31 + 34, 1.0, False,
                        torch.device("cpu"), 0.0, {"name": "cpu"})
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["label_ppm"]["value"] > checks["label_ppm"]["limit"]


def test_the_program_as_stated_is_correct(tmp_path):
    line = _run(tmp_path, "tiny.urban.offline")
    assert line["correct"] is True
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
