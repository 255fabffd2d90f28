"""bench_torch.py, the port's benchmark, on the CPU at B=2 x 4096.

The cells, the JSON line, the correctness checks (on the CPU the kernel
path and the plain path are both the plain versions, so the bits against
plain test the plumbing), the scans against ``bench.py``'s generators, the
refusal without a card, and the imports.  The card-only test runs the
script as a process; it imports no JAX, and tests/conftest.py does, hence

    python -m pytest --noconftest tests/test_torch_bench.py -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from patchwork_tpu_torch import PatchworkConfig  # noqa: E402
from patchwork_tpu_torch.core.timing import DeviceWindow  # noqa: E402
from patchwork_tpu_torch.oracle.reference import (  # noqa: E402
    filter_ground_oracle)

B, N = 2, 4096
CPU = torch.device("cpu")


@pytest.mark.parametrize("cloud,headline_only,names", [
    ("velodyne", False,
     ["velodyne_fast", "velodyne_exact", "demo_fast", "fused_iac_fast"]),
    ("demo", False,
     ["demo_fast", "demo_exact", "velodyne_fast", "fused_iac_fast"]),
    ("velodyne", True, ["velodyne_fast"]),
])
def test_cells_and_names(cloud, headline_only, names):
    cells = bench_torch.bench_cells(cloud, N, B, headline_only)
    assert [c.name for c in cells] == names
    assert all(c.n == N and c.b == B for c in cells)
    assert [c.cfg.fast_covariance for c in cells] == [
        name.endswith("_fast") for name in names]


def test_default_flags_are_bench_py_s():
    args = bench_torch.parse_args([])
    assert (args.points, args.batch, args.reps, args.samples, args.seed,
            args.cloud, args.skip_baseline, args.headline_only) == (
        131072, 8, 20, 10, 0, "velodyne", False, False)
    names = [c.name for c in bench_torch.bench_cells(
        args.cloud, args.points, args.batch, args.headline_only)]
    assert names == ["velodyne_fast", "velodyne_exact", "demo_fast",
                     "fused_iac_fast"]
    with pytest.raises(SystemExit):
        bench_torch.parse_args(["--samples", "9"])


def _record(cell, ms, checks):
    return bench_torch.cell_record(
        cell, 3, ms, 5, DeviceWindow(busy_ms=1.5, span_ms=6.0, kernels=12),
        {"level": 9, "seg_sum": 1, "fit_level": 0}, checks)


def test_record_and_line():
    cells = bench_torch.bench_cells("velodyne", N, B)
    ms = [8.0, 4.0, 5.0, 10.0, 2.0]          # ms per batch of 2 scans
    good = {c.name: _record(c, ms, {"bits_vs_plain": 0, "iou_vs_exact": 1.0}
                            if c.mode == "fast" else
                            {"bits_vs_plain": 0, "bits_vs_oracle": 0})
            for c in cells}
    rec = good["velodyne_fast"]
    assert rec["median_scans_per_s"] == 400.0       # 2 scans in 5 ms
    assert (rec["min_scans_per_s"], rec["max_scans_per_s"]) == (200.0, 1000.0)
    assert (rec["samples"], rec["reps"], rec["seeds"]) == (5, 5, [3, 4])
    assert (rec["busy_ms"], rec["span_ms"], rec["idle"]) == (1.5, 6.0, 0.75)
    assert rec["launches"] == {"level": 9, "seg_sum": 1}
    assert rec["ok"]

    device = {"name": "card", "power_limit": "700.00 W", "count": 1}
    line = bench_torch.bench_line("velodyne", N, good,
                                  {"velodyne": 4.0, "demo": 8.0}, device)
    text = json.dumps(line)
    assert "\n" not in text and json.loads(text) == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra",
                         "correct", "device", "cells"}
    assert line["metric"] == f"torch_velodyne_{N}pt_fast_scans_per_s"
    assert "synthetic_" not in line["metric"]
    assert (line["value"], line["unit"], line["vs_baseline"]) == (
        400.0, "scans/s", 100.0)
    assert line["extra"] == {
        "velodyne_exact_scans_per_s": 400.0, "demo_fast_scans_per_s": 400.0,
        "fused_iac_fast_scans_per_s": 400.0,
        "velodyne_oracle_scans_per_s": 4.0, "demo_oracle_scans_per_s": 8.0,
        "demo_fast_vs_baseline": 50.0}
    assert line["correct"] and line["device"] == device
    assert set(line["cells"]) == set(good)
    for rec in line["cells"].values():
        for key in ("median_scans_per_s", "min_scans_per_s",
                    "max_scans_per_s", "samples", "reps", "busy_ms",
                    "span_ms", "idle", "launches", "bits_vs_plain"):
            assert key in rec
        assert ("iou_vs_exact" in rec) == (rec["mode"] == "fast")
        assert ("bits_vs_oracle" in rec) == (rec["mode"] == "exact")

    # no baseline: vs_baseline None, no oracle keys
    assert bench_torch.bench_line("velodyne", N, good, {}, device)[
        "vs_baseline"] is None


@pytest.mark.parametrize("bad", [{"bits_vs_plain": 1, "iou_vs_exact": 1.0},
                                 {"bits_vs_plain": 0, "iou_vs_exact": 0.998},
                                 {"bits_vs_plain": 0, "bits_vs_oracle": 3}])
def test_line_is_incorrect_on_any_failed_check(bad):
    cells = bench_torch.bench_cells("velodyne", N, B)
    recs = {c.name: _record(c, [5.0] * 10, {"bits_vs_plain": 0,
                                            "iou_vs_exact": 1.0})
            for c in cells}
    recs["demo_fast"] = _record(cells[2], [5.0] * 10, bad)
    line = bench_torch.bench_line("velodyne", N, recs, {}, {})
    assert not recs["demo_fast"]["ok"] and line["correct"] is False


def test_mask_bits_counts_every_mask():
    a = [np.zeros(8, bool) for _ in range(4)]
    b = [m.copy() for m in a]
    b[1][2] = b[3][0] = b[3][7] = True
    assert bench_torch.mask_bits(a, a) == 0
    assert bench_torch.mask_bits(a, [torch.from_numpy(m) for m in b]) == 3


@pytest.mark.parametrize("cloud", ["velodyne", "demo"])
def test_exact_cell_checks_on_the_cpu(cloud):
    cell = bench_torch.Cell(cloud, N, B, PatchworkConfig())
    scans = cell.scans(0, CPU)
    masks = filter_ground_oracle(scans[0], PatchworkConfig())
    checks = bench_torch.cell_checks(cell, *bench_torch.upload(scans, CPU),
                                     masks)
    assert checks == {"bits_vs_plain": 0, "bits_vs_oracle": 0}
    # a flipped oracle bit is seen
    masks[0][np.flatnonzero(masks[2])[0]] ^= True
    assert bench_torch.cell_checks(cell, *bench_torch.upload(scans, CPU),
                                   masks)["bits_vs_oracle"] == 1
    with pytest.raises(ValueError, match="oracle"):
        bench_torch.cell_checks(cell, *bench_torch.upload(scans, CPU))


@pytest.mark.parametrize("cloud", ["velodyne", "demo", "fused_iac"])
def test_fast_cell_checks_on_the_cpu(cloud):
    cell = bench_torch.Cell(cloud, N, B, PatchworkConfig(fast_covariance=True))
    checks = bench_torch.cell_checks(
        cell, *bench_torch.upload(cell.scans(0, CPU), CPU))
    assert checks["bits_vs_plain"] == 0
    assert checks["iou_vs_exact"] >= bench_torch.IOU_FAST_MIN
    assert bench_torch.checks_pass(checks)


@pytest.mark.parametrize("cloud", ["velodyne", "demo", "fused_iac"])
def test_same_scans_as_bench_py(cloud):
    jax = pytest.importorskip("jax")
    jsyn = pytest.importorskip("patchwork_tpu.io.synthetic")
    gen = {"velodyne": jsyn.velodyne_like_cloud,
           "demo": jsyn.demo_point_cloud,
           "fused_iac": jsyn.fused_iac_cloud}[cloud]
    got = bench_torch.Cell(cloud, N, 2, PatchworkConfig()).scans(0, CPU)
    # bench.py's scans, the JAX fusion on the CPU as the port's here
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.stack([gen(N, seed=i) for i in range(2)])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_no_card_no_numbers(monkeypatch, capsys):
    floors = os.path.join(ROOT, "BENCH_FLOORS.json")
    with open(floors, "rb") as f:
        before = f.read()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(["--headline-only", "--skip-baseline"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    with open(floors, "rb") as f:
        assert f.read() == before


def test_no_card_process_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                          "--headline-only"], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_imports_no_jax():
    code = ("import sys; sys.path.insert(0, {!r}); import bench_torch; "
            "sys.exit(int(any(m == 'jax' or m.startswith(('jax.', "
            "'patchwork_tpu.')) or m in ('patchwork_tpu', 'chip_smoke') "
            "for m in sys.modules)))").format(ROOT)
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          timeout=120).returncode == 0


def test_event_samples_refuse_the_cpu():
    from patchwork_tpu_torch.core.timing import event_samples

    with pytest.raises(ValueError, match="CUDA"):
        event_samples(lambda: None, 10, 2, CPU)


@pytest.mark.cuda
def test_bench_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark times the card")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"),
         "--headline-only", "--skip-baseline", "--reps", "2"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True
    assert line["device"]["name"] == torch.cuda.get_device_name(0)
    cell = line["cells"]["velodyne_fast"]
    assert cell["samples"] >= 10 and cell["launches"]["level"] > 0
