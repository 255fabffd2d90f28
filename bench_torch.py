#!/usr/bin/env python3
"""Benchmark: scans/s of the PyTorch / CUDA port on the card against the
single-core NumPy oracle.

    python3 bench_torch.py          # from the repository root; needs one GPU

The port's counterpart of ``bench.py`` (which times the JAX package).  It
prints ONE JSON line on stdout, last; everything else goes to stderr:

  {"metric": ..., "value": N, "unit": "scans/s", "vs_baseline": N,
   "extra": {...}, "correct": true, "device": {...}, "cells": {...}}

The cells are ``bench.py``'s: the headline ``{cloud}`` fast (``value``),
``{cloud}`` exact, the other cloud fast and the fused 3-LiDAR IAC cloud
fast, each B scans of N points from seeds ``seed .. seed+B-1``
(``--seed 0`` gives ``bench.py``'s scans), through
``filter_ground_batched`` on the card.  Each cell is checked before it is
timed, on the same batch: every bit of the four masks against the plain
path (``plain=True``), scan 0 of an exact cell against the oracle
(``oracle/reference.py``), a fast cell's ground IoU against the same batch
in exact mode (at least 0.999).  Then, per cell: the kernel launches of one
untimed batch per family (``fit_cuda.LAUNCHES``), ``--samples`` samples of
CUDA events around ``--reps`` back-to-back batches (median, min and max
scans/s), and one window of ``--reps`` batches under ``torch.profiler``
(device busy ms per batch from the CUDA kernels' rows, the window's span
per batch, the idle share).  The baseline, as in ``bench.py``, is the
oracle on scan 0 of the headline cloud and of the other cloud, exact.

Without a CUDA device the script exits non-zero and prints no line of
numbers: it has no CPU mode.  A failed check sets ``"correct": false`` and
exit code 1, the line still printed.  It reads and writes no file of the
repository (the kernels' build goes to ``build/``, as every entry point's).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
from patchwork_tpu_torch.core.types import GroundResult
from patchwork_tpu_torch.io.synthetic import (demo_point_cloud,
                                              fused_iac_cloud,
                                              velodyne_like_cloud)

MIN_SAMPLES = 10
IOU_FAST_MIN = 0.999      # tests/test_fast_mode.py's contract
ORACLE_MIN_S = 0.5        # bench.py's oracle timing: 0.5 s or 3 calls
MASKS = ("ground", "valid", "in_zone", "in_patch")

# cloud -> (n, seed, device) -> (n, 3) float32 scan
CLOUDS: Dict[str, Callable[[int, int, torch.device], np.ndarray]] = {
    "velodyne": lambda n, seed, dev: velodyne_like_cloud(n, seed=seed),
    "demo": lambda n, seed, dev: demo_point_cloud(n, seed=seed),
    # merged on the card by the port's LidarFusion
    "fused_iac": lambda n, seed, dev: fused_iac_cloud(n, seed=seed,
                                                      device=dev),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One timed configuration: ``b`` scans of ``n`` points of ``cloud``,
    segmented under ``cfg``."""

    cloud: str
    n: int
    b: int
    cfg: PatchworkConfig

    @property
    def mode(self) -> str:
        return "fast" if self.cfg.fast_covariance else "exact"

    @property
    def name(self) -> str:
        return f"{self.cloud}_{self.mode}"

    def scans(self, seed: int, device) -> np.ndarray:
        """(b, n, 3) float32: the scans of seeds ``seed .. seed+b-1``."""
        gen = CLOUDS[self.cloud]
        return np.stack([gen(self.n, s, device)
                         for s in range(seed, seed + self.b)])


def bench_cells(cloud: str, n: int, b: int,
                headline_only: bool = False) -> List[Cell]:
    """``bench.py``'s cells, the headline first."""
    fast = PatchworkConfig(fast_covariance=True)
    exact = PatchworkConfig(fast_covariance=False)
    cells = [Cell(cloud, n, b, fast)]
    if not headline_only:
        cells += [Cell(cloud, n, b, exact),
                  Cell(other_cloud(cloud), n, b, fast),
                  Cell("fused_iac", n, b, fast)]
    return cells


def other_cloud(cloud: str) -> str:
    return "demo" if cloud == "velodyne" else "velodyne"


def upload(scans: np.ndarray, device):
    """The batch on ``device``, all points valid."""
    xyz = torch.from_numpy(scans).to(device)
    return xyz, torch.ones(xyz.shape[:2], dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# correctness, on the batch that is timed
# ---------------------------------------------------------------------------

def _masks(r) -> list:
    """The four masks of a GroundResult, or a (ground, valid, in_zone,
    in_patch) sequence of tensors or arrays, as NumPy arrays."""
    ms = [getattr(r, m) for m in MASKS] if isinstance(r, GroundResult) else r
    return [m.cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
            for m in ms]


def mask_bits(a, b) -> int:
    """Differing bits over the four masks of two results of one shape."""
    return sum(int(np.count_nonzero(x != y))
               for x, y in zip(_masks(a), _masks(b), strict=True))


def min_iou(a: torch.Tensor, b: torch.Tensor) -> float:
    """Smallest per-scan IoU of two (B, N) bool masks."""
    inter = (a & b).sum(1).double()
    union = (a | b).sum(1).double().clamp(min=1)
    return float((inter / union).min())


def cell_checks(cell: Cell, xyz: torch.Tensor, valid: torch.Tensor,
                oracle_masks=None) -> dict:
    """The cell's checks on its batch: ``bits_vs_plain`` (the kernel path
    against ``plain=True``, four masks), and ``bits_vs_oracle`` (scan 0 of
    an exact cell against ``oracle_masks``, the oracle's four masks of that
    scan) or ``iou_vs_exact`` (a fast cell's smallest per-scan ground IoU
    against the same batch in exact mode)."""
    got = filter_ground_batched(xyz, valid, cell.cfg)
    checks = {"bits_vs_plain": mask_bits(
        got, filter_ground_batched(xyz, valid, cell.cfg, plain=True))}
    if cell.cfg.fast_covariance:
        exact = filter_ground_batched(
            xyz, valid, dataclasses.replace(cell.cfg, fast_covariance=False))
        checks["iou_vs_exact"] = min_iou(got.ground, exact.ground)
    else:
        if oracle_masks is None:
            raise ValueError(f"{cell.name}: an exact cell is held to the "
                             "oracle's masks of its scan 0")
        checks["bits_vs_oracle"] = mask_bits(
            [getattr(got, m)[0] for m in MASKS], oracle_masks)
    return checks


def checks_pass(checks: dict) -> bool:
    return (checks["bits_vs_plain"] == 0
            and checks.get("bits_vs_oracle", 0) == 0
            and checks.get("iou_vs_exact", 1.0) >= IOU_FAST_MIN)


def oracle_run(scan: np.ndarray, cfg: PatchworkConfig):
    """Scans/s of the NumPy oracle on one scan by ``bench.py``'s rule
    (calls until ``ORACLE_MIN_S`` seconds or three calls), and its masks."""
    from patchwork_tpu_torch.oracle.reference import filter_ground_oracle

    t0 = time.perf_counter()
    reps = 0
    while True:
        masks = filter_ground_oracle(scan, cfg)
        reps += 1
        dt = time.perf_counter() - t0
        if dt >= ORACLE_MIN_S or reps >= 3:
            return reps / dt, masks


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def cell_record(cell: Cell, seed: int, ms: List[float], reps: int, window,
                launches: dict, checks: dict) -> dict:
    """One cell's entry of the line.  ``ms``: milliseconds per batch of
    each timed sample; ``window``: a ``core.timing.DeviceWindow`` per
    batch; ``launches``: kernel launches of one batch per family."""
    rates = sorted(cell.b * 1e3 / t for t in ms)
    return {"cloud": cell.cloud, "mode": cell.mode, "points": cell.n,
            "batch": cell.b, "seeds": [seed, seed + cell.b - 1],
            "median_scans_per_s": statistics.median(rates),
            "min_scans_per_s": rates[0], "max_scans_per_s": rates[-1],
            "samples": len(ms), "reps": reps,
            "busy_ms": window.busy_ms, "span_ms": window.span_ms,
            "idle": 1.0 - window.busy_ms / window.span_ms,
            "launches": {k: v for k, v in launches.items() if v},
            **checks, "ok": checks_pass(checks)}


def bench_line(cloud: str, n: int, cells: Dict[str, dict],
               oracle_rates: Dict[str, float], device: dict) -> dict:
    """The JSON line: ``bench.py``'s keys (``extra`` holds each other
    cell's median and the oracle's rates), ``correct``, ``device`` and
    ``cells``."""
    head = cells[f"{cloud}_fast"]["median_scans_per_s"]
    extra = {f"{name}_scans_per_s": c["median_scans_per_s"]
             for name, c in cells.items() if name != f"{cloud}_fast"}
    for c, rate in oracle_rates.items():
        extra[f"{c}_oracle_scans_per_s"] = rate
        if c != cloud:
            extra[f"{c}_fast_vs_baseline"] = (
                cells[f"{c}_fast"]["median_scans_per_s"] / rate)
    return {"metric": f"torch_{cloud}_{n}pt_fast_scans_per_s",
            "value": head, "unit": "scans/s",
            "vs_baseline": (head / oracle_rates[cloud]
                            if cloud in oracle_rates else None),
            "extra": extra,
            "correct": all(c["ok"] for c in cells.values()),
            "device": device, "cells": cells}


def device_record() -> dict:
    """The card's name and power limit (nvidia-smi) and the device count."""
    from patchwork_tpu_torch.core.device import card_info

    name, limit = card_info().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip(),
            "count": torch.cuda.device_count()}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def measure_cell(cell: Cell, xyz: torch.Tensor, valid: torch.Tensor,
                 samples: int, reps: int):
    """On the card: the launches of one untimed batch per family, then
    ``samples`` event samples of ``reps`` batches (ms per batch), then one
    profiled window of ``reps`` batches."""
    from patchwork_tpu_torch.core.timing import device_busy_ms, event_samples
    from patchwork_tpu_torch.kernels import fit_cuda

    def run():
        filter_ground_batched(xyz, valid, cell.cfg)

    fit_cuda.reset_launches()
    run()
    torch.cuda.synchronize(xyz.device)
    launches = dict(fit_cuda.LAUNCHES)
    ms = event_samples(run, samples, reps, xyz.device)
    window = device_busy_ms(run, reps, warm=0)
    return ms, window, launches


def _samples(text: str) -> int:
    k = int(text)
    if k < MIN_SAMPLES:
        raise argparse.ArgumentTypeError(
            f"at least {MIN_SAMPLES} samples (a median and a range need them)")
    return k


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=131072,
                    help="points per scan (KITTI-360 scale)")
    ap.add_argument("--batch", type=int, default=8, help="scans per batch")
    ap.add_argument("--reps", type=int, default=20,
                    help="back-to-back batches in a sample and in the "
                         "profiled window")
    ap.add_argument("--samples", type=_samples, default=MIN_SAMPLES,
                    help=f"timed samples per cell (at least {MIN_SAMPLES})")
    ap.add_argument("--seed", type=int, default=0,
                    help="scans are made from seeds SEED .. SEED+BATCH-1")
    ap.add_argument("--skip-baseline", action="store_true",
                    help="do not time the NumPy oracle (exact cells are "
                         "still held to it)")
    ap.add_argument("--cloud", choices=["velodyne", "demo"],
                    default="velodyne", help="the headline cloud")
    ap.add_argument("--headline-only", action="store_true",
                    help="only the headline cell ({cloud} fast)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device (it times the card and has no CPU "
              "mode)", file=sys.stderr)
        return 1
    # stdout carries the line alone
    with contextlib.redirect_stdout(sys.stderr):
        line = run(args)
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


def run(args: argparse.Namespace) -> dict:
    from patchwork_tpu_torch.core.device import cuda_device
    from patchwork_tpu_torch.kernels import _build
    from patchwork_tpu_torch.oracle.reference import filter_ground_oracle

    def log(msg: str) -> None:
        print(f"# {msg}", file=sys.stderr, flush=True)

    dev = cuda_device()
    device = device_record()
    _build.load()
    log(f"{device['name']}, {device['power_limit']}; kernels built and "
        f"loaded in {_build.build_seconds():.1f} s")
    cfg_exact = PatchworkConfig(fast_covariance=False)
    timed = set() if args.skip_baseline else {args.cloud}
    if not (args.skip_baseline or args.headline_only):
        timed.add(other_cloud(args.cloud))
    oracle = {}     # cloud -> (scans/s or None, the masks of its scan 0)
    cells = {}
    for cell in bench_cells(args.cloud, args.points, args.batch,
                            args.headline_only):
        scans = cell.scans(args.seed, dev)
        wanted = cell.cloud in timed or cell.mode == "exact"
        if wanted and cell.cloud not in oracle:
            oracle[cell.cloud] = (
                oracle_run(scans[0], cfg_exact) if cell.cloud in timed
                else (None, filter_ground_oracle(scans[0], cfg_exact)))
        xyz, valid = upload(scans, dev)
        t0 = time.perf_counter()
        checks = cell_checks(cell, xyz, valid,
                             oracle.get(cell.cloud, (None, None))[1])
        t_checks = time.perf_counter() - t0
        ms, window, launches = measure_cell(cell, xyz, valid, args.samples,
                                            args.reps)
        rec = cells[cell.name] = cell_record(cell, args.seed, ms, args.reps,
                                             window, launches, checks)
        log(f"{cell.name} B={cell.b} N={cell.n}: "
            f"{rec['median_scans_per_s']:.1f} scans/s "
            f"({rec['min_scans_per_s']:.1f}-{rec['max_scans_per_s']:.1f}, "
            f"{len(ms)} x {args.reps} batches); busy {window.busy_ms:.3f} of "
            f"{window.span_ms:.3f} ms a batch (idle {rec['idle']:.3f}); "
            f"launches {rec['launches']}; checks {checks} in "
            f"{t_checks:.1f} s: {'ok' if rec['ok'] else 'FAILED'}")
    rates = {c: oracle[c][0] for c in sorted(timed)}
    for c, rate in rates.items():
        log(f"cpu oracle ({c}, scan 0, exact): {rate:.3f} scans/s")
    return bench_line(args.cloud, args.points, cells, rates, device)


if __name__ == "__main__":
    sys.exit(main())
