"""Readings that set the limits of ``correct``: runs of a cell with the
program as the configuration states it, or with a control in its place.

    python3 -m benchmark.control --workload NAME --seeds A,B,C \
        --seconds S --control none|bf16

``none``: the program as configured (the lower readings).  ``bf16``: the
benchmark's reference, computed on the scans rounded to bfloat16, the
precision below the float32 the configuration states, answers in the
node's place (``PatchworkNode._step``).  One JSON line a seed on stdout:
the compared numbers.  The benchmark's own runs never run this; it needs
a card, as they do.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import reference
from .harness import algorithm_values, run_cell
from .manifest import Manifest
from .run import ROOT, card_info, process_start

__all__ = ["bf16_step", "patched_step"]


def bf16_step(alg: reference.Algorithm):
    """A stand-in for ``PatchworkNode._step``: the reference on each
    scan's valid rows rounded to bfloat16."""

    def step(node, xyz, valid):
        b, cap, _ = xyz.shape
        ground = torch.zeros((b, cap), dtype=torch.bool)
        ok = valid.cpu()
        for slot in range(b):
            rows = xyz[slot].cpu()[ok[slot]]
            pts = rows.to(torch.bfloat16).to(torch.float32).numpy()
            g, _, _, _ = reference.filter_ground(pts, alg)
            ground[slot, : len(g)] = torch.from_numpy(g)
        ground = ground.to(xyz.device)
        v = valid & torch.isfinite(xyz).all(-1)
        return ground, v, ground.sum(-1), (v & ~ground).sum(-1)

    return step


@contextlib.contextmanager
def patched_step(step):
    """``PatchworkNode._step`` replaced by ``step(node, xyz, valid)``."""
    from patchwork_tpu_torch.node import PatchworkNode

    orig = PatchworkNode._step
    PatchworkNode._step = step
    try:
        yield
    finally:
        PatchworkNode._step = orig


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", choices=("none", "bf16"),
                    default="none")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = Manifest(ROOT)
    card = card_info()
    conf = bench.config(bench.cell(args.workload).config)
    alg = reference.Algorithm.from_dict(algorithm_values(conf))
    step = (patched_step(bf16_step(alg)) if args.control == "bf16"
            else contextlib.nullcontext())
    with step:
        for seed in (int(s) for s in args.seeds.split(",")):
            with contextlib.redirect_stdout(sys.stderr):
                line = run_cell(bench, args.workload, seed, args.seconds,
                                False, torch.device("cuda", 0), t_start,
                                card)
            rec = {"workload": args.workload, "control": args.control,
                   "seed": seed, "correct": line["correct"],
                   "attempted": line["attempted"],
                   **{k: c["value"] for k, c in line["checks"].items()},
                   "card": card}
            print(json.dumps(rec), flush=True)
            t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
