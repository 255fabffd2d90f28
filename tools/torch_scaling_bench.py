#!/usr/bin/env python3
"""Weak scaling of the PyTorch port's sharded engines over 1..D ranks:
a fixed load a rank, efficiency t(1) / t(D).

The counterpart of tools/scaling_bench.py.  For each D in 1, 2, 4, ... up
to ``--max-ranks``, D x sp worker processes of
tools/torch_multihost_bench.py join one ``torch.distributed`` group on a
(D, sp) mesh and run ``make_sharded_pipeline`` on SCANS_PER_RANK demo
scans a dp rank, a fixed number of steps in lockstep (each step joins the
masks across the ranks): ms a step, the slowest rank's.  ``--sp 1`` is the
dp engine (whole scans a rank, the configuration's fused kernels); ``--sp
2`` the point-sharded engine (each rank segments its N/sp points of every
scan, every per-node statistic crossing the sp group).  For weak scaling
the ideal is a constant time a step as ranks and work grow together.

One card cannot give scaling numbers: NCCL refuses two ranks on one card
and gloo stages every collective through host memory; on the CPU the ranks
share the host's cores.  So on one card or on the CPU the tool checks the
mechanism; the numbers between cards wait for a machine with more than one.

Usage:
  python3 tools/torch_scaling_bench.py [--points 32768] [--max-ranks 4]
      [--sp 1] [--reps 3] [--device cpu] [--backend gloo]
      [--json-out scaling.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_multihost_bench as mh  # noqa: E402


def curve(points=32768, max_ranks=4, sp=1, reps=3, device="cuda",
          backend="gloo", timeout=600.0, log=print) -> dict:
    """ms a step and efficiency t(1) / t(D) for D = 1, 2, 4, ... ranks of
    dp (each with ``sp`` ranks of points)."""
    if device == "cuda":
        from patchwork_tpu_torch.kernels import _build

        _build.load()
    args = types.SimpleNamespace(
        points=points, device=device, backend=backend, bench_reps=reps,
        ba_steps=1, box_s=1.0, timeout=timeout, procs=None)
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= max_ranks]
    ms = {}
    for d in sizes:
        rows = mh.scale_arm(args, "scale", d * sp, sp=sp)
        ms[d] = max(r["ms_per_step"] for r in rows)
        log(f"  dp={d:3d} sp={sp} (batch {d * mh.SCANS_PER_RANK:3d}): "
            f"{ms[d]:9.2f} ms/step  weak-scaling efficiency "
            f"{100 * ms[sizes[0]] / ms[d]:6.1f}%")
    impl = "point-sharded" if sp > 1 else "dp"
    return {"metric": f"weak_scaling_efficiency_{impl}_dp{sizes[-1]}",
            "value": ms[sizes[0]] / ms[sizes[-1]], "unit": "ratio",
            "device": device, "backend": backend, "points": points,
            "scans_per_rank": mh.SCANS_PER_RANK, "sp": sp, "reps": reps,
            "ms_per_step": {str(d): t for d, t in ms.items()},
            "efficiency": {str(d): ms[sizes[0]] / t for d, t in ms.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--max-ranks", type=int, default=4,
                    help="the largest dp size D")
    ap.add_argument("--sp", type=int, default=1,
                    help="ranks of points per scan (1: the dp engine)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="gloo")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    try:
        out = curve(args.points, args.max_ranks, args.sp, args.reps,
                    args.device, args.backend, args.timeout)
    except RuntimeError as e:
        print(f"torch_scaling_bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
