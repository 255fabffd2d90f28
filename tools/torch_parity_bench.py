#!/usr/bin/env python3
"""Parity and latency of the PyTorch port's segment-op impls and the whole
engine, each exact mask held to the port's NumPy oracle: the reference's
test_cuda analogue.

The counterpart of tools/parity_bench.py (and, with ``--batch``, of
tools/fused_bench.py).  The reference's test_cuda.cpp (src/test_cuda.cpp:
58-138) times each op on a 100k-point uniform cube and checks elementwise
parity; here, on the card unless ``--device cpu``:

1. the elementwise trio ``rotate_2d``, ``transform_4x4`` and ``ego_mask``
   on ``uniform_cube_cloud`` (``--points`` rounded up to a power of two,
   as the JAX tool does), timed by CUDA events, and the rotation against
   NumPy (max error below 1e-4);
2. the whole engine on ``demo_point_cloud`` per segment impl: ms a scan,
   scans/s and ground count, and its exact masks against the plain path
   (``filter_ground(..., plain=True)`` under the default impl, the
   kernels' plain versions) and against ``oracle.reference``;
3. with ``--batch B`` (B > 1), B scans of ``--cloud`` through
   ``filter_ground_batched`` per impl: scans/s and the masks against the
   first bit-for-bit impl's (``"fused"`` or ``"pallas"``).

The contract, stronger than the JAX tool's IoU-level one for ``"pallas"``:
``"fused"`` and ``"pallas"`` equal the plain path and the oracle bit for
bit; ``"scatter"`` adds with ``index_add_``, float atomics in no fixed
order on the card, so it is held to IoU >= 0.999 and its mismatches are
reported.  ``"onehot"`` is an alias of ``"scatter"`` in the port
(``segment/segops.py``): it is listed as such and not timed twice.
Prints a line per measurement and one JSON line; exits 1 on any failure.

Usage:
  python3 tools/torch_parity_bench.py [--points 100000]
      [--impls scatter onehot pallas fused] [--reps 3] [--batch 8]
      [--cloud demo] [--device cpu] [--json-out parity.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

IOU_MIN = 0.999
ROT_TOL = 1e-4
ALIASES = {"onehot": "scatter"}
BITWISE = ("fused", "pallas")


def _iou(a, b) -> float:
    return float((a & b).sum()) / max(float((a | b).sum()), 1.0)


def run(points=100000, impls=("scatter", "onehot", "pallas", "fused"), reps=3,
        batch=0, cloud="demo", device=None, log=print) -> dict:
    """Every measurement and check of the tool; ``out["ok"]`` is False on
    any failure."""
    import torch
    from patchwork_tpu_torch import PatchworkConfig, filter_ground
    from patchwork_tpu_torch import filter_ground_batched
    from patchwork_tpu_torch.core.device import resolve_device
    from patchwork_tpu_torch.core.timing import time_ms
    from patchwork_tpu_torch.io.synthetic import (demo_point_cloud,
                                                  uniform_cube_cloud,
                                                  velodyne_like_cloud)
    from patchwork_tpu_torch.ops.pointcloud import (ego_mask, rotate_2d,
                                                    transform_4x4)
    from patchwork_tpu_torch.oracle.reference import filter_ground_oracle

    dev = resolve_device(device)
    n = 1 << (points - 1).bit_length()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}  points: {n}")
    out = {"metric": "parity_bench", "points": n, "device": name,
           "elementwise_ms": {}, "engine": {}, "aliases": {}, "failures": []}

    def fail(msg):
        out["failures"].append(msg)

    # -- 1. the elementwise trio on the uniform cube ---------------------
    cube = torch.from_numpy(uniform_cube_cloud(n, seed=0)).to(dev)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [1, 2, 3]
    t = torch.from_numpy(t).to(dev)
    for op, fn in (("rotate_2d", lambda: rotate_2d(cube, 45.0)),
                   ("transform_4x4", lambda: transform_4x4(cube, t)),
                   ("ego_mask", lambda: ego_mask(cube, 2.5))):
        ms = time_ms(fn, reps, dev)
        out["elementwise_ms"][op] = ms
        log(f"  {op:16s} {ms:8.3f} ms")
    ref = cube.cpu().numpy()
    c, s = np.cos(np.deg2rad(45.0)), np.sin(np.deg2rad(45.0))
    expect = ref.copy()
    expect[:, 0] = ref[:, 0] * c - ref[:, 1] * s
    expect[:, 1] = ref[:, 0] * s + ref[:, 1] * c
    err = float(np.abs(rotate_2d(cube, 45.0).cpu().numpy() - expect).max())
    out["rotation_max_err"] = err
    log(f"  rotation parity vs host: max err {err:.2e} "
        f"({'PASS' if err < ROT_TOL else 'FAIL'})")
    if not err < ROT_TOL:
        fail(f"rotation max error {err}")

    # -- 2. the engine per segment impl on one scene ---------------------
    scene = demo_point_cloud(n, seed=0)
    xyz = torch.from_numpy(scene).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    cfg = PatchworkConfig()
    plain = filter_ground(xyz, valid, cfg, plain=True).ground.cpu().numpy()
    oracle = filter_ground_oracle(scene, cfg)[0]
    d = int((plain != oracle).sum())
    out["plain_vs_oracle_bits"] = d
    log(f"  plain path vs oracle: {d} differing mask bits")
    if d:
        fail(f"the plain path differs from the oracle in {d} bits")
    timed = []
    for impl in impls:
        if impl in ALIASES:
            out["aliases"][impl] = ALIASES[impl]
            log(f"  engine[{impl:8s}] alias of {ALIASES[impl]!r} in the port:"
                f" not timed twice")
            continue
        c_impl = cfg.replace(segment_impl=impl)
        g = filter_ground(xyz, valid, c_impl).ground
        ms = time_ms(lambda: filter_ground(xyz, valid, c_impl), reps, dev,
                     warm=0)
        g = g.cpu().numpy()
        rec = {"ms": ms, "scans_per_s": 1e3 / ms, "ground": int(g.sum()),
               "bits_vs_plain": int((g != plain).sum()),
               "bits_vs_oracle": int((g != oracle).sum()),
               "iou_vs_plain": _iou(g, plain), "iou_vs_oracle": _iou(g, oracle)}
        out["engine"][impl] = rec
        timed.append(impl)
        if impl in BITWISE:
            good = rec["bits_vs_plain"] == 0 and rec["bits_vs_oracle"] == 0
            rule = "bit for bit"
        else:
            good = (rec["iou_vs_plain"] >= IOU_MIN
                    and rec["iou_vs_oracle"] >= IOU_MIN)
            rule = f"IoU >= {IOU_MIN}"
        log(f"  engine[{impl:8s}] {ms:8.2f} ms/scan ({rec['scans_per_s']:7.1f}"
            f" scans/s)  ground={rec['ground']}  vs plain "
            f"{rec['bits_vs_plain']} / vs oracle {rec['bits_vs_oracle']} "
            f"mismatches, IoU {rec['iou_vs_oracle']:.6f} "
            f"({'PASS' if good else 'FAIL'} {rule})")
        if not good:
            fail(f"engine[{impl}] breaks its contract ({rule}): {rec}")

    # -- 3. the batch arm -------------------------------------------------
    if batch > 1:
        gen = {"demo": demo_point_cloud, "velodyne": velodyne_like_cloud}[cloud]
        xb = torch.from_numpy(np.stack([gen(n, seed=i) for i in range(batch)]))
        xb = xb.to(dev)
        vb = torch.ones(xb.shape[:2], dtype=torch.bool, device=dev)
        out["batch"] = {"cloud": cloud, "batch": batch, "impls": {}}
        masks = {}
        # held to a bitwise impl where one runs
        first_impl = next((i for i in timed if i in BITWISE), timed[0])
        for impl in [first_impl] + [i for i in timed if i != first_impl]:
            c_impl = cfg.replace(segment_impl=impl)
            masks[impl] = filter_ground_batched(xb, vb, c_impl).ground.cpu()
            ms = time_ms(lambda: filter_ground_batched(xb, vb, c_impl), reps,
                         dev, warm=0)
            first = masks[first_impl]
            rec = {"scans_per_s": batch * 1e3 / ms, "ms": ms,
                   "bits_vs_first": int((masks[impl] != first).sum()),
                   "iou_vs_first": _iou(masks[impl].numpy(), first.numpy())}
            out["batch"]["impls"][impl] = rec
            both_bitwise = impl in BITWISE and first_impl in BITWISE
            good = (rec["bits_vs_first"] == 0 if both_bitwise
                    else rec["iou_vs_first"] >= IOU_MIN)
            log(f"  batch {cloud} B={batch} [{impl:8s}] "
                f"{rec['scans_per_s']:9.2f} scans/s; masks vs {first_impl}: "
                f"{rec['bits_vs_first']} mismatches ({'PASS' if good else 'FAIL'})")
            if not good:
                fail(f"batch [{impl}] masks differ from {first_impl}: {rec}")

    out["ok"] = not out["failures"]
    log("ALL PARITY PASS" if out["ok"] else "PARITY FAILURES")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=100000)
    ap.add_argument("--impls", nargs="+",
                    default=["scatter", "onehot", "pallas", "fused"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=0,
                    help="B > 1: the batch arm (tools/fused_bench.py's)")
    ap.add_argument("--cloud", choices=["demo", "velodyne"], default="demo")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    out = run(args.points, args.impls, args.reps, args.batch, args.cloud,
              args.device)
    print(json.dumps(out), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
