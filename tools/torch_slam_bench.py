#!/usr/bin/env python
"""SLAM end-to-end run of the PyTorch port on the card: a simulated closed
drive through the whole back end, one JSON line with the ATEs, the stage
times and the kernel launches.

The counterpart of tools/slam_bench.py (``simulate_loop_drive``, ``run``),
on ``patchwork_tpu_torch`` only: segmentation (``filter_ground_batched``:
the level path's kernels and binning's segment sum) -> ground-constrained
ICP odometry -> loop-closure detection -> degree-capped pose graph ->
landmark bundle adjustment (its segment sums over a plan of their ids, the
segment-sum kernel) -> map.  Each stage is timed on the host clock between
two ``torch.cuda.synchronize``; the launches are the kernel families'
counts (``fit_cuda.LAUNCHES``) over the run.

Usage:
  python tools/torch_slam_bench.py [--keyframes 100] [--icp parallel]
      [--json-out slam.json] [--device cpu]
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def simulate_loop_drive(num_frames: int, seed: int = 0,
                        num_pillars: int = 70, noise: float = 0.01,
                        laps: int = 1):
    """Closed circular drive through a pillar world; returns (scans, gt).

    ``laps`` > 1 keeps the per-frame motion constant as ``num_frames``
    grows: the vehicle circles the same loop again, so long runs exercise
    solver scale (keyframes, loop closures), not a larger world."""
    from patchwork_tpu_torch.io.synthetic import simulate_world

    world = simulate_world(seed=seed, num_pillars=num_pillars)
    rng = np.random.default_rng(seed)
    scans, gt = [], []
    pose = np.eye(4, dtype=np.float32)
    yaw_step = 2 * np.pi * laps / num_frames
    for _ in range(num_frames):
        inv = np.linalg.inv(pose).astype(np.float32)
        local = world @ inv[:3, :3].T + inv[:3, 3]
        local = local + rng.normal(0, noise, local.shape).astype(np.float32)
        scans.append(local.astype(np.float32))
        gt.append(pose.copy())
        c, s = np.cos(yaw_step), np.sin(yaw_step)
        step = np.eye(4, dtype=np.float32)
        step[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        step[0, 3] = 0.8
        pose = (pose @ step).astype(np.float32)
    return scans, np.stack(gt)


class _Stages:
    """Host seconds of each stage between two synchronizes and, with
    ``profile``, its device busy seconds (the CUDA kernels' and copies' own
    time under torch.profiler) and its five costliest kernels."""

    def __init__(self, dev, profile: bool):
        self.dev, self.profile = dev, profile and dev.type == "cuda"
        self.seconds, self.device = {}, {}

    def sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if self.profile else contextlib.nullcontext())
        self.sync()
        t0 = time.perf_counter()
        with prof:
            yield
            self.sync()
        self.seconds[name] = time.perf_counter() - t0
        if self.profile:
            evs = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in evs) / 1e6
            top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
            self.device[name] = {
                "busy_s": busy, "idle": 1.0 - busy / self.seconds[name],
                "kernels": sum(e.count for e in evs),
                "top": [[e.key[:60], e.self_device_time_total / 1e6, e.count]
                        for e in top]}


def run(num_keyframes: int = 100, seed: int = 3, ba_iters: int = 4,
        laps: int | None = None, icp: str = "sequential", batch: int = 8,
        pair_chunk: int = 32, max_candidates: int | None = None,
        map_out: str | None = None, device=None, keep: dict | None = None,
        profile: bool = False, log=print):
    """One session; returns the JSON dict it logs.  ``keep`` receives the
    odometry, the scans and the ground truth; ``profile`` adds each stage's
    device busy time (the profiler slows the host: time without it)."""
    import torch

    from patchwork_tpu_torch import PatchworkConfig
    from patchwork_tpu_torch.core.device import card_info, resolve_device
    from patchwork_tpu_torch.kernels import fit_cuda
    from patchwork_tpu_torch.slam import LidarOdometry
    from patchwork_tpu_torch.slam.landmarks import refine_with_ba
    from patchwork_tpu_torch.slam.odometry import OdometryConfig

    dev = resolve_device(device)
    stage = _Stages(dev, profile)
    if laps is None:
        laps = max(1, num_keyframes // 100)   # constant per-frame motion
    scans, gt = simulate_loop_drive(num_keyframes, seed=seed, laps=laps)
    before = dict(fit_cuda.LAUNCHES)

    with stage("odometry"):
        odo = LidarOdometry(
            patchwork=PatchworkConfig(filtering_radius=80.0, max_levels=1),
            cfg=OdometryConfig(capacity=32768, obstacle_samples=1024,
                               ground_samples=512, icp_iters=12),
            device=dev)
        odo.add_scans(scans, parallel_icp=(icp == "parallel"), batch=batch,
                      pair_chunk=pair_chunk)
    ate_odo = odo.trajectory_error(gt)
    with stage("loops"):
        # half a lap apart, within a radius that widens with the lap count
        accepted = odo.detect_loop_closures(
            radius=3.0 + 0.5 * (laps - 1),
            min_separation=max(10, num_keyframes // laps // 2),
            min_inliers=100, max_candidates=max_candidates,
            pair_chunk=pair_chunk)
    with stage("graph"):
        odo.optimize(iters=max(8, 2 * laps), max_degree=6)
    ate_graph = odo.trajectory_error(gt)
    ba_detail = {}
    with stage("ba"):
        refine_with_ba(odo, iters=ba_iters, timings=ba_detail)
    ate_ba = odo.trajectory_error(gt)
    launches = {k: v - before[k] for k, v in fit_cuda.LAUNCHES.items()}

    if map_out:
        from patchwork_tpu_torch.slam import save_map_ply

        n_vert = save_map_ply(map_out, odo, voxel=0.5)
        print(f"# map: {n_vert} vertices -> {map_out}", file=sys.stderr)
    if keep is not None:
        keep.update(odo=odo, scans=scans, gt=gt)

    out = {
        "metric": f"slam_e2e_{num_keyframes}kf_ate_rmse",
        "value": min(ate_graph, ate_ba),
        "unit": "m",
        "keyframes": num_keyframes,
        "icp": icp,
        "batch": batch,
        "pair_chunk": pair_chunk,
        "loop_closures": len(accepted),
        "ate_odometry_m": ate_odo,
        "ate_posegraph_m": ate_graph,
        "ate_ba_m": ate_ba,
        "wall_s": sum(stage.seconds.values()),
        "stage_s": stage.seconds,
        "odometry_detail": getattr(odo, "last_timings", {}),
        "ba_detail": ba_detail,
        "launches": {k: v for k, v in launches.items() if v},
        **({"stage_device": stage.device} if stage.profile else {}),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card_info() if dev.type == "cuda" else None,
    }
    log(json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=100)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--ba-iters", type=int, default=4)
    ap.add_argument("--laps", type=int, default=None,
                    help="loop laps (default keyframes//100: constant "
                         "per-frame motion at any scale)")
    ap.add_argument("--icp", default="sequential",
                    choices=["sequential", "parallel"],
                    help="odometry ICP chain: the sequential warm-started "
                         "chain, or batched pair solves")
    ap.add_argument("--batch", type=int, default=8,
                    help="scans per segmentation batch")
    ap.add_argument("--pair-chunk", type=int, default=32,
                    help="ICP pair solves per batch")
    ap.add_argument("--max-candidates", type=int, default=None,
                    help="loop-closure candidate budget (default ~K/3)")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    ap.add_argument("--profile", action="store_true",
                    help="each stage's device busy time (torch.profiler)")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--map-out", default=None,
                    help="write the optimized world-frame map as PLY")
    args = ap.parse_args()
    out = run(args.keyframes, args.seed, ba_iters=args.ba_iters,
              laps=args.laps, icp=args.icp, batch=args.batch,
              pair_chunk=args.pair_chunk, max_candidates=args.max_candidates,
              map_out=args.map_out, device=args.device,
              profile=args.profile)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
