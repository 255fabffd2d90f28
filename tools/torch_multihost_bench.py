#!/usr/bin/env python3
"""Run the PyTorch port's ``parallel/`` in several OS processes, one rank of
a ``torch.distributed`` group each, and hold every sharded entry point to
the same computation run on one process.

The counterpart of tools/multihost_bench.py: its launcher, parity worker
and, with ``--scaling``, its weak-scaling arms (below).  The launcher
spawns ``--procs`` workers of this script; they meet through a
``FileStore`` in a temporary directory (no port, so parallel runs cannot
collide).  Every worker:

1. joins the group (``parallel.initialize_multihost``) and builds two
   meshes: (P, 1) for the scan-sharded engine and bundle adjustment, and
   (P / 2, 2) for the point-sharded engines (``--procs`` even);
2. runs the dp engine (``make_sharded_filter_ground``, whole scans), the
   pipeline (``make_sharded_pipeline`` on the (P / 2, 2) mesh, whole
   scans, replicated over sp), the sp engine (points sharded: each rank
   segments its own N/2 points of every scan, and per-node blocks cross
   the sp pair) on the engines' batch, on a split-heavy batch when one is
   given (its remap levels take the median across ranks) and with
   ``adaptive_seed_height=False`` (the percentile), the explicit-collective
   engine on ``PatchworkConfig.patchwork()`` and ``bundle_adjust_sharded``,
   dense and PCG, each twice;
3. compares each result with the same computation on one process:
   ``filter_ground_batched`` with the impl the entry point runs, the
   explicit engine on the whole scans (``patchwork_level``) and the
   configuration's own single-device engine, ``bundle_adjust``;
4. writes its record: differing mask bits per engine, the largest pose and
   point difference of BA, whether two BA runs gave the same bits, the
   launches per kernel family, the collectives, the peak of the card's
   allocator and the order statistics taken across ranks of each entry
   point's timed call, times (by CUDA events on the card, the host clock
   on the CPU), the device busy time of one call of each sp arm
   (torch.profiler, on the card), and the cost of one ``ordered_sum`` of a
   CG iteration's (K, 6) and (L, 3) blocks.

If a worker fails, the launcher kills the others and exits non-zero; it
exits non-zero too if any check fails.  On the card it builds the kernels
before it spawns (``kernels/_build.load``), so the workers find them built.
Two ranks on one card need ``--backend gloo`` (NCCL refuses two ranks on
one device); gloo's collectives on CUDA tensors go through host memory.

Inputs: ``--inputs FILE.npz`` (arrays made from a seed by the caller) with
any of ``xyz`` (B, N, 3) / ``valid`` (B, N) for the engines, ``xyz_pw`` /
``valid_pw`` for the explicit engine (default: the same scans),
``xyz_split`` / ``valid_split`` for the sp engine's split-heavy arm under
the default configuration (no such arm without them), and
``ba_dense_*`` / ``ba_pcg_*`` for the two BA problems (``poses``,
``points``, ``obs_k``, ``obs_l``, ``obs_p``, ``obs_w``); what is missing
comes from the port's generators (``velodyne_like_cloud`` from seeds 0..B-1,
:func:`synthetic_ba`).

``--scaling``: at each P of ``--scaling-procs``, P ranks in one group run
the dp engine (``make_sharded_pipeline``, whole scans, SCANS_PER_RANK a
rank, a fixed number of steps in lockstep) and ``bundle_adjust_sharded`` on
P x ``--ba-obs`` observations, then P processes with no group run the same
load a process (``filter_ground_batched``, ``bundle_adjust``) in a time box
entered through a file barrier; comm_efficiency is the group's aggregate
scans/s over theirs (what the shared cores cost cancels in the ratio).  On
one card or the CPU this checks the mechanism, not scaling between cards.

Usage:
  python3 tools/torch_multihost_bench.py --procs 4 --device cpu \\
      --batch 4 --points 2048 --json-out mh.json
  python3 tools/torch_multihost_bench.py --scaling --scaling-procs 1,2,4 \\
      --device cpu --points 2048 --json-out scaling.json
  python3 tools/torch_multihost_bench.py --procs 2 --device cuda \\
      --backend gloo --batch 8 --points 131072 --inputs split.npz \\
      --json-out mh.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

BA_KEYS = ("poses", "points", "obs_k", "obs_l", "obs_p", "obs_w")
SP = 2   # the point-sharded engines' mesh: (procs / 2, 2)
# largest |pose difference| of sharded BA against bundle_adjust on one
# process.  The two add the same partials in another order; sound runs read
# up to 2.9e-6 (dense) and 1.8e-5 (PCG at 1000 keyframes on the card).  On
# the CPU the PCG problem at 1000 keyframes reads 6.8e-4 at two ranks and
# 1.2e-3 at four, above this limit: BA's CPU sums difference one prefix sum
# over all observations, which a rank takes over its own block only
# (tools/torch_ba_bench.py --margin; the JAX package reads 1.5e-3 at four).
# Every rank summing the same block instead moves the poses by 0.08-0.17
# (PERF.md).
ONE_PROCESS_TOL = {"dense": 1e-4, "pcg": 1e-3}


def synthetic_ba(k: int, l: int, o: int, seed: int = 0) -> dict:
    """A BA problem of K poses along a line, L landmarks and O observations
    made from ``seed``: keyframe ids in runs, landmark ids at random, local
    coordinates with 1 cm of noise, poses and points perturbed."""
    import torch
    from patchwork_tpu_torch.slam.se3 import se3_exp

    rng = np.random.default_rng(seed)
    xi = np.zeros((k, 6), np.float32)
    xi[:, 0] = np.arange(k, dtype=np.float32)
    xi[:, 5] = 0.05 * np.arange(k, dtype=np.float32)
    gt = se3_exp(torch.from_numpy(xi)).numpy()
    pts = rng.uniform(-10, 10, (l, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 3.0, l)
    obs_k = (np.arange(o) // -(-o // k)).astype(np.int32)
    obs_l = rng.integers(0, l, o).astype(np.int32)
    inv = np.linalg.inv(gt.astype(np.float64))
    local = (np.einsum("oij,oj->oi", inv[obs_k, :3, :3], pts[obs_l])
             + inv[obs_k, :3, 3])
    obs_p = (local + rng.normal(0, 0.01, (o, 3))).astype(np.float32)
    pert = rng.normal(0, 0.05, (k, 6)).astype(np.float32)
    pert[0] = 0.0
    poses = (gt @ se3_exp(torch.from_numpy(pert)).numpy()).astype(np.float32)
    points = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    return {"poses": poses, "points": points, "obs_k": obs_k, "obs_l": obs_l,
            "obs_p": obs_p, "obs_w": np.ones(o, np.float32)}


def _pad_obs(arrays: dict, multiple: int) -> dict:
    """Observations padded with obs_w = 0 to a multiple of ``multiple``."""
    pad = (-len(arrays["obs_k"])) % multiple
    out = dict(arrays)
    for key in ("obs_k", "obs_l", "obs_p", "obs_w"):
        a = arrays[key]
        out[key] = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return out


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------

class _Clock:
    """Times a call: CUDA events on the card (after one untimed call), the
    host clock on the CPU; and the kernel launches and the collectives
    (``all_gather`` / ``all_reduce`` calls, counted by wrapping them) of
    the timed call."""

    def __init__(self, dev):
        import torch
        import torch.distributed as dist

        self.torch = torch
        self.dev = dev
        self.name = "cuda events" if dev.type == "cuda" else "host clock"
        self.collectives = 0
        for op in ("all_gather", "all_reduce"):
            setattr(dist, op, self._counted(getattr(dist, op)))

    def _counted(self, fn):
        def call(*args, **kw):
            self.collectives += 1
            return fn(*args, **kw)

        return call

    def __call__(self, fn, *args, **kw):
        from patchwork_tpu_torch.kernels import fit_cuda
        from patchwork_tpu_torch.segment import segops

        torch = self.torch
        if self.dev.type == "cuda":
            fn(*args, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(self.dev)
        before, n0 = dict(fit_cuda.LAUNCHES), self.collectives
        os0 = dict(segops.ORDER_STATS)
        if self.dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v - before[k] for k, v in fit_cuda.LAUNCHES.items()
                    if v != before[k]}
        extra = {
            "peak_mb": (torch.cuda.max_memory_allocated(self.dev) / 2 ** 20
                        if self.dev.type == "cuda" else None),
            "order_stats": {k: v - os0[k]
                            for k, v in segops.ORDER_STATS.items()}}
        return out, ms, launches, self.collectives - n0, extra

    def busy_ms(self, fn, *args, **kw):
        """Device busy time of one call: the card's kernels, copies and
        fills as torch.profiler records them; None on the CPU."""
        torch = self.torch
        if self.dev.type != "cuda":
            return None
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args, **kw)
            torch.cuda.synchronize()
        return sum(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0))
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA) / 1e3


def _inputs(args, dev) -> dict:
    import torch
    from patchwork_tpu_torch.io.synthetic import velodyne_like_cloud

    arrays = dict(np.load(args.inputs)) if args.inputs else {}
    if "xyz" not in arrays:
        arrays["xyz"] = np.stack([velodyne_like_cloud(args.points, seed=i)
                                  for i in range(args.batch)])
        arrays["valid"] = np.ones(arrays["xyz"].shape[:2], bool)
    arrays.setdefault("xyz_pw", arrays["xyz"])
    arrays.setdefault("valid_pw", arrays["valid"])
    if "xyz_split" in arrays:
        arrays.setdefault("valid_split",
                          np.ones(arrays["xyz_split"].shape[:2], bool))
    for solver, shape in (("dense", (6, 24, 144)), ("pcg", (8, 32, 256))):
        if f"ba_{solver}_poses" not in arrays:
            for key, a in synthetic_ba(*shape).items():
                arrays[f"ba_{solver}_{key}"] = a
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items() if not k.startswith("ba_")} | {
        k: v for k, v in arrays.items() if k.startswith("ba_")}


def _bits(a, b) -> int:
    return int((a != b).sum().item())


def _same_bits(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _worker_device(args, rank: int):
    import torch
    from patchwork_tpu_torch.core.device import cuda_device

    if args.device == "cpu":
        torch.set_num_threads(1)
        return torch.device("cpu")
    dev = cuda_device(rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _worker(args) -> int:
    import torch
    import torch.distributed as dist
    from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
    from patchwork_tpu_torch.parallel import (
        host_summary, initialize_multihost, is_multihost, make_mesh,
        make_sharded_filter_ground, make_sharded_pipeline,
        make_shardmap_patchwork)
    from patchwork_tpu_torch.parallel.mesh import ordered_sum
    from patchwork_tpu_torch.parallel.sharded import point_sharded_impl
    from patchwork_tpu_torch.parallel.shardmap_engine import patchwork_level
    from patchwork_tpu_torch.slam import (BAProblem, bundle_adjust,
                                          bundle_adjust_sharded)

    rank, procs = args.worker, args.procs
    dev = _worker_device(args, rank)
    if not initialize_multihost(f"file://{args.store}", procs, rank,
                                backend=args.backend):
        raise RuntimeError("the worker did not join the process group")
    if is_multihost() != (procs > 1):
        raise RuntimeError(f"is_multihost() wrong for {procs} processes")
    data = _inputs(args, dev)
    mesh_dp = make_mesh(procs, dp=procs, sp=1, device_type=dev.type)
    mesh_sp = make_mesh(procs, dp=procs // SP, sp=SP, device_type=dev.type)
    clock = _Clock(dev)
    rec = {"rank": rank, "procs": procs, "summary": host_summary(),
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "backend": args.backend, "mesh_sp": [procs // SP, SP],
           "clock": clock.name, "ms": {}, "launches": {}, "collectives": {},
           "peak_mb": {}, "order_stats": {}, "busy_ms": {}}
    arrays = {}

    def arm(name, fn, *a, **kw):
        out, ms, launches, collectives, extra = clock(fn, *a, **kw)
        rec["ms"][name] = ms
        rec["launches"][name] = launches
        rec["collectives"][name] = collectives
        for key, v in extra.items():
            rec[key][name] = v
        return out

    xyz, valid = data["xyz"], data["valid"]
    b = xyz.shape[0]
    cfg = PatchworkConfig(**json.loads(args.config_json))

    # -- the dp engine: whole scans per rank, the configuration's kernels
    ref = filter_ground_batched(xyz, valid, cfg.replace(segment_impl="fused"))
    rec["ms"]["one process"] = clock(filter_ground_batched, xyz, valid,
                                     cfg.replace(segment_impl="fused"))[1]
    res = arm("dp", make_sharded_filter_ground(cfg, mesh_dp,
                                               shard_points=False), xyz, valid)
    rec["dp_bit_errors"] = _bits(res.ground, ref.ground)
    rec["dp_scans_per_s"] = b / (rec["ms"]["dp"] / 1e3)
    rec["one_process_scans_per_s"] = b / (rec["ms"]["one process"] / 1e3)
    arrays["dp"] = res.ground

    # -- the pipeline: whole scans, replicated over sp; counts
    res, g_cnt, ng_cnt = arm("pipeline", make_sharded_pipeline(
        cfg, mesh_sp, shard_points=False), xyz, valid)
    rec["pipeline_bit_errors"] = _bits(res.ground, ref.ground)
    rec["pipeline_count_errors"] = (
        _bits(g_cnt, res.ground.sum(1))
        + _bits(ng_cnt, (res.valid & ~res.ground).sum(1)))
    arrays["pipeline"] = res.ground

    # -- the sp engine: points sharded, the impl forced; on the engines'
    # batch, the split-heavy batch and with percentile seeds
    impl = point_sharded_impl(cfg, dev)
    rec["sp_impl"] = impl
    sp_arms = [("sp", cfg, xyz, valid),
               ("sp_pct", cfg.replace(adaptive_seed_height=False), xyz,
                valid)]
    if "xyz_split" in data:
        sp_arms.append(("sp_split", PatchworkConfig(), data["xyz_split"],
                        data["valid_split"]))
    for name, c, x, v in sp_arms:
        ref_sp = filter_ground_batched(x, v, c.replace(segment_impl=impl))
        fn = make_sharded_filter_ground(c, mesh_sp)
        res = arm(name, fn, x, v)
        rec["busy_ms"][name] = clock.busy_ms(fn, x, v)
        rec[f"{name}_bit_errors"] = _bits(res.ground, ref_sp.ground)
        arrays[name] = res.ground

    # -- the explicit-collective engine, single level
    cfg_pw = PatchworkConfig.patchwork(**json.loads(args.pw_config_json))
    xp, vp = data["xyz_pw"], data["valid_pw"]
    g = arm("explicit", make_shardmap_patchwork(cfg_pw, mesh_sp), xp, vp)
    rec["explicit_bit_errors"] = _bits(g, patchwork_level(cfg_pw, xp, vp))
    rec["explicit_vs_engine_bit_errors"] = _bits(
        g, filter_ground_batched(xp, vp, cfg_pw).ground)
    arrays["explicit"] = g

    # -- bundle adjustment, observations over the ranks
    for solver in ("dense", "pcg"):
        a = _pad_obs({k: data[f"ba_{solver}_{k}"] for k in BA_KEYS}, procs)
        prob = BAProblem.from_numpy(*(a[k] for k in BA_KEYS), device=dev)
        runs = [arm(f"ba {solver}", bundle_adjust_sharded, prob, mesh_dp,
                    iters=args.ba_iters, solver=solver),
                bundle_adjust_sharded(prob, mesh_dp, iters=args.ba_iters,
                                      solver=solver)]
        one = bundle_adjust(prob, iters=args.ba_iters, solver=solver)
        rec[f"ba_{solver}_shape"] = [int(prob.poses.shape[0]),
                                     int(prob.points.shape[0]),
                                     int(prob.obs_k.shape[0])]
        rec[f"ba_{solver}_pose_max_abs_diff"] = float(
            (runs[0].poses - one.poses).abs().max())
        rec[f"ba_{solver}_point_max_abs_diff"] = float(
            (runs[0].points - one.points).abs().max())
        rec[f"ba_{solver}_runs_equal"] = (
            _same_bits(runs[0].poses, runs[1].poses)
            and _same_bits(runs[0].points, runs[1].points))
        arrays[f"ba_{solver}_poses"] = runs[0].poses
        arrays[f"ba_{solver}_points"] = runs[0].points

    # -- the collectives of one CG iteration: (K, 6) and (L, 3) blocks
    k, l = rec["ba_pcg_shape"][:2]
    group = mesh_dp.get_group("dp") if procs > 1 else None
    blocks = [torch.ones((k, 6), device=dev), torch.ones((l, 3), device=dev)]
    dist.barrier()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        for t in blocks:
            ordered_sum(t, group)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec["cg_collectives_us"] = (time.perf_counter() - t0) * 1e6 / reps

    rec["ok"] = bool(
        rec["dp_bit_errors"] == 0 and rec["pipeline_bit_errors"] == 0
        and rec["pipeline_count_errors"] == 0
        and all(rec[f"{name}_bit_errors"] == 0 for name, *_ in sp_arms)
        and rec["explicit_bit_errors"] == 0
        and rec["explicit_vs_engine_bit_errors"] == 0
        and all(rec[f"ba_{s}_runs_equal"]
                and rec[f"ba_{s}_pose_max_abs_diff"] <= ONE_PROCESS_TOL[s]
                for s in ONE_PROCESS_TOL))
    with open(args.result, "w") as f:
        json.dump(rec, f)
    if rank == 0 and args.arrays_out:
        np.savez(args.arrays_out,
                 **{k: v.cpu().numpy() for k, v in arrays.items()})
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# scaling workers (tools/multihost_bench.py --scaling)
# ---------------------------------------------------------------------------

SCANS_PER_RANK = 2     # the per-rank load, constant as the ranks grow
BA_OBS_BASE = 8192     # observations a rank holds in the BA arm
BA_KL = (50, 64)       # poses and landmarks of the BA arm, fixed


def _scale_batch(points: int, b: int, dev):
    """B demo scans of ``points`` (tools/multihost_bench.py's scaling
    workload) on ``dev``."""
    import torch
    from patchwork_tpu_torch.io.synthetic import demo_point_cloud

    xyz = torch.from_numpy(np.stack([demo_point_cloud(points, seed=i)
                                     for i in range(b)])).to(dev)
    return xyz, torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)


def _ba_problem(obs: int, multiple: int, dev):
    from patchwork_tpu_torch.slam import BAProblem

    a = _pad_obs(synthetic_ba(*BA_KL, obs), multiple)
    return BAProblem.from_numpy(*(a[k] for k in BA_KEYS), device=dev)


def _steps(fn, steps: int, dev):
    """``steps`` calls of ``fn``, the last one waited for: (t0, t1) on the
    host's monotonic clock, which every process of the host shares."""
    import torch

    t0 = time.monotonic()
    for _ in range(steps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return t0, time.monotonic()


def _timebox(fn, dev, box_s: float):
    """Calls of ``fn`` (each waited for) until ``box_s`` have passed:
    (steps, t0, t1).  Independent processes start it together after a
    barrier, so the launcher can divide their scans by the makespan."""
    steps, t0 = 0, time.monotonic()
    while True:
        _steps(fn, 1, dev)
        steps += 1
        t1 = time.monotonic()
        if t1 - t0 >= box_s:
            return steps, t0, t1


def _file_barrier(directory: str, rank: int, procs: int,
                  timeout_s: float = 600.0) -> bool:
    """Every worker's ready file present (no process group needed)."""
    open(os.path.join(directory, f"ready_{rank}"), "w").close()
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if all(os.path.exists(os.path.join(directory, f"ready_{i}"))
               for i in range(procs)):
            return True
        time.sleep(0.05)
    return False


def _worker_scale(args) -> int:
    """Distributed arm: ``--procs`` ranks in one group, a (P / sp, sp) mesh,
    ``make_sharded_pipeline`` on SCANS_PER_RANK scans a dp rank (whole
    scans at sp 1, the point-sharded engine above), a fixed number of steps
    (each joins the masks across the ranks, so they run in lockstep); with
    ``--ba-obs``, ``bundle_adjust_sharded`` on P x that many observations."""
    import torch.distributed as dist
    from patchwork_tpu_torch import PatchworkConfig
    from patchwork_tpu_torch.parallel import (initialize_multihost, make_mesh,
                                              make_sharded_pipeline)
    from patchwork_tpu_torch.slam import bundle_adjust_sharded

    rank, procs, sp = args.worker, args.procs, args.sp
    dev = _worker_device(args, rank)
    if not initialize_multihost(f"file://{args.store}", procs, rank,
                                backend=args.backend):
        raise RuntimeError("the worker did not join the process group")
    mesh = make_mesh(procs, dp=procs // sp, sp=sp, device_type=dev.type)
    b = SCANS_PER_RANK * (procs // sp)
    xyz, valid = _scale_batch(args.points, b, dev)
    fn = make_sharded_pipeline(PatchworkConfig(), mesh, shard_points=sp > 1)
    fn(xyz, valid)
    dist.barrier()
    t0, t1 = _steps(lambda: fn(xyz, valid), args.bench_reps, dev)
    rec = {"rank": rank, "procs": procs, "sp": sp, "scans": args.bench_reps * b,
           "window": [t0, t1], "ms_per_step": (t1 - t0) * 1e3 / args.bench_reps}
    if args.ba_obs:
        prob = _ba_problem(args.ba_obs * procs, procs, dev)
        mesh_dp = make_mesh(procs, dp=procs, sp=1, device_type=dev.type)

        def solve():
            return bundle_adjust_sharded(prob, mesh_dp, iters=2, solver="pcg")

        solve()
        dist.barrier()
        b0, b1 = _steps(solve, args.ba_steps, dev)
        rec.update(ba_obs=args.ba_obs * procs, ba_window=[b0, b1],
                   ba_solve_s=(b1 - b0) / args.ba_steps)
    with open(args.result, "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _worker_independent(args) -> int:
    """Control arm: the same per-rank load in a process of its own (no
    group, no collective), ``filter_ground_batched`` on SCANS_PER_RANK
    scans, timeboxed after a file barrier; with ``--ba-obs``,
    ``bundle_adjust`` on that many observations."""
    from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
    from patchwork_tpu_torch.slam import bundle_adjust

    rank, procs = args.worker, args.procs
    dev = _worker_device(args, rank)
    xyz, valid = _scale_batch(args.points, SCANS_PER_RANK, dev)
    cfg = PatchworkConfig()
    filter_ground_batched(xyz, valid, cfg)
    synced = _file_barrier(args.barrier_dir, rank, procs)
    steps, t0, t1 = _timebox(lambda: filter_ground_batched(xyz, valid, cfg),
                             dev, args.box_s)
    rec = {"rank": rank, "barrier_ok": synced,
           "scans": steps * SCANS_PER_RANK, "window": [t0, t1],
           "ms_per_step": (t1 - t0) * 1e3 / steps}
    if args.ba_obs:
        prob = _ba_problem(args.ba_obs, 1, dev)

        def solve():
            return bundle_adjust(prob, iters=2, solver="pcg")

        solve()
        _file_barrier(args.barrier_dir + "_ba", rank, procs)
        steps, b0, b1 = _timebox(solve, dev, args.box_s)
        rec.update(ba_obs=args.ba_obs, ba_window=[b0, b1],
                   ba_solve_s=(b1 - b0) / steps)
    with open(args.result, "w") as f:
        json.dump(rec, f)
    return 0


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def _run_workers(args, tmp: str, procs: int | None = None,
                 argv: list | None = None) -> list:
    """Spawn ``procs`` workers (``args.procs`` by default) of this script
    with the command line ``argv`` (this process's by default); kill all of
    them as soon as one fails or at the time limit.  Returns their records,
    or raises."""
    procs = args.procs if procs is None else procs
    store = os.path.join(tmp, "store")
    common = sys.argv[1:] if argv is None else [str(a) for a in argv]
    # every worker runs on this host: gloo's pairs over the loopback device
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    workers, logs = [], []
    try:
        for i in range(procs):
            log = open(os.path.join(tmp, f"worker{i}.log"), "w")
            logs.append(log)
            workers.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *common,
                 "--procs", str(procs), "--worker", str(i), "--store", store,
                 "--result", os.path.join(tmp, f"worker{i}.json")],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env))
        deadline = time.monotonic() + args.timeout
        while True:
            rcs = [p.poll() for p in workers]
            bad = [i for i, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad or time.monotonic() > deadline:
                why = (f"worker {bad[0]} exited {rcs[bad[0]]}" if bad
                       else f"time limit {args.timeout} s")
                for log in logs:
                    log.flush()
                tails = "".join(
                    f"--- worker {i} ---\n"
                    + open(os.path.join(tmp, f"worker{i}.log")).read()[-3000:]
                    for i in (bad or range(procs)))
                raise RuntimeError(f"{why}:\n{tails}")
            if all(rc == 0 for rc in rcs):
                break
            time.sleep(0.05)
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
        for p in workers:
            p.wait()
        for log in logs:
            log.close()
    return [json.load(open(os.path.join(tmp, f"worker{i}.json")))
            for i in range(procs)]


def _launch(args) -> int:
    if args.device == "cuda":
        from patchwork_tpu_torch.kernels import _build

        _build.load()
    tmp = tempfile.mkdtemp(prefix="torch_multihost_")
    t0 = time.perf_counter()
    try:
        workers = _run_workers(args, tmp)
    except RuntimeError as e:
        print(f"torch_multihost_bench: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    doc = {"procs": args.procs, "device": args.device,
           "backend": args.backend, "batch": args.batch,
           "wall_s": time.perf_counter() - t0,
           "all_ok": all(w["ok"] for w in workers), "workers": workers}
    summary = {k: max(w[k] for w in workers) for k in workers[0]
               if k.endswith("_bit_errors") or k in (
                   "pipeline_count_errors", "ba_dense_pose_max_abs_diff",
                   "ba_pcg_pose_max_abs_diff")}
    print(json.dumps({"procs": args.procs, "all_ok": doc["all_ok"],
                      **summary}))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0 if doc["all_ok"] else 1


def scale_arm(args, mode: str, procs: int, sp: int = 1,
              ba_obs: int = 0) -> list:
    """One arm of the scaling runs: ``procs`` workers in ``mode`` ("scale"
    or "independent"), their records."""
    tmp = tempfile.mkdtemp(prefix="torch_scaling_")
    barrier = os.path.join(tmp, "barrier")
    for d in (barrier, barrier + "_ba"):
        os.makedirs(d)
    argv = ["--mode", mode, "--sp", sp, "--points", args.points,
            "--device", args.device, "--backend", args.backend,
            "--bench-reps", args.bench_reps, "--ba-obs", ba_obs,
            "--ba-steps", args.ba_steps, "--box-s", args.box_s,
            "--barrier-dir", barrier, "--timeout", args.timeout]
    try:
        return _run_workers(args, tmp, procs, argv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _makespan(rows, key="window"):
    return (max(r[key][1] for r in rows) - min(r[key][0] for r in rows))


def _scaling(args) -> int:
    """Weak scaling of the dp engine against independent processes
    (tools/multihost_bench.py's ``--scaling``): at each P, P ranks in one
    group (every step joins the masks) and P processes with no group, each
    rank SCANS_PER_RANK scans; comm_efficiency = the group's aggregate
    scans/s over the independent processes' (both share the host's cores,
    so what the cores cost cancels in the ratio).  The BA arm: the group
    solves P x BA_OBS_BASE observations with bundle_adjust_sharded, each
    independent process BA_OBS_BASE with bundle_adjust."""
    import statistics

    if args.device == "cuda":
        from patchwork_tpu_torch.kernels import _build

        _build.load()
    rows = []
    for p in (int(v) for v in args.scaling_procs.split(",")):
        t0 = time.perf_counter()
        try:
            dist_rows = scale_arm(args, "scale", p, ba_obs=args.ba_obs)
            indep = scale_arm(args, "independent", p, ba_obs=args.ba_obs)
        except RuntimeError as e:
            print(f"torch_multihost_bench: {e}", file=sys.stderr)
            return 1
        # every rank of the group counted the whole batch
        dist_rate = sum(r["scans"] for r in dist_rows) / p / _makespan(
            dist_rows)
        ispan = _makespan(indep)
        indep_rate = sum(r["scans"] for r in indep) / ispan
        shared = (min(r["window"][1] for r in indep)
                  - max(r["window"][0] for r in indep))
        row = {"procs": p, "dp_dist_scans_per_s": dist_rate,
               "dp_indep_aggregate_scans_per_s": indep_rate,
               "dp_comm_efficiency": dist_rate / indep_rate,
               "indep_window_overlap": shared / ispan if ispan > 0 else 0.0,
               "barriers_ok": all(r["barrier_ok"] for r in indep),
               "wall_s": time.perf_counter() - t0}
        row["overlap_valid"] = row["indep_window_overlap"] >= 0.7
        if args.ba_obs:
            t_dist = statistics.median(r["ba_solve_s"] for r in dist_rows)
            t_ind = statistics.median(r["ba_solve_s"] for r in indep)
            row.update(ba_obs_global=args.ba_obs * p,
                       ba_dist_solve_s=t_dist, ba_indep_solve_s=t_ind,
                       ba_comm_efficiency=t_ind / t_dist)
        rows.append(row)
        print(f"# P={p}: dp comm-eff {row['dp_comm_efficiency']:.3f}, BA "
              f"comm-eff {row.get('ba_comm_efficiency', float('nan')):.3f}",
              file=sys.stderr)
    doc = {"comment": (
        "Weak scaling of the dp engine against independent processes, "
        f"{args.device}, {args.backend}; every rank of a host shares its "
        "cores (and on one card its card), so the efficiencies check the "
        "mechanism, not the scaling between cards"),
        "host_cores": os.cpu_count(), "points": args.points,
        "scans_per_rank": SCANS_PER_RANK, "ba_obs_per_rank": args.ba_obs,
        "rows": rows}
    valid = [r for r in rows if r["overlap_valid"]] or rows
    print(json.dumps({
        "metric": "dp_comm_efficiency_worst",
        "value": min(r["dp_comm_efficiency"] for r in valid),
        "unit": "ratio", "procs": [r["procs"] for r in rows],
        "device": args.device,
        "ba_comm_efficiency": [r.get("ba_comm_efficiency") for r in rows]}))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="gloo")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=131072)
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--config-json", default="{}",
                    help="PatchworkConfig fields of the engines")
    ap.add_argument("--pw-config-json", default="{}",
                    help="PatchworkConfig.patchwork() fields of the "
                         "explicit engine")
    ap.add_argument("--ba-iters", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--arrays-out", default=None,
                    help="rank 0's masks and BA results, .npz")
    ap.add_argument("--scaling", action="store_true",
                    help="weak scaling of the dp engine against independent "
                         "processes at each of --scaling-procs")
    ap.add_argument("--scaling-procs", default="1,2,4")
    ap.add_argument("--bench-reps", type=int, default=8,
                    help="--scaling: steps of the group's timed window")
    ap.add_argument("--box-s", type=float, default=10.0,
                    help="--scaling: seconds of an independent process's "
                         "timed window")
    ap.add_argument("--ba-obs", type=int, default=BA_OBS_BASE,
                    help="--scaling: BA observations a rank (0: no BA arm)")
    ap.add_argument("--ba-steps", type=int, default=4,
                    help="--scaling: solves of the group's BA window")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mode", default="full",
                    choices=["full", "scale", "independent"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--sp", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--barrier-dir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode == "scale":
        return _worker_scale(args)
    if args.mode == "independent":
        return _worker_independent(args)
    if args.scaling:
        return _scaling(args)
    if args.procs % SP:
        ap.error(f"--procs {args.procs}: the point-sharded engines' mesh "
                 f"has sp {SP}, so --procs must divide by {SP}")
    if args.worker is not None:
        return _worker(args)
    return _launch(args)


if __name__ == "__main__":
    sys.exit(main())
