#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, one line each:
  1. card: torch's device name, and nvidia-smi's name and power limit;
  2. build: compile the kernels of patchwork_tpu_torch/csrc with nvcc;
  3. kernels: every kernel wrapper against its plain PyTorch version, on the
     inputs the main path gives it (captured from runs of the slice: the
     level path, the "pallas" segment ops, the generic engine's fit, and
     for the apply sweep, the moments2 sweep and the plane table the one
     route that still runs them, a node table above the card's gate, Sp
     4224 at B=2 x 32768; beside those, labelled "gate shut", the sweeps at
     B=8 x 131072 with the gate shut for the call, the shapes of earlier
     readings), with its bound (the least time the card could take: bytes over
     3.35 TB/s or float32 operations over 67 TFLOP/s) and, where one PyTorch
     call computes the same function, that call's time; then the
     redesigned kernels: the sweep plan against its plain version, the
     apply sweep and the moments2 sweep with a shared plan on the wide
     table's input, on velodyne, split terrain and a shuffled cloud at Sp
     128 and 256 (the moments2
     sweep also without a plan, and after an apply sweep on the same plan),
     seg_gather at C = 1, 3, 8 and point counts that are no multiple of 4,
     and fit_level at B = 1, 3, 8, each scan against its solo run, a
     max_iter exit beside a convergence exit, every one run twice with
     equal bits; level_core, kernel #1's level in one co-operative launch
     (R3-R5, stats, early-outs, deficient rounds, seeds, fit, split,
     finish), on velodyne level 0 (Sp 128), a split-terrain remap level (Sp
     256), velodyne 3 m up (every node deficient), split terrain with NaN
     and +-inf coordinates (parked by binning, and on live points of level
     0) and percentile seeds, exact and fast: state and stats bit for bit
     against its plain version twice, at max_iter 2 too, each scan alone
     against the batch, the whole level against level_reference twice; its
     time and device time beside the same level as its phases one by one
     (the phase kernels and the loop of sweeps), its registers and spills
     (ptxas) and blocks per scan; the order statistic at Sp 128
     (percentile ranks) and Sp 256 (medians) with its kernels per call, and
     on a skewed input (one node holds two fifths of a scan); its per-round
     entry (the point-sharded engine's) on the split remap level's medians,
     whole and in two halves whose histograms are summed after every
     round, against its plain version and the one-launch kernel; the
     voxel filter's run sums; the segment sum on each route (dense, plan +
     planned, over a binding's plan) and min/max, on binning's sum, level 0's bbox, the generic path's deeper levels
     (split terrain B=8 x 153600) and the wide table's binding, each twice
     against its plain version with its time, device time, bound and
     index_add_'s; the device times (torch.profiler) of the
     moments2 sweep, seg_gather, torch.gather, level_core and the order
     statistic;
  4. slice: filter_ground_batched on B=8 x 131072 velodyne-like scans and
     on B=8 x 131072 split-terrain scans (whose patches recurse), exact and
     fast mode, through the kernels: exact masks equal the plain path's bit
     for bit (fast masks are compared on the first two scans: the plain path
     takes seconds a batch), fast IoU >= 0.999 vs exact, a second run gives
     the same masks, the level family's launches a batch are 1 on velodyne
     and 1 + 3 (exact) or 2 (fast) a remap level on split terrain (at most
     16 and 11),
     sector ids agree with CPU binning, RecursivePatchwork on one scan; then
     the generic level engine: segment_impl="pallas" at B=8 x 131072, and
     the default "fused" above the path gate on 128-beam velodyne and split
     terrain at B=8 x 153600 and on 128-beam velodyne at B=8 x 262144 (one
     fit_level launch a level), held to the plain path and to the level path
     forced on the same scans; then a table too wide for the one-launch fit
     (max_active_nodes_cfg 4096, Sp 4224, split terrain B=2 x 32768):
     fit_level at level 0, the loop of apply and moments2 sweeps deeper,
     held to the plain path; every kernel family was launched; the level
     path builds no segment plan, a generic batch at most one a bound sum;
  5. quality: the five hard labeled scenes at 65536 points (seeds 0, 1),
     IoU within 0.001 of EVAL_r05.json in both modes (by
     tools/torch_eval_scenes.py's run);
  6. timing: scans/s of the kernel path (CUDA events) beside the plain
     path's (its run in phase 4), and of the generic path beside the level path forced on the same scans;
  7. front ends, through the entry points a user calls, built with no
     device argument (they default to the card, and what they return must
     lie there), with the launch
     counts read around those calls only: (a) LidarFusion on the card fuses
     eight 3-LiDAR IAC scenes to 131072 points each, bit for bit as on the
     CPU, and filter_ground_batched segments them (exact masks equal the
     plain path's, fast IoU >= 0.999); (b) RecursivePatchwork's
     sample_ground_and_obstacles, and PointCloudProcessor and the API's
     static utilities with no device (each allocates on the card and agrees
     with device="cpu"); (c) the CLI in this process on the demo
     cloud and on a split-terrain KITTI frame (whose patches split, so the
     order statistic runs), with both PNGs decoded, and on the same frame
     with a node table above the card's gate (the loop of sweeps); (d) the
     CLI as a
     process on a 3-topic MCAP (bag -> fusion -> engine); (e) a JSON launch
     descriptor over eight 128-beam KITTI frames of 153600 points, default
     config (fit_level) and segment_impl "pallas"; (f) PatchworkNode over 16
     velodyne frames at batch sizes 1 and 8, with frames/s and stage times.
     Every count and mask is held to filter_ground/filter_ground_batched on
     the same points, and all eight kernel families must launch;
  8. SLAM: tools/torch_slam_bench.py's path on its closed loop drive at
     SLAM_KEYFRAMES keyframes of full scans (20400 points, the bench's
     config: capacity 32768, 1024 obstacle and 512 ground samples, 12 ICP
     steps): parallel ICP, loop closures, the degree-capped pose graph,
     landmark BA; the three ATEs, the closures, the stage seconds and the
     launches of the level, seg_sum and seg_plan families in the session
     (each must launch), beside the JAX package's figures for the same
     drive on a CPU; differing mask bits kernel vs plain on one extract
     chunk (expect 0); BA's sums over a plan of their ids against
     seg_sum_plain on the session's own obs_k and obs_l and at the
     1000-keyframe shape (BA_SHAPE), with their times, the plan's and
     index_add_'s (expect max_abs_err 0); bundle_adjust twice on the
     session's problem (equal bits).  It fails on any of those, on a pose
     graph worse than odometry, or on a final ATE of SLAM_ATE_MAX or more;
  9. parallel (patchwork_tpu_torch/parallel, bundle_adjust_sharded): (a) in
     this process, a one-rank group over NCCL: make_shardmap_fused (the
     level path), make_sharded_pipeline (the point-sharded engine: the
     generic path with the kernel segment ops, every per-node statistic
     reduced over sp, the order statistic by #2's per-round entry) and
     make_shardmap_patchwork (PatchworkConfig.patchwork()) on the velodyne
     and split-terrain batches of phase 4, each mask equal bit for bit to
     filter_ground_batched with the impl the entry point runs, the counts
     to the masks' sums; the sp engine's ms a batch and its reductions a
     call;
     bundle_adjust_sharded on phase 8's session problem and a PCG problem
     at BA_SHAPE (MH_BA_ITERS steps) equal bit for bit to bundle_adjust;
     kernels #1, #2, #6, #7 and #8 launched; the explicit engine's segment
     ops over one binding of the velodyne batch, whole and each sp-2 half
     (#6's 4- and 6-row sums over its plan, #7's gather, #8's bboxes), and
     BA's sums over each W=2 rank's half of both problems' observations,
     every bit against their plain versions; the dp engine's time against
     filter_ground_batched's; (b) two processes on the one card over gloo
     (NCCL refuses two ranks on one device), tools/torch_multihost_bench.py
     --procs 2 on the velodyne and split-terrain batches and the two BA
     problems: dp over 2, sp over 2 (velodyne, velodyne with percentile
     seeds, split terrain, whose medians must cross the ranks), the
     explicit engine at sp 2, each 0 differing mask bits against the same
     computation on one process, each rank's peak memory and device busy
     time of an sp call, BA's poses within
     the tool's ONE_PROCESS_TOL (1e-4) of bundle_adjust and two runs equal
     bit for bit; each rank's launches per kernel family and times (CUDA
     events) beside the card's name and power limit;
 10. reference: the card's exact masks against the port's NumPy oracle
     (patchwork_tpu_torch/oracle/reference.py, run on the host): the
     parity scenes (patchwork_tpu_torch/oracle/scenes.py) under "fused"
     and "pallas", 0 differing bits in ground, valid, in_zone and in_patch
     (the all-deficient scene: ground IoU > 0.95), and scan 0 of the
     velodyne and split-terrain batches of phase 4 (131072 points, the
     level path) and of the 128-beam velodyne batch (153600, the generic
     path's fit_level), exact, 0 differing bits and equal to its row of the
     batch; the oracle's seconds;
 11. benchmark: bench_torch.py --reps BENCH_REPS as a process (the port's
     one-line benchmark: bench.py's four cells, each held to the plain
     path and the oracle or exact mode before it is timed): exit 0, one
     JSON line on stdout with "correct": true, the device name torch's, and
     the level and seg_sum families launched in every cell; its cells on
     one line each;
 12. spans: one engine call on each shape of BENCHMARK.json's cells (the
     os128 cell's organized sweeps, B=8 x 262144, the generic path; the
     live cell's HDL-64E sweep, B=1 x 131072, the level path), through the
     node's own pad and step: under torch.cuda.set_sync_debug_mode("warn")
     every synchronisation, by the span open at it, none outside an
     "engine.read" span; the same call under "error" with only the read
     spans exempt, the same masks; the read spans by parent and the waits
     in each; the spans of a batch (os128) and of a frame (live) through
     node.run, and the cost of a span with the profiler off (all of a
     batch's or frame's under SPAN_COST_MAX_MS) and on.
Then a JSON line per kernel family (launches summed over phases 4, 7, 8,
9 and 10, phase 9's part (b) as its workers count them; seg_sum's entry
carries BA's sums; seg_order_stat_rounds, #2's per-round entry, launches
in phase 9 only) and, last, the device line.  Exits
non-zero, and prints no result line, if there is no CUDA device, a build
fails, or any phase fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))

B, N = 8, 131072
N_GEN = 153600      # a Hesai AT128 frame (128 x 1200): above the fit gate
N_BIG = 262144      # an OS-128 frame at 2048 columns; the API's next bucket
B_WIDE, N_WIDE = 2, 32768   # the scans of the configuration below
# a node table too wide for the one-launch fit: its fits run as loops of sweeps
WIDE_NODES = 4096
HARD_POINTS = 65536
SLAM_KEYFRAMES = 200   # phase 8's loop drive (tools/torch_slam_bench.py)
SLAM_ATE_MAX = 0.5     # the bar of tests/test_slam.py's end-to-end run
# BA at 1000 keyframes (K, L, O): the JAX package's CPU run in
# SLAM_TPU_r05.json, cpu_baseline_final_cfg.ba_detail
BA_SHAPE = (1000, 339, 205991)
# tools/slam_bench.py --keyframes 200 --icp parallel, the JAX package on a
# CPU (its samples differ: threefry, not torch.Generator)
JAX_SLAM_200KF_CPU = {"ate_odometry_m": 2.1207, "ate_posegraph_m": 0.2112,
                      "ate_ba_m": 0.1619, "loop_closures": 63,
                      "n_landmarks": 271, "n_obs": 41191}
# phase 9: Gauss-Newton steps of the sharded BA runs
MH_BA_ITERS = 2
# phase 11: back-to-back batches in a sample of bench_torch.py
BENCH_REPS = 5
# phase 11: kernel families every cell of bench_torch.py launches (its
# cells are below the path gate: the level path and binning's sum)
BENCH_FAMILIES = ("level", "seg_sum")
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3   # float sums; the design adds in one order
IOU_FAST_MIN = 0.999
IOU_EVAL_TOL = 0.001
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s off the tensor cores
PEAK_BYTES_S, PEAK_FLOPS = 3.35e12, 67e12
# float32 operations per point, counted from the expressions (arithmetic,
# compares and each sum's adds; integer atomics and key work not counted):
# one sweep of each kind, [exact, fast]
APPLY_FLOPS = {False: 31, True: 43}
M2_FLOPS = 19
# the level's phases around its sweeps (csrc/level.cuh): the labels and
# seeds with their sums, sweep 0 (pw_seed_point: 23 + the 6 rows' adds;
# fast + 6 products and 6 more adds); R5 on a remap level
# (pw_remap_point); node stats where the launch counts them (two
# compares); the finish (three compares); R1's rows and adds and R1b's
# (engine.level on a remap level).  The deficient rounds (compares, in
# scans with a deficient node), the per-node phases and the medians'
# integer key work are left out: a bound that counts less stays a bound.
SEED_FLOPS = {False: 29, True: 41}
REMAP_FLOPS, STATS_FLOPS, FINISH_FLOPS = 18, 2, 3
R1_FLOPS = {False: 6 + 9, True: 10}


T0 = time.perf_counter()


def stamp(phase: str) -> None:
    """Seconds since the script started, at the start of a phase."""
    print(f"[{phase}] starts at {time.perf_counter() - T0:.1f} s", flush=True)


class Failures:
    def __init__(self):
        self.items = []

    def check(self, ok: bool, what: str) -> bool:
        if not ok:
            self.items.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


def tool(name: str):
    """The module of ``tools/<name>.py``: a phase that a tool also runs
    calls the tool's own function, so there is one code for it."""
    import importlib

    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def _clone(args):
    import torch

    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _abs_err(a, b) -> float:
    """Max |a - b| over float tensors, with equal infinities counting 0."""
    import torch

    if not a.is_floating_point():
        return float((a != b).sum().item())
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max().item()) if d.numel() else 0.0


def _nbytes(*xs) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(xs))


def kernel_bound(name, args, kw, out, sweeps):
    """(bound_ms, bound_by, bytes, flops) of one call: every input read
    once and every output written once over the card's memory rate, against
    the float32 operations the inputs ask for over its peak rate.  ``sweeps``
    is per scan the sweeps of a level call (its level_core's, sweep 0
    included) or the apply sweeps of a fit_level call: the work this run's
    data needed."""
    if name in ("apply_sweep", "moments2_sweep"):
        pts, state, tab = args[:3]
        b, _, n = pts.shape
        fast = name == "apply_sweep" and bool(args[4])
        # x, y, z, mask and node id read per point; the apply sweep writes
        # the mask back
        per_point = 24 if name == "apply_sweep" else 20
        byts = b * n * per_point + _nbytes(tab, out)
        flops = b * n * (APPLY_FLOPS[fast] if name == "apply_sweep"
                         else M2_FLOPS)
    elif name == "fit_level":
        p, g0 = args[:2]
        b, _, n = p.shape
        fast = bool(kw.get("fast", False))
        byts = _nbytes(p, g0, out)
        flops = sum(n * (k * APPLY_FLOPS[fast]
                         + (0 if fast else (k - 1) * M2_FLOPS))
                    for k in sweeps)
    elif name in ("level_core", "level"):
        pts = args[0]
        b, _, n = pts.shape
        if name == "level_core":
            # every input read once, the stats and the state written
            fast = bool(args[10])
            rest = dict(zip(("remap", "tz", "nstats"), args[11:]), **kw)
            remap = rest.get("remap") is not None
            counts = rest.get("nstats") is None
            byts = _nbytes(args, out) + _nbytes(args[1])
            extra = 0
        else:
            fast = bool(kw.get("fast", False))
            remap = bool(kw.get("remap", False))
            counts = bool(kw.get("adaptive", True))
            byts = _nbytes(args[:2], out)
            extra = R1_FLOPS[fast] if remap else 0
        # per scan: sweep 0 (the seeds'), k - 1 apply sweeps, in exact mode
        # a moments2 sweep before each, and the phases around them
        flops = sum(n * (SEED_FLOPS[fast] + (k - 1) * APPLY_FLOPS[fast]
                         + (0 if fast else (k - 1) * M2_FLOPS)
                         + (REMAP_FLOPS if remap else 0)
                         + (STATS_FLOPS if counts else 0) + FINISH_FLOPS
                         + extra)
                    for k in sweeps)
    elif name == "seg_sum":
        rows, seg = args[:2]
        byts, flops = _nbytes(rows, seg, out), rows.numel()
    elif name == "seg_order_stat":
        byts, flops = _nbytes(args[:4], out), 20 * args[0].numel()
    elif name == "seg_gather":
        byts, flops = _nbytes(args, out), args[1].numel()
    elif name == "seg_minmax":
        byts, flops = _nbytes(args[:3], out), 2 * args[0].numel()
    else:
        raise ValueError(name)
    t_bytes, t_flops = byts / PEAK_BYTES_S, flops / PEAK_FLOPS
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations", byts, flops)


def library_ms(name, args):
    """Time of the one PyTorch call that computes the same function on the
    same inputs (prepared outside the timing), or None.  A yardstick only:
    the port never calls it.  ``index_add_`` adds with float atomics in no
    fixed order, so it is a yardstick of speed, not of the bits."""
    import torch

    if name == "seg_sum":
        rows, seg, num_segs = args
        b, r, n = rows.shape
        src = rows.permute(0, 2, 1).reshape(b * n, r).contiguous()
        idx = (seg.long() + num_segs * torch.arange(
            b, device=seg.device)[:, None]).reshape(-1)
        out = torch.zeros((b * num_segs, r), device=rows.device)
        return _time_ms(lambda: out.index_add_(0, idx, src), (), {}, 20)
    if name == "seg_gather":
        table, seg = args
        idx = seg.long()[:, None, :].expand(-1, table.shape[1], -1)
        return _time_ms(lambda: torch.gather(table, 2, idx), (), {}, 20)
    return None


def redesigned_kernel_checks(dev, fails, sweep_inputs, fit_inputs,
                             gather_input) -> None:
    """Phase 3's checks of the sweep plan, the planned apply and moments2
    sweeps, seg_gather and the co-operative fit_level (see the module
    docstring).  ``sweep_inputs``: label -> apply_sweep arguments captured
    from the main path; ``fit_inputs``: mode -> fit_level arguments;
    ``gather_input``: seg_gather's captured (table, seg)."""
    import torch
    from patchwork_tpu_torch.kernels import fit_cuda, seg_cuda

    same = _same_bits

    for label, a in sorted(sweep_inputs.items()):
        pts, state, tab, trash = a[:4]
        sp = tab.shape[2]
        plan = fit_cuda.sweep_plan(state, sp)
        again = fit_cuda.sweep_plan(state, sp)
        want = fit_cuda.sweep_plan_plain(state, sp)
        ok_plan = (same(plan.tensors(), want.tensors())
                   and same(plan.tensors(), again.tensors()))
        nodes = float(plan.tile_off[:, -1].float().mean()) / (
            pts.shape[2] // fit_cuda.TILE)
        t_plan = _time_ms(fit_cuda.sweep_plan, (state, sp), {}, 10)
        line = []
        for fast in (False, True):
            runs = []
            for _ in range(2):
                st = state.clone()
                runs.append((fit_cuda.apply_sweep(pts, st, tab, trash, fast,
                                                  plan), st))
            st = state.clone()
            ref = (fit_cuda.apply_sweep_plain(pts, st, tab, trash, fast), st)
            torch.cuda.synchronize()
            ok = same(runs[0], ref) and same(runs[0], runs[1])
            ms = _time_ms(fit_cuda.apply_sweep,
                          (pts, state, tab, trash, fast, plan), {}, 20)
            line.append(f"{'fast' if fast else 'exact'} {ms:.3f} ms "
                        f"{'ok' if ok else 'MISMATCH'}")
            fails.check(ok, f"apply_sweep with a shared plan, {label} "
                            f"{'fast' if fast else 'exact'}: differs from its "
                            "plain version or between two runs")
        # the moments2 sweep about the table's centroids: on the plan the
        # apply sweeps above used (twice), right after an apply sweep on it,
        # and with no plan
        ctab = tab[:, :3].contiguous()
        ref = fit_cuda.moments2_sweep_plain(pts, state, ctab, trash)
        runs = [fit_cuda.moments2_sweep(pts, state, ctab, trash, plan)
                for _ in range(2)]
        st = state.clone()
        fit_cuda.apply_sweep(pts, st, tab, trash, False, plan)
        after = fit_cuda.moments2_sweep(pts, st, ctab, trash, plan)
        ref_after = fit_cuda.moments2_sweep_plain(pts, st, ctab, trash)
        alone = fit_cuda.moments2_sweep(pts, state, ctab, trash)
        torch.cuda.synchronize()
        ok = (same(runs[0], ref) and same(runs[0], runs[1])
              and same(alone, ref) and same(after, ref_after)
              and int(plan.done.abs().sum()) == 0)
        ms = _time_ms(fit_cuda.moments2_sweep,
                      (pts, state, ctab, trash, plan), {}, 20)
        line.append(f"moments2 {ms:.3f} ms {'ok' if ok else 'MISMATCH'}")
        fails.check(ok, f"moments2_sweep, {label}: differs from its plain "
                        "version with a shared plan, after an apply sweep "
                        "on it, without a plan or between two runs")
        print(f"[3 redesigned] sweeps {label} B={pts.shape[0]} "
              f"N={pts.shape[2]} Sp={sp}, {nodes:.2f} nodes per tile: plan "
              f"{'ok' if ok_plan else 'MISMATCH'} ({t_plan:.3f} ms), "
              + ", ".join(line), flush=True)
        fails.check(ok_plan, f"sweep plan, {label}: differs from its plain "
                             "version or between two runs")

    # seg_gather beyond the main path's shapes: 1, 3 and 8 channels, point
    # counts that are no multiple of 4 (rows off a 16-byte boundary)
    table, seg = gather_input
    for c in (1, 3, 8):
        tab_c = table[:, :1].expand(-1, c, -1) * torch.arange(
            1, c + 1, device=dev, dtype=torch.float32)[None, :, None]
        tab_c = tab_c.contiguous()
        oks = []
        for n in (seg.shape[1], seg.shape[1] - 1, seg.shape[1] - 2, 1027):
            ids = seg[:, :n].contiguous()
            got = seg_cuda.seg_gather(tab_c, ids)
            oks.append(same(got, seg_cuda.seg_gather_plain(tab_c, ids))
                       and same(got, seg_cuda.seg_gather(tab_c, ids)))
        print(f"[3 redesigned] seg_gather C={c} N={seg.shape[1]}, -1, -2, "
              f"1027: {'ok' if all(oks) else 'MISMATCH'}", flush=True)
        fails.check(all(oks), f"seg_gather C={c}: differs from its plain "
                              "version at some N")

    for mode, (args, kw) in sorted(fit_inputs.items()):
        p, g0, num_segs, max_iter = args
        fast = kw["fast"]
        n = p.shape[2]
        blocks = {b: fit_cuda.fit_level_blocks(b, n, num_segs, fast)
                  for b in (1, 3, 8)}
        print(f"[3 redesigned] fit_level {mode} N={n}: one co-operative "
              f"launch, blocks per scan {blocks}", flush=True)
        for b in (1, 3, 8):
            pb, gb = p[:b].contiguous(), g0[:b].contiguous()
            for mi in (max_iter, 2):
                sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
                got = fit_cuda.fit_level(pb, gb, num_segs, mi, fast=fast,
                                         sweeps_out=sweeps)
                again = fit_cuda.fit_level(pb, gb, num_segs, mi, fast=fast)
                # the batch of 8 at the full max_iter was held to the plain
                # version above, as the family's own entry
                want = got if (b, mi) == (8, max_iter) else \
                    fit_cuda.fit_level_plain(pb, gb, num_segs, mi, fast)
                torch.cuda.synchronize()
                ok = same(got, want) and same(got, again)
                solo = b == 8 and all(
                    same(fit_cuda.fit_level(pb[i:i + 1].contiguous(),
                                            gb[i:i + 1].contiguous(),
                                            num_segs, mi, fast=fast),
                         (got[0][i:i + 1], got[1][i:i + 1]))
                    for i in range(b))
                exits = ["max_iter" if k == mi + 2 else "converged"
                         for k in sweeps.tolist()]
                print(f"[3 redesigned] fit_level {mode} B={b} max_iter {mi}: "
                      f"sweeps per scan {sweeps.tolist()} ({exits.count('max_iter')}"
                      f" max_iter exits), vs plain and run twice "
                      f"{'ok' if ok else 'MISMATCH'}"
                      + (f", each scan alone {'ok' if solo else 'MISMATCH'}"
                         if b == 8 else ""), flush=True)
                fails.check(ok, f"fit_level {mode} B={b} max_iter {mi}: "
                                "differs from its plain version or between "
                                "two runs")
                if b == 8:
                    fails.check(solo, f"fit_level {mode} max_iter {mi}: a "
                                      "scan alone differs from the batch")
        if mode == "exact":
            got = fit_cuda.fit_level(p, g0, num_segs, 2, fast=fast)[0]
            fails.check(not torch.equal(
                got, fit_cuda.fit_level(p, g0, num_segs, max_iter,
                                        fast=fast)[0]),
                "fit_level: the max_iter exit equals the convergence exit")


def _same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)
               for x, y in zip(_tensors(a), _tensors(b)))


def level_sweeps(core) -> list:
    """Per scan the sweeps (sweep 0 included) of level_core's captured
    call ``core`` = (args, kwargs)."""
    import torch
    from patchwork_tpu_torch.kernels import fit_cuda

    args, kw = core
    a = _clone(args)
    sweeps = torch.zeros(a[0].shape[0], dtype=torch.int32,
                         device=a[0].device)
    fit_cuda.level_core(*a, sweeps_out=sweeps, **kw)
    return sweeps.tolist()


def level_core_checks(dev, fails, inputs) -> dict:
    """Phase 3's checks of level_core, kernel #1's level in one co-operative
    launch: ``inputs`` maps (scene, mode) to (level_core's arguments,
    engine.level's arguments) as the main path gave them, each (args,
    kwargs).  The launch against its plain version (the phases one by one
    around the loop of plain sweeps) in every bit of the state and the
    stats, twice, at the full max_iter and at max_iter 2 (a max_iter exit,
    checked), the first three scans and each scan alone against the
    batch; the whole level (R1, R1b, the medians and the
    launch) against level_reference, twice.  Timed beside the same level as
    its phases one by one (level_sequence over the kernels: the phase
    kernels and the loop of sweeps), by events and by device time; the
    launch's registers, spills and blocks per scan.  Returns the JSON keys
    of the family's entry (velodyne level 0, exact)."""
    import torch
    from patchwork_tpu_torch.kernels import _build, fit_cuda
    from patchwork_tpu_torch.segment import engine

    regs = {("fast" if "ILb1E" in k else "exact"): v
            for k, v in _build.ptxas_info(r"pw_fit_level_kernelILb.ELb1E").items()}
    print(f"[3 level_core] ptxas of the level layout of pw_fit_level_kernel: "
          f"{regs} (a register cap "
          f"of 48 under __launch_bounds__(256, 5))", flush=True)
    fails.check(len(regs) == 2, "no ptxas report of the level kernel")

    def run(fn, a, mi=None, **kw):
        a = _clone(a)
        if mi is not None:
            a = a[:4] + (mi,) + a[5:]
        return fn(*a, **kw), a[1]

    def cut(a, lo, hi):
        """Scans lo..hi of level_core's arguments."""
        return tuple(t[lo:hi].contiguous() if isinstance(t, torch.Tensor)
                     else tuple(x[lo:hi].contiguous() for x in t)
                     if isinstance(t, tuple) else t for t in a)

    entry = {}
    for (scene, mode), ((args, kw), (largs, lkw)) in sorted(inputs.items()):
        pts = args[0]
        b, n, sp, max_iter = pts.shape[0], pts.shape[2], args[2].shape[2], \
            args[4]
        fast = bool(args[10])
        blocks = fit_cuda.fit_level_blocks(b, n, sp, fast, level=True)
        b3 = min(b, 3)
        blocks3 = fit_cuda.fit_level_blocks(b3, n, sp, fast, level=True)
        sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
        got = run(fit_cuda.level_core, args, sweeps_out=sweeps)
        per_scan = sweeps.tolist()
        again = run(fit_cuda.level_core, args)
        held = []
        t_plain = _time_ms(lambda: held.append(
            run(fit_cuda.level_core_plain, args)), (), {}, 1)
        want = held.pop()
        ok = _same_bits(got, want) and _same_bits(got, again)
        sweeps2 = torch.zeros(b, dtype=torch.int32, device=dev)
        at2 = run(fit_cuda.level_core, args, 2, sweeps_out=sweeps2)
        ok2 = _same_bits(at2, run(fit_cuda.level_core_plain, args, 2))
        # max_iter 2 really leaves by max_iter: a scan that runs longer at
        # the full max_iter stops after sweep 0, two sweeps and the can = 0
        # one, and the mask differs
        cut_short = sum(k2 == 4 < k for k2, k in zip(sweeps2.tolist(),
                                                     per_scan))
        exits = cut_short > 0 and not torch.equal(at2[1][:, 0], got[1][:, 0])
        # the first three scans alone, more blocks a scan, at both max_iters
        ok3 = all(_same_bits(run(fit_cuda.level_core, cut(args, 0, b3), mi),
                             tuple(t[:b3] for t in whole))
                  for mi, whole in ((max_iter, got), (2, at2)))
        solo = all(_same_bits(run(fit_cuda.level_core, cut(args, i, i + 1)),
                              (got[0][i:i + 1], got[1][i:i + 1]))
                   for i in range(b))
        lvl = engine.level(*_clone(largs), **lkw)
        lvl2 = engine.level(*_clone(largs), **lkw)
        ref = engine.level_reference(*_clone(largs), **lkw)
        if not lkw.get("adaptive", True):
            # the order statistic leaves zth of an empty node undefined
            # (its rank is out of range): stats row 6 where cnt is 0
            empty = ref[1][:, 3] == 0
            for st in (lvl[1], lvl2[1], ref[1]):
                st[:, 6][empty] = 0.0
        ok_ref = _same_bits(lvl, ref) and _same_bits(lvl, lvl2)
        picks = int((want[1][:, 2] > 0.5).sum().item())
        # the non-finite coordinates reach the result: the stats differ
        # from those of the same points made finite
        finite = (torch.nan_to_num(args[0], 0.0, 1.0, -1.0),) + args[1:]
        nonfinite = not _same_bits(got[0], run(fit_cuda.level_core,
                                               finite)[0])
        print(f"[3 level_core] {scene} {mode} B={b} N={n} Sp={sp}: one "
              f"launch, {blocks} blocks a scan, sweeps per scan {per_scan} "
              f"(sweep 0 included), deficient picks {picks}, stats moved by"
              f" non-finite points {nonfinite}; vs plain and run twice "
              f"{'ok' if ok else 'MISMATCH'}, at max_iter 2 "
              f"{'ok' if ok2 else 'MISMATCH'} ({cut_short} scans cut short)"
              f", B={b3} ({blocks3} blocks a scan) "
              f"{'ok' if ok3 else 'MISMATCH'}, each scan alone "
              f"{'ok' if solo else 'MISMATCH'}; the level vs "
              f"level_reference and twice {'ok' if ok_ref else 'MISMATCH'}",
              flush=True)
        fails.check(ok and ok2, f"level_core {scene} {mode}: differs from "
                                "its plain version or between two runs")
        fails.check(exits, f"level_core {scene} {mode}: the max_iter exit "
                           "equals the convergence exit")
        fails.check(ok3, f"level_core {scene} {mode}: the first {b3} scans "
                         "alone differ from the batch")
        fails.check(solo, f"level_core {scene} {mode}: a scan alone differs "
                          "from the batch")
        fails.check(ok_ref, f"level {scene} {mode}: differs from "
                            "level_reference or between two runs")
        if scene.startswith("deficient"):
            fails.check(picks > 0, f"level_core {scene}: no deficient pick")
        if scene.startswith("NaN"):
            fails.check(nonfinite, f"level_core {scene}: the non-finite "
                                   "points changed no stat")
        # the launch beside the same level as its phases one by one, on the
        # same input
        t_one = _time_ms(fit_cuda.level_core, args, kw, 5)
        t_seq = _time_ms(lambda *a: fit_cuda.level_sequence(fit_cuda, *a),
                         args, kw, 3)
        d_one = _device_ms(lambda: run(fit_cuda.level_core, args), 5,
                           r"pw_fit_level_kernel<\w+, true>") or float("nan")
        d_seq = _device_ms(lambda: run(
            lambda *a: fit_cuda.level_sequence(fit_cuda, *a), args), 3,
            "pw_") or float("nan")
        d_phases = _device_ms(lambda: run(
            lambda *a: fit_cuda.level_sequence(fit_cuda, *a), args), 3,
            "pw_stats|pw_early|pw_def|pw_seed|pw_split|pw_finish|pw_remap"
        ) or float("nan")
        bnd = kernel_bound("level_core", args, kw, got[0], per_scan)
        print(f"[3 level_core] {scene} {mode}: one launch {t_one:.3f} ms "
              f"(device {d_one:.4f} ms); its phases one by one {t_seq:.3f} ms"
              f" (device {d_seq:.4f} ms, of which the phases around the fit "
              f"{d_phases:.4f}); plain {t_plain:.1f} ms; bound {bnd[0]:.4f} "
              f"ms by {bnd[1]} ({bnd[2]} B, {bnd[3]} flop)", flush=True)
        if (scene, mode) == ("velodyne level 0", "exact"):
            entry = {"launch_ms": t_one, "launch_device_ms": d_one,
                     "phases_one_by_one_ms": t_seq,
                     "phases_one_by_one_device_ms": d_seq,
                     "phases_around_fit_device_ms": d_phases,
                     "launch_plain_ms": t_plain, "launch_bound_ms": bnd[0],
                     "launch_bound_by": bnd[1],
                     "sweeps_per_scan": per_scan,
                     "blocks_per_scan": blocks, "ptxas": regs}
    return entry


def order_stat_checks(dev, fails, inputs) -> dict:
    """Phase 3's checks of the order statistic on the main path's inputs
    (label -> arguments): against its plain version wherever the rank is in
    range, twice with equal bits everywhere, its time by events, its device
    time and its kernels per call."""
    import torch
    from patchwork_tpu_torch.kernels import fit_cuda

    # the worst case beside the main path's inputs: one node holds two
    # fifths of every scan (a dense near patch), and one block walks it
    vals, seg, valid, k, s = inputs["median, split remap level"]
    m = 2 * vals.shape[1] // 5
    seg, valid = seg.clone(), valid.clone()
    seg[:, :m] = 0
    valid[:, :m] = True
    k = torch.stack([torch.bincount(seg[b][valid[b]].long(), minlength=s)[:s]
                     for b in range(seg.shape[0])]) // 2
    inputs = dict(inputs)
    inputs["skewed, one node holds 2/5 of a scan"] = (
        vals, seg, valid, k.to(torch.int32), s)
    entry = {}
    for label, a in sorted(inputs.items()):
        vals, seg, valid, k, s = a
        cnt = torch.stack([torch.bincount(seg[b][valid[b]].long(),
                                          minlength=s)[:s]
                           for b in range(seg.shape[0])])
        ok_k = (k.long() >= 0) & (k.long() < cnt)
        got = fit_cuda.seg_order_stat(*a)
        want = fit_cuda.seg_order_stat_plain(*a)
        ok = (_same_bits(got[ok_k], want[ok_k])
              and _same_bits(got, fit_cuda.seg_order_stat(*a)))
        ms = _time_ms(fit_cuda.seg_order_stat, a, {}, 20)
        t_plain = _time_ms(fit_cuda.seg_order_stat_plain, a, {}, 3)
        d_ms, per_call = _device_ms(lambda: fit_cuda.seg_order_stat(*a), 20,
                                    "pw_os_", count=True)
        d_ms = float("nan") if d_ms is None else d_ms
        print(f"[3 order stat] {label} B={vals.shape[0]} N={vals.shape[1]} "
              f"Sp={s}, {int(ok_k.sum())} ranks in range: {ms:.3f} ms a call "
              f"(device {d_ms:.4f} ms, {per_call:.0f} kernels a call), plain "
              f"{t_plain:.3f} ms; vs plain and run twice "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        fails.check(ok, f"seg_order_stat {label}: differs from its plain "
                        "version or between two runs")
        fails.check(int(ok_k.sum()) > 0, f"seg_order_stat {label}: no rank "
                                         "in range")
        if label.startswith("median"):
            entry.update({"device_ms": d_ms, "kernels_per_call": per_call})
        elif label.startswith("skewed"):
            entry.update({"skewed_ms": ms, "skewed_device_ms": d_ms})
    return entry


def rounds_in_parts(fn, a, parts: int):
    """``fn`` (seg_order_stat or its plain version) with the per-round
    entry on ``parts`` ranks in threads of this process, each holding a
    contiguous block of every scan's points, each round's histograms summed
    over them as ``mesh.all_sum`` sums them over processes: every rank's
    result."""
    import threading

    vals, seg, valid, k, s = a
    n = vals.shape[1]
    cut = [n * r // parts for r in range(parts + 1)]
    barrier = threading.Barrier(parts, timeout=120)
    slots, outs, errors = [None] * parts, [None] * parts, []

    def run(r):
        def reduce(h):
            slots[r] = h
            barrier.wait()
            total = slots[0].clone()
            for other in slots[1:]:
                total += other
            barrier.wait()
            return total

        lo, hi = cut[r], cut[r + 1]
        try:
            outs[r] = fn(vals[:, lo:hi].contiguous(), seg[:, lo:hi].contiguous(),
                         valid[:, lo:hi].contiguous(), k, s, reduce=reduce)
        except Exception as e:   # noqa: BLE001 - reported by the caller
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(parts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs


def order_stat_rounds_checks(dev, fails, a) -> dict:
    """Phase 3's checks of #2's per-round entry (seg_order_stat with a
    ``reduce``), on the split remap level's median inputs with the ranks in
    range selected: whole and in two halves whose histograms are summed,
    against its plain version and the one-launch kernel bit for bit; its
    time by events (whole, ``reduce`` the identity), device time, kernels a
    call and bound.  Returns its JSON entry."""
    import torch
    from patchwork_tpu_torch.kernels import fit_cuda

    vals, seg, valid, k, s = a
    cnt = torch.stack([torch.bincount(seg[b][valid[b]].long(), minlength=s)[:s]
                       for b in range(seg.shape[0])])
    k = torch.where(k.long() < cnt, k, -1).to(torch.int32).contiguous()
    a = (vals, seg, valid, k, s)
    used = k >= 0

    def ident(h):
        return h

    got = fit_cuda.seg_order_stat(*a, reduce=ident)
    want = fit_cuda.seg_order_stat_plain(*a, reduce=ident)
    halves = rounds_in_parts(fit_cuda.seg_order_stat, a, 2)
    halves_plain = rounds_in_parts(fit_cuda.seg_order_stat_plain, a, 2)
    one_launch = fit_cuda.seg_order_stat(*a)
    ok = {"whole vs plain": _same_bits(got, want),
          "halves vs plain halves": all(_same_bits(h, p) for h, p in
                                        zip(halves, halves_plain)),
          "halves vs whole": all(_same_bits(h, got) for h in halves),
          "vs the one-launch kernel": _same_bits(got[used], one_launch[used]),
          "run twice": _same_bits(got, fit_cuda.seg_order_stat(
              *a, reduce=ident))}
    err = max(_abs_err(got, want), max(_abs_err(h, p) for h, p in
                                        zip(halves, halves_plain)))
    ms = _time_ms(lambda *x: fit_cuda.seg_order_stat(*x, reduce=ident), a,
                  {}, 20)
    plain_ms = _time_ms(lambda *x: fit_cuda.seg_order_stat_plain(
        *x, reduce=ident), a, {}, 3)
    d_ms, per_call = _device_ms(
        lambda: fit_cuda.seg_order_stat(*a, reduce=ident), 20, "pw_os_",
        count=True)
    bound = kernel_bound("seg_order_stat", a, {}, got, None)
    print(f"[3 order stat rounds] split remap level B={vals.shape[0]} "
          f"N={vals.shape[1]} Sp={s}, {int(used.sum())} segments counted: "
          f"{ms:.3f} ms a call (device {d_ms}, {per_call:.0f} kernels a "
          f"call), plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms by "
          f"{bound[1]}; two halves' histograms summed; {ok}", flush=True)
    fails.check(all(ok.values()), f"seg_order_stat_rounds: {ok}")
    fails.check(int(used.sum()) > 0, "seg_order_stat_rounds: no rank in "
                                     "range")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "device_ms": d_ms,
            "kernels_per_call": per_call}


def run_sum_check(dev, fails) -> None:
    """The voxel filter on the card (its run sums are a kernel of the port,
    though of no TPU kernel): two runs with equal bits, equal to the CPU's,
    and the kernel against its plain version."""
    import numpy as np
    import torch
    from patchwork_tpu_torch.io.synthetic import demo_point_cloud
    from patchwork_tpu_torch.kernels import seg_cuda
    from patchwork_tpu_torch.ops.sampling import voxel_grid_filter

    pts = torch.from_numpy(demo_point_cloud(N, seed=1))
    valid = torch.ones(N, dtype=torch.bool)
    runs = [voxel_grid_filter(pts.to(dev), valid.to(dev), 2.0)
            for _ in range(2)]
    cpu = voxel_grid_filter(pts, valid, 2.0)
    twice = _same_bits(runs[0], runs[1])
    as_cpu = _same_bits([t.cpu() for t in runs[0]], cpu)
    rng = np.random.default_rng(0)
    first = torch.from_numpy(rng.random(N) < 0.1)
    first[0] = True
    a = [pts.to(dev), first.to(dev), valid.to(dev),
         (torch.cumsum(first.long(), 0) - 1).to(torch.int32).to(dev)]
    vs_plain = _same_bits(seg_cuda.run_sum(*a), seg_cuda.run_sum_plain(*a))
    ms = _time_ms(seg_cuda.run_sum, a, {}, 20)
    lib = torch.zeros_like(a[0])
    idx = a[3].long()
    lib_ms = _time_ms(lambda: lib.index_add_(0, idx, a[0]), (), {}, 20)
    print(f"[3 run sum] voxel_grid_filter N={N}, voxel 2.0, "
          f"{int(runs[0][1].sum())} voxels: two runs on the card equal "
          f"{twice}, equal to the CPU's bits {as_cpu}; run_sum vs plain "
          f"{vs_plain}, {ms:.3f} ms (index_add_, float atomics: {lib_ms:.3f} "
          f"ms)", flush=True)
    fails.check(twice, "voxel_grid_filter: two runs on the card differ")
    fails.check(as_cpu, "voxel_grid_filter: the card's bits differ from the "
                        "CPU's")
    fails.check(vs_plain, "run_sum differs from its plain version")


def seg_op_checks(dev, fails, sums, minmaxes) -> dict:
    """Phase 3's checks of #6 seg_sum and #8 seg_minmax on the main path's
    inputs (label -> arguments; binning's sum, the generic path's deeper
    levels, the wide table's binding): every route against its plain
    version, twice, every bit; each one's time by events and on the
    device, with the bound and, for the sum, index_add_.  #6: a call with
    no plan (the dense route), a plan built for the call and the planned
    sum, and a sum over a binding's plan (built once); #8: its one route.
    Returns the JSON keys of the two families' entries."""
    import torch
    from patchwork_tpu_torch.kernels import fit_cuda, seg_cuda

    nan = float("nan")
    entry = {"seg_sum": {}, "seg_minmax": {}}
    for label, (rows, seg, s) in sums.items():
        want = fit_cuda.seg_sum_plain(rows, seg, s)
        plan = fit_cuda.seg_plan(seg, s)
        routes = {
            "dense": lambda: fit_cuda.seg_sum(rows, seg, s),
            "plan + planned": lambda: fit_cuda.seg_sum(
                rows, seg, s, plan=fit_cuda.seg_plan(seg, s)),
            "over a binding's plan": lambda: fit_cuda.seg_sum(rows, seg, s,
                                                              plan=plan)}
        row = {}
        for route, fn in routes.items():
            ok = _same_bits(fn(), want) and _same_bits(fn(), want)
            fails.check(ok, f"seg_sum {label}, {route}: differs from its "
                            "plain version or between two runs")
            row[route] = {"ms": _time_ms(fn, (), {}, 20),
                          "device_ms": _device_ms(fn, 20, "pw_") or nan,
                          "ok": ok}
        row["plan_device_ms"] = _device_ms(lambda: fit_cuda.seg_plan(seg, s),
                                           20, "pw_plan") or nan
        row["library_ms"] = library_ms("seg_sum", (rows, seg, s))
        row["bound_ms"] = kernel_bound("seg_sum", (rows, seg, s), {}, want,
                                       None)[0]
        entry["seg_sum"][label] = row
        print(f"[3 seg ops] seg_sum {label} B={rows.shape[0]} R={rows.shape[1]}"
              f" N={rows.shape[2]} S={s}: " + "; ".join(
                  f"{r} {v['ms']:.4f} ms (device {v['device_ms']:.4f}) "
                  f"{'ok' if v['ok'] else 'MISMATCH'}"
                  for r, v in row.items() if isinstance(v, dict))
              + f"; plan device {row['plan_device_ms']:.4f} ms; index_add_ "
              f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms",
              flush=True)
    for label, (vals, seg, mask, s) in minmaxes.items():
        want = seg_cuda.seg_minmax_plain(vals, seg, mask, s)
        routes = {"one launch": lambda: seg_cuda.seg_minmax(vals, seg, mask,
                                                             s)}
        row = {}
        for route, fn in routes.items():
            ok = _same_bits(fn(), want) and _same_bits(fn(), want)
            fails.check(ok, f"seg_minmax {label}, {route}: differs from its "
                            "plain version or between two runs")
            row[route] = {"ms": _time_ms(fn, (), {}, 20),
                          "device_ms": _device_ms(fn, 20, "pw_") or nan,
                          "ok": ok}
        row["bound_ms"] = kernel_bound("seg_minmax", (vals, seg, mask, s), {},
                                       want, None)[0]
        entry["seg_minmax"][label] = row
        print(f"[3 seg ops] seg_minmax {label} B={vals.shape[0]} "
              f"C={vals.shape[1]} N={vals.shape[2]} S={s}: " + "; ".join(
                  f"{r} {v['ms']:.4f} ms (device {v['device_ms']:.4f}) "
                  f"{'ok' if v['ok'] else 'MISMATCH'}"
                  for r, v in row.items() if isinstance(v, dict))
              + f"; bound {row['bound_ms']:.4f} ms", flush=True)
    return entry


class Capture:
    """Keep the arguments of chosen calls of module functions (cloned
    before the call, which may update its inputs in place)."""

    def __init__(self, module, names, pick):
        self.module, self.saved, self.calls = module, {}, {}
        self.orig = {n: getattr(module, n) for n in names}
        for name in names:
            setattr(module, name, self._wrap(name, pick.get(name, 1)))

    def _wrap(self, name, pick):
        fn = self.orig[name]

        def wrapped(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            if self.calls[name] == pick:
                self.saved[name] = (_clone(args), dict(kwargs))
            return fn(*args, **kwargs)

        return wrapped

    def restore(self):
        for name, fn in self.orig.items():
            setattr(self.module, name, fn)


def first_calls(run, module, name, label_of) -> dict:
    """The arguments of the first call of ``module.name`` under each label
    that ``label_of(args)`` gives it (None: not kept) while ``run()``
    runs, cloned before the call."""
    saved = {}
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        label = label_of(args)
        if label and label not in saved:
            saved[label] = _clone(args)
        return orig(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return saved


def min_iou(a, b) -> float:
    """Smallest per-scan IoU of two (B, N) bool masks."""
    inter = (a & b).sum(1).double()
    union = (a | b).sum(1).double().clamp(min=1)
    return float((inter / union).min().item())


def level_path(engine, fn, *args, **kwargs):
    """Run ``fn`` with the fit gate open: filter_ground_batched then takes
    the level path (``_fused_levels``) at any scan size."""
    gate = engine._gate
    engine._gate = lambda n, sp: True
    try:
        return fn(*args, **kwargs)
    finally:
        engine._gate = gate


@contextlib.contextmanager
def card_gate(admits):
    """Run with the card's gate of the one-launch fit replaced by
    ``admits(sp)``: ``lambda sp: False`` sends every fit to the loop of
    sweeps."""
    from patchwork_tpu_torch.kernels import fit_cuda

    gate = fit_cuda.fit_level_fits
    fit_cuda.fit_level_fits = (
        lambda sp, fast, device, level=False: admits(sp))
    try:
        yield
    finally:
        fit_cuda.fit_level_fits = gate


def _time_ms(fn, args, kwargs, reps: int) -> float:
    """Mean CUDA-event time of fn over reps back-to-back calls, each on its
    own clone of the inputs (a sweep updates its inputs in place)."""
    import torch

    clones = [_clone(args) for _ in range(reps)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in clones:
        fn(*a, **kwargs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, pattern: str, count: bool = False):
    """Mean device time per call (torch.profiler) of the kernels whose
    name matches ``pattern``; None where the profiler saw none.  With
    ``count`` also the number of those kernels per call."""
    from patchwork_tpu_torch.core.timing import device_busy_ms

    window = device_busy_ms(fn, reps, pattern)
    ms = window.busy_ms if window.busy_ms > 0 else None
    return (ms, window.kernels) if count else ms


def scans_per_s(xyz, valid, cfg, plain, reps, warm=True):
    """Scans/s of filter_ground_batched over ``reps`` calls (CUDA events),
    after a warm-up call unless the path has run before."""
    import torch
    from patchwork_tpu_torch import filter_ground_batched

    if warm:
        filter_ground_batched(xyz, valid, cfg, plain=plain)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        filter_ground_batched(xyz, valid, cfg, plain=plain)
    end.record()
    torch.cuda.synchronize()
    return reps * xyz.shape[0] / (start.elapsed_time(end) / 1000.0)


def read_png(path: str):
    """Decode an 8-bit RGB PNG with unfiltered rows, as viz.bev.save_png
    writes it, to an (H, W, 3) uint8 array (zlib only)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


def _cli_counts(text: str):
    g = re.search(r"Ground points: (\d+)", text)
    n = re.search(r"Non-ground points: (\d+)", text)
    return (int(g.group(1)), int(n.group(1))) if g and n else None


def _write_kitti(directory: str, clouds) -> None:
    import numpy as np

    os.makedirs(directory, exist_ok=True)
    for i, pts in enumerate(clouds):
        rec = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
        rec.astype(np.float32).tofile(os.path.join(directory, f"{i:06d}.bin"))


def phase7(dev, card: str, fails: Failures) -> dict:
    """The front ends on the card (see the module docstring); returns the
    launch counts of their own calls per kernel family."""
    import numpy as np
    import torch
    from patchwork_tpu_torch import (
        PatchworkConfig, PointCloudProcessor, RecursivePatchwork, cli,
        filter_ground, filter_ground_batched)
    from patchwork_tpu_torch.core.config import default_lidar_configs
    from patchwork_tpu_torch.fusion.fusion import LidarFusion
    from patchwork_tpu_torch.io.bag import write_mcap_topics
    from patchwork_tpu_torch.io.synthetic import (
        demo_point_cloud, fused_iac_cloud, iac_three_lidar_scene,
        split_terrain_cloud, velodyne_like_cloud)
    from patchwork_tpu_torch.kernels import fit_cuda
    from patchwork_tpu_torch.launch import load_launch, run_launch
    from patchwork_tpu_torch.node import PatchworkNode
    from patchwork_tpu_torch.viz.bev import (
        bev_ground_nonground_image, bev_height_image)

    fit_cuda.reset_launches()
    front = {k: 0 for k in fit_cuda.LAUNCHES}

    def front_end(fn, *args, **kwargs):
        """Call an entry point, adding its launches to phase 7's counts."""
        before = dict(fit_cuda.LAUNCHES)
        out = fn(*args, **kwargs)
        for k, v in fit_cuda.LAUNCHES.items():
            front[k] += v - before[k]
        return out

    def on_card(pts):
        xyz = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
        return xyz, torch.ones(xyz.shape[:-1], dtype=torch.bool, device=dev)

    def counts(res):
        return int(res.num_ground()), int(res.num_non_ground())

    cfg_exact, cfg_fast = PatchworkConfig(), PatchworkConfig(fast_covariance=True)

    # (a) fusion, then the engine on the fused clouds
    # no device argument anywhere an entry point is built: the card is the
    # default, and what comes back must lie on it
    fused = [front_end(fused_iac_cloud, N, seed=s) for s in range(B)]
    same = all(np.array_equal(a.view(np.int32),
                              fused_iac_cloud(N, seed=s,
                                              device="cpu").view(np.int32))
               for s, a in enumerate(fused))
    clouds0 = iac_three_lidar_scene(N // 3 + 512, seed=0)
    fuser = LidarFusion()
    on_default = [fuser.device.type == "cuda",
                  front_end(fuser.fuse, clouds0).xyz.is_cuda]   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        front_end(fuser.fuse, clouds0).xyz.sum()
    torch.cuda.synchronize()
    fuse_ms = (time.perf_counter() - t0) / 5 * 1e3
    iac = on_card(np.stack(fused))
    g_ex = front_end(filter_ground_batched, *iac, cfg_exact).ground
    g_fa = front_end(filter_ground_batched, *iac, cfg_fast).ground
    g_pl = filter_ground_batched(*iac, cfg_exact, plain=True).ground
    diff = int((g_ex != g_pl).sum().item())
    iou = min_iou(g_ex, g_fa)
    rate = {m: scans_per_s(*iac, c, False, 3)
            for m, c in (("exact", cfg_exact), ("fast", cfg_fast))}
    print(f"[7a fusion] fused_iac B={B} N={N} on the card equal to the CPU "
          f"fusion: {same}; LidarFusion.fuse of one 3 x {N // 3 + 512} scene "
          f"{fuse_ms:.3f} ms; exact kernel vs plain differing mask bits "
          f"{diff}; fast vs exact min IoU {iou:.6f}; engine {rate['exact']:.1f}"
          f" scans/s exact, {rate['fast']:.1f} fast on {card}", flush=True)
    fails.check(same, "fused_iac: the card's fusion differs from the CPU's")
    fails.check(diff == 0, f"fused_iac exact: {diff} mask bits differ")
    fails.check(iou >= IOU_FAST_MIN, f"fused_iac: fast IoU {iou} < 0.999")

    # (b) the API's enhanced filtering
    rp_cpu = RecursivePatchwork(cfg_exact, device="cpu")
    rp = RecursivePatchwork(cfg_exact)
    on_default += [rp.device.type == "cuda",
                   rp.segment(fused[0])[0].ground.is_cuda,
                   not rp_cpu.segment(fused[0][:4096])[0].ground.is_cuda]
    sel = front_end(rp.sample_ground_and_obstacles, fused[0])
    sel_cpu = rp_cpu.sample_ground_and_obstacles(fused[0])
    ground_rows = {r.tobytes() for r in rp_cpu.filter_ground_points(fused[0])[0]}

    def band(rows):
        return np.array([r for r in rows if r.tobytes() not in ground_rows])

    b_card, b_cpu = band(sel), band(sel_cpu)
    n_sample = min(2000, len(ground_rows))
    ok = (np.array_equal(b_card, b_cpu)
          and len(sel) == len(b_card) + n_sample == len(sel_cpu))
    print(f"[7b api] sample_ground_and_obstacles fused_iac seed 0: band "
          f"{len(b_card)} (CPU {len(b_cpu)}), selected {len(sel)} = band + "
          f"{n_sample}: {ok}", flush=True)
    fails.check(ok, "sample_ground_and_obstacles differs from the CPU port")

    # the NumPy-in / NumPy-out utilities: with no device each one allocates
    # on the card, and agrees with device="cpu" (masks and the rotation bit
    # for bit; sums to 1e-4, which add in another order)
    pts = demo_point_cloud(N, seed=1)
    pts[::97] = np.nan
    clean = PointCloudProcessor.remove_nan_points(pts, device="cpu")
    plane = ([1.0, 2.0, 0.5], [0.1, 0.2, 0.97])
    utils = [(PointCloudProcessor.remove_nan_points, pts, (), 0),
             (PointCloudProcessor.filter_by_distance, pts, (5.0, 30.0), 0),
             (PointCloudProcessor.filter_by_height, pts, (0.2, 1.7), 0),
             (PointCloudProcessor.compute_centroid, clean, (), 1e-4),
             (PointCloudProcessor.compute_covariance, clean, (), 1e-4),
             (PointCloudProcessor.compute_distances_to_plane, clean, plane,
              1e-4),
             (PointCloudProcessor.voxel_grid_filter, clean, (2.0,), 1e-4),
             (PointCloudProcessor.random_subsample, clean, (2000, 3), None),
             (RecursivePatchwork.rotate_points_2d, clean, (37.5,), 0),
             (RecursivePatchwork.remove_ego_vehicle, clean, (4.0,), 0)]
    bad = []
    for fn, cloud, args, tol in utils:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = front_end(fn, cloud, *args)
        ran_on_card = torch.cuda.max_memory_allocated() > base
        want = fn(cloud, *args, device="cpu")
        agree = got.shape == want.shape
        if tol == 0:
            agree = agree and np.array_equal(got.view(np.int32),
                                             want.view(np.int32))
        elif tol is not None:   # a sample is drawn on its device: shape only
            agree = agree and np.allclose(got, want, rtol=tol, atol=tol)
        on_default.append(ran_on_card)
        if not (ran_on_card and agree):
            bad.append(fn.__name__)
    print(f"[7b utilities] PointCloudProcessor and the API's static "
          f"utilities, {len(utils)} calls with no device on N={N}: on the "
          f"card and equal to device=\"cpu\": {not bad} {bad}", flush=True)
    fails.check(not bad, f"utilities not on the card or unlike the CPU: {bad}")

    with tempfile.TemporaryDirectory() as tmp:
        # (c) the CLI in this process: demo cloud, then a split-terrain frame
        prefix = os.path.join(tmp, "demo")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = front_end(cli.main, [
                "--demo", "--num-points", str(N), "--use-patchwork",
                "--separate-display", "--device", dev.type,
                "--out-prefix", prefix])
        cli_ms = (time.perf_counter() - t0) * 1e3
        pts = demo_point_cloud(N, seed=0)
        res = filter_ground(*on_card(pts), cfg_exact)
        non_ground = res.valid & ~res.ground
        img1 = read_png(prefix + "_patchwork.png")
        want1 = bev_ground_nonground_image(on_card(pts)[0], res.ground,
                                           non_ground, 300, 150, -150.0,
                                           -75.0, 150.0, 75.0)
        filt = rp.sample_ground_and_obstacles(pts, 1.1, 0.5, seed=0)
        img2 = read_png(prefix + "_enhanced.png")
        want2 = bev_height_image(*on_card(filt), 300, 150, -150.0, -75.0,
                                 150.0, 75.0)
        ok = (rc == 0 and _cli_counts(out.getvalue()) == counts(res)
              and np.array_equal(img1, want1.cpu().numpy())
              and np.array_equal(img2, want2.cpu().numpy()))
        print(f"[7c cli] demo N={N}: rc {rc}, counts "
              f"{_cli_counts(out.getvalue())} vs filter_ground {counts(res)}, "
              f"PNGs decode to the images: {ok}; {cli_ms:.1f} ms in process",
              flush=True)
        fails.check(ok, "CLI demo: counts or images differ")

        kdir = os.path.join(tmp, "split")
        pts = split_terrain_cloud(N, seed=0)
        _write_kitti(kdir, [pts])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = front_end(cli.main, [
                "--kitti", kdir, "--frame", "0", "--use-patchwork",
                "--device", dev.type, "--out-prefix",
                os.path.join(tmp, "split")])
        want = counts(filter_ground(*on_card(pts), cfg_exact))
        ok = rc == 0 and _cli_counts(out.getvalue()) == want
        print(f"[7c cli] split-terrain KITTI frame N={N}: rc {rc}, counts "
              f"{_cli_counts(out.getvalue())} vs filter_ground {want}",
              flush=True)
        fails.check(ok, "CLI kitti: counts differ")

        # the same frame with a node table above the card's gate: the fits
        # of its deeper levels run as loops of sweeps
        wide = {"max_active_nodes_cfg": WIDE_NODES}
        out = io.StringIO()
        before = dict(front)
        with contextlib.redirect_stdout(out):
            rc = front_end(cli.main, [
                "--kitti", kdir, "--frame", "0", "--use-patchwork",
                "--device", dev.type, "--config-json", json.dumps(wide),
                "--out-prefix", os.path.join(tmp, "wide")])
        want = counts(filter_ground(*on_card(pts), PatchworkConfig(**wide)))
        sweeps = front["apply_sweep"] - before["apply_sweep"]
        ok = rc == 0 and _cli_counts(out.getvalue()) == want and sweeps > 0
        print(f"[7c cli] the same frame with {wide}: rc {rc}, counts "
              f"{_cli_counts(out.getvalue())} vs filter_ground {want}, "
              f"{sweeps} apply sweeps", flush=True)
        fails.check(ok, "CLI kitti above the card's gate: counts differ or "
                        "no loop of sweeps ran")

        # (d) the CLI as a process: 3-topic bag -> fusion -> engine
        bag = os.path.join(tmp, "iac.mcap")
        write_mcap_topics(bag, {c.topic_name + "/points": [x] for c, x in
                                zip(default_lidar_configs(), clouds0)},
                          compression="none")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "patchwork_tpu_torch.cli", bag,
             "--use-patchwork"], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=600)
        proc_s = time.perf_counter() - t0
        fused0 = fuser.fuse(clouds0).to_numpy()
        want = counts(rp.segment(fused0)[0])
        got = _cli_counts(proc.stdout)
        print(f"[7d cli] python -m patchwork_tpu_torch.cli <3-topic mcap> "
              f"--use-patchwork: rc {proc.returncode}, counts {got} vs "
              f"fusion + engine {want} ({len(fused0)} fused points); "
              f"{proc_s:.1f} s as a process", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:] + proc.stderr[-2000:], flush=True)
        fails.check(proc.returncode == 0 and got == want,
                    "CLI bag: counts differ or the process failed")

        # (e) launch descriptor over 128-beam KITTI frames of N_GEN points
        kdir = os.path.join(tmp, "velo128")
        frames = [velodyne_like_cloud(N_GEN, seed=s, num_beams=128)
                  for s in range(B)]
        _write_kitti(kdir, frames)
        for label, config in (("default", {}), ("pallas",
                                                {"segment_impl": "pallas"})):
            desc_path = os.path.join(tmp, f"launch_{label}.json")
            with open(desc_path, "w") as f:
                json.dump({"source": {"kitti": kdir}, "capacity": N_GEN,
                           "config": config}, f)
            before = dict(front)
            t0 = time.perf_counter()
            results, node = front_end(run_launch, load_launch(desc_path),
                                      log=lambda s: None)
            on_default.append(node.device.type == "cuda")
            dt = time.perf_counter() - t0
            got_l = {k: front[k] - before[k] for k in front}
            ref = filter_ground_batched(*on_card(np.stack(frames)),
                                        node.config).ground.cpu().numpy()
            ok = (len(results) == B and all(
                np.array_equal(r.ground_mask, ref[r.index]) for r in results))
            print(f"[7e launch] {label} config, {len(results)} of {B} frames "
                  f"of {N_GEN} points, masks equal filter_ground_batched: "
                  f"{ok}; {B / dt:.1f} frames/s; launches {got_l}", flush=True)
            fails.check(ok, f"launch {label}: results missing or masks differ")

    # (f) the streaming node over 16 velodyne frames
    frames = [velodyne_like_cloud(N, seed=s) for s in range(2 * B)]
    for bs in (1, B):
        node = PatchworkNode(capacity=N, batch_size=bs)
        on_default += [node.device.type == "cuda",
                       node._pad(frames[:1], 1)[0].is_cuda]
        if bs == 1:
            ref = np.concatenate([
                filter_ground_batched(*on_card(np.stack(frames[i:i + B])),
                                      node.config).ground.cpu().numpy()
                for i in (0, B)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = front_end(node.run, frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ok = (len(results) == len(frames) and all(
            np.array_equal(r.ground_mask, ref[r.index]) for r in results))
        print(f"[7f node] batch_size {bs}: {len(results)} of {len(frames)} "
              f"frames of {N} points, masks equal filter_ground_batched: {ok};"
              f" {len(results) / dt:.1f} frames/s on {card}\n"
              f"{node.times.report()}", flush=True)
        fails.check(ok, f"node batch_size {bs}: results missing or masks "
                        "differ")

    print(f"[7 front ends] built with no device argument, on the card: "
          f"{all(on_default)} ({len(on_default)} checks); launches {front}",
          flush=True)
    fails.check(all(on_default), "an entry point built with no device "
                                 f"argument is not on the card: {on_default}")
    for fam, n in front.items():
        # #2's per-round entry serves the point-sharded engine (phase 9)
        fails.check(n > 0 or fam == "seg_order_stat_rounds",
                    f"kernel family {fam} never launched by the front ends")
    return front


def ba_sum_checks(dev, fails, label, bindings, tag="8 slam",
                  timed=True) -> dict:
    """BA's segment sums over a binding's plan (kernel #6, planned route)
    against seg_sum_plain, every chunk of eight rows, twice, every bit;
    with ``timed``, the time of the hot sums of a CG iteration (R=6 over
    keyframes, R=3 over landmarks) by events and on the device, the plan's
    build, the bound and index_add_'s time.  bindings: name -> (values
    (O, C), ids (O,), n)."""
    import torch
    from patchwork_tpu_torch.kernels import fit_cuda
    from patchwork_tpu_torch.slam import ba

    nan = float("nan")
    out = {}
    for name, (vals, ids, n) in bindings.items():
        # the layout of ba._make_seg_sums' "onehot" sums
        ids_p = fit_cuda._pad_ids(ids.int()[None])
        rows = ba._tile_rows(vals, ids_p.shape[1])
        plan = fit_cuda.seg_plan(ids_p, n)
        err, ok = 0.0, True
        for c0 in range(0, rows.shape[0], 8):
            r = rows[c0:c0 + 8][None]
            want = fit_cuda.seg_sum_plain(r, ids_p, n)
            got = [fit_cuda.seg_sum(r, ids_p, n, plan=plan) for _ in range(2)]
            ok = ok and all(_same_bits(g, want) for g in got)
            err = max(err, _abs_err(got[0], want))
        fails.check(ok and err == 0.0, f"BA sums {label} {name}: the planned "
                    f"sum differs from seg_sum_plain (max_abs_err {err})")
        if not timed:
            out[name] = {"O": int(ids.numel()), "S": int(n),
                         "channels": rows.shape[0], "max_abs_err": err,
                         "ok": ok}
            print(f"[{tag}] BA sums {label} {name} O={ids.numel()} S={n} "
                  f"C={rows.shape[0]}: planned vs plain max_abs_err "
                  f"{err:.3g} {'ok' if ok else 'MISMATCH'}", flush=True)
            continue
        hot = rows[:6 if name.startswith("obs_k") else 3][None].contiguous()

        def fn():
            return fit_cuda.seg_sum(hot, ids_p, n, plan=plan)

        src = hot[0].T.contiguous()
        idx = ids_p[0].long()
        acc = torch.zeros((n, hot.shape[1]), dtype=torch.float32, device=dev)
        row = {"O": int(ids.numel()), "S": int(n), "channels": rows.shape[0],
               "max_abs_err": err, "ok": ok, "R": hot.shape[1],
               "ms": _time_ms(fn, (), {}, 20),
               "device_ms": _device_ms(fn, 20, "pw_seg_sum") or nan,
               "plan_device_ms": _device_ms(
                   lambda: fit_cuda.seg_plan(ids_p, n), 10, "pw_plan") or nan,
               "library_ms": library_ms("seg_sum", (hot, ids_p, n)),
               "library_device_ms": _device_ms(
                   lambda: acc.index_add_(0, idx, src), 20, ".") or nan,
               "bound_ms": kernel_bound("seg_sum", (hot, ids_p, n), {},
                                        fn(), None)[0]}
        out[name] = row
        print(f"[{tag}] BA sums {label} {name} O={row['O']} S={n} "
              f"C={row['channels']}: planned vs plain max_abs_err {err:.3g} "
              f"{'ok' if ok else 'MISMATCH'}; R={row['R']} {row['ms']:.4f} ms "
              f"(device {row['device_ms']:.4f}), plan device "
              f"{row['plan_device_ms']:.4f} ms, index_add_ "
              f"{row['library_ms']:.4f} ms (device "
              f"{row['library_device_ms']:.4f}), bound {row['bound_ms']:.4f}"
              f" ms", flush=True)
    return out


def phase8(dev, card: str, fails: Failures) -> tuple:
    """SLAM on the card (see the module docstring); returns (the launch
    counts of the session per kernel family, the JSON keys of BA's sums,
    the session's BA problem and keywords)."""
    import numpy as np
    import torch
    from patchwork_tpu_torch import filter_ground_batched
    from patchwork_tpu_torch.kernels import fit_cuda
    from patchwork_tpu_torch.slam import ba, landmarks

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_slam_bench

    keep = {}
    cap = Capture(landmarks, ["bundle_adjust"], {})
    fit_cuda.reset_launches()
    try:
        res = torch_slam_bench.run(SLAM_KEYFRAMES, icp="parallel", keep=keep,
                                   log=lambda line: None)
    finally:
        cap.restore()
    launches = dict(fit_cuda.LAUNCHES)
    odo = keep["odo"]
    print(f"[8 slam] {SLAM_KEYFRAMES} keyframes, parallel ICP, loop drive "
          f"(tools/torch_slam_bench.py) on {card}: ATE odometry "
          f"{res['ate_odometry_m']:.4f} m, pose graph "
          f"{res['ate_posegraph_m']:.4f} m, BA {res['ate_ba_m']:.4f} m; "
          f"{res['loop_closures']} loop closures; stage s "
          f"{json.dumps(res['stage_s'])}; BA {json.dumps(res['ba_detail'])}",
          flush=True)
    print(f"[8 slam] the JAX package on this drive, CPU (a quality "
          f"reference, not a time): {JAX_SLAM_200KF_CPU}", flush=True)
    print(f"[8 slam] launches in the session: level {launches['level']}, "
          f"seg_sum {launches['seg_sum']}, seg_plan {launches['seg_plan']}; "
          f"all {dict((k, v) for k, v in launches.items() if v)}", flush=True)
    for fam in ("level", "seg_sum", "seg_plan"):
        fails.check(launches[fam] > 0, f"SLAM: kernel family {fam} never "
                                       "launched")
    fails.check(odo.device.type == "cuda"
                and odo._frames.stacked["obst"].is_cuda,
                "SLAM: the odometry does not live on the card")
    fails.check(res["ate_posegraph_m"] <= res["ate_odometry_m"],
                "SLAM: the pose graph made the trajectory worse")
    fails.check(res["ate_ba_m"] < SLAM_ATE_MAX,
                f"SLAM: final ATE {res['ate_ba_m']} >= {SLAM_ATE_MAX} m")

    # one extract chunk: the kernels' masks against the plain path's
    scans = keep["scans"][:8]
    longest = max(len(p) for p in keep["scans"])
    n = min(odo.cfg.capacity, max(4096, -(-longest // 4096) * 4096))
    padded = [odo._pad_host(p, n) for p in scans]
    xyz = torch.from_numpy(np.stack([x for x, _ in padded])).to(dev)
    valid = torch.from_numpy(np.stack([v for _, v in padded])).to(dev)
    gk = filter_ground_batched(xyz, valid, odo.pw).ground
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    gp = filter_ground_batched(xyz, valid, odo.pw, plain=True).ground
    end.record()
    torch.cuda.synchronize()
    rate_p = len(scans) / (start.elapsed_time(end) / 1000.0)
    rate_k = scans_per_s(xyz, valid, odo.pw, False, 10)
    diff = int((gk != gp).sum().item())
    print(f"[8 slam] extract chunk B={len(scans)} N={n} (max_levels "
          f"{odo.pw.max_levels}): kernel vs plain differing mask bits {diff} "
          f"of {gk.numel()}; kernel path {rate_k:.1f} scans/s, plain path "
          f"{rate_p:.2f} scans/s (one batch)", flush=True)
    fails.check(diff == 0, f"SLAM extract: {diff} mask bits differ")

    # BA: the planned sums on the session's own bindings, and two runs of
    # the solver on the same problem
    (prob,), kw = cap.saved["bundle_adjust"]
    k, l = prob.poses.shape[0], prob.points.shape[0]
    r, jp, jx = ba._obs_blocks(prob.poses, prob.points, prob)
    o = prob.obs_k.numel()
    # the dense solver's third binding: the distinct (keyframe, landmark)
    # pairs, more ids than the plan's shared table holds
    pairs = torch.unique(prob.obs_k.long() * l + prob.obs_l.long(),
                         return_inverse=True)[1]
    entry = {"session": ba_sum_checks(dev, fails, f"{SLAM_KEYFRAMES} kf", {
        "obs_k, A (36 channels)": (ba._outer(jp, jp).reshape(o, 36),
                                    prob.obs_k, k),
        "obs_l, C and bx (12 channels)": (torch.cat(
            [ba._outer(jx, jx).reshape(o, 9),
             torch.einsum("oai,oa->oi", jx, r)], 1), prob.obs_l, l),
        "pairs, B (18 channels)": (ba._outer(jp, jx).reshape(o, 18), pairs,
                                   int(pairs.max()) + 1)})}
    # the 1000-keyframe shape (BA_SHAPE): keyframe ids in runs, landmark
    # ids scattered, values from a seed
    bk, bl, bo = BA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    ok_ = torch.arange(bo, device=dev) // -(-bo // bk)
    ol_ = torch.randint(0, bl, (bo,), generator=gen, device=dev)
    vals = torch.randn((bo, 36), generator=gen, device=dev)
    entry["1000 kf shape"] = ba_sum_checks(dev, fails, "1000 kf shape", {
        "obs_k (36 channels)": (vals, ok_, bk),
        "obs_l (12 channels)": (vals[:, :12].contiguous(), ol_, bl)})
    solver = ba._auto_solver(k, l)
    runs = [ba.bundle_adjust(prob, **kw) for _ in range(2)]
    same = _same_bits(runs[0].poses, runs[1].poses) and _same_bits(
        runs[0].points, runs[1].points)
    print(f"[8 slam] bundle_adjust K={k} L={l} O={o} ({solver}, "
          f"{kw.get('iters')} iterations) run twice: poses and points equal "
          f"bit for bit {same}", flush=True)
    fails.check(same, "SLAM: two bundle_adjust runs on one problem differ")
    entry["solver"] = solver
    return launches, entry, (prob, kw)


def explicit_binding_checks(fails, label, xyz, valid, cfg) -> None:
    """The explicit engine's segment ops over one SegOps binding, as the
    point-sharded generic engine (shardmap_engine.patchwork_level) builds
    it on a rank's block (xyz (B, n, 3), valid (B, n)): the fit loop's 4-,
    5- (a changed-point row and the next sums) and 6-row sums (#6 over the
    binding's plan), a per-point gather of a 3-row table (#7) and the
    bounding boxes (#8), each twice against its plain version
    (fit_cuda.seg_sum_plain, torch.gather, seg_cuda.seg_minmax_plain) on
    the same inputs, every bit."""
    import torch
    from patchwork_tpu_torch.kernels import fit_cuda, seg_cuda
    from patchwork_tpu_torch.segment.binning import bin_points
    from patchwork_tpu_torch.segment.segops import SegOps

    s = cfg.num_patches + 1
    patch, in_patch, _, fin, _ = bin_points(xyz, valid, cfg)
    xt = torch.where(fin[..., None], xyz, torch.zeros_like(xyz)).permute(
        0, 2, 1).contiguous()
    g = in_patch.to(torch.float32)[:, None]
    x, y, z = (xt * g).unbind(1)
    ops = SegOps(patch, s, "pallas")
    seg = ops.seg
    m1 = torch.cat([g, xt * g], 1)
    m2 = torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], 1)
    sums = ops.sum(m1)
    table = sums[:, 1:4] / torch.clamp(sums[:, :1], min=1.0)
    checks = {
        "sum 4 rows": (lambda: ops.sum(m1),
                       fit_cuda.seg_sum_plain(m1, seg, s)),
        "sum 5 rows": (lambda: ops.sum(torch.cat([g, m1], 1)),
                       fit_cuda.seg_sum_plain(torch.cat([g, m1], 1), seg, s)),
        "sum 6 rows": (lambda: ops.sum(m2),
                       fit_cuda.seg_sum_plain(m2, seg, s)),
        "gather 3 rows": (lambda: ops.gather(table), torch.gather(
            table, 2, seg.long()[:, None].expand(-1, 3, -1))),
        "bbox": (lambda: ops.bbox(xt, in_patch), seg_cuda.seg_minmax_plain(
            xt, seg, in_patch, s))}
    ok = {}
    for name, (fn, want) in checks.items():
        ok[name] = _same_bits(fn(), want) and _same_bits(fn(), want)
        fails.check(ok[name], f"parallel (a) explicit binding {label} "
                              f"{name}: differs from its plain version")
    print(f"[9 parallel] (a) explicit engine's binding {label} "
          f"B={xyz.shape[0]} n={xyz.shape[1]} S={s} (plan "
          f"{ops.plan is not None}): kernel vs plain, twice, every bit "
          f"{ok}", flush=True)


def ba_block_bindings(prob, lo: int, hi: int, dense: bool) -> dict:
    """The bindings bundle_adjust_sharded sums over on the rank that holds
    observations lo..hi-1 of ``prob``, with the values of its first step:
    keyframes (A, 36 channels), landmarks (C and bx, 12) and, for the dense
    solver, the problem's (keyframe, landmark) pairs (B, 18)."""
    import torch
    from patchwork_tpu_torch.slam import ba

    k, l = prob.poses.shape[0], prob.points.shape[0]
    block = prob._replace(obs_k=prob.obs_k[lo:hi], obs_l=prob.obs_l[lo:hi],
                          obs_p=prob.obs_p[lo:hi], obs_w=prob.obs_w[lo:hi])
    r, jp, jx = ba._obs_blocks(prob.poses, prob.points, block)
    o = hi - lo
    out = {"obs_k, A (36 channels)": (ba._outer(jp, jp).reshape(o, 36),
                                      block.obs_k, k),
           "obs_l, C and bx (12 channels)": (torch.cat(
               [ba._outer(jx, jx).reshape(o, 9),
                torch.einsum("oai,oa->oi", jx, r)], 1), block.obs_l, l)}
    if dense:
        uniq, inv = torch.unique(prob.obs_k.long() * l + prob.obs_l.long(),
                                 return_inverse=True)
        out["pairs, B (18 channels)"] = (ba._outer(jp, jx).reshape(o, 18),
                                         inv[lo:hi], uniq.numel())
    return out


def phase9(dev, card: str, fails: Failures, scenes: dict,
           ba_session) -> dict:
    """Multi-process execution (see the module docstring); returns the
    launches of the sharded entry points per kernel family: part (a)'s in
    this process, and part (b)'s workers' timed calls."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
    from patchwork_tpu_torch.kernels import fit_cuda
    from patchwork_tpu_torch.parallel import (
        host_summary, initialize_multihost, make_mesh, make_sharded_pipeline,
        make_shardmap_fused, make_shardmap_patchwork)
    from patchwork_tpu_torch.slam import (BAProblem, bundle_adjust,
                                          bundle_adjust_sharded)

    mh = tool("torch_multihost_bench")

    launches = dict.fromkeys(fit_cuda.LAUNCHES, 0)

    def counted(label, fn, *args, **kw):
        """A sharded entry point's call, its launches added to the phase's
        and printed."""
        fit_cuda.reset_launches()
        out = fn(*args, **kw)
        for k, v in fit_cuda.LAUNCHES.items():
            launches[k] += v
        print(f"[9 parallel] (a) {label}: launches "
              f"{dict((k, v) for k, v in fit_cuda.LAUNCHES.items() if v)}",
              flush=True)
        return out

    def bits(a, b) -> int:
        return int((a != b).sum().item())

    def reductions(fn, *args):
        """Calls of parallel/mesh.py's collective helpers (each a collective
        at sp > 1; a group of one rank issues none) of one call of fn."""
        from patchwork_tpu_torch.parallel import mesh as pmesh

        n = [0]
        gather, reduce = pmesh.all_gather, pmesh._all_reduce

        def rec_gather(t, group):
            n[0] += 1
            return gather(t, group)

        def rec_reduce(t, group, op):
            n[0] += 1
            return reduce(t, group, op)

        pmesh.all_gather, pmesh._all_reduce = rec_gather, rec_reduce
        try:
            fn(*args)
        finally:
            pmesh.all_gather, pmesh._all_reduce = gather, reduce
        return n[0]

    cfg, cfg_pw = PatchworkConfig(), PatchworkConfig.patchwork()
    prob_s, kw_s = ba_session
    pcg = mh.synthetic_ba(*BA_SHAPE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        # (a) in this process: a one-rank group over NCCL
        initialize_multihost(f"file://{tmp}/store", 1, 0, backend="nccl")
        mesh = make_mesh()
        print(f"[9 parallel] (a) {host_summary()}, backend "
              f"{dist.get_backend()}, mesh {tuple(mesh.mesh.shape)}",
              flush=True)
        for scene, (xyz, valid) in scenes.items():
            want = filter_ground_batched(xyz, valid, cfg).ground
            want_sp = filter_ground_batched(
                xyz, valid, cfg.replace(segment_impl="pallas")).ground
            want_pw = filter_ground_batched(xyz, valid, cfg_pw).ground
            g_dp = counted(f"{scene} make_shardmap_fused",
                           make_shardmap_fused(cfg, mesh), xyz, valid).ground
            res, g_cnt, ng_cnt = counted(
                f"{scene} make_sharded_pipeline",
                make_sharded_pipeline(cfg, mesh), xyz, valid)
            g_pw = counted(f"{scene} make_shardmap_patchwork",
                           make_shardmap_patchwork(cfg_pw, mesh), xyz, valid)
            diff = {"make_shardmap_fused": bits(g_dp, want),
                    "make_sharded_pipeline": bits(res.ground, want_sp),
                    "make_shardmap_patchwork": bits(g_pw, want_pw)}
            cnt_err = bits(g_cnt, res.ground.sum(1)) + bits(
                ng_cnt, (res.valid & ~res.ground).sum(1))
            print(f"[9 parallel] (a) {scene} B={xyz.shape[0]} "
                  f"N={xyz.shape[1]}: differing mask bits against "
                  f"filter_ground_batched with the impl each runs {diff}; "
                  f"count errors {cnt_err}", flush=True)
            fails.check(not any(diff.values()) and cnt_err == 0,
                        f"parallel (a) {scene}: {diff}, counts {cnt_err}")
            # the point-sharded engine: its time against the engine with
            # the impl it forces, and its reductions a call
            fn_sp = make_sharded_pipeline(cfg, mesh)
            n_red = reductions(fn_sp, xyz, valid)
            ms_sp = _time_ms(fn_sp, (xyz, valid), {}, 3)
            ms_one = _time_ms(filter_ground_batched, (
                xyz, valid, cfg.replace(segment_impl="pallas")), {}, 3)
            print(f"[9 parallel] (a) {scene} sp engine at one rank: "
                  f"{ms_sp:.3f} ms a batch, filter_ground_batched (pallas) "
                  f"{ms_one:.3f} ms; {n_red} reductions a call (a "
                  f"collective each at sp > 1); CUDA events on {card}",
                  flush=True)
        xyz, valid = scenes["velodyne"]
        half = xyz.shape[1] // 2
        explicit_binding_checks(fails, "whole scans", xyz, valid, cfg_pw)
        for r in range(2):
            part = slice(r * half, (r + 1) * half)
            explicit_binding_checks(fails, f"sp 2, rank {r}'s half",
                                    xyz[:, part], valid[:, part], cfg_pw)
        # five rounds in turns, ten calls each, so that drift of the card
        # falls on both alike
        fn = make_shardmap_fused(cfg, mesh)
        rounds = [(_time_ms(fn, (xyz, valid), {}, 10),
                   _time_ms(filter_ground_batched, (xyz, valid, cfg), {}, 10))
                  for _ in range(5)]
        ms_dp, ms_one = (sorted(r[i] for r in rounds)[2] for i in (0, 1))
        b = xyz.shape[0]
        print(f"[9 parallel] (a) velodyne B={b} N={xyz.shape[1]}, median of "
              f"5 rounds in turns: make_shardmap_fused at W=1 {ms_dp:.3f} "
              f"ms ({b / ms_dp * 1e3:.1f} scans/s), filter_ground_batched "
              f"{ms_one:.3f} ms ({b / ms_one * 1e3:.1f} scans/s); rounds ms "
              f"{[(round(x, 3), round(y, 3)) for x, y in rounds]}; CUDA "
              f"events on {card}", flush=True)
        prob_p = BAProblem.from_numpy(*(pcg[k] for k in mh.BA_KEYS),
                                      device=dev)
        for label, prob, kw in (("session", prob_s, kw_s),
                                ("1000 kf shape", prob_p,
                                 {"iters": MH_BA_ITERS, "solver": "pcg"})):
            s = counted(f"bundle_adjust_sharded {label}",
                        bundle_adjust_sharded, prob, mesh, **kw)
            o = bundle_adjust(prob, **kw)
            same = _same_bits(s.poses, o.poses) and _same_bits(s.points,
                                                               o.points)
            print(f"[9 parallel] (a) bundle_adjust_sharded {label} K="
                  f"{prob.poses.shape[0]} L={prob.points.shape[0]} O="
                  f"{prob.obs_k.shape[0]} {kw}: equal to bundle_adjust bit "
                  f"for bit {same}", flush=True)
            fails.check(same, f"parallel (a) BA {label}: differs from "
                              "bundle_adjust at W=1")
        # the sums of (b)'s two ranks, each over its half of the
        # observations (padded as the tool pads them)
        for label, prob, dense in (("session", prob_s, True),
                                   ("1000 kf shape", prob_p, False)):
            a = mh._pad_obs({k: getattr(prob, k).cpu().numpy()
                             for k in mh.BA_KEYS}, 2)
            prob = BAProblem.from_numpy(*(a[k] for k in mh.BA_KEYS),
                                        device=dev)
            o = prob.obs_k.shape[0] // 2
            for r in range(2):
                ba_sum_checks(dev, fails, f"{label}, W=2 rank {r}'s block",
                              ba_block_bindings(prob, r * o, (r + 1) * o,
                                                dense),
                              tag="9 parallel", timed=False)
        print(f"[9 parallel] (a) launches in all "
              f"{dict((k, v) for k, v in launches.items() if v)}", flush=True)
        for fam in ("level", "seg_order_stat", "seg_order_stat_rounds",
                    "seg_sum", "seg_gather", "seg_minmax"):
            fails.check(launches[fam] > 0,
                        f"parallel (a): kernel family {fam} never launched")
        dist.destroy_process_group()

        # (b) two processes on the one card, over gloo
        arrays = {"xyz": xyz.cpu().numpy(), "valid": valid.cpu().numpy(),
                  "xyz_split": scenes["split"][0].cpu().numpy(),
                  "valid_split": scenes["split"][1].cpu().numpy()}
        for key in mh.BA_KEYS:
            arrays[f"ba_dense_{key}"] = getattr(prob_s, key).cpu().numpy()
            arrays[f"ba_pcg_{key}"] = pcg[key]
        np.savez(os.path.join(tmp, "in.npz"), **arrays)
        out = os.path.join(tmp, "out.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "torch_multihost_bench.py"),
             "--procs", "2", "--device", "cuda", "--backend", "gloo",
             "--batch", str(xyz.shape[0]), "--points", str(xyz.shape[1]),
             "--inputs", os.path.join(tmp, "in.npz"), "--ba-iters",
             str(MH_BA_ITERS), "--timeout", "300", "--json-out", out],
            capture_output=True, text=True, timeout=420, cwd=ROOT)
        wall = time.perf_counter() - t0
        print(f"[9 parallel] (b) tools/torch_multihost_bench.py --procs 2 "
              f"--backend gloo: rc {proc.returncode} in {wall:.1f} s; "
              f"{proc.stdout.strip()[-600:]}", flush=True)
        if not fails.check(proc.returncode == 0 and os.path.exists(out),
                           "parallel (b): the two-process run failed"):
            print(proc.stderr[-4000:], flush=True)
            return launches
        with open(out) as f:
            doc = json.load(f)
        for w in doc["workers"]:
            fams = {}
            for arm in w["launches"].values():
                for k, v in arm.items():
                    fams[k] = fams.get(k, 0) + v
                    launches[k] += v
            print(f"[9 parallel] (b) rank {w['rank']} ({w['summary']}): "
                  f"differing mask bits dp {w['dp_bit_errors']}, pipeline "
                  f"{w['pipeline_bit_errors']}, sp ({w['sp_impl']}) "
                  f"{w['sp_bit_errors']}, sp percentile "
                  f"{w['sp_pct_bit_errors']}, sp split terrain "
                  f"{w['sp_split_bit_errors']}, explicit "
                  f"{w['explicit_bit_errors']}"
                  f" (vs the engine {w['explicit_vs_engine_bit_errors']}); "
                  f"BA max |pose diff| dense "
                  f"{w['ba_dense_pose_max_abs_diff']:.3g}, pcg "
                  f"{w['ba_pcg_pose_max_abs_diff']:.3g}, two runs equal "
                  f"{w['ba_dense_runs_equal']} {w['ba_pcg_runs_equal']}; "
                  f"launches {json.dumps(w['launches'])}; collectives "
                  f"{json.dumps(w['collectives'])}", flush=True)
            print(f"[9 parallel] (b) rank {w['rank']} times ms "
                  f"({w['clock']}) {json.dumps(w['ms'])}; dp "
                  f"{w['dp_scans_per_s']:.1f} scans/s, one process (both "
                  f"ranks on the card) {w['one_process_scans_per_s']:.1f}; "
                  f"ordered_sum of a CG iteration's two blocks "
                  f"{w['cg_collectives_us']:.1f} us; on {card}", flush=True)
            print(f"[9 parallel] (b) rank {w['rank']} peak MB (the card's "
                  f"allocator, this process) {json.dumps(w['peak_mb'])}; "
                  f"device busy ms of one sp call (torch.profiler) "
                  f"{json.dumps(w['busy_ms'])}; order statistics across "
                  f"ranks {json.dumps(w['order_stats'])}", flush=True)
            fails.check(w["order_stats"]["sp_split"]["median"] > 0,
                        f"parallel (b) rank {w['rank']}: the split terrain "
                        "took no median across ranks")
            fails.check(w["ok"], f"parallel (b) rank {w['rank']}: a check "
                                 "failed")
            fails.check(fams.get("level", 0) > 0
                        and fams.get("seg_gather", 0) > 0
                        and fams.get("seg_minmax", 0) > 0,
                        f"parallel (b) rank {w['rank']}: launches {fams}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


MASKS = ("ground", "valid", "in_zone", "in_patch")
REFERENCE_IMPLS = ("fused", "pallas")
# phase 10's launched families: #1 (level path), #6 (binning), #7 and #8
# ("pallas", the generic path), #2 (the split scene's remap levels), #5 (the
# 128-beam scan above the path gate)
REFERENCE_FAMILIES = ("level", "seg_sum", "fit_level", "seg_gather",
                      "seg_minmax", "seg_order_stat")


def oracle_bits(res, outs) -> list:
    """Differing bits of a (1, N) GroundResult's four masks against the
    oracle's (ground, valid, in_zone, in_patch)."""
    import numpy as np

    return [int((getattr(res, m)[0].cpu().numpy() != np.asarray(o)).sum())
            for m, o in zip(MASKS, outs)]


def phase10(dev, fails: Failures, headline: dict) -> dict:
    """The card's exact masks against the port's NumPy oracle
    (``oracle/reference.py``, on the host): the parity scenes under
    "fused" and "pallas", 0 differing bits in all four masks (the
    all-deficient scene: IoU > 0.95 of ground, the others exact); scan 0
    of each ``headline`` batch (label -> (xyz, valid, the batch's exact
    ground mask from phase 4)), exact, 0 differing bits, and equal to its
    row of the batch.  Returns the launches of the card's runs per kernel
    family."""
    import numpy as np
    import torch
    from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
    from patchwork_tpu_torch.kernels import fit_cuda
    from patchwork_tpu_torch.oracle.reference import filter_ground_oracle
    from patchwork_tpu_torch.oracle.scenes import (
        DEFICIENT_CONFIG, DEFICIENT_IOU_MIN, PARITY_SCENES,
        all_deficient_scene)

    cases = [(name, make(), kw) for name, (make, kw) in
             sorted(PARITY_SCENES.items())]
    cases.append(("all_deficient", all_deficient_scene(), DEFICIENT_CONFIG))
    oracle_s = 0.0
    launches = dict.fromkeys(fit_cuda.LAUNCHES, 0)

    def on_card(xyz, cfg):
        x = torch.from_numpy(np.ascontiguousarray(xyz))[None].to(dev)
        v = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
        fit_cuda.reset_launches()
        res = filter_ground_batched(x, v, cfg)
        for k, n in fit_cuda.LAUNCHES.items():
            launches[k] += n
        return res

    total = 0
    for name, pts, kw in cases:
        t0 = time.perf_counter()
        outs = filter_ground_oracle(pts, PatchworkConfig(**kw))
        dt = time.perf_counter() - t0
        oracle_s += dt
        for impl in REFERENCE_IMPLS:
            res = on_card(pts, PatchworkConfig(segment_impl=impl, **kw))
            bits = oracle_bits(res, outs)
            line = (f"[10 reference] {name} ({len(pts)} points) {impl}: "
                    f"differing bits {'/'.join(map(str, bits))} "
                    f"(ground/valid/in_zone/in_patch); oracle {dt:.3f} s")
            if name == "all_deficient":
                g = res.ground[0].cpu().numpy()
                iou = float((g & outs[0]).sum()) / max(float((g | outs[0]).sum()), 1.0)
                print(f"{line}; ground IoU {iou:.6f}", flush=True)
                fails.check(iou > DEFICIENT_IOU_MIN and sum(bits[1:]) == 0,
                            f"reference {name} {impl}: IoU {iou}, bits {bits}")
            else:
                print(line, flush=True)
                total += sum(bits)
                fails.check(sum(bits) == 0,
                            f"reference {name} {impl}: {bits} bits differ "
                            "from the oracle")
    for scene, (xyz, valid, batch_ground) in headline.items():
        pts = xyz[0].cpu().numpy()
        t0 = time.perf_counter()
        outs = filter_ground_oracle(pts, PatchworkConfig())
        dt = time.perf_counter() - t0
        oracle_s += dt
        res = on_card(pts, PatchworkConfig())
        bits = oracle_bits(res, outs)
        same = torch.equal(res.ground[0], batch_ground[0])
        total += sum(bits)
        print(f"[10 reference] {scene} scan 0 of B={xyz.shape[0]} x "
              f"{xyz.shape[1]} exact: differing bits "
              f"{'/'.join(map(str, bits))}; equal to its row of phase 4's "
              f"batch: {same}; oracle {dt:.3f} s", flush=True)
        fails.check(sum(bits) == 0 and same,
                    f"reference {scene} scan 0: {bits} bits differ from the "
                    f"oracle, or from the batch ({same})")
    print(f"[10 reference] {len(cases)} parity scenes x {len(REFERENCE_IMPLS)}"
          f" impls and {len(headline)} headline scans: {total} differing "
          f"bits; "
          f"oracle {oracle_s:.2f} s in all; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for fam in REFERENCE_FAMILIES:
        fails.check(launches[fam] > 0,
                    f"kernel family {fam} never launched in phase 10")
    return launches


def phase11(fails: Failures) -> None:
    """bench_torch.py as a process, held to its contract: exit 0, one JSON
    line on stdout, correct, on this card, each cell through the kernels."""
    import torch

    torch.cuda.empty_cache()    # the card's free memory to the process
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"), "--reps",
         str(BENCH_REPS)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    lines = proc.stdout.splitlines()
    print(f"[11 bench] python3 bench_torch.py --reps {BENCH_REPS}: rc "
          f"{proc.returncode}, {len(lines)} stdout line(s), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        line = json.loads(lines[-1]) if len(lines) == 1 else None
    except ValueError:
        line = None
    if proc.returncode != 0 or line is None:
        print(proc.stdout[-2000:] + proc.stderr[-4000:], flush=True)
    fails.check(proc.returncode == 0 and line is not None,
                "bench_torch.py: non-zero exit or not one JSON line")
    if line is None:
        return
    for name, cell in line["cells"].items():
        print(f"[11 bench] {name}: {json.dumps(cell)}", flush=True)
        for fam in BENCH_FAMILIES:
            fails.check(cell["launches"].get(fam, 0) > 0,
                        f"bench_torch.py {name}: kernel family {fam} never "
                        "launched")
    print(f"[11 bench] {line['metric']} {line['value']} {line['unit']}, "
          f"vs_baseline {line['vs_baseline']}, correct {line['correct']}, "
          f"device {line['device']}; extra {line['extra']}", flush=True)
    fails.check(line["correct"] is True, "bench_torch.py: correct is not true")
    fails.check(line["device"]["name"] == torch.cuda.get_device_name(0),
                f"bench_torch.py: device {line['device']['name']!r} is not "
                f"{torch.cuda.get_device_name(0)!r}")


# phase 12: the cells of BENCHMARK.json whose shapes it runs, and the spans
# of the node's per-batch (or per-frame) path that the cost is counted over
SPAN_CELLS = ("os128.urban.offline", "kitti360.urban.live")
SPAN_COST_MAX_MS = 0.05     # the spans of a batch (os128) or a frame (live)
SPAN_COST_REPS = 3000       # batches of spans timed, profiler off (on: 1/10)
SPAN_SEED = 2**31 + 12      # the pools' seed (os128's batches recurse)


class _SyncLog:
    """Under ``torch.cuda.set_sync_debug_mode("warn")``, each warning of a
    synchronising CUDA operation with the span open at it and the
    package's innermost frames."""

    def __init__(self):
        self.seen = []      # (span or None, "file:line < file:line")

    def __call__(self, message, category, filename, lineno, file=None,
                 line=None):
        import traceback

        from patchwork_tpu_torch.core import timing

        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "patchwork_tpu_torch" in f.filename]
        where = " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                           for f in reversed(frames[-3:] or stack[-4:]))
        self.seen.append((timing.current(), where))


def _read_exempt(span_fn):
    """``timing.span`` with the sync debug mode off inside each read span
    and back to "error" after it."""
    import torch

    from patchwork_tpu_torch.core import timing

    class Exempt:
        def __init__(self, inner):
            self.inner = inner

        def __enter__(self):
            torch.cuda.set_sync_debug_mode(0)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            try:
                return self.inner.__exit__(*exc)
            finally:
                torch.cuda.set_sync_debug_mode("error")

    def span(name):
        inner = span_fn(name)
        return Exempt(inner) if name == timing.READ else inner

    return span


def _spans_ms(spans: int, reps: int, profiler: bool) -> float:
    """Median host ms of a batch's ``spans`` spans (a root and its
    children, into a new StageTimes each time, the collector on) over
    ``reps`` batches, with a profiler (CPU and CUDA activities) running or
    not."""
    import torch

    from patchwork_tpu_torch.core import timing

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = []
    with (torch.profiler.profile(activities=acts) if profiler
          else contextlib.nullcontext()):
        for _ in range(reps):
            times = timing.StageTimes()
            t0 = time.perf_counter()
            with times.time("engine"):
                for _ in range(spans - 1):
                    with timing.span("engine.level"):
                        pass
            out.append(time.perf_counter() - t0)
    out.sort()
    return out[len(out) // 2] * 1e3


def phase12(dev, card: str, fails: Failures) -> dict:
    """Each cell's pool of scans (``SPAN_SEED``) through the engine a batch
    (os128) or a frame (live) at a time, with the node's own pad and step:
    every synchronisation a call makes under the sync debug mode "warn", by
    the span open at it; each call again under "error" with only the read
    spans exempt, the same masks; the read spans and the waits in them;
    then the spans of a batch or frame through ``node.run`` and their cost
    with the profiler off and on."""
    import warnings
    from collections import Counter

    import torch

    from benchmark import traffic
    from benchmark.manifest import Manifest
    from patchwork_tpu_torch import PatchworkConfig
    from patchwork_tpu_torch.core import timing
    from patchwork_tpu_torch.node import NodeParams, PatchworkNode

    bench = Manifest(ROOT)
    out = {}
    for name in SPAN_CELLS:
        cell = bench.cell(name)
        conf = bench.config(cell.config)
        mix = bench.mix(cell.traffic)
        b = mix["batch_size"]
        node = PatchworkNode(NodeParams(**conf["node_params"]),
                             PatchworkConfig(**conf["patchwork_config"]),
                             capacity=conf["capacity"], batch_size=b,
                             device=dev)
        pool = traffic.make_pool(bench.scene(mix["scene"]), conf["sensor"],
                                 mix, SPAN_SEED)
        batches = [node._pad(pool[k:k + b], b)
                   for k in range(0, len(pool), b)]
        node._step(*batches[0])             # warm: the kernels loaded
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")      # its first call, out of
        torch.cuda.set_sync_debug_mode(0)           # the window

        log = _SyncLog()
        times = timing.StageTimes()
        refs = []
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = log
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for xyz, valid in batches:
                    with times.time("engine"):
                        refs.append(node._step(xyz, valid))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        reads = [s for s in times.spans if s.name == timing.READ]
        waits = Counter(id(sp) for sp, _ in log.seen
                        if sp is not None and sp.name == timing.READ)
        outside = [(sp.name, where) for sp, where in log.seen
                   if sp is not None and sp.name != timing.READ]
        around = [where for sp, where in log.seen if sp is None]
        silent = Counter(s.parent.name for s in reads if not waits[id(s)])
        where_read = Counter(where for sp, where in log.seen
                             if sp is not None and sp.name == timing.READ)
        calls = len(batches)
        levels = Counter(s.name for s in times.spans)["engine.level"]

        real_span = timing.span
        timing.span = _read_exempt(real_span)
        torch.cuda.set_sync_debug_mode("error")
        error, agains = None, []
        try:
            for xyz, valid in batches:
                with timing.StageTimes().time("engine"):
                    agains.append(node._step(xyz, valid))
        except RuntimeError as e:
            error = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
            timing.span = real_span
        same = error is None and all(
            torch.equal(x, y) for ref, again in zip(refs, agains)
            for x, y in zip(ref, again))

        per_call = {"shape": [b, conf["capacity"]], "calls": calls,
                    "levels": levels / calls,
                    "syncs": len(log.seen) / calls,
                    "reads": len(reads) / calls,
                    "syncs_in_reads": sum(waits.values()) / calls,
                    "outside_reads": outside,
                    "outside_the_call": around,
                    "reads_by_parent": {
                        k: v / calls for k, v in
                        Counter(s.parent.name for s in reads).items()},
                    "reads_without_a_sync": dict(silent),
                    "syncs_by_place": dict(where_read),
                    "error_mode": error or "no synchronisation outside a "
                    "read", "same_masks": same}
        print(f"[12 spans] {name}: per call {json.dumps(per_call)}",
              flush=True)
        fails.check(not outside, f"spans {name}: {len(outside)} "
                    f"synchronisation(s) outside a read span: {outside}")
        fails.check(not around, f"spans {name}: {len(around)} "
                    f"synchronisation(s) around the engine call: {around}")
        fails.check(error is None, f"spans {name}: under \"error\" with "
                    f"the reads exempt: {error}")
        fails.check(same, f"spans {name}: the masks of the exempt run "
                    "differ")

        # the spans of a batch (B=8) or a frame (B=1, pipelined)
        node.times = timing.StageTimes()
        node.run(pool, pipeline_depth=mix.get("pipeline_depth", 2))
        per_call["spans"] = len(node.times.spans) / calls
        per_call["spans_by_name"] = {
            k: v / calls for k, v in
            Counter(s.name for s in node.times.spans).items()}
        out[name] = per_call

    for name, per_call in out.items():
        unit = "batch" if bench.mix(bench.cell(name).traffic)[
            "batch_size"] > 1 else "frame"
        n = round(per_call["spans"])
        off = per_call["cost_ms_profiler_off"] = _spans_ms(
            n, SPAN_COST_REPS, False)
        on = per_call["cost_ms_profiler_on"] = _spans_ms(
            n, SPAN_COST_REPS // 10, True)
        print(f"[12 spans] {name}: {per_call['spans']:.1f} spans a {unit} "
              f"({json.dumps(per_call['spans_by_name'])}); {n} spans take "
              f"{off:.4f} ms with the profiler off, {on:.4f} ms on "
              f"(median of {SPAN_COST_REPS} and {SPAN_COST_REPS // 10}); "
              f"{card}", flush=True)
        fails.check(off < SPAN_COST_MAX_MS, f"spans {name}: {off} ms a "
                    f"{unit} with the profiler off")
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from patchwork_tpu_torch import (
        PatchworkConfig, RecursivePatchwork, filter_ground_batched)
    from patchwork_tpu_torch.core.device import card_info, cuda_device
    from patchwork_tpu_torch.io.synthetic import (
        HARD_SCENES, split_terrain_cloud,
        velodyne_like_cloud)
    from patchwork_tpu_torch.kernels import _build, fit_cuda, seg_cuda
    from patchwork_tpu_torch.segment import binning, engine

    fails = Failures()
    dev = cuda_device()

    # ---- 1. card ----
    card = card_info().splitlines()[0]
    print(f"[1 card] torch: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    # ---- 2. build ----
    _build.load()
    print(f"[2 build] nvcc sm_90a build+load {_build.build_seconds():.1f} s "
          f"({_build.CSRC})", flush=True)

    def batch(gen, seeds, n=N):
        xyz = torch.from_numpy(np.stack([gen(n, seed=s) for s in seeds]))
        return xyz.to(dev), torch.ones(xyz.shape[:2], dtype=torch.bool,
                                       device=dev)

    def velodyne128(n, seed):
        return velodyne_like_cloud(n, seed=seed, num_beams=128)

    cfg_exact = PatchworkConfig()
    cfg_fast = PatchworkConfig(fast_covariance=True)
    cfg_pallas = PatchworkConfig(segment_impl="pallas")
    velo = batch(velodyne_like_cloud, range(B))
    split = batch(split_terrain_cloud, range(B))
    velo_gen = batch(velodyne128, range(B), N_GEN)
    split_gen = batch(split_terrain_cloud, range(B), N_GEN)
    velo_big = batch(velodyne128, range(B), N_BIG)
    cfg_wide = PatchworkConfig(max_active_nodes_cfg=WIDE_NODES)
    wide = batch(split_terrain_cloud, range(B_WIDE), N_WIDE)

    # ---- 3. kernels vs plain versions, on the main path's inputs ----
    stamp("3 kernels")
    members = ["seg_order_stat", "seg_sum", "apply_sweep", "moments2_sweep",
               "remap_r1", "remap_r1b", "remap_nodes", "remap_points",
               "node_stats", "early_outs", "deficient_round", "seed_init",
               "plane_table", "split_decision", "finish_nodes"]
    # the level family's phases one by one: above the card's gate only
    phases = ["remap_nodes", "remap_points", "node_stats", "early_outs",
              "deficient_round", "seed_init", "split_decision",
              "finish_nodes"]
    family_of = {m: "level" for m in members}
    for f in ("seg_order_stat", "seg_sum", "apply_sweep", "moments2_sweep",
              "fit_level", "seg_gather", "seg_minmax"):
        family_of[f] = f
    # (label, mode) -> (wrapper name, module, args, kwargs)
    captured = {}
    core_inputs = {}    # (scene, mode) -> (level_core's args, level's args)
    # the loop of sweeps as the engine runs it today: the table above the
    # card's gate (Sp 4224), the gate as it is.  The second iteration of the
    # first deeper level's fit: its moments2 sweep, plane table and apply
    # sweep (with the level's plan).  These are the shapes the sweeps' JSON
    # entries report.
    sweep_members = ["apply_sweep", "moments2_sweep", "plane_table"]
    cap_w = Capture(fit_cuda, sweep_members, {"apply_sweep": 3,
                                               "moments2_sweep": 2,
                                               "plane_table": 2})
    try:
        filter_ground_batched(*wide, cfg_wide)
    finally:
        cap_w.restore()
    for name in sweep_members:
        captured[(name, "exact")] = (name, fit_cuda) + cap_w.saved[name]
    def core_capture(data, cfg, pick):
        """The pick-th level of one batch: level_core's and engine.level's
        arguments, and the wrappers of the level family it called first."""
        cap_k = Capture(fit_cuda, [m for m in members
                                   if m not in sweep_members] + ["level_core"],
                        {"level_core": pick})
        cap_l = Capture(engine, ["level"], {"level": pick})
        try:
            filter_ground_batched(*data, cfg)
        finally:
            cap_l.restore()
            cap_k.restore()
        return (cap_k.saved.pop("level_core"), cap_l.saved["level"],
                cap_k.saved)

    def with_special_values(data):
        """The batch with NaN, +inf and -inf coordinates in every scan
        (binning parks them on the trash id)."""
        xyz = data[0].clone()
        for j, v in enumerate((float("nan"), float("inf"), float("-inf"))):
            xyz[:, 11 + 7 * j::997, j] = v
        return xyz, data[1]

    def live_special_values(core, lvl):
        """NaN, +inf and -inf coordinates on live points of level 0's
        packed points too, in both captures (they share the points)."""
        pts = core[0][0]
        live = (pts[:, 3] < core[0][3]).nonzero()
        for j, v in enumerate((float("nan"), float("inf"), float("-inf"))):
            pick = live[j::101]
            for p in (pts, lvl[0][0]):
                p[pick[:, 0], j, pick[:, 1]] = v

    deficient = (velo[0] + torch.tensor([0.0, 0.0, 3.0], device=dev),
                 velo[1])
    for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
        # a split-terrain batch as the main path runs it: R1, R1b and the
        # order statistic at their first call, a remap level (Sp 256) in one
        # launch
        core, lvl, first = core_capture(split, cfg, 2)
        core_inputs[("split remap level", mode)] = (core, lvl)
        for name, v in first.items():
            captured[(name, mode)] = (name, fit_cuda) + v
        captured[("level", mode)] = ("level", engine) + lvl
        # beside them, labelled: the level family's phases and the sweeps at
        # B=8 x 131072 (Sp 256), which only a shut gate gives them now (the
        # same level as its phases around a loop of sweeps; the shapes
        # earlier readings were taken at)
        cap_g = Capture(fit_cuda, sweep_members + phases,
                        {"apply_sweep": 5, "moments2_sweep": 5,
                         "plane_table": 5, **{m: 2 for m in phases},
                         "remap_nodes": 1, "remap_points": 1})
        try:
            with card_gate(lambda sp: False):
                filter_ground_batched(*split, cfg)
        finally:
            cap_g.restore()
        for name, v in cap_g.saved.items():
            captured[(name + "/gate shut", mode)] = (name, fit_cuda) + v
        # velodyne level 0 (Sp 128); every seed threshold below the points
        # (the deficient rounds); NaN and +-inf coordinates
        for scene, data in (("velodyne level 0", velo),
                            ("deficient, z + 3 m", deficient),
                            ("NaN and +-inf", with_special_values(split))):
            core, lvl, _ = core_capture(data, cfg, 1)
            if scene.startswith("NaN"):
                live_special_values(core, lvl)
            core_inputs[(scene, mode)] = (core, lvl)
    # the order statistic as the main path calls it: the split median at Sp
    # 256 (above) and the percentile seeds of level 0 at Sp 128
    cap_o = Capture(fit_cuda, ["seg_order_stat", "level_core"], {})
    cap_p = Capture(engine, ["level"], {})
    try:
        filter_ground_batched(*velo, PatchworkConfig(
            adaptive_seed_height=False))
    finally:
        cap_p.restore()
        cap_o.restore()
    core_inputs[("percentile seeds", "exact")] = (cap_o.saved["level_core"],
                                                  cap_p.saved["level"])
    order_stat_inputs = {
        "median, split remap level": captured[("seg_order_stat",
                                               "exact")][2],
        "percentile, velodyne level 0": cap_o.saved["seg_order_stat"][0]}
    # the generic engine: "pallas" segment ops at B x N, and the fit of
    # "fused" above the gate at B x N_GEN (fit_level at level 0, the loop of
    # sweeps at the deeper levels where the card's gate is shut above Sp 128)
    cap_s = Capture(seg_cuda, ["seg_gather", "seg_minmax"], {"seg_gather": 3})
    try:
        filter_ground_batched(*velo, cfg_pallas)
    finally:
        cap_s.restore()
    for name, v in cap_s.saved.items():
        captured[(name, "exact")] = (name, seg_cuda) + v
    fit_inputs = {}    # level 0's _fused_fit_resid call, per mode
    for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
        cap_f = Capture(fit_cuda, ["fit_level", "apply_sweep",
                                   "moments2_sweep"],
                        {"apply_sweep": 3, "moments2_sweep": 3})
        cap_e = Capture(engine, ["_fused_fit_resid"], {})
        try:
            with card_gate(lambda sp: sp < 256):
                filter_ground_batched(*split_gen, cfg)
        finally:
            cap_f.restore()
            cap_e.restore()
        fit_inputs[mode] = cap_e.saved["_fused_fit_resid"]
        captured[("fit_level", mode)] = (("fit_level", fit_cuda)
                                         + cap_f.saved["fit_level"])
        for name in ("apply_sweep", "moments2_sweep"):
            captured[(name + "/fit gate shut", mode)] = ((name, fit_cuda)
                                               + cap_f.saved[name])

    # the apply sweep's inputs per scene for the redesigned kernels' checks
    cap_v = Capture(fit_cuda, ["apply_sweep"], {"apply_sweep": 5})
    try:
        with card_gate(lambda sp: False):
            filter_ground_batched(*velo, cfg_exact)
    finally:
        cap_v.restore()
    velo_sweep = cap_v.saved["apply_sweep"][0]
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(0)).to(dev)
    sweep_inputs = {
        "velodyne": velo_sweep,
        "velodyne shuffled": (velo_sweep[0][:, :, perm].contiguous(),
                              velo_sweep[1][:, :, perm].contiguous())
        + tuple(velo_sweep[2:]),
        "wide table, main path": captured[("apply_sweep", "exact")][2],
        "split terrain": captured[("apply_sweep/gate shut", "exact")][2],
        "split terrain, generic fit": captured[(
            "apply_sweep/fit gate shut", "exact")][2]}

    # #6 and #8 beyond binning's sum and level 0's bbox: the generic path's
    # deeper levels (split terrain B x N_GEN, 161 segments) and the wide
    # table's binding (4097 segments), first call of each shape
    seg_sums = {"binning": captured[("seg_sum", "exact")][2]}
    seg_minmaxes = {"velodyne level 0, pallas":
                    captured[("seg_minmax", "exact")][2]}
    for label, data, cfg in (("generic deeper", split_gen, cfg_exact),
                             ("wide table", wide, cfg_wide)):
        def run():
            filter_ground_batched(*data, cfg)

        for k, a in first_calls(run, seg_cuda, "seg_sum", lambda a: (
                f"R={a[0].shape[1]}" if a[2] > 81 else None)).items():
            seg_sums[f"{label} {k}"] = a
        for k, a in first_calls(run, seg_cuda, "seg_minmax", lambda a: (
                f"C={a[0].shape[1]}" if a[3] > 81 else None)).items():
            seg_minmaxes[f"{label} {k}"] = a

    exact_only = {"seg_order_stat", "remap_nodes", "remap_points",
                  "node_stats", "early_outs", "deficient_round",
                  "finish_nodes", "seg_gather", "seg_minmax"}
    err = {f: 0.0 for f in set(family_of.values())}
    ms = {f: 0.0 for f in err}
    plain_ms = {f: 0.0 for f in err}
    bound = {}      # family -> (bound_ms, bound_by, bytes, flops)
    lib_ms = {}
    extra = {}      # family -> further keys of its JSON entry
    for (label, mode), (name, module, args, kw) in sorted(captured.items()):
        if name == "level":
            fn_k, fn_p = engine.level, engine.level_reference
        else:
            fn_k = getattr(module, name)
            fn_p = getattr(module.plain, name)
        ak, ap = _clone(args), _clone(args)
        out_plain = []
        before = dict(fit_cuda.LAUNCHES)
        out_k = fn_k(*ak, **kw)
        sweeps = (fit_cuda.LAUNCHES["apply_sweep"] - before["apply_sweep"],
                  fit_cuda.LAUNCHES["moments2_sweep"]
                  - before["moments2_sweep"])
        t_p = _time_ms(lambda: out_plain.append(fn_p(*ap, **kw)), (), {}, 1)
        out_p = out_plain.pop()
        tk, tp = _tensors((out_k, ak)), _tensors((out_p, ap))
        if name == "seg_order_stat":
            # garbage by contract where k >= count: compare the rest
            vals, seg, valid, k, s = args
            cnt = torch.stack([torch.bincount(seg[b][valid[b]].long(),
                                              minlength=s)[:s]
                               for b in range(seg.shape[0])])
            ok = k.long() < cnt
            tk, tp = [out_k[ok]], [out_p[ok]]
        e = max(_abs_err(a, b) for a, b in zip(tk, tp))
        if name == "level":
            # every bit of the state and the stats (level_core_checks holds
            # the one launch on more inputs)
            fine = _same_bits(out_k, out_p)
            sweeps = level_sweeps(core_inputs[("split remap level", mode)][0])
        elif name in exact_only:
            fine = e == 0.0
        else:
            fine = all(torch.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL,
                                      equal_nan=True) if a.is_floating_point()
                       else torch.equal(a, b) for a, b in zip(tk, tp))
            # the per-point outputs that are masks (state; fit_level's g)
            # must match exactly
            for a, b in zip(tk, tp):
                if a.dim() == 3 and (a.shape[1] == 4 or name == "fit_level"
                                     and a.shape[1] == 1):
                    fine = fine and torch.equal(a, b)
        fam = family_of.get(name, "level")
        err[fam] = max(err[fam], e)
        slow = name in ("level", "fit_level")
        t_k = _time_ms(fn_k, args, kw, 3 if slow else 20)
        if not slow:    # the slow plain versions are timed on their one run
            t_p = _time_ms(fn_p, args, kw, 3)
        tail = ""
        if label in ms and mode == "exact":   # the family's own entry point
            ms[label], plain_ms[label] = t_k, t_p
            if name == "fit_level":
                per_scan = torch.zeros(args[0].shape[0], dtype=torch.int32,
                                       device=dev)
                fn_k(*_clone(args), sweeps_out=per_scan, **kw)
                sweeps = per_scan.tolist()
                extra[label] = {"sweeps_per_scan": sweeps}
            bound[label] = kernel_bound(name, args, kw, out_k, sweeps)
            lib_ms[label] = library_ms(name, args)
            tail = (f" bound {bound[label][0]:.4f} ms by {bound[label][1]} "
                    f"({bound[label][2]} B, {bound[label][3]} flop)"
                    + (f" library {lib_ms[label]:.3f} ms"
                       if lib_ms[label] is not None else ""))
        print(f"[3 kernels] {label:28s} {mode:5s} max_abs_err {e:.3g} "
              f"kernel {t_k:.3f} ms plain {t_p:.3f} ms{tail} "
              f"{'ok' if fine else 'MISMATCH'}", flush=True)
        fails.check(fine, f"kernel {label} ({mode}) disagrees with its plain "
                          f"version (max_abs_err {e})")

    stamp("3 redesigned")
    redesigned_kernel_checks(
        dev, fails, sweep_inputs,
        {mode: captured[("fit_level", mode)][2:] for mode in ("exact", "fast")},
        captured[("seg_gather", "exact")][2])
    stamp("3 level_core")
    extra["level"] = level_core_checks(dev, fails, core_inputs)
    extra["seg_order_stat"] = order_stat_checks(dev, fails, order_stat_inputs)
    rounds_entry = order_stat_rounds_checks(
        dev, fails, order_stat_inputs["median, split remap level"])
    run_sum_check(dev, fails)
    stamp("3 seg ops")
    seg_entry = seg_op_checks(dev, fails, seg_sums, seg_minmaxes)

    # device times of the moments2 sweep and seg_gather, and of the
    # library call beside seg_gather (events read max(host, device) a call)
    for fam, pattern in (("apply_sweep", "pw_apply"),
                         ("moments2_sweep", "pw_m2")):
        extra[fam] = {}
        for key, label in (("device_ms", fam),
                           ("device_ms_gate_shut_b8", fam + "/gate shut")):
            name, module, args, kw = captured[(label, "exact")]
            extra[fam][key] = _device_ms(
                lambda: getattr(fit_cuda, name)(*_clone(args), **kw), 50,
                pattern)
    table, seg = captured[("seg_gather", "exact")][2]
    idx = seg.long()[:, None, :].expand(-1, table.shape[1], -1)
    extra["seg_gather"] = {
        "device_ms": _device_ms(lambda: seg_cuda.seg_gather(table, seg), 100,
                                "pw_gather"),
        "library_device_ms": _device_ms(lambda: torch.gather(table, 2, idx),
                                        100, r"^(?!.*pw_).*gather")}
    extra["seg_sum"] = {"routes": seg_entry["seg_sum"]}
    extra["seg_minmax"] = {"routes": seg_entry["seg_minmax"]}
    print(f"[3 device] apply_sweep {extra['apply_sweep']}; moments2_sweep "
          f"{extra['moments2_sweep']}; seg_gather "
          f"{extra['seg_gather']} (ms of device time, torch.profiler)",
          flush=True)

    # kernel 5 against the loop of sweeps it stands for, on the same level-0
    # fit (the loop is exact two-pass in both modes; fit_level honours fast)
    for mode, (args, kw) in sorted(fit_inputs.items()):
        t_one = _time_ms(engine._fused_fit_resid, args, kw, 3)
        g_one = engine._fused_fit_resid(*_clone(args), **kw)[0]
        with card_gate(lambda sp: False):
            t_loop = _time_ms(engine._fused_fit_resid, args, kw, 3)
            g_loop = engine._fused_fit_resid(*_clone(args), **kw)[0]
        d = int((g_one != g_loop).sum().item())
        print(f"[3 kernels] level-0 fit B={B} N={N_GEN} {mode}: fit_level "
              f"{t_one:.3f} ms, loop of sweeps {t_loop:.3f} ms; differing "
              f"mask bits {d}", flush=True)
        if mode == "exact":
            fails.check(d == 0, f"fit_level and the loop of sweeps differ "
                                f"by {d} mask bits")

    # ---- 4. the slice through the kernels ----
    stamp("4 slice")
    fit_cuda.reset_launches()
    masks = {}
    for scene, (xyz, valid) in (("velodyne", velo), ("split", split)):
        for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
            before = dict(fit_cuda.LAUNCHES)
            g1 = filter_ground_batched(xyz, valid, cfg).ground
            d = {k: v - before[k] for k, v in fit_cuda.LAUNCHES.items()}
            print(f"[4 slice] {scene} {mode} B={B} N={N}: launches of one "
                  f"batch", {k: v for k, v in d.items() if v}, flush=True)
            # every level of the level path is one launch of the level
            # family: no sweep, no plan of its own; a remap level adds R1
            # (and in exact mode R1b) and one median (#2); velodyne runs one
            # level, split terrain five remap levels
            fails.check(d["apply_sweep"] == 0 and d["moments2_sweep"] == 0
                        and d["sweep_plan"] == 0 and d["level"] > 0,
                        f"{scene} {mode}: the level path launched sweeps {d}")
            # binning's one sum has no binding: no segment plan either
            fails.check(d["seg_plan"] == 0 and d["seg_sum"] == 1,
                        f"{scene} {mode}: the level path built a segment plan"
                        f" or summed more than once {d}")
            per_remap = 2 if mode == "fast" else 3
            fails.check(d["level"] == 1 + per_remap * d["seg_order_stat"],
                        f"{scene} {mode}: {d['level']} launches of the level "
                        f"family for {d['seg_order_stat']} remap levels")
            if scene == "velodyne":
                fails.check(d["level"] == 1, f"velodyne {mode}: {d['level']} "
                            "launches of the level family, not 1")
            else:
                most = 11 if mode == "fast" else 16
                fails.check(0 < d["seg_order_stat"] and d["level"] <= most,
                            f"split {mode}: {d['level']} launches of the level"
                            f" family (at most {most}), "
                            f"{d['seg_order_stat']} remap levels")
            g2 = filter_ground_batched(xyz, valid, cfg).ground
            masks[(scene, mode)] = g1
            fails.check(torch.equal(g1, g2),
                        f"{scene} {mode}: two kernel runs differ")
    res_api = RecursivePatchwork(cfg_exact).filter_ground_points(
        velo[0][0].cpu().numpy())
    launches_level = dict(fit_cuda.LAUNCHES)

    # the generic level engine, its counts read on their own; the level path
    # (engine.level) must not run, though the loop of sweeps launches the
    # level family's plane table.  Every fit is one fit_level launch, at
    # 262144 points too; only a table above the card's gate takes the loop
    # of sweeps (apply, moments2, their plan)
    def counted(data, cfg):
        before = dict(fit_cuda.LAUNCHES)
        cap = Capture(engine, ["level"], {})
        try:
            g = filter_ground_batched(*data, cfg).ground
        finally:
            cap.restore()
        d = {k: fit_cuda.LAUNCHES[k] - v for k, v in before.items()}
        d["level path"] = cap.calls.get("level", 0)
        return g, d

    stamp("4 generic")
    fit_cuda.reset_launches()
    gen = {}
    gen["pallas"], d = counted(velo, cfg_pallas)
    fails.check(d["level path"] == 0 and d["seg_gather"] > 0
                and d["seg_minmax"] > 0, f"pallas: not the generic path {d}")
    for scene, data in (("velodyne128", velo_gen), ("split", split_gen)):
        for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
            gen[(scene, mode)], d = counted(data, cfg)
            print(f"[4 generic] {scene} {mode} B={B} N={N_GEN}: launches of "
                  f"one batch", {k: v for k, v in d.items() if v}, flush=True)
            # a binding builds one plan, at its first sum, and adds over it
            print(f"[4 generic] {scene} {mode}: {d['seg_plan']} segment plans"
                  f" for {d['seg_sum'] - 1} bound sums (binning's has none)",
                  flush=True)
            fails.check(0 < d["seg_plan"] <= d["seg_sum"] - 1,
                        f"{scene} {mode} N={N_GEN}: segment plans {d}")
            fails.check(d["level path"] == 0 and d["fit_level"] > 0
                        and d["apply_sweep"] == 0,
                        f"{scene} {mode} N={N_GEN}: not the generic path "
                        f"with fit_level only {d}")
    gen["big"], d = counted(velo_big, cfg_exact)
    print(f"[4 generic] velodyne128 exact B={B} N={N_BIG}: launches of one "
          f"batch", {k: v for k, v in d.items() if v}, flush=True)
    fails.check(d["level path"] == 0 and d["fit_level"] > 0
                and d["apply_sweep"] == 0,
                f"velodyne128 N={N_BIG}: not one fit_level launch a level {d}")
    sp_wide = fit_cuda.sp_width(cfg_wide.max_active_nodes + 1)
    gen["wide"], d = counted(wide, cfg_wide)
    print(f"[4 generic] split exact B={B_WIDE} N={N_WIDE}, "
          f"max_active_nodes_cfg {WIDE_NODES} (Sp {sp_wide}, above the "
          f"card's gate: {not fit_cuda.fit_level_fits(sp_wide, False, dev)}): "
          f"launches of one batch", {k: v for k, v in d.items() if v},
          flush=True)
    fails.check(not fit_cuda.fit_level_fits(sp_wide, False, dev)
                and fit_cuda.fit_level_fits(256, True, dev, level=True),
                "the card's gate: Sp 256 refused or the wide table admitted")
    fails.check(d["level path"] == 0 and d["fit_level"] > 0
                and d["apply_sweep"] > 0 and d["moments2_sweep"] > 0
                and d["sweep_plan"] > 0,
                f"wide table: no loop of sweeps above the card's gate {d}")
    launches_gen = dict(fit_cuda.LAUNCHES)
    launches = {k: launches_level[k] + launches_gen[k] for k in launches_gen}

    stamp("4 against plain")

    def plain_diff(data, cfg, got):
        """Differing mask bits against the plain path, how many were
        compared, and the plain path's scans/s on that run (CUDA events).
        The plain path takes seconds a batch, so fast mode, where no
        bitwise claim is made, compares the first two scans."""
        nb = 2 if cfg.fast_covariance else data[0].shape[0]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gp = filter_ground_batched(data[0][:nb], data[1][:nb], cfg,
                                   plain=True).ground
        end.record()
        torch.cuda.synchronize()
        return (int((gp != got[:nb]).sum().item()), gp.numel(),
                nb / (start.elapsed_time(end) / 1000.0))

    plain_rate = {}     # (scene, mode) -> (scans/s of the plain path, scans)

    n_api = len(res_api[0])
    n_batch = int(masks[("velodyne", "exact")][0].sum().item())
    fails.check(n_api == n_batch,
                f"RecursivePatchwork ground count {n_api} != batch {n_batch}")

    for scene, (xyz, valid) in (("velodyne", velo), ("split", split)):
        ex = masks[(scene, "exact")]
        fa = masks[(scene, "fast")]
        for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
            diff, of, rate = plain_diff((xyz, valid), cfg,
                                        masks[(scene, mode)])
            plain_rate[(scene, mode)] = (rate, of // xyz.shape[1])
            print(f"[4 slice] {scene} {mode}: kernel vs plain differing mask "
                  f"bits {diff} of {of}", flush=True)
            if mode == "exact":
                fails.check(diff == 0, f"{scene} exact: {diff} mask bits "
                                       "differ from the plain path")
        inter = (ex & fa).sum(1).double()
        union = (ex | fa).sum(1).double().clamp(min=1)
        iou = float((inter / union).min().item())
        print(f"[4 slice] {scene}: fast vs exact min IoU {iou:.6f}; ground "
              f"per scan {ex.sum(1).tolist()}", flush=True)
        # the split scene's deficient 3-point seeds are ill-conditioned
        # fits (PARITY.md), so its fast-vs-exact IoU is reported only
        if scene == "velodyne":
            fails.check(iou >= IOU_FAST_MIN, f"{scene}: fast IoU {iou} < 0.999")
        pa_gpu = binning.assign_patches(xyz, valid, cfg_exact)
        pa_cpu = binning.assign_patches(xyz.cpu(), valid.cpu(), cfg_exact)
        flips = (pa_gpu.patch.cpu() != pa_cpu.patch).sum(1).tolist()
        print(f"[4 slice] {scene}: patch-id flips CUDA vs CPU torch.atan2 "
              f"binning: {sum(flips)} of {pa_cpu.patch.numel()} points, per "
              f"scan {flips}", flush=True)
    print(f"[4 slice] RecursivePatchwork.filter_ground_points: {n_api} ground,"
          f" {len(res_api[1])} non-ground of {N}", flush=True)
    print(f"[4 slice] main-path launches, level path {launches_level}",
          flush=True)
    for fam in ("seg_order_stat", "level", "seg_sum"):
        fails.check(launches_level[fam] > 0,
                    f"kernel family {fam} never launched on the level path")

    # generic engine against the plain path and the level path forced
    diff = int((filter_ground_batched(*velo, cfg_pallas, plain=True).ground
                != gen["pallas"]).sum().item())
    same = torch.equal(gen["pallas"], masks[("velodyne", "exact")])
    print(f"[4 generic] pallas velodyne B={B} N={N} exact: kernel vs plain "
          f"differing mask bits {diff}; equal to the level path: {same}",
          flush=True)
    fails.check(diff == 0 and same, "pallas velodyne: masks differ")
    for scene, data in (("velodyne128", velo_gen), ("split", split_gen)):
        for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
            g = gen[(scene, mode)]
            d_plain, of, _ = plain_diff(data, cfg, g)
            gl = level_path(engine, filter_ground_batched, *data, cfg).ground
            d_level = int((gl != g).sum().item())
            iou = min_iou(g, gl)
            print(f"[4 generic] {scene} B={B} N={N_GEN} {mode}: kernel vs "
                  f"plain differing mask bits {d_plain} of {of}; vs the level "
                  f"path {d_level} of {g.numel()} (min IoU {iou:.6f})",
                  flush=True)
            if mode == "exact":
                fails.check(d_plain == 0, f"{scene} N={N_GEN} exact: "
                                          f"{d_plain} bits differ from plain")
                if scene == "velodyne128":
                    fails.check(d_level == 0, f"{scene} N={N_GEN} exact: "
                                f"{d_level} bits differ from the level path")
                else:   # the 3-point-seed exception of PARITY.md
                    fails.check(iou >= IOU_FAST_MIN, f"{scene} N={N_GEN}: "
                                f"IoU {iou} vs the level path < 0.999")
        iou = min_iou(gen[(scene, "exact")], gen[(scene, "fast")])
        print(f"[4 generic] {scene} N={N_GEN}: fast vs exact min IoU "
              f"{iou:.6f}", flush=True)
        if scene == "velodyne128":
            fails.check(iou >= IOU_FAST_MIN, f"{scene} N={N_GEN}: fast IoU "
                                             f"{iou} < 0.999")
    diff = int((filter_ground_batched(*velo_big, cfg_exact, plain=True).ground
                != gen["big"]).sum().item())
    print(f"[4 generic] velodyne128 B={B} N={N_BIG} exact: kernel vs plain "
          f"differing mask bits {diff}", flush=True)
    fails.check(diff == 0, f"velodyne128 N={N_BIG}: {diff} bits differ")
    diff = int((filter_ground_batched(*wide, cfg_wide, plain=True).ground
                != gen["wide"]).sum().item())
    print(f"[4 generic] split B={B_WIDE} N={N_WIDE} exact, the loop of sweeps "
          f"above the card's gate: kernel vs plain differing mask bits {diff}",
          flush=True)
    fails.check(diff == 0, f"wide table: {diff} bits differ from plain")
    print(f"[4 generic] main-path launches, generic path {launches_gen}",
          flush=True)
    for fam in ("seg_sum", "seg_gather", "seg_minmax", "fit_level",
                "apply_sweep", "moments2_sweep"):
        fails.check(launches_gen[fam] > 0,
                    f"kernel family {fam} never launched on the generic path")

    # ---- 5. quality on the hard labeled scenes ----
    stamp("5 quality")
    with open(os.path.join(ROOT, "EVAL_r05.json")) as f:
        ref = json.load(f)["scenes"]
    evaluated = tool("torch_eval_scenes").run(HARD_POINTS, 2, dev,
                                              log=lambda msg: None)["scenes"]
    for name in HARD_SCENES:
        line = []
        for mode in ("exact", "fast"):
            iou = evaluated[name][mode]["iou"]
            want = ref[name][mode]["iou"]
            line.append(f"{mode} {iou:.4f} (EVAL {want})")
            fails.check(abs(iou - want) <= IOU_EVAL_TOL,
                        f"{name} {mode}: IoU {iou:.4f} vs EVAL {want}")
        print(f"[5 quality] {name}: " + ", ".join(line), flush=True)

    # ---- 6. timing ----
    stamp("6 timing")
    for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
        rk = scans_per_s(*velo, cfg, False, 10)
        rp, nb = plain_rate[("velodyne", mode)]     # its run in phase 4
        print(f"[6 timing] velodyne B={B} N={N} {mode}: kernel path "
              f"{rk:.1f} scans/s, plain path {rp:.2f} scans/s (one batch of "
              f"{nb}) on {card}", flush=True)
    for n, data, mode, cfg in ((N_GEN, velo_gen, "exact", cfg_exact),
                               (N_GEN, velo_gen, "fast", cfg_fast),
                               (N_BIG, velo_big, "exact", cfg_exact)):
        rg = scans_per_s(*data, cfg, False, 3)
        rl = level_path(engine, scans_per_s, *data, cfg, False, 3)
        print(f"[6 timing] velodyne128 B={B} N={n} {mode}: generic path "
              f"{rg:.1f} scans/s, level path forced {rl:.1f} scans/s on "
              f"{card}", flush=True)

    # ---- 7. front ends ----
    stamp("7 front ends")
    launches_front = phase7(dev, card, fails)
    launches = {k: launches[k] + launches_front[k] for k in launches}

    # ---- 8. SLAM ----
    stamp("8 slam")
    launches_slam, extra_ba, ba_session = phase8(dev, card, fails)
    launches = {k: launches[k] + launches_slam[k] for k in launches}

    # ---- 9. multi-process execution ----
    stamp("9 parallel")
    launches_par = phase9(dev, card, fails, {"velodyne": velo, "split": split},
                          ba_session)
    launches = {k: launches[k] + launches_par[k] for k in launches}

    # ---- 10. the card against the reference algorithm ----
    stamp("10 reference")
    launches_ref = phase10(dev, fails, {
        "velodyne": velo + (masks[("velodyne", "exact")],),
        "split": split + (masks[("split", "exact")],),
        "velodyne128": velo_gen + (gen[("velodyne128", "exact")],)})
    launches = {k: launches[k] + launches_ref[k] for k in launches}

    # ---- 11. the port's benchmark, as a process ----
    stamp("11 bench")
    phase11(fails)

    # ---- 12. spans and host reads on the benchmark's cells ----
    stamp("12 spans")
    phase12(dev, card, fails)

    if fails.items:
        print(f"chip_smoke: {len(fails.items)} check(s) failed",
              file=sys.stderr)
        return 1

    src = "patchwork_tpu_torch/csrc/"
    table = [
        ("seg_order_stat", "orderstat.cu",
         "patchwork_tpu/kernels/fit_pallas.py:692"),
        ("apply_sweep", "sweeps.cu", "patchwork_tpu/kernels/fit_pallas.py:180"),
        ("moments2_sweep", "sweeps.cu",
         "patchwork_tpu/kernels/fit_pallas.py:220"),
        ("level", "fitloop.cu", "patchwork_tpu/kernels/fit_pallas.py:1465"),
        ("seg_sum", "seg.cu", "patchwork_tpu/kernels/seg_pallas.py:74"),
        ("fit_level", "fitloop.cu", "patchwork_tpu/kernels/fit_pallas.py:525"),
        ("seg_gather", "seg.cu", "patchwork_tpu/kernels/seg_pallas.py:112"),
        ("seg_minmax", "seg.cu", "patchwork_tpu/kernels/seg_pallas.py:165"),
    ]
    extra["seg_sum"]["plan_launches"] = launches["seg_plan"]
    extra["seg_sum"]["bundle_adjust"] = extra_ba
    stamp("results")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + f,
         "replaces": rep, "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bound[name][0], "bound_by": bound[name][1],
         "library_ms": lib_ms[name], **extra.get(name, {})}
        for name, f, rep in table] + [
        # #2's per-round entry: the point-sharded engine's order statistic
        {"name": "seg_order_stat_rounds", "route": "cuda",
         "source": src + "orderstat.cu",
         "replaces": "patchwork_tpu/kernels/fit_pallas.py:692",
         "launches": launches["seg_order_stat_rounds"], "library_ms": None,
         **rounds_entry}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
