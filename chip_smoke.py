#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, one line each:
  1. card: torch's device name, and nvidia-smi's name and power limit;
  2. build: compile the kernels of patchwork_tpu_torch/csrc with nvcc;
  3. kernels: every kernel wrapper against its plain PyTorch version, on the
     inputs the main path gives it (captured from runs of the slice: the
     level path, the "pallas" segment ops and the generic engine's fit);
  4. slice: filter_ground_batched on B=8 x 131072 velodyne-like scans and
     on B=8 x 131072 split-terrain scans (whose patches recurse), exact and
     fast mode, through the kernels: exact masks equal the plain path's bit
     for bit, fast IoU >= 0.999 vs exact, a second run gives the same masks,
     sector ids agree with CPU binning, RecursivePatchwork on one scan; then
     the generic level engine: segment_impl="pallas" at B=8 x 131072, and
     the default "fused" above the fit gate on 128-beam velodyne and split
     terrain at B=8 x 153600 (fit_level at level 0, the loop of sweeps
     deeper) and on 128-beam velodyne at B=8 x 262144 (the loop of sweeps
     only), held to the plain path and to the level path forced on the same
     scans; every kernel family was launched;
  5. quality: the five hard labeled scenes at 65536 points (seeds 0, 1),
     IoU within 0.001 of EVAL_r05.json in both modes;
  6. timing: scans/s of the kernel path and the plain path (CUDA events),
     and of the generic path beside the level path forced on the same scans;
  7. front ends, through the entry points a user calls, with the launch
     counts read around those calls only: (a) LidarFusion on the card fuses
     eight 3-LiDAR IAC scenes to 131072 points each, bit for bit as on the
     CPU, and filter_ground_batched segments them (exact masks equal the
     plain path's, fast IoU >= 0.999); (b) RecursivePatchwork's
     sample_ground_and_obstacles; (c) the CLI in this process on the demo
     cloud and on a split-terrain KITTI frame (whose patches split, so the
     order statistic runs), with both PNGs decoded; (d) the CLI as a
     process on a 3-topic MCAP (bag -> fusion -> engine); (e) a JSON launch
     descriptor over eight 128-beam KITTI frames of 153600 points, default
     config (fit_level) and segment_impl "pallas"; (f) PatchworkNode over 16
     velodyne frames at batch sizes 1 and 8, with frames/s and stage times.
     Every count and mask is held to filter_ground/filter_ground_batched on
     the same points, and all eight kernel families must launch.
Then a JSON line per kernel family and, last, the device line.  Exits
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
HARD_POINTS = 65536
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3   # float sums; the design adds in one order
IOU_FAST_MIN = 0.999
IOU_EVAL_TOL = 0.001


def split_terrain_cloud(n: int, seed: int):
    """Sloped ground (8% grade) with a 0.5 m step and box obstacles: the
    engine parity suite's recursion scene, whose residuals split patches
    to depth 3+ (tests/test_engine_parity.py test_split_recursion)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_obst = n // 6
    n_g = n - n_obst
    g = np.empty((n_g, 3), np.float32)
    g[:, 0] = rng.uniform(-80, 80, n_g)
    g[:, 1] = rng.uniform(-80, 80, n_g)
    g[:, 2] = 0.08 * g[:, 0] + 0.5 * (g[:, 1] > 20) + rng.normal(0, 0.05, n_g)
    obst = rng.uniform(-40, 40, (n_obst, 2))
    oz = rng.uniform(0.5, 3.0, n_obst)
    return np.concatenate([g, np.column_stack([obst, oz])]).astype(np.float32)


class Failures:
    def __init__(self):
        self.items = []

    def check(self, ok: bool, what: str) -> bool:
        if not ok:
            self.items.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


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


def _time_ms(fn, args, kwargs, reps: int) -> float:
    """Mean CUDA-event time of fn over reps calls on fresh input clones."""
    import torch

    total = 0.0
    for _ in range(reps):
        a = _clone(args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a, **kwargs)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def scans_per_s(xyz, valid, cfg, plain, reps):
    """Scans/s of filter_ground_batched over ``reps`` calls after a warm-up
    (CUDA events)."""
    import torch
    from patchwork_tpu_torch import filter_ground_batched

    filter_ground_batched(xyz, valid, cfg, plain=plain)   # warm-up
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
        PatchworkConfig, RecursivePatchwork, cli, filter_ground,
        filter_ground_batched)
    from patchwork_tpu_torch.core.config import default_lidar_configs
    from patchwork_tpu_torch.fusion.fusion import LidarFusion
    from patchwork_tpu_torch.io.bag import write_mcap_topics
    from patchwork_tpu_torch.io.synthetic import (
        demo_point_cloud, fused_iac_cloud, iac_three_lidar_scene,
        velodyne_like_cloud)
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
    fused = [front_end(fused_iac_cloud, N, seed=s, device=dev)
             for s in range(B)]
    same = all(np.array_equal(a.view(np.int32),
                              fused_iac_cloud(N, seed=s).view(np.int32))
               for s, a in enumerate(fused))
    clouds0 = iac_three_lidar_scene(N // 3 + 512, seed=0)
    fuser = LidarFusion(device=dev)
    front_end(fuser.fuse, clouds0)           # warm-up
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
    rp_cpu = RecursivePatchwork(cfg_exact)
    sel = front_end(RecursivePatchwork(cfg_exact, device=dev)
                    .sample_ground_and_obstacles, fused[0])
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
        filt = RecursivePatchwork(cfg_exact, device=dev) \
            .sample_ground_and_obstacles(pts, 1.1, 0.5, seed=0)
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
        fused0 = LidarFusion(device=dev).fuse(clouds0).to_numpy()
        want = counts(RecursivePatchwork(cfg_exact, device=dev)
                      .segment(fused0)[0])
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
                                      log=lambda s: None, device=dev)
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
        node = PatchworkNode(capacity=N, batch_size=bs, device=dev)
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

    print(f"[7 front ends] launches {front}", flush=True)
    for fam, n in front.items():
        fails.check(n > 0, f"kernel family {fam} never launched by the "
                           "front ends")
    return front


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
        HARD_SCENES, hard_labeled_scene, velodyne_like_cloud)
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

    # ---- 3. kernels vs plain versions, on the main path's inputs ----
    members = ["seg_order_stat", "seg_sum", "apply_sweep", "moments2_sweep",
               "remap_r1", "remap_r1b", "remap_nodes", "remap_points",
               "node_stats", "early_outs", "deficient_round", "seed_init",
               "plane_table", "split_decision", "finish_nodes"]
    family_of = {m: "level" for m in members}
    for f in ("seg_order_stat", "seg_sum", "apply_sweep", "moments2_sweep",
              "fit_level", "seg_gather", "seg_minmax"):
        family_of[f] = f
    # (label, mode) -> (wrapper name, module, args, kwargs)
    captured = {}
    for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
        cap_k = Capture(fit_cuda, members, {"apply_sweep": 5,
                                             "moments2_sweep": 5,
                                             "plane_table": 5})
        cap_l = Capture(engine, ["level"], {"level": 2})
        try:
            filter_ground_batched(*split, cfg)
        finally:
            cap_k.restore()
            cap_l.restore()
        for name, v in cap_k.saved.items():
            captured[(name, mode)] = (name, fit_cuda) + v
        captured[("level", mode)] = ("level", engine) + cap_l.saved["level"]
    # the generic engine: "pallas" segment ops at B x N, and the fit of
    # "fused" above the gate at B x N_GEN (fit_level at level 0, the loop of
    # sweeps at the deeper levels)
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
            filter_ground_batched(*split_gen, cfg)
        finally:
            cap_f.restore()
            cap_e.restore()
        fit_inputs[mode] = cap_e.saved["_fused_fit_resid"]
        captured[("fit_level", mode)] = (("fit_level", fit_cuda)
                                         + cap_f.saved["fit_level"])
        for name in ("apply_sweep", "moments2_sweep"):
            captured[(name + "/fit", mode)] = ((name, fit_cuda)
                                               + cap_f.saved[name])

    exact_only = {"seg_order_stat", "remap_nodes", "remap_points",
                  "node_stats", "early_outs", "deficient_round",
                  "finish_nodes", "seg_gather", "seg_minmax"}
    err = {f: 0.0 for f in set(family_of.values())}
    ms = {f: 0.0 for f in err}
    plain_ms = {f: 0.0 for f in err}
    for (label, mode), (name, module, args, kw) in sorted(captured.items()):
        if name == "level":
            fn_k, fn_p = engine.level, engine.level_reference
        else:
            fn_k = getattr(module, name)
            fn_p = getattr(module.plain, name)
        ak, ap = _clone(args), _clone(args)
        out_k, out_p = fn_k(*ak, **kw), fn_p(*ap, **kw)
        torch.cuda.synchronize()
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
            state_k, stats_k = out_k
            state_p, stats_p = out_p
            exact = (torch.equal(state_k, state_p)
                     and torch.equal(stats_k[:, [0, 1, 3, 4]],
                                     stats_p[:, [0, 1, 3, 4]]))
            fine = exact and torch.allclose(stats_k, stats_p, rtol=SUM_RTOL,
                                            atol=SUM_ATOL, equal_nan=True)
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
        t_p = _time_ms(fn_p, args, kw, 1 if name == "fit_level"
                       else 2 if slow else 3)
        if label in ms and mode == "exact":   # the family's own entry point
            ms[label], plain_ms[label] = t_k, t_p
        print(f"[3 kernels] {label:19s} {mode:5s} max_abs_err {e:.3g} "
              f"kernel {t_k:.3f} ms plain {t_p:.3f} ms "
              f"{'ok' if fine else 'MISMATCH'}", flush=True)
        fails.check(fine, f"kernel {label} ({mode}) disagrees with its plain "
                          f"version (max_abs_err {e})")

    # kernel 5 against the loop of sweeps it stands for, on the same level-0
    # fit (the loop is exact two-pass in both modes; fit_level honours fast)
    for mode, (args, kw) in sorted(fit_inputs.items()):
        t_one = _time_ms(engine._fused_fit_resid, args, kw, 3)
        g_one = engine._fused_fit_resid(*_clone(args), **kw)[0]
        gate = fit_cuda.megakernel_fits
        fit_cuda.megakernel_fits = lambda n, sp: False
        try:
            t_loop = _time_ms(engine._fused_fit_resid, args, kw, 3)
            g_loop = engine._fused_fit_resid(*_clone(args), **kw)[0]
        finally:
            fit_cuda.megakernel_fits = gate
        d = int((g_one != g_loop).sum().item())
        print(f"[3 kernels] level-0 fit B={B} N={N_GEN} {mode}: fit_level "
              f"{t_one:.3f} ms, loop of sweeps {t_loop:.3f} ms; differing "
              f"mask bits {d}", flush=True)
        if mode == "exact":
            fails.check(d == 0, f"fit_level and the loop of sweeps differ "
                                f"by {d} mask bits")

    # ---- 4. the slice through the kernels ----
    fit_cuda.reset_launches()
    masks = {}
    for scene, (xyz, valid) in (("velodyne", velo), ("split", split)):
        for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
            g1 = filter_ground_batched(xyz, valid, cfg).ground
            g2 = filter_ground_batched(xyz, valid, cfg).ground
            masks[(scene, mode)] = g1
            fails.check(torch.equal(g1, g2),
                        f"{scene} {mode}: two kernel runs differ")
    res_api = RecursivePatchwork(cfg_exact, device=dev).filter_ground_points(
        velo[0][0].cpu().numpy())
    launches_level = dict(fit_cuda.LAUNCHES)

    # the generic level engine, its counts read on their own; the level path
    # (engine.level) must not run, though the loop of sweeps launches the
    # level family's plane table
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

    fit_cuda.reset_launches()
    gen = {}
    gen["pallas"], d = counted(velo, cfg_pallas)
    fails.check(d["level path"] == 0 and d["seg_gather"] > 0
                and d["seg_minmax"] > 0, f"pallas: not the generic path {d}")
    for scene, data in (("velodyne128", velo_gen), ("split", split_gen)):
        for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
            gen[(scene, mode)], d = counted(data, cfg)
            fails.check(d["level path"] == 0 and d["fit_level"] > 0,
                        f"{scene} {mode} N={N_GEN}: not the generic path "
                        f"with fit_level {d}")
    gen["big"], d = counted(velo_big, cfg_exact)
    fails.check(d["level path"] == 0 and d["fit_level"] == 0
                and d["apply_sweep"] > 0,
                f"velodyne128 N={N_BIG}: not the loop of sweeps {d}")
    launches_gen = dict(fit_cuda.LAUNCHES)
    launches = {k: launches_level[k] + launches_gen[k] for k in launches_gen}

    n_api = len(res_api[0])
    n_batch = int(masks[("velodyne", "exact")][0].sum().item())
    fails.check(n_api == n_batch,
                f"RecursivePatchwork ground count {n_api} != batch {n_batch}")

    for scene, (xyz, valid) in (("velodyne", velo), ("split", split)):
        ex = masks[(scene, "exact")]
        fa = masks[(scene, "fast")]
        for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
            gp = filter_ground_batched(xyz, valid, cfg, plain=True).ground
            diff = int((gp != masks[(scene, mode)]).sum().item())
            print(f"[4 slice] {scene} {mode}: kernel vs plain differing mask "
                  f"bits {diff} of {gp.numel()}", flush=True)
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
        flips = int((pa_gpu.patch.cpu() != pa_cpu.patch).sum().item())
        print(f"[4 slice] {scene}: patch-id flips CUDA vs CPU torch.atan2 "
              f"binning: {flips}", flush=True)
    print(f"[4 slice] RecursivePatchwork.filter_ground_points: {n_api} ground,"
          f" {len(res_api[1])} non-ground of {N}", flush=True)
    print(f"[4 slice] main-path launches, level path {launches_level}",
          flush=True)
    for fam in ("seg_order_stat", "apply_sweep", "moments2_sweep", "level",
                "seg_sum"):
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
            gp = filter_ground_batched(*data, cfg, plain=True).ground
            gl = level_path(engine, filter_ground_batched, *data, cfg).ground
            d_plain = int((gp != g).sum().item())
            d_level = int((gl != g).sum().item())
            iou = min_iou(g, gl)
            print(f"[4 generic] {scene} B={B} N={N_GEN} {mode}: kernel vs "
                  f"plain differing mask bits {d_plain}; vs the level path "
                  f"{d_level} of {g.numel()} (min IoU {iou:.6f})", flush=True)
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
    print(f"[4 generic] main-path launches, generic path {launches_gen}",
          flush=True)
    for fam in ("seg_sum", "seg_gather", "seg_minmax", "fit_level",
                "apply_sweep", "moments2_sweep"):
        fails.check(launches_gen[fam] > 0,
                    f"kernel family {fam} never launched on the generic path")

    # ---- 5. quality on the hard labeled scenes ----
    with open(os.path.join(ROOT, "EVAL_r05.json")) as f:
        ref = json.load(f)["scenes"]
    for name in HARD_SCENES:
        scenes = [hard_labeled_scene(name, HARD_POINTS, seed=s) for s in (0, 1)]
        xyz = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
        valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
        line = []
        for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
            g = filter_ground_batched(xyz, valid, cfg).ground.cpu().numpy()
            ious = []
            for gi, (_, lab) in zip(g, scenes):
                tp = float((gi & lab).sum())
                ious.append(tp / max(float((gi | lab).sum()), 1.0))
            iou = float(np.mean(ious))
            want = ref[name][mode]["iou"]
            line.append(f"{mode} {iou:.4f} (EVAL {want})")
            fails.check(abs(iou - want) <= IOU_EVAL_TOL,
                        f"{name} {mode}: IoU {iou:.4f} vs EVAL {want}")
        print(f"[5 quality] {name}: " + ", ".join(line), flush=True)

    # ---- 6. timing ----
    for mode, cfg in (("exact", cfg_exact), ("fast", cfg_fast)):
        rk = scans_per_s(*velo, cfg, False, 10)
        rp = scans_per_s(*velo, cfg, True, 1)
        print(f"[6 timing] velodyne B={B} N={N} {mode}: kernel path "
              f"{rk:.1f} scans/s, plain path {rp:.2f} scans/s on {card}",
              flush=True)
    for n, data, mode, cfg in ((N_GEN, velo_gen, "exact", cfg_exact),
                               (N_GEN, velo_gen, "fast", cfg_fast),
                               (N_BIG, velo_big, "exact", cfg_exact)):
        rg = scans_per_s(*data, cfg, False, 3)
        rl = level_path(engine, scans_per_s, *data, cfg, False, 3)
        print(f"[6 timing] velodyne128 B={B} N={n} {mode}: generic path "
              f"{rg:.1f} scans/s, level path forced {rl:.1f} scans/s on "
              f"{card}", flush=True)

    # ---- 7. front ends ----
    launches_front = phase7(dev, card, fails)
    launches = {k: launches[k] + launches_front[k] for k in launches}

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
        ("level", "level.cu", "patchwork_tpu/kernels/fit_pallas.py:1465"),
        ("seg_sum", "sweeps.cu", "patchwork_tpu/kernels/seg_pallas.py:74"),
        ("fit_level", "fitloop.cu", "patchwork_tpu/kernels/fit_pallas.py:525"),
        ("seg_gather", "seg.cu", "patchwork_tpu/kernels/seg_pallas.py:112"),
        ("seg_minmax", "seg.cu", "patchwork_tpu/kernels/seg_pallas.py:165"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + f,
         "replaces": rep, "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, f, rep in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
