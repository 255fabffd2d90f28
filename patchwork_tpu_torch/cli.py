"""Command-line front end of the PyTorch / CUDA port.

Counterpart of ``patchwork_tpu/cli.py``, with ``--device`` (default
``cuda``): without a CUDA device the CLI exits non-zero unless
``--device cpu`` is given; it never falls back to the CPU on its own.  The
CUDA kernels build once into ``build/`` at first use.

Mirrors the reference CLI (src/main.cpp:16-45,88-322) with pure-array
ingest instead of ROS2 bags: demo mode (synthetic), KITTI ``.bin`` scans,
and ``.npz`` clouds.  Unlike the reference — whose CLI never forwards its
parameters into PatchworkConfig (main.cpp:193, SURVEY.md §5) — every
algorithm flag here reaches the engine.

Usage examples:
  python -m patchwork_tpu_torch.cli --demo --use-patchwork
  python -m patchwork_tpu_torch.cli --demo --use-patchwork --device cpu
  python -m patchwork_tpu_torch.cli --kitti /data/velodyne --frame 10 --use-patchwork
  python -m patchwork_tpu_torch.cli scan.bin --use-patchwork --separate-display
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="patchwork_tpu_torch",
        description="Recursive Patchwork ground segmentation on PyTorch "
                    "with CUDA kernels",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("input", nargs="?",
                   help=".bin / .npz point cloud, or .db3/.mcap bag file")
    p.add_argument("--demo", action="store_true", help="synthetic demo cloud")
    p.add_argument("--kitti", help="KITTI velodyne directory")
    p.add_argument("--frame", type=int, default=0, help="frame number")
    p.add_argument("--topics", nargs="+", default=None,
                   help="bag topics; >1 topic triggers multi-LiDAR fusion "
                        "(default: auto-detect point-cloud topics)")
    p.add_argument("--stream", action="store_true",
                   help="stream ALL frames (KITTI dir or bag topic) through "
                        "the engine; writes masks npz + latency report")
    p.add_argument("--launch", metavar="FILE",
                   help="run a YAML/JSON deployment descriptor (node params "
                        "+ config + source + capacity in one file — the "
                        "launch-file analogue, see patchwork_tpu_torch/launch.py)")
    p.add_argument("--variant", default="recursive",
                   help="algorithm variant: recursive | patchwork | patchwork_pp")
    p.add_argument("--num-points", type=int, default=10000, help="demo cloud size")
    p.add_argument("--seed", type=int, default=0, help="demo RNG seed")
    # BEV geometry (main.cpp defaults)
    p.add_argument("--bev-width", type=int, default=300)
    p.add_argument("--bev-height", type=int, default=150)
    p.add_argument("--x-min", type=float, default=-150.0)
    p.add_argument("--y-min", type=float, default=-75.0)
    p.add_argument("--use-patchwork", action="store_true")
    p.add_argument("--target-height", type=float, default=1.1)
    p.add_argument("--height-tolerance", type=float, default=0.5)
    p.add_argument("--separate-display", action="store_true")
    p.add_argument("--out-prefix", default=None, help="output file prefix")
    # algorithm config (all PatchworkConfig fields reachable)
    p.add_argument("--config-json", help="PatchworkConfig overrides as JSON")
    p.add_argument("--sensor-height", type=float)
    p.add_argument("--filtering-radius", type=float)
    p.add_argument("--num-sectors", type=int)
    p.add_argument("--max-iter", type=int)
    p.add_argument("--th-dist", type=float)
    p.add_argument("--th-seeds", type=float)
    p.add_argument("--max-levels", type=int)
    return p


def _is_bag(path: str) -> bool:
    if path.endswith((".db3", ".mcap")):
        return True
    try:
        from .io.bag import sniff_format

        sniff_format(path)
        return True
    except (ValueError, OSError):
        return False


def load_cloud(args, device: torch.device) -> np.ndarray:
    from .io.synthetic import demo_point_cloud

    if args.demo:
        return demo_point_cloud(args.num_points, seed=args.seed)
    if args.kitti:
        from .io.kitti import list_sequence, read_bin

        paths = list_sequence(args.kitti)
        if not paths:
            sys.exit(f"no .bin scans in {args.kitti}")
        if args.frame >= len(paths):
            sys.exit(f"frame {args.frame} out of range ({len(paths)} scans)")
        return read_bin(paths[args.frame])
    if args.input:
        if _is_bag(args.input):
            return load_bag_frame(args, device)
        if args.input.endswith(".npz"):
            with np.load(args.input) as f:
                key = "xyz" if "xyz" in f else list(f.keys())[0]
                return np.asarray(f[key], np.float32)[:, :3]
        from .io.kitti import read_bin

        return read_bin(args.input)
    sys.exit("need --demo, --kitti DIR, or an input file (see --help)")


def load_bag_frame(args, device: torch.device) -> np.ndarray:
    """Load one frame from a bag; multiple topics -> multi-LiDAR fusion
    (reference: src/main.cpp:217-249)."""
    from .fusion.fusion import LidarFusion
    from .io.bag import BagReader

    with BagReader(args.input) as bag:
        topics = args.topics or bag.point_cloud_topics()
        if not topics:
            sys.exit(f"no point-cloud topics in {args.input} "
                     f"(topics: {bag.topic_names()})")
        print(f"Topics: {' '.join(topics)}")
        clouds = bag.load_multiple_point_clouds(topics, args.frame)
    if not any(len(c) for c in clouds):
        sys.exit(f"no points at frame {args.frame} on any topic")
    if len(clouds) == 1:
        return clouds[0]
    fusion = LidarFusion(device=device)
    fused = fusion.fuse(clouds)
    return fused.to_numpy()


def stream_mode(args, device: torch.device) -> int:
    """Process a whole sequence/bag through the streaming node; write
    packed masks + per-frame counts + latency report."""
    from .node import NodeParams, PatchworkNode
    from .utils.checkpoint import save_masks

    if args.kitti:
        from .io.kitti import iter_sequence

        scans = iter_sequence(args.kitti)
    elif args.input and _is_bag(args.input):
        from .io.bag import BagReader

        bag = BagReader(args.input)
        topics = args.topics or bag.point_cloud_topics()
        if not topics:
            sys.exit("no point-cloud topics in bag")
        scans = bag.iter_point_clouds(topics[0])
    else:
        sys.exit("--stream needs --kitti DIR or a bag input")

    cap = 1 << (17 if args.num_points <= 131072 else args.num_points.bit_length())
    node = PatchworkNode(NodeParams(), config=make_config(args), capacity=cap,
                         device=device)
    results = node.run(scans)
    for r in results:
        print(f"Processed frame {r.index} in {r.latency_s*1e3:.1f} ms: "
              f"{r.num_ground} ground, {r.num_obstacles} obstacles")
    print(node.times.report())
    if results:
        out = (args.out_prefix or "stream") + "_masks.npz"
        save_masks(
            out,
            np.stack([r.ground_mask for r in results]),
            np.stack([r.valid_mask for r in results]),
            np.array([r.index for r in results]),
        )
        print(f"Saved: {out}")
    return 0


def make_config(args):
    from .core.config import PatchworkConfig

    kw = {}
    if args.config_json:
        kw.update(json.loads(args.config_json))
    if args.variant != "recursive":
        base = PatchworkConfig.variant(args.variant)
        kw.setdefault("max_split_depth", base.max_split_depth)
        kw.setdefault("max_levels", base.max_levels)
        for f in ("adaptive_seed_height", "flat_dz", "num_sectors"):
            kw.setdefault(f, getattr(base, f))
    for field, name in [
        ("sensor_height", "sensor_height"),
        ("filtering_radius", "filtering_radius"),
        ("num_sectors", "num_sectors"),
        ("max_iter", "max_iter"),
        ("th_dist", "th_dist"),
        ("th_seeds", "th_seeds"),
        ("max_levels", "max_levels"),
    ]:
        v = getattr(args, name)
        if v is not None:
            kw[field] = v
    return PatchworkConfig(**kw)


def resolve_device(name: str) -> torch.device:
    """The requested device; exits with a message when it is a CUDA device
    and there is none (no silent fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit(f"--device {name}: no CUDA device is available "
                     "(pass --device cpu to run on the CPU)")
        from .core.device import cuda_device

        return cuda_device(device.index or 0)
    return device


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.perf_counter()
    device = resolve_device(args.device)

    if args.launch:
        from .launch import load_launch, run_launch

        run_launch(load_launch(args.launch), device=device)
        return 0

    if args.stream:
        return stream_mode(args, device)

    pts = load_cloud(args, device)
    print(f"Total points: {len(pts)}")

    from .api import RecursivePatchwork
    from .viz.bev import (
        bev_ground_nonground_image,
        bev_height_image,
        save_png,
    )

    cfg = make_config(args)
    base = args.out_prefix or (
        "demo_frame" if args.demo else f"lidar_bev_frame_{args.frame}"
    )
    w, h = args.bev_width, args.bev_height
    x0, y0 = args.x_min, args.y_min
    x1, y1 = x0 + w, y0 + h  # reference: extent == pixel count (main.cpp:282)

    if args.use_patchwork:
        engine = RecursivePatchwork(cfg, device=device)
        res, n = engine.segment(pts)
        xyz = torch.zeros((res.ground.shape[0], 3), device=device)
        xyz[:n] = torch.from_numpy(np.ascontiguousarray(pts[:, :3]))
        ground = res.ground
        non_ground = res.valid & ~res.ground
        n_ground = int(res.num_ground())
        n_non = int(res.num_non_ground())
        print(f"Ground points: {n_ground}")
        print(f"Non-ground points: {n_non}")

        if args.separate_display:
            img = bev_ground_nonground_image(
                xyz, ground, non_ground, w, h, x0, y0, x1, y1
            )
            save_png(img, f"{base}_patchwork.png")
            print(f"Saved: {base}_patchwork.png")
            filtered = engine.sample_ground_and_obstacles(
                pts, args.target_height, args.height_tolerance, seed=args.seed
            )
            fxyz = torch.from_numpy(filtered).to(device)
            img2 = bev_height_image(
                fxyz, torch.ones(len(filtered), dtype=torch.bool,
                                 device=device),
                w, h, x0, y0, x1, y1,
            )
            save_png(img2, f"{base}_enhanced.png")
            print(f"Saved: {base}_enhanced.png")
        else:
            img = bev_height_image(xyz, non_ground, w, h, x0, y0, x1, y1)
            save_png(img, f"{base}_patchwork.png")
            print(f"Saved: {base}_patchwork.png")
    else:
        name = "demo_original.png" if args.demo else f"{base}.png"
        pxyz = torch.from_numpy(np.ascontiguousarray(pts[:, :3])).to(device)
        img = bev_height_image(
            pxyz, torch.ones(len(pts), dtype=torch.bool, device=device),
            w, h, x0, y0, x1, y1
        )
        save_png(img, name)
        print(f"Saved: {name}")

    dt_ms = (time.perf_counter() - t_start) * 1000
    print(f"Processing completed in {dt_ms:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
