#!/usr/bin/env python3
"""Render the reference README's comparison figure with the PyTorch port:
raw LiDAR, Patchwork, Patchwork++ and Recursive Patchwork BEV images side
by side, on the card unless ``--device cpu``.

The counterpart of tools/make_demo.py: the same panels (a height image of
the raw scan, then the ground / non-ground overlay of each configuration
variant), the same layout (8-pixel gaps, an 18-pixel strip above the
panels, a (20, 20, 20) background) and the same scan (``velodyne_like_cloud``
or a KITTI ``.bin`` frame).  The port writes the PNG with
``viz.bev.save_png`` (zlib and struct only) and draws no text, so the strip
above the panels stays blank: the panels are, left to right, raw,
patchwork, patchwork_pp and recursive (printed when the file is saved).
Like every BEV image of the port, the overlay draws the last pixel that the
JAX package's blanks (its ``viz/bev.py:81-86``).

Usage:
  python3 tools/torch_make_demo.py [--out demo_comparison.png]
      [--points 40000] [--device cpu]
  python3 tools/torch_make_demo.py --kitti /data/velodyne --frame 0
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

PANELS = ("raw", "patchwork", "patchwork_pp", "recursive")
PAD, LABEL_H, BACKGROUND = 8, 18, (20, 20, 20)


def panels(pts: np.ndarray, width: int, height: int, extent: float,
           device=None) -> list:
    """[(name, (H, W, 3) uint8 array)] of the figure's four panels."""
    import torch
    from patchwork_tpu_torch import PatchworkConfig, make_filter_ground
    from patchwork_tpu_torch.core.device import resolve_device
    from patchwork_tpu_torch.viz.bev import (bev_ground_nonground_image,
                                             bev_height_image)

    dev = resolve_device(device)
    xyz = torch.from_numpy(np.ascontiguousarray(pts[:, :3],
                                                np.float32)).to(dev)
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    e = extent
    out = []
    for name in PANELS:
        if name == "raw":
            img = bev_height_image(xyz, valid, width, height, -e, -e, e, e)
        else:
            res = make_filter_ground(PatchworkConfig.variant(name))(xyz, valid)
            img = bev_ground_nonground_image(
                xyz, res.ground, res.valid & ~res.ground, width, height,
                -e, -e, e, e)
        out.append((name, img.cpu().numpy()))
    return out


def figure(imgs: list) -> np.ndarray:
    """The panels side by side on the figure's canvas."""
    h, w = imgs[0][1].shape[:2]
    canvas = np.empty((h + LABEL_H + 2 * PAD, len(imgs) * (w + PAD) + PAD, 3),
                      np.uint8)
    canvas[:] = BACKGROUND
    for i, (_, img) in enumerate(imgs):
        x0 = PAD + i * (w + PAD)
        canvas[LABEL_H + PAD:LABEL_H + PAD + h, x0:x0 + w] = img
    return canvas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="demo_comparison.png")
    ap.add_argument("--points", type=int, default=40000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kitti", help="KITTI velodyne dir (else synthetic)")
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--size", type=int, nargs=2, default=(400, 400),
                    metavar=("W", "H"))
    ap.add_argument("--extent", type=float, default=60.0)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    args = ap.parse_args(argv)

    from patchwork_tpu_torch.viz.bev import save_png

    if args.kitti:
        from patchwork_tpu_torch.io.kitti import list_sequence, read_bin

        pts = read_bin(list_sequence(args.kitti)[args.frame])
    else:
        from patchwork_tpu_torch.io.synthetic import velodyne_like_cloud

        pts = velodyne_like_cloud(args.points, seed=args.seed)
    w, h = args.size
    save_png(figure(panels(pts, w, h, args.extent, args.device)), args.out)
    print(f"Saved: {args.out} (panels, left to right: {', '.join(PANELS)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
