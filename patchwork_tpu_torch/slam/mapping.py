"""World-frame map assembly and export from a finished SLAM session.

Counterpart of ``patchwork_tpu/slam/mapping.py``: the aggregated
world-frame cloud, the landmark classes and the trajectory of a
:class:`~.odometry.LidarOdometry` after optimization, written as npz or
ASCII PLY.  The keyframe feature clouds go to the world frame in one
batched product over the pose stack on the odometry's device; an optional
voxel filter on the host bounds the map.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..io.native import voxel_downsample_host

__all__ = ["build_map", "save_map_npz", "save_map_ply"]


def build_map(odo, voxel: Optional[float] = 0.5, include_ground: bool = True):
    """Aggregate a LidarOdometry's keyframe features into the world frame.

    Returns a dict: ``points`` (M, 3) world-frame map cloud, ``classes``
    (M,) uint8 (0 = ground, 1 = obstacle), ``trajectory`` (K, 3) keyframe
    positions, ``poses`` (K, 4, 4).  ``voxel`` (meters) de-duplicates the
    cloud by voxel-grid centroid; None keeps every point.  An odometry with
    no keyframe gives the empty map.
    """
    from .odometry import stack_frames

    k = len(odo.poses)
    if k == 0 or len(odo._frames) == 0:
        poses = (np.stack(odo.poses).astype(np.float32) if k
                 else np.zeros((0, 4, 4), np.float32))
        return {"points": np.zeros((0, 3), np.float32),
                "classes": np.zeros((0,), np.uint8),
                "trajectory": poses[:, :3, 3],
                "poses": poses}
    poses = np.stack(odo.poses).astype(np.float32)
    stacked = stack_frames(odo._frames)
    nk = int(stacked["obst"].shape[0])
    T = torch.from_numpy(poses[:nk]).to(stacked["obst"].device)
    groups = [("obst", "obst_valid", 1)]
    if include_ground:
        groups.append(("ground", "ground_valid", 0))
    pts_out, cls_out = [], []
    for key, vkey, cls in groups:
        # world = R p + t, all keyframes in one product
        w = (torch.einsum("kij,knj->kni", T[:, :3, :3], stacked[key])
             + T[:, None, :3, 3])
        w = w.cpu().numpy()[stacked[vkey].cpu().numpy()]
        if voxel:
            w = voxel_downsample_host(w.astype(np.float32), voxel)
        pts_out.append(w.astype(np.float32))
        cls_out.append(np.full(len(w), cls, np.uint8))
    return {"points": np.concatenate(pts_out),
            "classes": np.concatenate(cls_out),
            "trajectory": poses[:, :3, 3],
            "poses": poses}


def save_map_npz(path: str, odo, voxel: Optional[float] = 0.5) -> dict:
    """Build + save the map as npz; returns the map dict."""
    m = build_map(odo, voxel=voxel)
    np.savez_compressed(path, **m)
    return m


_CLASS_COLORS = {0: (60, 180, 60), 1: (220, 60, 60)}   # ground, obstacle
_TRAJ_COLOR = (60, 60, 220)


def save_map_ply(path: str, odo, voxel: Optional[float] = 0.5,
                 include_trajectory: bool = True) -> int:
    """Write the world-frame map as ASCII PLY (colored by class, with the
    trajectory as blue points).  Returns the vertex count."""
    m = build_map(odo, voxel=voxel)
    pts = [m["points"]]
    cols = [np.stack([
        np.full(len(m["points"]), _CLASS_COLORS[0][i], np.uint8)
        for i in range(3)], axis=1)]
    cols[0][m["classes"] == 1] = _CLASS_COLORS[1]
    if include_trajectory and len(m["trajectory"]):
        pts.append(m["trajectory"].astype(np.float32))
        cols.append(np.tile(np.asarray(_TRAJ_COLOR, np.uint8),
                            (len(m["trajectory"]), 1)))
    xyz = np.concatenate(pts)
    rgb = np.concatenate(cols)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(xyz)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for (x, y, z), (r, g, b) in zip(xyz, rgb):
            f.write(f"{x:.4f} {y:.4f} {z:.4f} {r} {g} {b}\n")
    return len(xyz)
