"""Persistence of SLAM state and of per-frame segmentation masks.

Counterpart of ``patchwork_tpu/utils/checkpoint.py``, in the same file
format (plain ``.npz`` plus a JSON sidecar), so a checkpoint written by
either package loads in the other: a LidarOdometry's poses, edges and
configs, and packed per-frame masks.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from ..core.config import PatchworkConfig

__all__ = ["save_odometry", "load_odometry", "save_masks", "load_masks"]


def save_odometry(path: str, odo, extra: Optional[dict] = None) -> None:
    """Persist a LidarOdometry's trajectory and edges (+ config sidecar at
    ``path + ".json"``)."""
    poses = (np.stack(odo.poses) if odo.poses
             else np.zeros((0, 4, 4), np.float32))
    ei = np.array([e[0] for e in odo.edges], np.int32)
    ej = np.array([e[1] for e in odo.edges], np.int32)
    eT = (np.stack([e[2] for e in odo.edges]).astype(np.float32)
          if odo.edges else np.zeros((0, 4, 4), np.float32))
    np.savez_compressed(path, poses=poses, edge_i=ei, edge_j=ej, edge_T=eT)
    meta = {"patchwork": json.loads(odo.pw.to_json()),
            "odometry": dataclasses.asdict(odo.cfg), **(extra or {})}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def load_odometry(path: str):
    """(poses (K, 4, 4), edges [(i, j, T_ij)], PatchworkConfig or None)."""
    with np.load(path) as f:
        poses = f["poses"]
        edges = [(int(i), int(j), T)
                 for i, j, T in zip(f["edge_i"], f["edge_j"], f["edge_T"])]
    cfg = None
    side = path + ".json"
    if os.path.exists(side):
        with open(side) as f:
            meta = json.load(f)
        cfg = PatchworkConfig(**meta.get("patchwork", {}))
    return poses, edges, cfg


def save_masks(path: str, ground: np.ndarray, valid: np.ndarray,
               frame_ids: Optional[np.ndarray] = None) -> None:
    """Persist per-frame segmentation masks ((F, N) bool, packed)."""
    np.savez_compressed(
        path,
        ground=np.packbits(np.asarray(ground, bool), axis=-1),
        valid=np.packbits(np.asarray(valid, bool), axis=-1),
        n=np.int64(np.asarray(ground).shape[-1]),
        frame_ids=(frame_ids if frame_ids is not None
                   else np.arange(len(ground), dtype=np.int64)),
    )


def load_masks(path: str):
    """(ground (F, N) bool, valid (F, N) bool, frame_ids (F,))."""
    with np.load(path) as f:
        n = int(f["n"])
        ground = np.unpackbits(f["ground"], axis=-1)[..., :n].astype(bool)
        valid = np.unpackbits(f["valid"], axis=-1)[..., :n].astype(bool)
        return ground, valid, f["frame_ids"].copy()
