"""KITTI / KITTI-360 velodyne ``.bin`` ingest, NumPy only.

A copy of ``patchwork_tpu/io/kitti.py`` (importing the reference package
imports JAX).  A KITTI velodyne file is a flat float32 ``(N, 4)`` record
stream: x, y, z, reflectance.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["read_bin", "list_sequence", "iter_sequence", "pad_to_capacity"]


def read_bin(path: str, with_intensity: bool = False) -> np.ndarray:
    """Read one velodyne scan; returns (N, 3) or (N, 4) float32."""
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % 4 != 0:
        raise ValueError(f"{path}: size {raw.size} not a multiple of 4 floats")
    pts = raw.reshape(-1, 4)
    return pts if with_intensity else pts[:, :3]


def list_sequence(directory: str, suffix: str = ".bin") -> List[str]:
    """Sorted scan paths of a KITTI-style sequence directory."""
    names = sorted(n for n in os.listdir(directory) if n.endswith(suffix))
    return [os.path.join(directory, n) for n in names]


def iter_sequence(
    directory: str, limit: Optional[int] = None, with_intensity: bool = False
) -> Iterator[np.ndarray]:
    for i, p in enumerate(list_sequence(directory)):
        if limit is not None and i >= limit:
            return
        yield read_bin(p, with_intensity)


def pad_to_capacity(pts: np.ndarray, capacity: int):
    """Pad/truncate to (capacity, 3) + valid mask, SoA from ingest onward."""
    n = min(len(pts), capacity)
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[:n] = pts[:n, :3]
    valid = np.zeros(capacity, bool)
    valid[:n] = True
    return xyz, valid
