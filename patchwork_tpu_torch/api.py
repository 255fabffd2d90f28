"""High-level NumPy-in / NumPy-out API mirroring the reference class surface.

Counterpart of ``patchwork_tpu/api.py``: ``RecursivePatchwork`` with the
reference class's entry points (include/recursive_patchwork.hpp:47-87) and
the mask form of its enhanced filtering,
:func:`sample_ground_and_obstacles_masks`.  Point clouds are padded to
power-of-two capacities (``api.py:31-35``), so scans of any size reuse a
few shapes.  Under the default ``segment_impl="fused"``, capacities above
the fit gate (``fit_cuda.megakernel_fits``: any cloud of 131,073 points or
more, whose bucket is 262,144) take the generic level engine, as in the
JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core.config import PatchworkConfig
from .core.types import GroundResult
from .ops.pointcloud import ego_mask as _ego_mask
from .ops.pointcloud import height_band_mask, rotate_2d
from .ops.sampling import random_subsample_mask
from .segment.engine import filter_ground

__all__ = ["RecursivePatchwork", "sample_ground_and_obstacles_masks"]


def _bucket_capacity(n: int, min_cap: int = 1024) -> int:
    cap = min_cap
    while cap < n:
        cap *= 2
    return cap


def sample_ground_and_obstacles_masks(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    cfg: PatchworkConfig,
    target_height: float,
    base_tol: float,
    generator: torch.Generator,
    ground_sample_size: int = 2000,
    ego_radius: float = 2.5,
):
    """Mask form of the reference's enhanced filtering
    (RecursivePatchwork::sampleGroundAndObstacles, cpp:428-465): one
    segmentation pass, then the non-ground points outside the ego radius in
    the closed band ``[t - tol, t + tol]`` (the reference's |z - t| <= tol),
    plus a uniform sample of ``ground_sample_size`` ground points drawn with
    ``generator``.

    Returns (selected (N,) bool, result: GroundResult).  The band's bounds
    are computed in float32, as the JAX reference computes them.
    """
    res = filter_ground(xyz, valid, cfg)
    t, tol = np.float32(target_height), np.float32(base_tol)
    obstacles = (res.valid & ~res.ground & _ego_mask(xyz, ego_radius)
                 & height_band_mask(xyz, float(t - tol), float(t + tol)))
    ground_sample = random_subsample_mask(res.ground, ground_sample_size,
                                          generator)
    return obstacles | ground_sample, res


class RecursivePatchwork:
    """Drop-in style replacement for the reference RecursivePatchwork class,
    running on an explicit ``device`` (a CUDA device runs the kernels)."""

    def __init__(self, config: PatchworkConfig | None = None,
                 device: torch.device | str = "cpu"):
        self.config = config or PatchworkConfig()
        self.device = torch.device(device)

    # -- config (hpp:66-67) --
    def set_config(self, config: PatchworkConfig) -> None:
        self.config = config

    def get_config(self) -> PatchworkConfig:
        return self.config

    # -- static utilities (hpp:56-64) --
    @staticmethod
    def clean_points(points: np.ndarray) -> np.ndarray:
        """Drop NaN/inf rows (cpp:19-35)."""
        points = np.asarray(points, np.float32)
        return points[np.isfinite(points).all(axis=1)]

    @staticmethod
    def rotate_points_2d(points: np.ndarray, angle_degrees: float) -> np.ndarray:
        """2D rotation about +Z (cpp:37-54)."""
        return rotate_2d(torch.from_numpy(np.asarray(points, np.float32)),
                         angle_degrees).numpy()

    @staticmethod
    def remove_ego_vehicle(points: np.ndarray, radius: float = 2.5) -> np.ndarray:
        """Drop points with 2D distance <= radius (cpp:64-75)."""
        points = np.asarray(points, np.float32)
        return points[_ego_mask(torch.from_numpy(points), radius).numpy()]

    def _pad(self, points: np.ndarray):
        points = np.asarray(points, np.float32)[:, :3]
        n = len(points)
        cap = _bucket_capacity(n)
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:n] = points
        valid = np.zeros(cap, bool)
        valid[:n] = True
        return (torch.from_numpy(xyz).to(self.device),
                torch.from_numpy(valid).to(self.device), n)

    def segment(self, points: np.ndarray) -> Tuple[GroundResult, int]:
        """Run the engine; returns the mask bundle plus true point count."""
        xyz, valid, n = self._pad(points)
        return filter_ground(xyz, valid, self.config), n

    def filter_ground_points(
        self, points: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ground_points, non_ground_points) — reference cpp:310-426.

        Non-ground includes finite points beyond the filtering radius;
        NaN/inf points are dropped entirely.
        """
        res, n = self.segment(points)
        pts = np.asarray(points, np.float32)[:, :3]
        g = res.ground[:n].cpu().numpy()
        v = res.valid[:n].cpu().numpy()
        return pts[g & v], pts[v & ~g]

    def sample_ground_and_obstacles(
        self,
        points: np.ndarray,
        target_height: float = 1.1,
        base_tol: float = 0.5,
        seed: int = 0,
    ) -> np.ndarray:
        """Enhanced filtering (cpp:428-465): obstacle band + ground sample,
        drawn with a generator on the engine's device seeded from ``seed``."""
        xyz, valid, n = self._pad(points)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sel, _ = sample_ground_and_obstacles_masks(
            xyz, valid, self.config, target_height, base_tol, gen)
        pts = np.asarray(points, np.float32)[:, :3]
        return pts[sel[:n].cpu().numpy()]
