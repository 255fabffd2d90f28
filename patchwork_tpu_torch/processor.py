"""PointCloudProcessor — the reference's stateless utility kit
(include/point_cloud_processor.hpp:16-48), NumPy in / NumPy out.

Counterpart of ``patchwork_tpu/processor.py``, on the torch ops of
``ops/``; each method runs on a CPU tensor.  Device-resident pipelines
call ``ops/`` directly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ops.geometry import masked_centroid, masked_covariance
from .ops.pointcloud import (
    distance_band_mask,
    finite_mask,
    height_band_mask,
    plane_distances,
)
from .ops.sampling import random_subsample_mask, voxel_grid_filter

__all__ = ["PointCloudProcessor"]


def _t(points) -> torch.Tensor:
    return torch.from_numpy(np.asarray(points, np.float32).reshape(-1, 3))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).reshape(3))


class PointCloudProcessor:
    """All-static utility kit (reference: point_cloud_processor.cpp)."""

    # -- filtering (cpp:16-56) --
    @staticmethod
    def remove_nan_points(points) -> np.ndarray:
        pts = _t(points)
        return pts[finite_mask(pts)].numpy()

    @staticmethod
    def filter_by_distance(points, min_dist: float, max_dist: float) -> np.ndarray:
        pts = _t(points)
        return pts[distance_band_mask(pts, min_dist, max_dist)].numpy()

    @staticmethod
    def filter_by_height(points, min_height: float, max_height: float) -> np.ndarray:
        pts = _t(points)
        return pts[height_band_mask(pts, min_height, max_height)].numpy()

    # -- statistics (cpp:58-100) --
    @staticmethod
    def compute_centroid(points) -> np.ndarray:
        pts = _t(points)
        if len(pts) == 0:
            return np.zeros(3, np.float32)
        c, _ = masked_centroid(pts, torch.ones(len(pts), dtype=torch.bool))
        return c.numpy()

    @staticmethod
    def compute_covariance(points, centroid=None) -> np.ndarray:
        pts = _t(points)
        if len(pts) < 2:
            return np.zeros((3, 3), np.float32)
        ones = torch.ones(len(pts), dtype=torch.bool)
        c = (_vec(centroid) if centroid is not None
             else masked_centroid(pts, ones)[0])
        return masked_covariance(pts, ones, c).numpy()

    @staticmethod
    def compute_pca(points) -> Tuple[np.ndarray, np.ndarray]:
        """(centroid, eigenvector matrix, ascending-eigenvalue columns).

        Reference computePCA (cpp:88-100) returns Eigen's full eigenvector
        matrix; identity + zero centroid for n < 3.
        """
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if len(pts) < 3:
            return np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
        c = PointCloudProcessor.compute_centroid(pts)
        cov = PointCloudProcessor.compute_covariance(pts, c)
        _, vecs = np.linalg.eigh(cov.astype(np.float64))
        return c, vecs.astype(np.float32)

    # -- plane distances (cpp:102-120) --
    @staticmethod
    def compute_point_to_plane_distance(point, plane_point, plane_normal) -> float:
        return float(plane_distances(_t(point), _vec(plane_point),
                                     _vec(plane_normal))[0])

    @staticmethod
    def compute_distances_to_plane(points, plane_point, plane_normal) -> np.ndarray:
        return plane_distances(_t(points), _vec(plane_point),
                               _vec(plane_normal)).numpy()

    # -- sampling (cpp:122-196) --
    @staticmethod
    def random_subsample(points, target_size: int, seed: int = 0) -> np.ndarray:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if len(pts) <= target_size:
            return pts
        gen = torch.Generator().manual_seed(seed)
        sel = random_subsample_mask(torch.ones(len(pts), dtype=torch.bool),
                                    target_size, gen)
        return pts[sel.numpy()]

    @staticmethod
    def voxel_grid_filter(points, voxel_size: float) -> np.ndarray:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if len(pts) == 0 or voxel_size <= 0:
            return pts
        c, v = voxel_grid_filter(torch.from_numpy(pts),
                                 torch.ones(len(pts), dtype=torch.bool),
                                 voxel_size)
        return c[v].numpy()

    # -- validity (cpp:228-239) --
    @staticmethod
    def is_valid_point(point) -> bool:
        return bool(np.isfinite(np.asarray(point, np.float32)).all())

    @staticmethod
    def has_valid_points(points) -> bool:
        return bool(np.isfinite(np.asarray(points, np.float32)).all())
