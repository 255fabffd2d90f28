"""PointCloudProcessor — the reference's stateless utility kit
(include/point_cloud_processor.hpp:16-48), NumPy in / NumPy out.

Counterpart of ``patchwork_tpu/processor.py``, on the torch ops of
``ops/``.  Every method that computes on tensors takes ``device``: the
card when it is None (``core.device.resolve_device``, which raises without
a card), the CPU only for ``device="cpu"``; points go to that device and
the result comes back as NumPy.  Device-resident pipelines call ``ops/``
directly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core.device import resolve_device
from .ops.geometry import masked_centroid, masked_covariance
from .ops.pointcloud import (
    distance_band_mask,
    finite_mask,
    height_band_mask,
    plane_distances,
)
from .ops.sampling import random_subsample_mask, voxel_grid_filter

__all__ = ["PointCloudProcessor"]


def _t(points, device) -> torch.Tensor:
    """(N, 3) float32 points on the device ``device`` resolves to."""
    return torch.from_numpy(
        np.ascontiguousarray(points, np.float32).reshape(-1, 3)).to(
            resolve_device(device))


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(v, np.float32).reshape(3)).to(like.device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _all(pts: torch.Tensor) -> torch.Tensor:
    return torch.ones(len(pts), dtype=torch.bool, device=pts.device)


class PointCloudProcessor:
    """All-static utility kit (reference: point_cloud_processor.cpp), on
    the card unless ``device="cpu"``; the validity tests are NumPy only."""

    # -- filtering (cpp:16-56) --
    @staticmethod
    def remove_nan_points(points, device=None) -> np.ndarray:
        pts = _t(points, device)
        return _np(pts[finite_mask(pts)])

    @staticmethod
    def filter_by_distance(points, min_dist: float, max_dist: float,
                           device=None) -> np.ndarray:
        pts = _t(points, device)
        return _np(pts[distance_band_mask(pts, min_dist, max_dist)])

    @staticmethod
    def filter_by_height(points, min_height: float, max_height: float,
                         device=None) -> np.ndarray:
        pts = _t(points, device)
        return _np(pts[height_band_mask(pts, min_height, max_height)])

    # -- statistics (cpp:58-100) --
    @staticmethod
    def compute_centroid(points, device=None) -> np.ndarray:
        pts = _t(points, device)
        if len(pts) == 0:
            return np.zeros(3, np.float32)
        c, _ = masked_centroid(pts, _all(pts))
        return _np(c)

    @staticmethod
    def compute_covariance(points, centroid=None, device=None) -> np.ndarray:
        pts = _t(points, device)
        if len(pts) < 2:
            return np.zeros((3, 3), np.float32)
        ones = _all(pts)
        c = (_vec(centroid, pts) if centroid is not None
             else masked_centroid(pts, ones)[0])
        return _np(masked_covariance(pts, ones, c))

    @staticmethod
    def compute_pca(points, device=None) -> Tuple[np.ndarray, np.ndarray]:
        """(centroid, eigenvector matrix, ascending-eigenvalue columns).

        Reference computePCA (cpp:88-100) returns Eigen's full eigenvector
        matrix; identity + zero centroid for n < 3.  Centroid and
        covariance are computed on ``device``, the 3x3 eigensolve in float64
        on the host.
        """
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if len(pts) < 3:
            return np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
        c = PointCloudProcessor.compute_centroid(pts, device)
        cov = PointCloudProcessor.compute_covariance(pts, c, device)
        _, vecs = np.linalg.eigh(cov.astype(np.float64))
        return c, vecs.astype(np.float32)

    # -- plane distances (cpp:102-120) --
    @staticmethod
    def compute_point_to_plane_distance(point, plane_point, plane_normal,
                                        device=None) -> float:
        return float(PointCloudProcessor.compute_distances_to_plane(
            point, plane_point, plane_normal, device)[0])

    @staticmethod
    def compute_distances_to_plane(points, plane_point, plane_normal,
                                   device=None) -> np.ndarray:
        pts = _t(points, device)
        return _np(plane_distances(pts, _vec(plane_point, pts),
                                   _vec(plane_normal, pts)))

    # -- sampling (cpp:122-196) --
    @staticmethod
    def random_subsample(points, target_size: int, seed: int = 0,
                         device=None) -> np.ndarray:
        """Drawn with a generator on ``device`` seeded from ``seed``: the
        card's sample and the CPU's differ for one seed."""
        device = resolve_device(device)
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if len(pts) <= target_size:
            return pts
        gen = torch.Generator(device=device).manual_seed(seed)
        sel = random_subsample_mask(
            torch.ones(len(pts), dtype=torch.bool, device=device),
            target_size, gen)
        return pts[_np(sel)]

    @staticmethod
    def voxel_grid_filter(points, voxel_size: float, device=None) -> np.ndarray:
        """On the card a voxel's points are added with atomics
        (``index_add_``), so a centroid's last bit can change from run to
        run; on the CPU the sum is in sorted order."""
        device = resolve_device(device)
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if len(pts) == 0 or voxel_size <= 0:
            return pts
        xyz = _t(pts, device)
        c, v = voxel_grid_filter(xyz, _all(xyz), voxel_size)
        return _np(c[v])

    # -- validity (cpp:228-239) --
    @staticmethod
    def is_valid_point(point) -> bool:
        return bool(np.isfinite(np.asarray(point, np.float32)).all())

    @staticmethod
    def has_valid_points(points) -> bool:
        return bool(np.isfinite(np.asarray(points, np.float32)).all())
