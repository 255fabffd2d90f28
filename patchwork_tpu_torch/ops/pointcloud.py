"""Point-cloud masks and per-point geometry in plain PyTorch.

Counterpart of ``patchwork_tpu/ops/pointcloud.py``: masks instead of
compaction, SoA ``(..., N, 3)`` float32 tensors, everything batched over
leading dimensions.
"""

from __future__ import annotations

import math

import torch

from ..core import timing

__all__ = [
    "finite_mask",
    "rotate_2d",
    "transform_4x4",
    "distance_2d",
    "polar_angle",
    "radius_mask",
    "ego_mask",
    "height_band_mask",
    "distance_band_mask",
    "plane_distances",
]


def finite_mask(xyz: torch.Tensor) -> torch.Tensor:
    """True where all three coordinates are finite (cpp:19-35)."""
    return torch.isfinite(xyz).all(dim=-1)


def rotate_2d(xyz: torch.Tensor, angle_degrees: float) -> torch.Tensor:
    """Rotate points about +Z by ``angle_degrees``; Z unchanged.

    The angle is converted in float32, as the JAX reference does.
    """
    angle = torch.tensor(angle_degrees, dtype=torch.float32) * (math.pi / 180.0)
    c, s = torch.cos(angle).to(xyz.device), torch.sin(angle).to(xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)


def transform_4x4(xyz: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Apply homogeneous 4x4 transforms with a perspective divide.

    ``xyz`` is (..., N, 3); ``matrix`` (..., 4, 4) broadcasts against its
    leading dims (e.g. (S, 4, 4) stacked extrinsics for fusion).  Each row
    is summed pairwise, ``(x*m0 + y*m1) + (z*m2 + 1*m3)``, the order of the
    JAX reference's einsum (ops/pointcloud.py:59-70) on the CPU: a batched
    matmul or a left-to-right sum adds in another order and moves fused
    points by an ulp, which can flip a mask bit downstream.  Separate
    multiplies and adds give the same bits on the CPU and on a CUDA tensor.
    """
    m = matrix.to(device=xyz.device, dtype=torch.float32)[..., None, :, :]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = [(x * m[..., i, 0] + y * m[..., i, 1])
            + (z * m[..., i, 2] + m[..., i, 3]) for i in range(4)]
    return torch.stack(rows[:3], dim=-1) / rows[3][..., None]


def distance_2d(xyz: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) (cuda_wrapper.cu:48-55)."""
    x, y = xyz[..., 0], xyz[..., 1]
    return torch.sqrt(x * x + y * y)


def polar_angle(xyz: torch.Tensor) -> torch.Tensor:
    """atan2(y, x) wrapped to [0, 2*pi) with the reference's strictly
    negative test (cuda_wrapper.cu:67-74)."""
    a = torch.atan2(xyz[..., 1], xyz[..., 0])
    with timing.span(timing.READ):     # a copy in: waits for the card
        two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32,
                              device=a.device)
    return torch.where(a < 0, a + two_pi, a)


def radius_mask(distances: torch.Tensor, radius: float) -> torch.Tensor:
    """d <= radius (cuda_wrapper.cu:58-64)."""
    return distances <= radius


def ego_mask(xyz: torch.Tensor, radius) -> torch.Tensor:
    """True for points to KEEP (outside the ego radius): d > radius.

    ``radius`` is a number or a float32 tensor that broadcasts against the
    leading dims (e.g. ``ego_radius[:, None]`` for stacked sensors).
    """
    return distance_2d(xyz) > torch.as_tensor(radius, dtype=torch.float32,
                                              device=xyz.device)


def height_band_mask(xyz: torch.Tensor, min_height: float,
                     max_height: float) -> torch.Tensor:
    """min <= z <= max (point_cloud_processor.cpp:44-56)."""
    z = xyz[..., 2]
    return (z >= min_height) & (z <= max_height)


def distance_band_mask(xyz: torch.Tensor, min_dist: float,
                       max_dist: float) -> torch.Tensor:
    """min <= d2 <= max (point_cloud_processor.cpp:29-42)."""
    d = distance_2d(xyz)
    return (d >= min_dist) & (d <= max_dist)


def plane_distances(xyz: torch.Tensor, centroid: torch.Tensor,
                    normal: torch.Tensor) -> torch.Tensor:
    """|(p - c) . n| per point; ``centroid``/``normal`` (..., 3)."""
    d = xyz - centroid[..., None, :]
    n = normal[..., None, :]
    return torch.abs(d[..., 0] * n[..., 0] + d[..., 1] * n[..., 1]
                     + d[..., 2] * n[..., 2])
