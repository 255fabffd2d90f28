"""Polar-grid (ring x sector) patch assignment, batched, in plain PyTorch.

Counterpart of ``patchwork_tpu/segment/binning.py``: the same float32 edge
values and the same comparison directions as the reference
(d >= r0 && d < r1, a >= a0 && a < a1; src/recursive_patchwork.cpp:344-378).
The angle comes from ``torch.atan2`` on either device; a sector id flips
only where atan2 rounds across an edge (chip_smoke.py counts such flips
between the CPU and the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import PatchworkConfig
from ..core.device import true_div
from ..kernels import fit_cuda
from ..ops.pointcloud import distance_2d, finite_mask, polar_angle

__all__ = ["ring_edges", "sector_edges", "patch_centers", "PatchAssignment",
           "assign_patches"]


def ring_edges(cfg: PatchworkConfig) -> np.ndarray:
    """Log-spaced ring edges r_min * (R/r_min)^(i/num_rings), float32
    (the reference's powf expression, cpp:344-350)."""
    i = np.arange(cfg.num_rings + 1, dtype=np.float32)
    ratio = np.float32(cfg.filtering_radius) / np.float32(cfg.r_min)
    return np.float32(cfg.r_min) * np.power(
        ratio, i / np.float32(cfg.num_rings), dtype=np.float32
    )


def sector_edges(cfg: PatchworkConfig) -> np.ndarray:
    """Sector edges float32(s) * float32(2*pi/num_sectors) (cpp:352,364)."""
    s = np.arange(cfg.num_sectors + 1, dtype=np.float32)
    return s * np.float32(2.0 * math.pi / cfg.num_sectors)


def patch_centers(cfg: PatchworkConfig) -> np.ndarray:
    """(P+1, 3) per-patch polar-cell centers (radial midpoint of the ring
    on the sector bisector, z = 0); the trash row P is zero."""
    r_e = ring_edges(cfg)
    s_e = sector_edges(cfg)
    r_c = 0.5 * (r_e[:-1] + r_e[1:])
    a_c = 0.5 * (s_e[:-1] + s_e[1:])
    out = np.zeros((cfg.num_patches + 1, 3), np.float32)
    out[: cfg.num_patches, 0] = (r_c[:, None] * np.cos(a_c)[None, :]).reshape(-1)
    out[: cfg.num_patches, 1] = (r_c[:, None] * np.sin(a_c)[None, :]).reshape(-1)
    return out


class PatchAssignment(NamedTuple):
    patch: torch.Tensor     # (B, N) int32 patch id in [0, P); P if in no patch
    in_patch: torch.Tensor  # (B, N) bool
    in_zone: torch.Tensor   # (B, N) bool: finite & d <= filtering_radius
    finite: torch.Tensor    # (B, N) bool
    dist: torch.Tensor      # (B, N) float32 2D range
    rel_dist: torch.Tensor  # (B, P+1) float32 per-patch mean dist / radius


def assign_patches(xyz: torch.Tensor, valid: torch.Tensor,
                   cfg: PatchworkConfig, plain: bool = False) -> PatchAssignment:
    """Patch id ring*num_sectors+sector of every point of (B, N, 3) scans.

    ``plain=True`` takes the segment sum's plain version on any device."""
    num_p = cfg.num_patches
    fin = valid & finite_mask(xyz)
    xyz = torch.where(fin[..., None], xyz, torch.zeros_like(xyz))
    d = distance_2d(xyz)
    ang = polar_angle(xyz)
    in_zone = fin & (d <= cfg.filtering_radius)

    r_edges = torch.from_numpy(ring_edges(cfg)).to(xyz.device)
    s_edges = torch.from_numpy(sector_edges(cfg)).to(xyz.device)
    ring = (d[..., None] >= r_edges[1:-1]).sum(-1, dtype=torch.int32)
    in_ring = (d >= r_edges[0]) & (d < r_edges[-1])
    sector = (ang[..., None] >= s_edges[1:-1]).sum(-1, dtype=torch.int32)
    in_sector = ang < s_edges[-1]

    in_patch = in_zone & in_ring & in_sector
    patch = torch.where(in_patch, ring * cfg.num_sectors + sector,
                        torch.full_like(ring, num_p))

    # Per-patch mean 2D distance, threaded unchanged through the recursion
    # (cpp:383-390): a fixed-order segment sum, bitwise the same on the
    # CPU and the card.
    w = in_patch.to(torch.float32)
    k = fit_cuda.plain if plain else fit_cuda
    sums = k.seg_sum(torch.stack([d * w, w], 1), patch, num_p + 1)
    mean_dist = sums[:, 0] / torch.clamp(sums[:, 1], min=1.0)
    rel_dist = true_div(mean_dist, cfg.filtering_radius)
    return PatchAssignment(patch, in_patch, in_zone, fin, d, rel_dist)
