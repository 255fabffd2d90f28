"""Recursive Patchwork in NumPy: the semantics of the reference algorithm
(src/recursive_patchwork.cpp), recursive and in float32.

A frozen copy of ``patchwork_tpu_torch/oracle/reference.py`` as it stood
when the benchmark was written, line for line, with the three helpers it
imported from the program copied in: the ring and sector edges (the same
float32 expressions, cpp:344-352) and the polar angle (``torch.atan2`` on
the CPU, wrapped to [0, 2*pi)).  The parameters are an :class:`Algorithm`,
built from the configuration file's values, not the program's config.

Like the oracle it copies, it combines a split's children in the original
patch order (the reference writes them left then right, cpp:290-302); on
scans where nothing splits the two agree.

:class:`FitWork`, when passed, counts the work of the plane fits as the
algorithm does it on these points, whatever implements it: the
benchmark's yardstick for the fit's share of its roofline.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Algorithm", "FitWork", "ring_edges", "sector_edges",
           "polar_angle", "fit_plane_pca", "fit_plane_and_split",
           "filter_ground", "patch_ids"]


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """The parameters the algorithm reads (hpp:25-36 and the constants
    cpp hard-codes)."""

    sensor_height: float
    num_sectors: int
    max_iter: int
    adaptive_seed_height: bool
    th_seeds: float
    th_dist: float
    filtering_radius: float
    max_split_depth: int
    num_rings: int
    r_min: float
    seed_slope: float
    tau_slope: float
    split_residual_slope: float
    split_min_points_base: int
    split_min_points_slope: int
    flat_area_m2: float
    flat_dz: float
    flat_min_points: int
    seed_percentile: float
    min_seed_points: int

    @classmethod
    def from_dict(cls, values: dict) -> "Algorithm":
        """The fields of ``values`` that the algorithm reads; the others
        (the engine's knobs) are ignored."""
        return cls(**{f.name: values[f.name]
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class FitWork:
    """Points the algorithm's plane fits touch, summed over scans.

    ``dist_points``: over every fit iteration, the node's points (distance
    to the plane, the threshold, the convergence compare); ``fit_points``:
    over every plane fit (each iteration's and the final one), the points
    fitted (mean, centred rows, covariance); ``resid_points``: the final
    fit's residual pass; ``level_points``: over every scan, its points
    times the levels its recursion reached; ``scans``: scans counted."""

    dist_points: int = 0
    fit_points: int = 0
    resid_points: int = 0
    level_points: int = 0
    scans: int = 0


def ring_edges(alg: Algorithm) -> np.ndarray:
    """Log-spaced ring edges r_min * (R/r_min)^(i/num_rings), float32
    (the reference's powf expression, cpp:344-350)."""
    i = np.arange(alg.num_rings + 1, dtype=np.float32)
    ratio = np.float32(alg.filtering_radius) / np.float32(alg.r_min)
    return np.float32(alg.r_min) * np.power(
        ratio, i / np.float32(alg.num_rings), dtype=np.float32
    )


def sector_edges(alg: Algorithm) -> np.ndarray:
    """Sector edges float32(s) * float32(2*pi/num_sectors) (cpp:352,364)."""
    s = np.arange(alg.num_sectors + 1, dtype=np.float32)
    return s * np.float32(2.0 * math.pi / alg.num_sectors)


def polar_angle(xyz: torch.Tensor) -> torch.Tensor:
    """atan2(y, x) wrapped to [0, 2*pi) with the reference's strictly
    negative test (cuda_wrapper.cu:67-74)."""
    a = torch.atan2(xyz[..., 1], xyz[..., 0])
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=a.device)
    return torch.where(a < 0, a + two_pi, a)


def clean_mask(points: np.ndarray) -> np.ndarray:
    """Finite-coordinate mask (cpp:19-35)."""
    return np.isfinite(points).all(axis=1)


def fit_plane_pca(points: np.ndarray):
    """PCA plane fit (cpp:77-107): returns (centroid, normal, residual)."""
    if len(points) < 3:
        return (
            np.zeros(3, np.float32),
            np.array([0, 0, 1], np.float32),
            np.float32(np.inf),
        )
    centroid = points.mean(axis=0, dtype=np.float64).astype(np.float32)
    d = points - centroid
    cov = (d.astype(np.float64).T @ d.astype(np.float64)) / (len(points) - 1)
    _, vecs = np.linalg.eigh(cov)
    normal = vecs[:, 0].astype(np.float32)  # smallest eigenvalue
    if normal[2] < 0:
        normal = -normal
    resid = np.float32(np.abs(d @ normal).mean(dtype=np.float64))
    return centroid, normal, resid


def fit_plane_and_split(patch_points: np.ndarray, mean_dist: float,
                        depth: int, alg: Algorithm,
                        work: FitWork | None = None,
                        reached: list | None = None) -> np.ndarray:
    """Recursive seeded iterative plane fit + variance-axis median split
    (cpp:109-308).  Returns a bool ground mask in ORIGINAL patch order.
    ``reached`` (a one-item list) keeps the deepest depth entered."""
    n = len(patch_points)
    if n < 3 or depth > alg.max_split_depth:
        return np.zeros(n, bool)
    if reached is not None:
        reached[0] = max(reached[0], depth)

    x, y, z = patch_points[:, 0], patch_points[:, 1], patch_points[:, 2]

    # Minimum-area early-out (cpp:116-129).
    area = (x.max() - x.min()) * (y.max() - y.min())
    if area < alg.flat_area_m2 and depth > 0:
        return np.ones(n, bool)

    # Flatness early-out (cpp:132-140).
    if (z.max() - z.min()) < alg.flat_dz and n > alg.flat_min_points:
        return np.ones(n, bool)

    # Seed selection (cpp:143-182).
    rel_dist = np.float32(mean_dist) / np.float32(alg.filtering_radius)
    if alg.adaptive_seed_height:
        z_th = np.float32(alg.sensor_height) + np.float32(alg.seed_slope) * rel_dist
    else:
        sorted_z = np.sort(z)
        idx = int(alg.seed_percentile * len(sorted_z))
        z_th = sorted_z[idx] + np.float32(alg.th_seeds)

    seed_mask = z < z_th
    if seed_mask.sum() < alg.min_seed_points:
        lowest = np.argsort(z, kind="stable")[: alg.min_seed_points]
        seed_mask = np.zeros(n, bool)
        seed_mask[lowest] = True

    # Iterative plane fitting (cpp:186-217).
    ground_mask = seed_mask.copy()
    threshold = np.float32(alg.th_dist) * (
        np.float32(1.0) + np.float32(alg.tau_slope) * rel_dist
    )
    for _ in range(alg.max_iter):
        ground_points = patch_points[ground_mask]
        if len(ground_points) < 3:
            break
        centroid, normal, _ = fit_plane_pca(ground_points)
        dists = np.abs((patch_points - centroid) @ normal)
        new_mask = dists < threshold
        if work is not None:
            work.fit_points += len(ground_points)
            work.dist_points += n
        if np.array_equal(new_mask, ground_mask):
            break
        ground_mask = new_mask

    # Final fit + split decision (cpp:219-235).
    final_points = patch_points[ground_mask]
    _, _, residual = fit_plane_pca(final_points)
    if work is not None and len(final_points) >= 3:
        work.fit_points += len(final_points)
        work.resid_points += len(final_points)
    split_threshold = np.float32(alg.th_dist) * (
        np.float32(1.0) + np.float32(alg.split_residual_slope) * depth
    )
    min_patch_size = alg.split_min_points_base + alg.split_min_points_slope * depth

    if (
        residual > split_threshold
        and depth < alg.max_split_depth
        and n >= min_patch_size
    ):
        # Variance-axis median split (cpp:237-283): population variance
        # about the full-patch centroid, median = sorted[n // 2].
        centroid = patch_points.mean(axis=0, dtype=np.float64).astype(np.float32)
        var_x = np.mean((x - centroid[0]) ** 2, dtype=np.float64)
        var_y = np.mean((y - centroid[1]) ** 2, dtype=np.float64)
        vals = x if var_x > var_y else y
        median_val = np.sort(vals)[len(vals) // 2]

        left_sel = vals <= median_val
        left_res = fit_plane_and_split(patch_points[left_sel], mean_dist,
                                       depth + 1, alg, work, reached)
        right_res = fit_plane_and_split(patch_points[~left_sel], mean_dist,
                                        depth + 1, alg, work, reached)
        # Order-preserving combine (deviation from cpp:290-302 — see module doc).
        result = np.zeros(n, bool)
        result[left_sel] = left_res
        result[~left_sel] = right_res
        return result

    return ground_mask


def filter_ground(points: np.ndarray, alg: Algorithm,
                  work: FitWork | None = None):
    """End-to-end polar-grid segmentation (cpp:310-426).

    ``points``: (N, 3) float32.  Returns (ground, valid, in_zone, in_patch)
    boolean masks over the input rows: ground points are ``ground``,
    obstacle points ``valid & ~ground``.
    """
    points = np.asarray(points, np.float32)
    n = len(points)
    valid = clean_mask(points)
    ground = np.zeros(n, bool)
    in_zone = np.zeros(n, bool)
    in_patch = np.zeros(n, bool)
    if valid.sum() == 0:
        return ground, valid, in_zone, in_patch

    d = np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2).astype(np.float32)
    in_zone = valid & (d <= np.float32(alg.filtering_radius))
    if in_zone.sum() < 3:
        return ground, valid, in_zone, in_patch

    edges = ring_edges(alg)
    s_edges = sector_edges(alg)
    # the angle by CPU torch.atan2: the algorithm's semantics, not one math
    # library's rounding at a sector edge
    ang = polar_angle(torch.from_numpy(points[:, :2].copy())).numpy()

    reached = [-1]
    for ring in range(alg.num_rings):
        r0, r1 = edges[ring], edges[ring + 1]
        for sector in range(alg.num_sectors):
            a0 = s_edges[sector]
            a1 = s_edges[sector + 1]
            sel = in_zone & (d >= r0) & (d < r1) & (ang >= a0) & (ang < a1)
            idxs = np.nonzero(sel)[0]
            if len(idxs) == 0:
                continue
            in_patch[idxs] = True
            mean_dist = np.float32(d[idxs].mean(dtype=np.float64))
            mask = fit_plane_and_split(points[idxs], mean_dist, 0, alg,
                                       work, reached)
            ground[idxs[mask]] = True

    if work is not None:
        work.level_points += n * (reached[0] + 1)
        work.scans += 1
    return ground, valid, in_zone, in_patch


def patch_ids(points: np.ndarray, alg: Algorithm) -> np.ndarray:
    """Each row's patch, ``ring * num_sectors + sector``, as
    :func:`filter_ground` bins it (the same edges, angle and ``[r0, r1)``,
    ``[a0, a1)`` membership); -1 for a row in no patch."""
    points = np.asarray(points, np.float32)
    d = np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2).astype(np.float32)
    in_zone = clean_mask(points) & (d <= np.float32(alg.filtering_radius))
    if in_zone.sum() < 3:
        return np.full(len(points), -1, np.int64)
    ang = polar_angle(torch.from_numpy(points[:, :2].copy())).numpy()
    ring = np.searchsorted(ring_edges(alg), d, side="right") - 1
    sector = np.searchsorted(sector_edges(alg), ang, side="right") - 1
    ok = (in_zone & (ring >= 0) & (ring < alg.num_rings) & (sector >= 0)
          & (sector < alg.num_sectors))
    return np.where(ok, ring * alg.num_sectors + sector, -1).astype(np.int64)
