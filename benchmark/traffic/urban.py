"""Urban sweeps: a spinning LiDAR over flat ground with scattered vertical
obstacles, in the sensor's firing (azimuth) order.

A frozen copy of ``patchwork_tpu_torch/io/synthetic.velodyne_like_cloud``:
the same seed gives the same bits.  Patches converge at level 0, so the
algorithm's recursion is bypassed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["velodyne_like_cloud", "scan"]


def velodyne_like_cloud(
    num_points: int = 131072,
    seed: int = 0,
    num_beams: int = 64,
    max_range: float = 80.0,
    sensor_height: float = 1.73,
    obstacle_fraction: float = 0.15,
) -> np.ndarray:
    """Spinning-LiDAR-like scan: azimuth sweep x elevation beams, range
    density falling off with distance, ground returns at z ~= -h plus
    scattered vertical obstacles, emitted in azimuth order."""
    rng = np.random.default_rng(seed)
    n_obst = int(num_points * obstacle_fraction)
    n_ground = num_points - n_obst

    az = rng.uniform(0.0, 2.0 * np.pi, n_ground)
    beam = rng.integers(0, num_beams, n_ground)
    # downward beams: elevation from -25deg to -1deg like a automotive unit
    elev = np.deg2rad(-25.0 + 24.0 * beam / max(num_beams - 1, 1))
    # range where the beam meets the ground plane (capped)
    r = np.minimum(sensor_height / np.maximum(-np.sin(elev), 1e-3), max_range)
    r = r * rng.normal(1.0, 0.005, n_ground)  # range noise
    ground = np.empty((n_ground, 3), np.float32)
    ground[:, 0] = r * np.cos(elev) * np.cos(az)
    ground[:, 1] = r * np.cos(elev) * np.sin(az)
    ground[:, 2] = -sensor_height + rng.normal(0, 0.02, n_ground)

    centers = rng.uniform(-50, 50, (max(n_obst // 200, 1), 2))
    pick = rng.integers(0, len(centers), n_obst)
    obst = np.empty((n_obst, 3), np.float32)
    obst[:, 0] = centers[pick, 0] + rng.normal(0, 0.3, n_obst)
    obst[:, 1] = centers[pick, 1] + rng.normal(0, 0.3, n_obst)
    obst[:, 2] = rng.uniform(-sensor_height + 0.2, 1.5, n_obst)
    pts = np.concatenate([ground, obst]).astype(np.float32)
    # firing order: one revolution, azimuth-major
    all_az = np.concatenate(
        [az, np.arctan2(obst[:, 1], obst[:, 0])]).astype(np.float32)
    return pts[np.argsort(all_az, kind="stable")]


def scan(n: int, seed: int, sensor: dict,
         obstacle_fraction: float = 0.15) -> np.ndarray:
    """One (n, 3) float32 sweep of ``sensor`` (its beams, mount height and
    range cap)."""
    return velodyne_like_cloud(n, seed, num_beams=sensor["beams"],
                               max_range=sensor["max_range_m"],
                               sensor_height=sensor["mount_height_m"],
                               obstacle_fraction=obstacle_fraction)
