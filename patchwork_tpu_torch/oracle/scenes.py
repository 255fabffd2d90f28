"""The parity scenes: point clouds made from seeds on which the engine's
exact masks must equal :func:`.reference.filter_ground_oracle`'s bit for
bit, each with the configuration fields it runs under.

The same scenes as ``tests/test_engine_parity.py`` holds the JAX engine
to: flat demo ground, residual-triggered splits, non-finite points, a
velodyne-like scan, a cloud too small to fit, percentile seeds (with a
split and with deficient seeds) and the reference test suite's settings.
:func:`all_deficient_scene` is the one scene held at IoU > 0.95 instead:
every seed threshold lies below all its points, so its 3-point seed fits
are ill-conditioned (PARITY.md).
"""

from __future__ import annotations

import numpy as np

from ..io.synthetic import demo_point_cloud, velodyne_like_cloud

__all__ = ["PARITY_SCENES", "all_deficient_scene", "DEFICIENT_CONFIG",
           "DEFICIENT_IOU_MIN"]


def _split_scene():
    # sloped terrain + height step -> residual-triggered splits to depth 3
    rng = np.random.default_rng(7)
    n = 20000
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-80, 80, n)
    pts[:, 1] = rng.uniform(-80, 80, n)
    pts[:, 2] = 0.08 * pts[:, 0] + 0.5 * (pts[:, 1] > 20) + rng.normal(0, 0.05, n)
    obst = rng.uniform(-40, 40, (4000, 2))
    oz = rng.uniform(0.5, 3.0, 4000)
    return np.concatenate(
        [pts, np.column_stack([obst, oz]).astype(np.float32)]).astype(np.float32)


def _nan_scene():
    pts = demo_point_cloud(4096, seed=0).copy()
    pts[::37] = np.nan
    pts[5, 2] = np.inf
    return pts


def _bimodal_far_scene(n=24000, seed=5):
    rng = np.random.default_rng(seed)
    r = rng.uniform(90, 149, n)
    a = rng.uniform(0, 2 * np.pi, n)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = r * np.cos(a)
    pts[:, 1] = r * np.sin(a)
    pts[:, 2] = 0.528 * (rng.random(n) > 0.5)
    return pts


# name -> (maker of the (N, 3) float32 points, PatchworkConfig fields)
PARITY_SCENES = {
    "default_demo": (lambda: demo_point_cloud(10000, seed=1), {}),
    "split": (_split_scene, {}),
    "nan": (_nan_scene, {}),
    "velodyne": (lambda: velodyne_like_cloud(16384, seed=0), {}),
    "ten_points": (lambda: demo_point_cloud(10, seed=0), {}),
    "non_adaptive": (lambda: demo_point_cloud(8000, seed=42),
                     dict(adaptive_seed_height=False, filtering_radius=60.0)),
    "percentile_split": (_bimodal_far_scene,
                         dict(adaptive_seed_height=False, th_dist=0.24,
                              th_seeds=0.9, max_iter=1)),
    "percentile_deficient": (lambda: demo_point_cloud(8000, seed=9),
                             dict(adaptive_seed_height=False,
                                  seed_percentile=0.0001, th_seeds=-10.0)),
    "testsuite": (lambda: demo_point_cloud(5000, seed=42),
                  dict(filtering_radius=50.0, num_sectors=8, max_iter=50)),
}

DEFICIENT_CONFIG = dict(filtering_radius=60.0)
DEFICIENT_IOU_MIN = 0.95


def all_deficient_scene():
    """Every adaptive seed threshold lies below all points (run it under
    ``DEFICIENT_CONFIG``; held at IoU > ``DEFICIENT_IOU_MIN``)."""
    pts = demo_point_cloud(3000, seed=5).copy()
    pts[:, 2] += 2.0
    return pts
