"""Split terrain: sloped ground (8 % grade) with a 0.5 m step and box
obstacles, whose plane-fit residuals split patches down to the deepest
levels, so the algorithm's recursion does most of the work.

A frozen copy of ``patchwork_tpu_torch/io/synthetic.split_terrain_cloud``:
the same seed gives the same bits.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_terrain_cloud", "scan"]


def split_terrain_cloud(n: int, seed: int) -> np.ndarray:
    """(n, 3) float32: ground over 160 x 160 m, a sixth of the points on
    boxes 0.5-3 m high."""
    rng = np.random.default_rng(seed)
    n_obst = n // 6
    n_g = n - n_obst
    g = np.empty((n_g, 3), np.float32)
    g[:, 0] = rng.uniform(-80, 80, n_g)
    g[:, 1] = rng.uniform(-80, 80, n_g)
    g[:, 2] = 0.08 * g[:, 0] + 0.5 * (g[:, 1] > 20) + rng.normal(0, 0.05, n_g)
    obst = rng.uniform(-40, 40, (n_obst, 2))
    oz = rng.uniform(0.5, 3.0, n_obst)
    return np.concatenate([g, np.column_stack([obst, oz])]).astype(np.float32)


def scan(n: int, seed: int, sensor: dict) -> np.ndarray:
    """One (n, 3) float32 scene; the sensor model does not shape it."""
    return split_terrain_cloud(n, seed)
