"""Urban street seen by an organized spinning sensor (an Ouster OS1): every
pixel of its beams x columns image is one ray, and one row of the scan.

The beams are spaced evenly over the sensor's vertical field of view
(``vertical_fov_deg``), the columns evenly over one turn.  A ray returns
the first surface it meets: one of the scene's vertical cylinders (poles,
trunks, cars and walls stand in as cylinders; every seed has the same
set of distances, radii and heights, placed and paired in its own order)
or the flat ground at the mount height.  A ray that meets nothing (the
sky, above the horizon) or meets it beyond ``max_range_m`` is a
non-return, the row (0, 0, 0), as the driver's organized cloud carries
it.  Rows are beam-major: the organized cloud's rows are the beams, top
first, each one sweep in azimuth.
"""

from __future__ import annotations

import numpy as np

__all__ = ["scan"]


def scan(n: int, seed: int, sensor: dict, obstacles: int = 48,
         radius_m=(0.3, 2.5), height_m=(0.5, 4.0),
         distance_m=(6.0, 60.0)) -> np.ndarray:
    """One (n, 3) float32 sweep of ``sensor`` (its beams, columns, vertical
    field of view, mount height and range), ``n`` = beams x columns."""
    beams, cols = int(sensor["beams"]), int(sensor["columns"])
    if n != beams * cols:
        raise ValueError(f"an organized sweep of {beams} x {cols} holds "
                         f"{beams * cols} rows, not {n}")
    h = float(sensor["mount_height_m"])
    lo, hi = sensor["vertical_fov_deg"]
    rng = np.random.default_rng(seed)

    tan_e = np.tan(np.deg2rad(np.linspace(hi, lo, beams)))[:, None]
    az = 2.0 * np.pi * np.arange(cols) / cols
    # horizontal distance to the first surface a ray meets
    with np.errstate(divide="ignore"):
        t = np.where(tan_e < 0, h / -tan_e, np.inf) * np.ones((1, cols))
    ground = np.isfinite(t)

    dist = rng.permutation(np.linspace(*distance_m, obstacles))
    radius = rng.permutation(np.linspace(*radius_m, obstacles))
    top = rng.permutation(np.linspace(*height_m, obstacles)) - h
    bearing = rng.uniform(0.0, 2.0 * np.pi, obstacles)
    for d, b, r, z_top in zip(dist, bearing, radius, top):
        delta = np.angle(np.exp(1j * (az - b)))
        near = np.nonzero(np.abs(delta) < np.arcsin(r / d))[0]
        along = d * np.cos(delta[near])
        across = d * np.sin(delta[near])
        hit_t = along - np.sqrt(r * r - across * across)   # (columns,)
        z = hit_t[None, :] * tan_e                          # (beams, columns)
        hit = (z >= -h) & (z <= z_top) & (hit_t[None, :] < t[:, near])
        rows, k = np.nonzero(hit)
        t[rows, near[k]] = hit_t[k]
        ground[rows, near[k]] = False

    slant = t * np.sqrt(1.0 + tan_e * tan_e)
    ret = slant <= float(sensor["max_range_m"])
    t = np.where(ret, t * rng.normal(1.0, 0.005, t.shape), 0.0)
    pts = np.zeros((beams, cols, 3), np.float32)
    pts[..., 0] = t * np.cos(az)
    pts[..., 1] = t * np.sin(az)
    pts[..., 2] = np.where(ground, -h + rng.normal(0.0, 0.02, t.shape),
                           t * tan_e) * ret
    return pts.reshape(n, 3)
