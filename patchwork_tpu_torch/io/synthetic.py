"""Seeded synthetic point-cloud generators in NumPy.

A copy of the generators in ``patchwork_tpu/io/synthetic.py`` that the
port's main path and ``chip_smoke.py`` use: the machine with the card has
no JAX, and importing the reference package imports it.  The same seed
gives bit-identical arrays (tests/test_torch_synthetic.py checks this);
:func:`fused_iac_cloud` fuses through the port's own
:class:`~patchwork_tpu_torch.fusion.fusion.LidarFusion`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["demo_point_cloud", "demo_labels", "uniform_cube_cloud",
           "velodyne_like_cloud", "iac_three_lidar_scene", "fused_iac_cloud",
           "hard_labeled_scene", "HARD_SCENES"]


def demo_point_cloud(
    num_points: int = 10000,
    seed: int = 0,
    ground_fraction: float = 0.7,
    ground_extent: float = 50.0,
    obstacle_extent: float = 30.0,
    ground_sigma_z: float = 0.05,
    obstacle_z: tuple = (0.5, 3.0),
) -> np.ndarray:
    """70/30 ground/obstacle synthetic scan (reference: src/main.cpp:48-86)."""
    rng = np.random.default_rng(seed)
    n_ground = int(num_points * ground_fraction)
    n_obst = num_points - n_ground

    ground = np.empty((n_ground, 3), np.float32)
    ground[:, 0] = rng.uniform(-ground_extent, ground_extent, n_ground)
    ground[:, 1] = rng.uniform(-ground_extent, ground_extent, n_ground)
    ground[:, 2] = rng.normal(0.0, ground_sigma_z, n_ground)

    obst = np.empty((n_obst, 3), np.float32)
    obst[:, 0] = rng.uniform(-obstacle_extent, obstacle_extent, n_obst)
    obst[:, 1] = rng.uniform(-obstacle_extent, obstacle_extent, n_obst)
    obst[:, 2] = rng.uniform(obstacle_z[0], obstacle_z[1], n_obst)

    return np.concatenate([ground, obst]).astype(np.float32)


def demo_labels(num_points: int = 10000, ground_fraction: float = 0.7) -> np.ndarray:
    """True labels for demo_point_cloud rows (ground=True), by construction."""
    n_ground = int(num_points * ground_fraction)
    labels = np.zeros(num_points, bool)
    labels[:n_ground] = True
    return labels


def uniform_cube_cloud(num_points: int = 100000, seed: int = 0, extent: float = 10.0):
    """U(-extent, extent)^3 cloud (reference: src/test_cuda.cpp:10-23)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-extent, extent, (num_points, 3)).astype(np.float32)


def iac_three_lidar_scene(points_per_sensor: int = 4096, seed: int = 0):
    """Per-sensor clouds for the reference's default 3-LiDAR IAC layout.

    Matches setDefaultLidarConfigs (src/lidar_fusion.cpp:20-36): front 0
    deg, left +120 deg, right -120 deg, ego radius 2.5 m.  Each sensor
    observes a forward +-80 deg wedge of the SAME world (ground plane with
    pillar obstacles) in its own frame, so the fused cloud covers 360 deg
    with ~60 deg of pairwise overlap; some returns land inside the ego
    radius.  Returns a list of 3 (points_per_sensor, 3) float32 arrays in
    sensor frames; fusing with ``stack_extrinsics(default_lidar_configs())``
    reconstructs the world-frame scene.
    """
    yaws = np.deg2rad([0.0, 120.0, -120.0]).astype(np.float64)
    rng = np.random.default_rng(seed)
    clouds = []
    for yaw in yaws:
        n = points_per_sensor
        n_obst = int(n * 0.25)
        n_ground = n - n_obst
        # world-frame wedge centred on this sensor's heading
        ang = rng.uniform(yaw - np.deg2rad(80), yaw + np.deg2rad(80), n_ground)
        rad = np.sqrt(rng.uniform(1.0**2, 60.0**2, n_ground))  # incl. r<2.5
        g = np.empty((n_ground, 3), np.float64)
        g[:, 0] = rad * np.cos(ang)
        g[:, 1] = rad * np.sin(ang)
        g[:, 2] = rng.normal(0.0, 0.05, n_ground)
        # pillar obstacles inside the same wedge
        ao = rng.uniform(yaw - np.deg2rad(80), yaw + np.deg2rad(80), n_obst)
        ro = np.sqrt(rng.uniform(4.0**2, 40.0**2, n_obst))
        o = np.empty((n_obst, 3), np.float64)
        o[:, 0] = ro * np.cos(ao)
        o[:, 1] = ro * np.sin(ao)
        o[:, 2] = rng.uniform(0.5, 3.0, n_obst)
        world = np.concatenate([g, o])
        # express in the sensor frame: local = R(-yaw) @ world
        c, s = np.cos(-yaw), np.sin(-yaw)
        local = world.copy()
        local[:, 0] = c * world[:, 0] - s * world[:, 1]
        local[:, 1] = s * world[:, 0] + c * world[:, 1]
        clouds.append(local.astype(np.float32))
    return clouds


def fused_iac_cloud(num_points: int = 131072, seed: int = 0,
                    device: torch.device | str = "cpu") -> np.ndarray:
    """One merged 3-sensor IAC cloud of exactly ``num_points`` world-frame
    points: :func:`iac_three_lidar_scene` fused on ``device`` by the port's
    LidarFusion (stacked extrinsics + ego masks), ego-removed points
    dropped.  Equal, bit for bit, to the JAX generator's output."""
    from ..core.config import default_lidar_configs
    from ..fusion.fusion import LidarFusion

    per = num_points // 3 + 512  # headroom for ego-removed returns
    clouds = iac_three_lidar_scene(per, seed=seed)
    xyz = LidarFusion(default_lidar_configs(), device=device).fuse(
        clouds).to_numpy()
    if len(xyz) < num_points:  # pragma: no cover - headroom covers this
        reps = -(-num_points) // len(xyz)
        xyz = np.tile(xyz, (reps, 1))
    return xyz[:num_points].astype(np.float32)


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
    scattered vertical obstacles.  More representative point distribution
    than the uniform demo cloud (dense near the sensor, ring structure)
    for benchmarking; sensor frame has the ground BELOW the origin like
    KITTI (z ~ -sensor_height).

    Points are emitted in AZIMUTH order — the firing order of a real
    spinning sensor (and the row order of KITTI velodyne ``.bin`` files
    and PointCloud2 streams).  The engine is order-independent for
    correctness, but azimuth order makes polar patches near-contiguous in
    memory.
    """
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
    # firing order: one revolution, azimuth-major (see docstring)
    all_az = np.concatenate(
        [az, np.arctan2(obst[:, 1], obst[:, 0])]).astype(np.float32)
    return pts[np.argsort(all_az, kind="stable")]


# ---------------------------------------------------------------------------
# Hard labeled scenes (segmentation accuracy): slopes, curbs+ramps,
# overhanging structure, sparse far field and rolling terrain.  Ground
# surface near z=0, sensor above it (PatchworkConfig defaults).  Each
# returns (xyz (N,3) f32, ground_labels (N,) bool), labels true by
# construction.

def _scene_slope(n, rng):
    """8.5% grade hillside road: planar but NOT horizontal ground.

    Stresses the seed rule (z_th is a fixed height above the sensor
    foot, so uphill ground rises out of the seed band) and plane-fit
    normals far from +z."""
    n_g = int(n * 0.75)
    g = np.empty((n_g, 3), np.float32)
    g[:, 0] = rng.uniform(-55, 55, n_g)
    g[:, 1] = rng.uniform(-30, 30, n_g)
    g[:, 2] = 0.085 * g[:, 0] + rng.normal(0, 0.03, n_g)
    n_o = n - n_g
    centers = rng.uniform(-45, 45, (max(n_o // 150, 1), 2))
    pick = rng.integers(0, len(centers), n_o)
    o = np.empty((n_o, 3), np.float32)
    o[:, 0] = centers[pick, 0] + rng.normal(0, 0.25, n_o)
    o[:, 1] = centers[pick, 1] + rng.normal(0, 0.25, n_o)
    o[:, 2] = 0.085 * o[:, 0] + rng.uniform(0.4, 2.5, n_o)  # on the slope
    xyz = np.concatenate([g, o])
    labels = np.zeros(n, bool)
    labels[:n_g] = True
    return xyz, labels


def _scene_curb_ramp(n, rng):
    """Road + 0.18 m raised sidewalk joined by a short ramp.

    Both road and sidewalk are drivable ground; the curb step sits well
    inside th_dist (0.2) so a patch straddling it is the hard case."""
    n_road = int(n * 0.45)
    n_walk = int(n * 0.25)
    n_ramp = int(n * 0.05)
    n_o = n - n_road - n_walk - n_ramp
    road = np.empty((n_road, 3), np.float32)
    road[:, 0] = rng.uniform(-50, 50, n_road)
    road[:, 1] = rng.uniform(-8, 8, n_road)
    road[:, 2] = rng.normal(0, 0.02, n_road)
    walk = np.empty((n_walk, 3), np.float32)
    walk[:, 0] = rng.uniform(-50, 50, n_walk)
    walk[:, 1] = np.where(rng.random(n_walk) < 0.5,
                          rng.uniform(8.5, 20, n_walk),
                          rng.uniform(-20, -8.5, n_walk))
    walk[:, 2] = 0.18 + rng.normal(0, 0.02, n_walk)
    ramp = np.empty((n_ramp, 3), np.float32)
    ramp[:, 0] = rng.uniform(-50, 50, n_ramp)
    ramp[:, 1] = rng.uniform(8.0, 8.5, n_ramp) * rng.choice([-1, 1], n_ramp)
    ramp[:, 2] = 0.18 * (np.abs(ramp[:, 1]) - 8.0) / 0.5 + rng.normal(
        0, 0.02, n_ramp)
    # street furniture on the sidewalk: poles
    centers_x = rng.uniform(-45, 45, max(n_o // 100, 1))
    centers_y = rng.uniform(9, 19, len(centers_x)) * rng.choice(
        [-1, 1], len(centers_x))
    pick = rng.integers(0, len(centers_x), n_o)
    o = np.empty((n_o, 3), np.float32)
    o[:, 0] = centers_x[pick] + rng.normal(0, 0.1, n_o)
    o[:, 1] = centers_y[pick] + rng.normal(0, 0.1, n_o)
    o[:, 2] = 0.18 + rng.uniform(0.3, 3.0, n_o)
    xyz = np.concatenate([road, walk, ramp, o])
    labels = np.zeros(n, bool)
    labels[:n_road + n_walk + n_ramp] = True
    return xyz, labels


def _scene_overhang(n, rng):
    """Flat ground under overhanging structure (bridge deck + canopy).

    The overhang hangs 2.2-3.5 m above DRIVABLE ground: a fit that seeds
    from low points but thresholds generously can leak the deck into the
    ground mask; a height-band heuristic would fail outright."""
    n_g = int(n * 0.62)
    g = np.empty((n_g, 3), np.float32)
    g[:, 0] = rng.uniform(-55, 55, n_g)
    g[:, 1] = rng.uniform(-35, 35, n_g)
    g[:, 2] = rng.normal(0, 0.025, n_g)
    n_deck = int(n * 0.18)
    deck = np.empty((n_deck, 3), np.float32)
    deck[:, 0] = rng.uniform(-12, 12, n_deck)       # bridge strip
    deck[:, 1] = rng.uniform(-35, 35, n_deck)
    deck[:, 2] = 2.6 + rng.normal(0, 0.05, n_deck)
    n_can = int(n * 0.1)
    can = np.empty((n_can, 3), np.float32)          # tree canopy blobs
    cc = rng.uniform(-45, 45, (max(n_can // 300, 1), 2))
    pick = rng.integers(0, len(cc), n_can)
    can[:, 0] = cc[pick, 0] + rng.normal(0, 1.2, n_can)
    can[:, 1] = cc[pick, 1] + rng.normal(0, 1.2, n_can)
    can[:, 2] = rng.uniform(2.2, 3.5, n_can)
    n_o = n - n_g - n_deck - n_can                  # bridge piers
    pc = rng.uniform(-10, 10, (max(n_o // 200, 1),))
    pick = rng.integers(0, len(pc), n_o)
    o = np.empty((n_o, 3), np.float32)
    o[:, 0] = pc[pick] + rng.normal(0, 0.2, n_o)
    o[:, 1] = rng.choice([-20.0, 20.0], n_o) + rng.normal(0, 0.2, n_o)
    o[:, 2] = rng.uniform(0.1, 2.6, n_o)
    xyz = np.concatenate([g, deck, can, o])
    labels = np.zeros(n, bool)
    labels[:n_g] = True
    return xyz, labels


def _scene_sparse_far(n, rng):
    """Spinning-sensor density fall-off with a very sparse far field.

    Outer-ring patches get a handful of returns each — stressing the
    <3-seed fallback and rank-deficient plane fits; far obstacles are a
    guardrail and distant wall, each sparsely sampled."""
    n_g = int(n * 0.8)
    # 1/r^2-ish radial density: most returns near the sensor.
    # (1 - power(4)) has pdf 4(1-x)^3 on [0,1] — concentrated at 0, so r
    # concentrates at 2 m.  (r5 review: rng.power(4.0) alone is the
    # MIRROR distribution — it silently made the far field the dense
    # region and the near field empty, the opposite of this scene's
    # documented geometry.)
    r = 2.0 + 78.0 * (1.0 - rng.power(4.0, n_g))    # dense core
    far = rng.random(n_g) < 0.04                    # thin far tail
    r[far] = rng.uniform(40, 80, int(far.sum()))
    az = rng.uniform(0, 2 * np.pi, n_g)
    g = np.empty((n_g, 3), np.float32)
    g[:, 0] = r * np.cos(az)
    g[:, 1] = r * np.sin(az)
    g[:, 2] = rng.normal(0, 0.02, n_g) * (1 + r / 40)  # range noise growth
    n_o = n - n_g
    n_rail = n_o // 2
    o = np.empty((n_o, 3), np.float32)
    o[:n_rail, 0] = rng.uniform(-70, 70, n_rail)    # guardrail line
    o[:n_rail, 1] = 12.0 + rng.normal(0, 0.05, n_rail)
    o[:n_rail, 2] = rng.uniform(0.3, 0.8, n_rail)
    wall = n_o - n_rail                             # distant wall
    o[n_rail:, 0] = rng.uniform(55, 75, wall)
    o[n_rail:, 1] = rng.uniform(-40, 40, wall)
    o[n_rail:, 2] = rng.uniform(0.2, 4.0, wall)
    xyz = np.concatenate([g, o])
    labels = np.zeros(n, bool)
    labels[:n_g] = True
    return xyz, labels


def _scene_valley(n, rng):
    """Rolling terrain: z = 0.5 sin(x/12) cos(y/15) — nowhere planar.

    The per-patch planar model is only locally valid; split recursion
    must engage to follow the curvature."""
    n_g = int(n * 0.78)
    g = np.empty((n_g, 3), np.float32)
    g[:, 0] = rng.uniform(-55, 55, n_g)
    g[:, 1] = rng.uniform(-55, 55, n_g)
    g[:, 2] = (0.5 * np.sin(g[:, 0] / 12.0) * np.cos(g[:, 1] / 15.0)
               + rng.normal(0, 0.03, n_g))
    n_o = n - n_g
    centers = rng.uniform(-45, 45, (max(n_o // 150, 1), 2))
    pick = rng.integers(0, len(centers), n_o)
    o = np.empty((n_o, 3), np.float32)
    o[:, 0] = centers[pick, 0] + rng.normal(0, 0.25, n_o)
    o[:, 1] = centers[pick, 1] + rng.normal(0, 0.25, n_o)
    base = 0.5 * np.sin(o[:, 0] / 12.0) * np.cos(o[:, 1] / 15.0)
    o[:, 2] = base + rng.uniform(0.4, 2.5, n_o)
    xyz = np.concatenate([g, o])
    labels = np.zeros(n, bool)
    labels[:n_g] = True
    return xyz, labels


HARD_SCENES = {
    "slope": _scene_slope,
    "curb_ramp": _scene_curb_ramp,
    "overhang": _scene_overhang,
    "sparse_far": _scene_sparse_far,
    "valley": _scene_valley,
}


def hard_labeled_scene(name: str, num_points: int = 65536, seed: int = 0):
    """(xyz (N,3) f32, ground_labels (N,) bool) for a named hard scene.

    Rows are shuffled (labels permuted identically) so label blocks never
    align with any engine-internal ordering."""
    rng = np.random.default_rng(seed)
    xyz, labels = HARD_SCENES[name](num_points, rng)
    perm = rng.permutation(num_points)
    return (np.ascontiguousarray(xyz[perm], dtype=np.float32),
            np.ascontiguousarray(labels[perm]))
