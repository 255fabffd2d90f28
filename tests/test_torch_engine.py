"""The port's engine (plain versions on the CPU) against the recursive NumPy
oracle: exact-mode masks bit for bit on the parity scenes, as
tests/test_engine_parity.py holds the JAX engine."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.oracle.reference import filter_ground_oracle  # noqa: E402
from patchwork_tpu_torch import PatchworkConfig, filter_ground  # noqa: E402
from patchwork_tpu_torch.io.synthetic import (  # noqa: E402
    demo_point_cloud, velodyne_like_cloud)

torch.set_num_threads(1)


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


SCENES = {
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


def _run(pts, kw, valid=None):
    valid = np.ones(len(pts), bool) if valid is None else valid
    return filter_ground(torch.from_numpy(pts), torch.from_numpy(valid),
                         PatchworkConfig(**kw))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_exact_masks_match_oracle(name):
    make, kw = SCENES[name]
    pts = make()
    g_o, v_o, z_o, p_o = filter_ground_oracle(pts, JaxConfig(**kw))
    res = _run(pts, kw)
    np.testing.assert_array_equal(res.valid.numpy(), v_o)
    np.testing.assert_array_equal(res.in_zone.numpy(), z_o)
    np.testing.assert_array_equal(res.in_patch.numpy(), p_o)
    np.testing.assert_array_equal(res.ground.numpy(), g_o)


def test_all_deficient_iou():
    # every adaptive seed threshold lies below all points: 3-point seed
    # fits are ill-conditioned, so oracle parity is IoU-level (PARITY.md)
    pts = demo_point_cloud(3000, seed=5).copy()
    pts[:, 2] += 2.0
    kw = dict(filtering_radius=60.0)
    g_o, *_ = filter_ground_oracle(pts, JaxConfig(**kw))
    g = _run(pts, kw).ground.numpy()
    assert (g & g_o).sum() / max((g | g_o).sum(), 1) > 0.95


def test_validity_mask_padding():
    pts = demo_point_cloud(4000, seed=13)
    padded = np.concatenate([pts, np.full((512, 3), 1e9, np.float32)])
    valid = np.zeros(len(padded), bool)
    valid[:4000] = True
    kw = dict(filtering_radius=50.0)
    g = _run(padded, kw, valid).ground.numpy()
    g_o, *_ = filter_ground_oracle(pts, JaxConfig(**kw))
    np.testing.assert_array_equal(g[:4000], g_o)
    assert not g[4000:].any()
