"""The port's NumPy generators give bit-identical arrays to the reference's."""

import numpy as np
import pytest

pytest.importorskip("jax")

from patchwork_tpu.io import synthetic as jsyn  # noqa: E402
from patchwork_tpu_torch.io import synthetic as tsyn  # noqa: E402


@pytest.mark.parametrize("n,seed", [(10, 0), (5000, 1)])
def test_demo_point_cloud(n, seed):
    np.testing.assert_array_equal(tsyn.demo_point_cloud(n, seed=seed),
                                  jsyn.demo_point_cloud(n, seed=seed))


@pytest.mark.parametrize("n,seed", [(4096, 0), (8192, 3)])
def test_velodyne_like_cloud(n, seed):
    a = tsyn.velodyne_like_cloud(n, seed=seed)
    b = jsyn.velodyne_like_cloud(n, seed=seed)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(jsyn.HARD_SCENES))
@pytest.mark.parametrize("seed", [0, 1])
def test_hard_labeled_scene(name, seed):
    xa, la = tsyn.hard_labeled_scene(name, 4096, seed=seed)
    xb, lb = jsyn.hard_labeled_scene(name, 4096, seed=seed)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(la, lb)


def test_same_scene_set():
    assert sorted(tsyn.HARD_SCENES) == sorted(jsyn.HARD_SCENES)
