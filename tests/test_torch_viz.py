"""The port's BEV images and PNG writer against the JAX package's, on the
CPU: the same pixels bit for bit, out-of-range and edge points included."""

import io

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu.viz import bev as jbev  # noqa: E402
from patchwork_tpu.viz.visualization import Visualization as JaxViz  # noqa: E402
from patchwork_tpu_torch.viz import bev as tbev  # noqa: E402
from patchwork_tpu_torch.viz.visualization import Visualization  # noqa: E402

torch.set_num_threads(1)

W, H = 300, 150
BOUNDS = (-150.0, -75.0, 150.0, 75.0)


def _scene(seed=0, n=6000):
    """Points inside, outside and on the edges of the default image, with
    z spanning every colour clip, NaN rows, and a mask of which to draw."""
    rng = np.random.default_rng(seed)
    xyz = np.empty((n, 3), np.float32)
    xyz[:, 0] = rng.uniform(-200, 200, n)
    xyz[:, 1] = rng.uniform(-100, 100, n)
    xyz[:, 2] = rng.uniform(-4, 4, n)
    edges = np.array([[-150.0, -75.0], [-150.0, 0.0], [149.99, 0.0],
                      [150.0, 0.0], [0.0, 74.99], [0.0, 75.0],
                      [-150.5, 0.0], [-150.000001, -75.000001],
                      [149.9, -75.0], [-150.0, 74.9], [1e10, 0.0],
                      [-1e10, 0.0], [0.0, np.inf]], np.float32)
    xyz[:len(edges), :2] = edges
    xyz[100:110] = np.nan
    xyz[110, 2] = np.nan     # drawn with x, y finite: a NaN colour
    return xyz, rng.random(n) > 0.3


def _no_corner(xyz):
    """Keep points off the last pixel (H-1, W-1): the JAX overlay blanks it
    (see test_ground_overlay_corner_pixel)."""
    xyz = xyz.copy()
    corner = (xyz[:, 0] >= 149.0) & (xyz[:, 0] < 150.0) & (
        xyz[:, 1] >= 74.0) & (xyz[:, 1] < 75.0)
    xyz[corner, :2] = 0.0
    return xyz


def _both(fn_t, fn_j, xyz, *masks, **kw):
    got = fn_t(torch.from_numpy(xyz), *map(torch.from_numpy, masks), **kw)
    want = fn_j(jnp.asarray(xyz), *map(jnp.asarray, masks), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("geom", [{}, dict(width=64, height=48, x_min=-20.0,
                                          y_min=-10.0, x_max=12.5,
                                          y_max=30.0)],
                         ids=["default", "small"])
def test_height_and_enhanced_images_bitwise(seed, geom):
    xyz, mask = _scene(seed)
    for ft, fj in ((tbev.bev_height_image, jbev.bev_height_image),
                   (tbev.bev_enhanced_image, jbev.bev_enhanced_image)):
        got, want = _both(ft, fj, xyz, mask, **geom)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert got.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_ground_overlay_bitwise(seed):
    xyz, mask = _scene(seed)
    xyz = _no_corner(xyz)
    ground = mask & (np.arange(len(xyz)) % 2 == 0)
    non_ground = mask & ~ground
    got, want = _both(tbev.bev_ground_nonground_image,
                      jbev.bev_ground_nonground_image, xyz, ground, non_ground)
    np.testing.assert_array_equal(got, want)
    assert (got == [255, 0, 0]).all(-1).any() and (got == [0, 255, 0]).all(-1).any()


def test_ground_overlay_corner_pixel():
    # The JAX overlay parks undrawn points on index -1, which it wraps to
    # the last pixel and sets to black; the port draws that pixel.
    xyz = np.array([[149.5, 74.5, 0.0], [0.0, 0.0, 1.0]], np.float32)
    ground, non_ground = np.array([True, False]), np.array([False, True])
    got, want = _both(tbev.bev_ground_nonground_image,
                      jbev.bev_ground_nonground_image, xyz, ground, non_ground)
    assert tuple(got[H - 1, W - 1]) == (0, 255, 0)
    assert tuple(want[H - 1, W - 1]) == (0, 0, 0)
    got[H - 1, W - 1] = 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(150, 300), (1, 1), (7, 5)])
def test_save_png_decodes_to_the_image(tmp_path, shape):
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 256, (*shape, 3), np.uint8)
    for i, arr in enumerate((img, torch.from_numpy(img))):
        path = tmp_path / f"t{i}.png"
        tbev.save_png(arr, str(path))
        with Image.open(io.BytesIO(path.read_bytes())) as im:
            assert im.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(im), img)


def test_save_png_rejects_other_shapes(tmp_path):
    with pytest.raises(ValueError):
        tbev.save_png(np.zeros((4, 4, 4), np.uint8), str(tmp_path / "x.png"))


def test_visualization_class_matches():
    xyz, mask = _scene(3, 3000)
    xyz = _no_corner(xyz[np.isfinite(xyz).all(1)])
    g, n = xyz[: len(xyz) // 2], xyz[len(xyz) // 2:]
    t, j = Visualization(), JaxViz()
    np.testing.assert_array_equal(t.create_bev_image(xyz), j.create_bev_image(xyz))
    np.testing.assert_array_equal(t.create_ground_non_ground_image(g, n),
                                  j.create_ground_non_ground_image(g, n))
    np.testing.assert_array_equal(
        t.create_ground_non_ground_image(np.zeros((0, 3)), []),
        j.create_ground_non_ground_image(np.zeros((0, 3)), []))
    np.testing.assert_array_equal(t.create_enhanced_filtered_image(xyz),
                                  j.create_enhanced_filtered_image(xyz))
    for size in (1.0, 3.0):
        np.testing.assert_array_equal(
            t.draw_points(np.zeros((60, 80, 3), np.uint8), xyz[:200],
                          (1, 2, 3), size),
            j.draw_points(np.zeros((60, 80, 3), np.uint8), xyz[:200],
                          (1, 2, 3), size))
    for p in ([0.0, 0.0], [149.0, -75.0], [500.0, 500.0]):
        assert t.world_to_pixel(p, W, H, *BOUNDS) == j.world_to_pixel(p, W, H, *BOUNDS)
        assert t.is_point_in_bounds(p, *BOUNDS) == j.is_point_in_bounds(p, *BOUNDS)


def test_visualization_savers(tmp_path):
    from PIL import Image

    xyz, _ = _scene(4, 500)
    xyz = xyz[np.isfinite(xyz).all(1)]
    v = Visualization()
    v.set_ground_color((1, 2, 3))
    assert v.ground_color == (1, 2, 3)
    assert v.save_bev_image(xyz, str(tmp_path / "a.png"))
    assert v.save_ground_non_ground_image(xyz[:10], xyz[10:],
                                          str(tmp_path / "b.png"))
    with Image.open(tmp_path / "a.png") as im:
        np.testing.assert_array_equal(np.asarray(im), v.create_bev_image(xyz))
