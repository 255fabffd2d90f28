"""The port's point ops, eigensolve and binning against the JAX reference."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.io.synthetic import (  # noqa: E402
    demo_point_cloud, velodyne_like_cloud)
from patchwork_tpu.ops import geometry as jgeo  # noqa: E402
from patchwork_tpu.ops import pointcloud as jpc  # noqa: E402
from patchwork_tpu.segment import binning as jbin  # noqa: E402
from patchwork_tpu_torch import PatchworkConfig  # noqa: E402
from patchwork_tpu_torch.ops import geometry as tgeo  # noqa: E402
from patchwork_tpu_torch.ops import pointcloud as tpc  # noqa: E402
from patchwork_tpu_torch.segment import binning as tbin  # noqa: E402

torch.set_num_threads(1)


def _nan_scene():
    pts = demo_point_cloud(5000, seed=3).copy()
    pts[::97, 0] = np.nan
    pts[::131, 2] = np.inf
    return pts


SCENES = {
    "demo": lambda: demo_point_cloud(10000, seed=1),
    "velodyne": lambda: velodyne_like_cloud(16384, seed=0),
    "nan": _nan_scene,
}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("radius", [150.0, 50.0])
def test_assign_patches_vs_scatter(scene, radius):
    pts = SCENES[scene]()
    valid = np.ones(len(pts), bool)
    valid[::53] = False
    pa_j = jbin.assign_patches(jnp.asarray(pts), jnp.asarray(valid),
                               JaxConfig(filtering_radius=radius),
                               impl="scatter")
    pa_t = tbin.assign_patches(torch.from_numpy(pts)[None],
                               torch.from_numpy(valid)[None],
                               PatchworkConfig(filtering_radius=radius))
    for f in ("patch", "in_patch", "in_zone", "finite"):
        np.testing.assert_array_equal(getattr(pa_t, f)[0].numpy(),
                                      np.asarray(getattr(pa_j, f)), err_msg=f)
    # rel_dist: within rtol 1e-6 of the exact mean (the oracle's float64
    # mean, oracle/reference.py:192).  The two float32 sums add in other
    # orders (tiles here, point order in the JAX scatter) and the JAX sum
    # alone is up to ~9e-7 off at these sizes, so the two are held to the
    # sum of both bounds.
    patch = pa_t.patch[0].numpy()
    inp = pa_t.in_patch[0].numpy()
    d = pa_t.dist[0].numpy().astype(np.float64)
    p = PatchworkConfig(filtering_radius=radius).num_patches
    s64 = np.bincount(patch[inp], weights=d[inp], minlength=p + 1)[:p + 1]
    cnt = np.bincount(patch[inp], minlength=p + 1)[:p + 1]
    exact = np.float32(s64 / np.maximum(cnt, 1)) / np.float32(radius)
    np.testing.assert_allclose(pa_t.rel_dist[0].numpy(), exact, rtol=1e-6)
    np.testing.assert_allclose(pa_t.rel_dist[0].numpy(),
                               np.asarray(pa_j.rel_dist), rtol=2e-6)


def test_edges_and_centers_equal():
    for kw in ({}, {"num_sectors": 16, "num_rings": 4}):
        j, t = JaxConfig(**kw), PatchworkConfig(**kw)
        np.testing.assert_array_equal(tbin.ring_edges(t), jbin.ring_edges(j))
        np.testing.assert_array_equal(tbin.sector_edges(t),
                                      jbin.sector_edges(j))
        np.testing.assert_array_equal(tbin.patch_centers(t),
                                      jbin.patch_centers(j))


def _covariances(n=512, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, (n, 40, 3)) * rng.uniform(0.05, 5.0, (n, 1, 3))
    d = pts - pts.mean(1, keepdims=True)
    return (np.einsum("nki,nkj->nij", d, d) / 39).astype(np.float32)


def test_eigh3x3_within_2_ulp():
    # The closed form takes the small eigenvalues by cancellation against
    # the largest, so ulps are counted at the largest eigenvalue's scale
    # (the largest itself within 2 of its own ulps); eigenvector
    # components against the unit length (4 eps: their error grows with
    # 1 / eigenvalue gap, down to 1.5e-3 of the scale here).
    eps = np.finfo(np.float32).eps
    a = _covariances()
    vj, ej = map(np.asarray, jgeo.eigh3x3(jnp.asarray(a)))
    vt, et = (t.numpy() for t in tgeo.eigh3x3(torch.from_numpy(a)))
    np.testing.assert_array_max_ulp(vt[:, 2], vj[:, 2], maxulp=2)
    scale = vj[:, 2:3]
    assert (np.abs(vt - vj) <= 2 * eps * scale).all()
    np.testing.assert_allclose(et, ej, rtol=0, atol=4 * eps)


def test_eigh3x3_degenerate_falls_back_to_up():
    a = np.zeros((2, 3, 3), np.float32)
    a[1] = np.eye(3, dtype=np.float32)
    _, vec = tgeo.eigh3x3(torch.from_numpy(a))
    _, vj = jgeo.eigh3x3(jnp.asarray(a))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(vj))


def test_point_ops():
    pts = demo_point_cloud(4096, seed=4)
    pts[::9, 0] = np.nan
    x = torch.from_numpy(pts)
    j = jnp.asarray(pts)
    np.testing.assert_array_equal(tpc.finite_mask(x).numpy(),
                                  np.asarray(jpc.finite_mask(j)))
    fin = np.isfinite(pts).all(1)
    # XLA may fuse x*x + y*y into one FMA: 1 ulp apart at most
    np.testing.assert_array_max_ulp(tpc.distance_2d(x).numpy()[fin],
                                    np.asarray(jpc.distance_2d(j))[fin],
                                    maxulp=1)
    np.testing.assert_array_max_ulp(tpc.polar_angle(x).numpy()[fin],
                                    np.asarray(jpc.polar_angle(j))[fin],
                                    maxulp=1)
    np.testing.assert_allclose(tpc.rotate_2d(x, 30.0).numpy()[fin],
                               np.asarray(jpc.rotate_2d(j, 30.0))[fin],
                               rtol=1e-6, atol=1e-5)
    for name, args in (("ego_mask", (2.5,)), ("height_band_mask", (0.2, 1.5)),
                       ("distance_band_mask", (5.0, 30.0))):
        np.testing.assert_array_equal(
            getattr(tpc, name)(x, *args).numpy(),
            np.asarray(getattr(jpc, name)(j, *args)), err_msg=name)
    c = np.array([[1.0, 2.0, 0.0]], np.float32)
    n = np.array([[0.0, 0.6, 0.8]], np.float32)
    np.testing.assert_allclose(
        tpc.plane_distances(x[None], torch.from_numpy(c),
                            torch.from_numpy(n))[0].numpy()[fin],
        np.asarray(jpc.plane_distances(j[None], jnp.asarray(c),
                                       jnp.asarray(n)))[0][fin],
        rtol=1e-6, atol=1e-5)


def test_segops_vs_scatter():
    from patchwork_tpu.segment import segops as jseg
    from patchwork_tpu_torch.segment import segops as tseg

    rng = np.random.default_rng(2)
    n, s = 3000, 17
    seg = rng.integers(0, s, n).astype(np.int32)
    xyz = rng.normal(0, 10, (n, 3)).astype(np.float32)
    where = rng.random(n) < 0.7
    table = rng.normal(0, 1, (s, 2)).astype(np.float32)
    j = jseg.SegOps(jnp.asarray(seg), s, "scatter")
    # the port's SegOps is batched and channel-first: a batch of one scan
    t = tseg.SegOps(torch.from_numpy(seg)[None], s, "scatter")
    xyz_t = torch.from_numpy(xyz.T.copy())[None]
    where_t = torch.from_numpy(where)[None]
    np.testing.assert_array_equal(t.count(where_t)[0].numpy(),
                                  np.asarray(j.count(jnp.asarray(where))))
    np.testing.assert_allclose(t.sum(xyz_t)[0].numpy().T,
                               np.asarray(j.sum(jnp.asarray(xyz))),
                               rtol=1e-5, atol=1e-3)
    for got, ref in zip(t.bbox(xyz_t, where_t),
                        j.bbox(jnp.asarray(xyz), jnp.asarray(where))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    got = t.gather(torch.from_numpy(table.T.copy())[None])[0].numpy().T
    np.testing.assert_array_equal(got, np.asarray(j.gather(jnp.asarray(table))))
    k = rng.integers(0, 100, s).astype(np.int32)
    got = tseg.sort_by_segment(torch.from_numpy(seg), torch.from_numpy(xyz[:, 2]),
                               s).order_stat(torch.from_numpy(k))
    ref = jseg.sort_by_segment(jnp.asarray(seg), jnp.asarray(xyz[:, 2]),
                               s).order_stat(jnp.asarray(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
