"""The port's sampling and masked-geometry ops against the JAX package's,
on the CPU."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu.ops import geometry as jgeo  # noqa: E402
from patchwork_tpu.ops import sampling as jsam  # noqa: E402
from patchwork_tpu_torch.ops import geometry as tgeo  # noqa: E402
from patchwork_tpu_torch.ops import sampling as tsam  # noqa: E402

torch.set_num_threads(1)


def _jax_topk(scores, valid, k):
    """The JAX package's selection (sampling.py:23-39) on given scores."""
    g = jnp.where(jnp.asarray(valid), jnp.asarray(scores), -jnp.inf)
    _, idx = jax.lax.top_k(g, min(k, valid.shape[-1]))
    if valid.ndim == 1:
        sel = jnp.zeros(valid.shape, bool).at[idx].set(True)
    else:
        sel = jsam._batched_scatter_topk(jnp.asarray(valid), idx)
    return np.asarray(sel) & valid


@pytest.mark.parametrize("shape,k", [((5000,), 300), ((3, 2000), 150),
                                     ((700,), 2000)])
def test_topk_mask_matches_jax(shape, k):
    rng = np.random.default_rng(1)
    scores = rng.normal(size=shape).astype(np.float32)
    valid = rng.random(shape) > 0.2
    got = tsam._topk_mask(torch.from_numpy(scores), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(got.numpy(), _jax_topk(scores, valid, k))


def test_subsample_seeded_reproducible():
    valid = torch.from_numpy(np.random.default_rng(2).random(4000) > 0.3)

    def draw(seed):
        return tsam.random_subsample_mask(
            valid, 500, torch.Generator().manual_seed(seed))

    assert torch.equal(draw(7), draw(7))
    assert not torch.equal(draw(7), draw(8))


@pytest.mark.parametrize("k", [0, 1, 250, 1234, 5000])
def test_subsample_count_is_min_k_valid(k):
    valid = torch.from_numpy(np.random.default_rng(3).random((2, 2500)) > 0.5)
    sel = tsam.random_subsample_mask(valid, k, torch.Generator().manual_seed(0))
    assert torch.equal(sel.sum(-1), torch.clamp(valid.sum(-1), max=k))
    assert not bool((sel & ~valid).any())


@pytest.mark.parametrize("voxel", [0.25, 0.7, 3.0])
def test_voxel_grid_filter_matches_jax(voxel):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (6000, 3)).astype(np.float32)
    pts[:100] = pts[100:200]            # duplicate points share voxels
    valid = rng.random(6000) > 0.1
    c, v = tsam.voxel_grid_filter(torch.from_numpy(pts),
                                  torch.from_numpy(valid), voxel)
    jc, jv = jsam.voxel_grid_filter(jnp.asarray(pts), jnp.asarray(valid), voxel)
    jc, jv = np.asarray(jc), np.asarray(jv)
    np.testing.assert_array_equal(v.numpy(), jv)
    vox = np.floor(c.numpy()[v.numpy()] / voxel)   # same voxels, same order
    np.testing.assert_array_equal(vox, np.floor(jc[jv] / voxel))
    np.testing.assert_allclose(c.numpy(), jc, rtol=0, atol=1e-6)


def test_masked_geometry_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(4, 600, 3)).astype(np.float32) * [20, 20, 0.1]
    xyz = xyz.astype(np.float32)
    mask = rng.random((4, 600)) > 0.3
    mask[2] = False                      # empty
    mask[3, 2:] = False                  # n = 2 < 3: the sentinel
    tx, tm = torch.from_numpy(xyz), torch.from_numpy(mask)
    jx, jm = jnp.asarray(xyz), jnp.asarray(mask)
    c, n = tgeo.masked_centroid(tx, tm)
    jc, jn = jgeo.masked_centroid(jx, jm)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    cov = tgeo.masked_covariance(tx, tm, c)
    jcov = jgeo.masked_covariance(jx, jm, jc)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(tgeo.fit_plane_masked(tx, tm), jgeo.fit_plane_masked(jx, jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
