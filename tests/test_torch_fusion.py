"""The port's multi-LiDAR fusion against the JAX package's, on the CPU:
transforms, fused clouds and the engine's masks on them, bit for bit."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.core.config import LidarConfig as JaxLidar  # noqa: E402
from patchwork_tpu.fusion import fusion as jfus  # noqa: E402
from patchwork_tpu.io import synthetic as jsyn  # noqa: E402
from patchwork_tpu.ops import pointcloud as jpc  # noqa: E402
from patchwork_tpu.segment.engine import make_filter_ground  # noqa: E402
from patchwork_tpu_torch import PatchworkConfig, filter_ground  # noqa: E402
from patchwork_tpu_torch.core.config import (  # noqa: E402
    LidarConfig, default_lidar_configs)
from patchwork_tpu_torch.fusion import fusion as tfus  # noqa: E402
from patchwork_tpu_torch.io import synthetic as tsyn  # noqa: E402
from patchwork_tpu_torch.ops import pointcloud as tpc  # noqa: E402

torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def test_matrices_equal():
    for deg in (0.0, 120.0, -120.0, 33.3):
        np.testing.assert_array_equal(tfus.rotation_matrix_2d(deg),
                                      jfus.rotation_matrix_2d(deg))
    np.testing.assert_array_equal(tfus.translation_matrix(1.5, -2.0, 0.3),
                                  jfus.translation_matrix(1.5, -2.0, 0.3))
    np.testing.assert_array_equal(
        tfus.stack_extrinsics(default_lidar_configs()),
        jfus.stack_extrinsics(default_lidar_configs()))


@pytest.mark.parametrize("kind", ["extrinsics", "perspective"])
def test_transform_4x4_bitwise(kind):
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-60, 60, (3, 5000, 3)).astype(np.float32)
    if kind == "extrinsics":
        m = np.stack([tfus.rotation_matrix_2d(a) @ tfus.translation_matrix(
            1.0, -0.5, 1.7) for a in (0.0, 120.0, -120.0)]).astype(np.float32)
    else:   # a general matrix with a non-trivial last row
        m = rng.normal(size=(3, 4, 4)).astype(np.float32)
        m[:, 3] = [0.01, -0.02, 0.005, 1.0]
    want = jpc.transform_4x4(jnp.asarray(xyz), jnp.asarray(m))
    got = tpc.transform_4x4(torch.from_numpy(xyz), torch.from_numpy(m))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fuse_stacked_with_ego_removal_bitwise():
    clouds = tsyn.iac_three_lidar_scene(6000, seed=2)
    xyz = np.stack(clouds)
    valid = np.ones(xyz.shape[:2], bool)
    valid[1, ::7] = False
    ext = tfus.stack_extrinsics(default_lidar_configs())
    ego = np.array([2.5, 3.0, 2.5], np.float32)
    jx, jv = jfus.fuse_stacked(*(jnp.asarray(a) for a in (xyz, valid, ext, ego)))
    tx, tv = tfus.fuse_stacked(*(torch.from_numpy(a)
                                 for a in (xyz, valid, ext, ego)))
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < (~tv.numpy() & valid.reshape(-1)).sum()   # ego points removed


def test_lidar_fusion_truncates_extra_clouds(capsys):
    clouds = tsyn.iac_three_lidar_scene(1000, seed=5)
    clouds.append(clouds[0][:10])
    t = tfus.LidarFusion(device="cpu").fuse(clouds)
    t_msg = capsys.readouterr().out
    j = jfus.LidarFusion().fuse(clouds)
    assert t_msg == capsys.readouterr().out != ""
    np.testing.assert_array_equal(_bits(t.xyz), _bits(j.xyz))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())


def test_lidar_fusion_config_surface():
    f = tfus.LidarFusion([LidarConfig(1, "/a", 45.0, 1.0)], device="cpu")
    jf = jfus.LidarFusion([JaxLidar(1, "/a", 45.0, 1.0)])
    pts = tsyn.uniform_cube_cloud(500, seed=1)
    np.testing.assert_array_equal(f.fuse([pts]).to_numpy(),
                                  jf.fuse([pts]).to_numpy())
    f.add_lidar(LidarConfig(2, "/b"))
    assert len(f.configs) == 2
    f.clear_lidars()
    empty = f.fuse([])
    assert empty.capacity == 0 and int(empty.count()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_iac_cloud_bitwise(seed):
    np.testing.assert_array_equal(_bits(tsyn.fused_iac_cloud(16384, seed, device="cpu")),
                                  _bits(jsyn.fused_iac_cloud(16384, seed)))


@pytest.mark.parametrize("n,seed", [(300, 0), (4096, 3)])
def test_generators_bitwise(n, seed):
    for a, b in zip(tsyn.iac_three_lidar_scene(n, seed),
                    jsyn.iac_three_lidar_scene(n, seed)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsyn.uniform_cube_cloud(n, seed),
                                  jsyn.uniform_cube_cloud(n, seed))
    np.testing.assert_array_equal(tsyn.demo_labels(n), jsyn.demo_labels(n))


@pytest.mark.parametrize("cfg", [{}, {"fast_covariance": True},
                                 {"segment_impl": "scatter"}],
                         ids=["default", "fast", "scatter"])
def test_engine_masks_on_fused_cloud(cfg):
    pts = tsyn.fused_iac_cloud(16384, seed=0, device="cpu")
    got = filter_ground(torch.from_numpy(pts),
                        torch.ones(len(pts), dtype=torch.bool),
                        PatchworkConfig(**cfg)).ground.numpy()
    jcfg = dict(cfg)
    impl = jcfg.pop("segment_impl", "fused")
    want = make_filter_ground(JaxConfig(**jcfg), impl=impl)(
        jnp.asarray(pts), jnp.ones(len(pts), bool)).ground
    np.testing.assert_array_equal(got, np.asarray(want))
