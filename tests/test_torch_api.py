"""The port's fast mode, batching, API and import contract."""

import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from patchwork_tpu.api import RecursivePatchwork as JaxPatchwork  # noqa: E402
from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu_torch import (  # noqa: E402
    PatchworkConfig, RecursivePatchwork, filter_ground, filter_ground_batched)
from patchwork_tpu_torch.io.synthetic import (  # noqa: E402
    demo_point_cloud, velodyne_like_cloud)

torch.set_num_threads(1)


def _ground(pts, cfg):
    return filter_ground(torch.from_numpy(pts),
                         torch.ones(len(pts), dtype=torch.bool), cfg).ground


@pytest.mark.parametrize("gen", [demo_point_cloud, velodyne_like_cloud])
def test_fast_mode_iou_vs_exact(gen):
    pts = gen(8192, seed=3)
    exact = _ground(pts, PatchworkConfig()).numpy()
    fast = _ground(pts, PatchworkConfig(fast_covariance=True)).numpy()
    iou = (exact & fast).sum() / max((exact | fast).sum(), 1)
    assert iou >= 0.999, iou


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_batch_equals_single_scans(fast):
    # each scan converges on its own: a batch gives every scan its solo mask
    cfg = PatchworkConfig(filtering_radius=60.0, fast_covariance=fast)
    scans = [demo_point_cloud(4096, seed=i) for i in range(3)]
    scans[1][:, 2] += 0.08 * scans[1][:, 0]   # one scan that needs more work
    xyz = torch.from_numpy(np.stack(scans))
    res = filter_ground_batched(xyz, torch.ones(xyz.shape[:2], dtype=torch.bool),
                                cfg)
    for i, pts in enumerate(scans):
        assert torch.equal(res.ground[i], _ground(pts, cfg))


def test_api_matches_jax_api():
    pts = demo_point_cloud(5000, seed=21)
    pts[::101] = np.nan
    cfg = dict(filtering_radius=50.0, num_sectors=8)
    gt, nt = RecursivePatchwork(PatchworkConfig(**cfg)).filter_ground_points(pts)
    gj, nj = JaxPatchwork(JaxConfig(**cfg)).filter_ground_points(pts)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(RecursivePatchwork.clean_points(pts),
                                  JaxPatchwork.clean_points(pts))


def test_api_config_roundtrip():
    rp = RecursivePatchwork()
    cfg = PatchworkConfig(num_sectors=12)
    rp.set_config(cfg)
    assert rp.get_config() is cfg
    res, n = rp.segment(demo_point_cloud(3000, seed=2))
    assert n == 3000 and res.ground.shape == (4096,)
    assert int(res.num_ground()) + int(res.num_non_ground()) <= 3000


_MODULES = ["kernels.fit_cuda", "kernels.seg_cuda", "api", "processor",
            "node", "launch", "cli", "core.timing", "core.types",
            "fusion.fusion", "io.synthetic", "io.kitti", "io.native",
            "io.bag", "ops.sampling", "ops.geometry", "ops.pointcloud",
            "utils.metrics", "utils.checkpoint", "utils.debug", "viz.bev",
            "viz.visualization"]


def test_imports_without_jax():
    mods = ", ".join(f"patchwork_tpu_torch.{m}" for m in _MODULES)
    code = ("import sys; sys.modules['jax'] = None; "
            f"import patchwork_tpu_torch, {mods}; "
            "assert not any(m == 'patchwork_tpu' or m.startswith('patchwork_tpu.')"
            " for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_wrappers_reject_bad_inputs():
    from patchwork_tpu_torch.kernels import fit_cuda

    pts = torch.zeros((1, 8, 100))
    state = torch.zeros((1, 4, 100))
    tab = torch.zeros((1, 8, 128))
    with pytest.raises(ValueError):   # N not a tile multiple, on any device
        fit_cuda._check_points(pts, state)
    with pytest.raises(ValueError):
        fit_cuda._on_card(tab, torch.zeros(3, device="meta"))
