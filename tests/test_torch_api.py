"""The port's fast mode, batching, API and import contract."""

import os
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
    gt, nt = RecursivePatchwork(PatchworkConfig(**cfg),
                                device="cpu").filter_ground_points(pts)
    gj, nj = JaxPatchwork(JaxConfig(**cfg)).filter_ground_points(pts)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(RecursivePatchwork.clean_points(pts),
                                  JaxPatchwork.clean_points(pts))


def test_api_config_roundtrip():
    rp = RecursivePatchwork(device="cpu")
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
            "viz.visualization", "slam", "slam.se3", "slam.scan_matching",
            "slam.ba", "slam.pose_graph", "slam.odometry", "slam.landmarks",
            "slam.mapping"]


def test_imports_without_jax():
    # the port's modules, its SLAM tool and chip_smoke.py
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ", ".join(f"patchwork_tpu_torch.{m}" for m in _MODULES)
    code = ("import sys; sys.modules['jax'] = None; "
            f"sys.path[:0] = [{root!r}, {os.path.join(root, 'tools')!r}]; "
            f"import patchwork_tpu_torch, {mods}, torch_slam_bench, "
            "chip_smoke; "
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


# every method of the processor that computes on tensors, with arguments
_PROCESSOR_METHODS = {
    "remove_nan_points": (), "filter_by_distance": (1.0, 30.0),
    "filter_by_height": (0.0, 2.0), "compute_centroid": (),
    "compute_covariance": (), "compute_pca": (),
    "compute_distances_to_plane": ([0, 0, 0], [0, 0, 1]),
    "compute_point_to_plane_distance": ([0, 0, 0], [0, 0, 1]),
    "random_subsample": (100,), "voxel_grid_filter": (2.0,),
}


def _no_device_entry_points():
    from patchwork_tpu_torch import (LidarFusion, PointCloud,
                                     PointCloudProcessor, launch, node)
    from patchwork_tpu_torch.io.synthetic import fused_iac_cloud

    from patchwork_tpu_torch.slam import (BAProblem, LidarOdometry,
                                          PoseGraph, build_ba_problem)

    pts = demo_point_cloud(300, seed=0)
    eye, z3 = np.eye(4, dtype=np.float32)[None], np.zeros((1, 3), np.float32)
    desc = launch.LaunchDescription(
        node.NodeParams(), PatchworkConfig(),
        {"demo": {"frames": 1, "points": 300}}, capacity=512)
    return {
        "RecursivePatchwork": lambda **kw: RecursivePatchwork(**kw),
        "PatchworkNode": lambda **kw: node.PatchworkNode(capacity=512, **kw),
        "run_stream": lambda **kw: node.run_stream(iter([pts]), capacity=512,
                                                   verbose=False, **kw),
        "run_launch": lambda **kw: launch.run_launch(
            desc, log=lambda s: None, **kw),
        "LidarFusion": lambda **kw: LidarFusion(**kw),
        "PointCloud.from_numpy": lambda **kw: PointCloud.from_numpy(pts, **kw),
        "fused_iac_cloud": lambda **kw: fused_iac_cloud(3000, seed=0, **kw),
        "rotate_points_2d": lambda **kw: RecursivePatchwork.rotate_points_2d(
            pts, 30.0, **kw),
        "remove_ego_vehicle": lambda **kw: RecursivePatchwork.remove_ego_vehicle(
            pts, 2.5, **kw),
        "LidarOdometry": lambda **kw: LidarOdometry(**kw),
        "BAProblem.from_numpy": lambda **kw: BAProblem.from_numpy(
            eye, z3, [0], [0], z3, [1.0], **kw),
        "PoseGraph.from_numpy": lambda **kw: PoseGraph.from_numpy(
            eye, [0], [0], eye, np.eye(6)[None], **kw),
        "build_ba_problem": lambda **kw: build_ba_problem(eye, [z3], **kw),
        **{f"PointCloudProcessor.{name}":
           lambda name=name, args=args, **kw: getattr(
               PointCloudProcessor, name)(pts, *args, **kw)
           for name, args in _PROCESSOR_METHODS.items()},
    }


@pytest.mark.parametrize("entry", sorted(_no_device_entry_points()))
def test_entry_points_default_to_the_card(entry, monkeypatch):
    # no card here: with no device an entry point raises instead of running
    # on the CPU; device="cpu" (and only that) runs the plain versions
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = _no_device_entry_points()[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(device="cuda")
    build(device="cpu")
