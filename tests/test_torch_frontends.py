"""The port's user-facing front ends against the JAX package's, on the CPU:
PointCloudProcessor, the API's sampling and utilities, the containers,
timing and debug helpers, the streaming node, the launch descriptor and the
CLI."""

import contextlib
import dataclasses
import io
import json
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu import launch as jlaunch  # noqa: E402
from patchwork_tpu import node as jnode  # noqa: E402
from patchwork_tpu.api import RecursivePatchwork as JaxPatchwork  # noqa: E402
from patchwork_tpu.core import types as jtypes  # noqa: E402
from patchwork_tpu.processor import PointCloudProcessor as JaxProc  # noqa: E402
from patchwork_tpu.utils import metrics as jmetrics  # noqa: E402
from patchwork_tpu_torch import PatchworkConfig, RecursivePatchwork  # noqa: E402
from patchwork_tpu_torch import cli, launch, node  # noqa: E402
from patchwork_tpu_torch.core import timing, types  # noqa: E402
from patchwork_tpu_torch.io.synthetic import (  # noqa: E402
    demo_point_cloud, fused_iac_cloud)
from patchwork_tpu_torch.processor import PointCloudProcessor as Proc  # noqa: E402
from patchwork_tpu_torch.utils import checkpoint, debug, metrics  # noqa: E402

torch.set_num_threads(1)


def _cloud(n=3000, seed=0):
    pts = demo_point_cloud(n, seed=seed)
    pts[::97] = np.nan
    return pts


# ---- PointCloudProcessor ------------------------------------------------

@pytest.mark.parametrize("method,args", [
    ("remove_nan_points", ()),
    ("filter_by_distance", (5.0, 30.0)),
    ("filter_by_height", (0.2, 1.7)),
])
def test_processor_masks_bitwise(method, args):
    pts = _cloud()
    np.testing.assert_array_equal(getattr(Proc, method)(pts, *args),
                                  getattr(JaxProc, method)(pts, *args))


def test_processor_statistics():
    pts = demo_point_cloud(2500, seed=3)
    c = Proc.compute_centroid(pts)
    np.testing.assert_allclose(c, JaxProc.compute_centroid(pts), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(Proc.compute_covariance(pts),
                               JaxProc.compute_covariance(pts), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Proc.compute_covariance(pts, [1.0, 2.0, 0.0]),
                               JaxProc.compute_covariance(pts, [1.0, 2.0, 0.0]),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(Proc.compute_pca(pts), JaxProc.compute_pca(pts)):
        np.testing.assert_allclose(np.abs(a), np.abs(b), rtol=1e-4, atol=1e-5)
    # degenerate sizes: the reference's sentinels
    for small in (np.zeros((0, 3), np.float32), pts[:1], pts[:2]):
        np.testing.assert_array_equal(Proc.compute_centroid(small[:0]),
                                      JaxProc.compute_centroid(small[:0]))
        np.testing.assert_array_equal(Proc.compute_covariance(small[:1]),
                                      JaxProc.compute_covariance(small[:1]))
        for a, b in zip(Proc.compute_pca(small), JaxProc.compute_pca(small)):
            np.testing.assert_array_equal(a, b)
    # XLA's CPU dot fuses multiply-adds; the port rounds each product
    plane = ([1.0, 2.0, 0.5], [0.1, 0.2, 0.97])
    np.testing.assert_allclose(Proc.compute_distances_to_plane(pts, *plane),
                               JaxProc.compute_distances_to_plane(pts, *plane),
                               rtol=1e-6, atol=1e-6)
    assert Proc.compute_point_to_plane_distance(
        [1.0, 2.0, 3.0], [0, 0, 0], [0, 0, 1]) == \
        JaxProc.compute_point_to_plane_distance([1.0, 2.0, 3.0], [0, 0, 0],
                                                [0, 0, 1]) == 3.0


def test_processor_sampling():
    pts = demo_point_cloud(4000, seed=4)
    sub = Proc.random_subsample(pts, 700, seed=5)
    assert sub.shape == JaxProc.random_subsample(pts, 700, seed=5).shape
    rows = {r.tobytes() for r in pts}
    assert all(r.tobytes() in rows for r in sub)
    assert len({r.tobytes() for r in sub}) == 700
    np.testing.assert_array_equal(Proc.random_subsample(pts, 700, seed=5), sub)
    np.testing.assert_array_equal(Proc.random_subsample(pts[:10], 700), pts[:10])
    got, want = Proc.voxel_grid_filter(pts, 2.0), JaxProc.voxel_grid_filter(pts, 2.0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(Proc.voxel_grid_filter(pts, 0.0), pts)


def test_processor_validity():
    pts = _cloud(200)
    assert Proc.is_valid_point(pts[1]) == JaxProc.is_valid_point(pts[1]) is True
    assert Proc.is_valid_point(pts[0]) == JaxProc.is_valid_point(pts[0]) is False
    assert Proc.has_valid_points(pts) == JaxProc.has_valid_points(pts) is False
    assert Proc.has_valid_points(pts[1:50]) is True


# ---- API -----------------------------------------------------------------

def test_api_static_utilities():
    pts = demo_point_cloud(3000, seed=6)
    np.testing.assert_array_equal(RecursivePatchwork.remove_ego_vehicle(pts, 4.0),
                                  JaxPatchwork.remove_ego_vehicle(pts, 4.0))
    for angle in (0.0, 37.5, -120.0, 90.0):
        np.testing.assert_array_equal(
            RecursivePatchwork.rotate_points_2d(pts, angle),
            JaxPatchwork.rotate_points_2d(pts, angle))


@pytest.mark.parametrize("scene", ["demo", "fused_iac"])
def test_sample_ground_and_obstacles(scene):
    pts = (demo_point_cloud(6000, seed=7) if scene == "demo"
           else fused_iac_cloud(6000, seed=1))
    cfg = dict(filtering_radius=60.0)
    rp = RecursivePatchwork(PatchworkConfig(**cfg))
    jp = JaxPatchwork(JaxConfig(**cfg))
    got = rp.sample_ground_and_obstacles(pts, 1.1, 0.5, seed=3)
    want = jp.sample_ground_and_obstacles(pts, 1.1, 0.5, seed=3)
    g, ng = jp.filter_ground_points(pts)
    ground = {r.tobytes() for r in g}
    band = ng[(np.hypot(ng[:, 0], ng[:, 1]) > np.float32(2.5))
              & (ng[:, 2] >= np.float32(0.6)) & (ng[:, 2] <= np.float32(1.6))]
    obst = np.array([r for r in got if r.tobytes() not in ground])
    jobst = np.array([r for r in want if r.tobytes() not in ground])
    np.testing.assert_array_equal(obst, jobst)      # the band, bit for bit
    np.testing.assert_array_equal(obst, band)
    n_sample = len(got) - len(obst)
    assert n_sample == min(2000, len(g)) == len(want) - len(jobst)
    np.testing.assert_array_equal(
        got, rp.sample_ground_and_obstacles(pts, 1.1, 0.5, seed=3))


# ---- containers, timing, debug, metrics ----------------------------------

def test_point_cloud_and_scan_batch():
    pts = demo_point_cloud(500, seed=8)
    t = types.PointCloud.from_numpy(pts, capacity=512)
    j = jtypes.PointCloud.from_numpy(pts, capacity=512)
    assert t.capacity == j.capacity == 512 and int(t.count()) == int(j.count())
    np.testing.assert_array_equal(t.xyz.numpy(), np.asarray(j.xyz))
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    b = types.ScanBatch.stack([t, types.PointCloud.from_numpy(pts[:5], 512)])
    assert (b.batch, b.capacity) == (2, 512) and int(b[1].count()) == 5
    with pytest.raises(ValueError):
        types.PointCloud.from_numpy(pts, capacity=10)
    with pytest.raises(ValueError):
        types.PointCloud.from_numpy(pts[:, :2])


def test_timing_helpers():
    st = timing.StageTimes()
    with st.time("a"):
        pass
    st.add("a", 0.002)
    st.add("b", 0.001)
    s = st.summary()
    assert s["a"]["count"] == 2 and s["b"]["max_ms"] == pytest.approx(1.0)
    assert "a" in st.report() and "b" in st.report()
    t = timing.Timer()
    assert t.elapsed() >= 0.0
    timing.sync({"x": [torch.zeros(3)], "r": None})
    with timing.trace_annotation("span"):
        torch.zeros(1).add_(1)


def test_assert_finite():
    res = types.GroundResult(*(torch.zeros(3, dtype=torch.bool),) * 4)
    debug.assert_finite({"a": [torch.ones(3), (torch.arange(3), res)]})
    with pytest.raises(FloatingPointError, match="1 NaN / 1 inf"):
        debug.assert_finite([torch.ones(2),
                             {"b": torch.tensor([0.0, np.nan, np.inf])}])


def test_metrics_equal_jax():
    rng = np.random.default_rng(9)
    pred, truth, valid = (rng.random(1000) > p for p in (0.4, 0.5, 0.1))
    assert metrics.mask_metrics(pred, truth, valid) == \
        jmetrics.mask_metrics(pred, truth, valid)
    m = metrics.mask_metrics(pred, truth)
    assert metrics.format_metrics(m) == jmetrics.format_metrics(m)


# ---- node ------------------------------------------------------------------

NODE_CAP = 4096


def _scans():
    scans = [demo_point_cloud(3000 + 200 * i, seed=i) for i in range(5)]
    scans[2] = scans[2][:50]                 # below min_points: dropped
    scans[3] = demo_point_cloud(5000, seed=9)  # beyond the capacity
    return scans


@pytest.fixture(scope="module")
def jax_node_results():
    out = {}
    for b in (1, 3):
        n = jnode.PatchworkNode(jnode.NodeParams(max_iterations=30),
                                capacity=NODE_CAP, batch_size=b)
        out[b] = n.run(_scans())
    return out


@pytest.mark.parametrize("batch_size", [1, 3])
def test_node_masks_match_jax(batch_size, jax_node_results):
    n = node.PatchworkNode(node.NodeParams(max_iterations=30),
                           capacity=NODE_CAP, batch_size=batch_size)
    seen = []
    got = n.run(_scans(), sinks=[lambda pts, r: seen.append(r.index)])
    want = jax_node_results[batch_size]
    assert [r.index for r in got] == [r.index for r in want] == [0, 1, 3, 4]
    assert seen == [0, 1, 3, 4]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ground_mask, np.asarray(b.ground_mask))
        np.testing.assert_array_equal(a.valid_mask, np.asarray(b.valid_mask))
        assert (a.num_ground, a.num_obstacles) == (b.num_ground, b.num_obstacles)
    stages = n.times.summary()
    assert stages["frame"]["count"] == 4
    assert {"h2d", "engine", "d2h"} <= set(stages)


def test_node_process_and_limit(jax_node_results):
    n = node.PatchworkNode(node.NodeParams(max_iterations=30),
                           capacity=NODE_CAP)
    scans = _scans()
    assert n.process(scans[2]) is None
    r = n.process(scans[1], index=1)
    want = jax_node_results[1][1]
    np.testing.assert_array_equal(r.ground_mask, np.asarray(want.ground_mask))
    pts = scans[1]
    assert len(r.ground_points(pts)) + len(r.obstacle_points(pts)) == len(pts)
    assert [x.index for x in n.run(scans, limit=2)] == [0, 1]


def test_node_params_mapping():
    p = node.NodeParams(max_iterations=17, distance_threshold=0.3,
                        angle_threshold=0.25)
    jp = jnode.NodeParams(**dataclasses.asdict(p))
    assert p.to_config().to_json() == jp.to_config().to_json()
    assert p.to_config().th_seeds == 0.25
    base = PatchworkConfig(num_sectors=12)
    assert p.to_config(base).to_json() == \
        jp.to_config(JaxConfig(num_sectors=12)).to_json()


# ---- launch -----------------------------------------------------------------

def _descriptor(tmp_path):
    doc = {"node": {"min_points": 100, "max_iterations": 40},
           "config": {"filtering_radius": 60.0, "num_sectors": 8},
           "source": {"demo": {"frames": 3, "points": 2500}, "limit": 2},
           "capacity": 4096, "out_prefix": str(tmp_path / "run")}
    path = tmp_path / "launch.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_launch_json_matches_jax(tmp_path):
    path = _descriptor(tmp_path)
    desc = launch.load_launch(path)
    assert desc.to_dict() == jlaunch.load_launch(path).to_dict()
    logs = []
    got, _ = launch.run_launch(desc, log=logs.append, device="cpu")
    g, v, ids = checkpoint.load_masks(str(tmp_path / "run_masks.npz"))
    want, _ = jlaunch.run_launch(jlaunch.load_launch(path), log=lambda s: None)
    assert len(got) == len(want) == 2 and any("Saved" in s for s in logs)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.ground_mask, np.asarray(b.ground_mask))
        np.testing.assert_array_equal(g[i], a.ground_mask)
    np.testing.assert_array_equal(ids, [0, 1])


def test_launch_rejects_bad_descriptors():
    with pytest.raises(ValueError):
        launch.LaunchDescription.from_dict({"source": {}})
    with pytest.raises(ValueError):
        launch.LaunchDescription.from_dict({"node": {"bogus": 1},
                                            "source": {"demo": {}}})


# ---- CLI --------------------------------------------------------------------

def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def _counts(text):
    return (int(re.search(r"Ground points: (\d+)", text).group(1)),
            int(re.search(r"Non-ground points: (\d+)", text).group(1)))


@pytest.mark.parametrize("extra", [[], ["--separate-display"]])
def test_cli_cpu_counts_match_jax(tmp_path, extra):
    prefix = str(tmp_path / "demo")
    rc, text = _run_cli(["--demo", "--num-points", "6000", "--seed", "2",
                         "--use-patchwork", "--device", "cpu",
                         "--out-prefix", prefix, *extra])
    assert rc == 0
    g, ng = JaxPatchwork().filter_ground_points(demo_point_cloud(6000, seed=2))
    assert _counts(text) == (len(g), len(ng))
    assert (tmp_path / "demo_patchwork.png").exists()
    assert (tmp_path / "demo_enhanced.png").exists() == bool(extra)


def test_cli_kitti_and_stream(tmp_path):
    d = tmp_path / "velo"
    d.mkdir()
    for i in range(2):
        pts = demo_point_cloud(3000, seed=10 + i)
        np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1).tofile(
            d / f"{i:06d}.bin")
    rc, text = _run_cli(["--kitti", str(d), "--frame", "1", "--use-patchwork",
                         "--device", "cpu", "--out-prefix", str(tmp_path / "k")])
    g, ng = JaxPatchwork().filter_ground_points(demo_point_cloud(3000, seed=11))
    assert rc == 0 and _counts(text) == (len(g), len(ng))
    rc, text = _run_cli(["--kitti", str(d), "--stream", "--device", "cpu",
                         "--out-prefix", str(tmp_path / "s")])
    assert rc == 0 and text.count("Processed frame") == 2
    assert checkpoint.load_masks(str(tmp_path / "s_masks.npz"))[0].shape[0] == 2


def test_cli_launch_and_bag_fusion(tmp_path):
    from patchwork_tpu_torch.core.config import default_lidar_configs
    from patchwork_tpu_torch.fusion.fusion import LidarFusion
    from patchwork_tpu_torch.io.bag import write_mcap_topics
    from patchwork_tpu_torch.io.synthetic import iac_three_lidar_scene

    rc, text = _run_cli(["--launch", _descriptor(tmp_path), "--device", "cpu"])
    assert rc == 0 and text.count("Processed frame") == 2
    clouds = iac_three_lidar_scene(1500, seed=0)
    bag = str(tmp_path / "iac.mcap")
    write_mcap_topics(bag, {c.topic_name + "/points": [x] for c, x in
                            zip(default_lidar_configs(), clouds)},
                      compression="none")
    rc, text = _run_cli([bag, "--use-patchwork", "--device", "cpu",
                         "--out-prefix", str(tmp_path / "b")])
    fused = LidarFusion().fuse(clouds).to_numpy()
    g, ng = JaxPatchwork().filter_ground_points(fused)
    assert rc == 0 and "Topics: /lidar_front/points" in text
    assert _counts(text) == (len(g), len(ng))


def test_cli_default_device_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--demo", "--use-patchwork"])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
