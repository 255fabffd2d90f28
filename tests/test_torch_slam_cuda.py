"""The port's SLAM back end on the card: BA's segment sums over a plan of
their ids (kernel #6) against the plain version bit for bit at the
1000-keyframe shape, and the entry points on the card against the CPU.

These tests need an NVIDIA GPU and skip without one; they import no JAX:

    python -m pytest --noconftest tests/test_torch_slam_cuda.py -q
"""

import numpy as np
import pytest
import torch

from patchwork_tpu_torch.io.synthetic import simulate_sequence, simulate_world
from patchwork_tpu_torch.kernels import fit_cuda
from patchwork_tpu_torch.slam import (BAProblem, LidarOdometry,
                                      OdometryConfig, PoseGraph, ba,
                                      bundle_adjust, icp_ground_constrained,
                                      optimize_pose_graph, se3_exp)
from patchwork_tpu_torch import PatchworkConfig

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from patchwork_tpu_torch.core.device import cuda_device

    return cuda_device()


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality, -0.0 != +0.0 and NaN payloads included."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _plain_sums(vals, ids, n):
    """What ba._make_seg_sums("onehot") computes, by seg_sum_plain."""
    ids_p = fit_cuda._pad_ids(ids.int()[None])
    rows = ba._tile_rows(vals, ids_p.shape[1])
    out = torch.cat([fit_cuda.seg_sum_plain(rows[c0:c0 + 8][None], ids_p,
                                            n)[0]
                     for c0 in range(0, rows.shape[0], 8)])
    return out.T.reshape((n,) + vals.shape[1:])


@pytest.mark.parametrize("binding", ["obs_k", "obs_l", "pairs"])
def test_ba_planned_sums_bitwise_at_1000kf(dev, binding):
    # K = 1000 keyframes, L = 400 landmarks, O = 206000 observations:
    # keyframe ids in runs (a keyframe's observations come together),
    # landmark ids scattered, so a landmark's chain spans ~805 tiles; and
    # 20000 ids for (keyframe, landmark) pairs, more than the plan's shared
    # table holds
    rng = np.random.default_rng(0)
    o, k, l = 206000, 1000, 400
    n = {"obs_k": k, "obs_l": l, "pairs": 20000}[binding]
    ids = (np.arange(o) // (o // k) if binding == "obs_k"
           else rng.integers(0, n, o)).astype(np.int32)
    vals = torch.from_numpy(rng.normal(0, 1, (o, 6, 6)).astype(np.float32))
    before = dict(fit_cuda.LAUNCHES)
    seg = ba._make_seg_sums(torch.from_numpy(ids).to(dev), n)
    got = [seg(vals.to(dev)) for _ in range(2)]
    assert fit_cuda.LAUNCHES["seg_plan"] - before["seg_plan"] == 1
    # 36 channels, eight a launch, twice
    assert fit_cuda.LAUNCHES["seg_sum"] - before["seg_sum"] == 10
    want = _plain_sums(vals.to(dev), torch.from_numpy(ids).to(dev), n)
    assert _equal(got[0], want) and _equal(got[1], want)
    # the plain version adds in the same order on the CPU
    assert _equal(got[0].cpu(), _plain_sums(vals, torch.from_numpy(ids), n))


def _ba_arrays(k=8, l=60, seed=11):
    rng = np.random.default_rng(seed)
    xi = np.zeros((k, 6), np.float32)
    xi[:, 0] = np.arange(k)
    xi[:, 5] = 0.05 * np.arange(k)
    gt = se3_exp(torch.from_numpy(xi)).numpy()
    pts = rng.uniform(-10, 10, (l, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 3.0, l)
    ok, ol, op = [], [], []
    for ki in range(k):
        inv = np.linalg.inv(gt[ki])
        for li in rng.permutation(l)[: int(0.8 * l)]:
            ok.append(ki)
            ol.append(li)
            op.append(inv[:3, :3] @ pts[li] + inv[:3, 3]
                      + rng.normal(0, 0.01, 3))
    init = gt.copy()
    init[1:] = init[1:] @ se3_exp(torch.from_numpy(
        rng.normal(0, 0.05, (k - 1, 6)).astype(np.float32))).numpy()
    return (init, pts + rng.normal(0, 0.1, pts.shape).astype(np.float32),
            np.array(ok), np.array(ol), np.array(op, np.float32),
            np.ones(len(ok), np.float32))


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_bundle_adjust_on_card(dev, solver):
    arrays = _ba_arrays()
    pc = BAProblem.from_numpy(*arrays, device="cpu")
    pd = BAProblem.from_numpy(*arrays)
    assert pd.poses.is_cuda
    before = fit_cuda.LAUNCHES["seg_sum"]
    runs = [bundle_adjust(pd, iters=4, solver=solver) for _ in range(2)]
    assert fit_cuda.LAUNCHES["seg_sum"] > before
    assert _equal(runs[0].poses, runs[1].poses)
    assert _equal(runs[0].points, runs[1].points)
    cpu = bundle_adjust(pc, iters=4, solver=solver, seg_impl="onehot")
    np.testing.assert_allclose(runs[0].poses.cpu().numpy(),
                               cpu.poses.numpy(), atol=1e-4)


def test_icp_and_pose_graph_on_card(dev):
    rng = np.random.default_rng(3)
    obst = rng.uniform(-20, 20, (2, 700, 3)).astype(np.float32)
    ground = rng.uniform(-20, 20, (2, 500, 3)).astype(np.float32)
    ground[..., 2] = 0.0
    shift = np.array([0.3, -0.2, 0.0], np.float32)
    args = [obst + shift, np.ones((2, 700), bool), ground + shift,
            np.ones((2, 500), bool), obst, np.ones((2, 700), bool), ground,
            np.ones((2, 500), bool)]
    on = icp_ground_constrained(*[torch.from_numpy(a).to(dev) for a in args])
    off = icp_ground_constrained(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(on.transform.cpu().numpy(),
                               off.transform.numpy(), atol=1e-4)
    k = 20
    step = se3_exp(torch.tensor([1.0, 0, 0, 0, 0, 0.1])).numpy()
    poses = np.stack([np.linalg.matrix_power(step, i) for i in range(k)])
    ei = np.r_[np.arange(k - 1), 0].astype(np.int32)
    ej = np.r_[np.arange(1, k), k - 1].astype(np.int32)
    eT = np.stack([np.linalg.inv(poses[i]) @ poses[j] for i, j in zip(ei, ej)])
    info = np.tile(np.eye(6, dtype=np.float32) * 100, (k, 1, 1))
    noisy = poses.copy()
    noisy[1:, 0, 3] += rng.normal(0, 0.05, k - 1)
    for solver in ("dense", "cg"):
        gd = optimize_pose_graph(PoseGraph.from_numpy(noisy, ei, ej, eT, info),
                                 iters=4, solver=solver)
        gc = optimize_pose_graph(PoseGraph.from_numpy(noisy, ei, ej, eT, info,
                                                      device="cpu"),
                                 iters=4, solver=solver)
        assert gd.poses.is_cuda
        np.testing.assert_allclose(gd.poses.cpu().numpy(), gc.poses.numpy(),
                                   atol=1e-4)


def test_odometry_lands_on_the_card(dev):
    world = simulate_world(seed=2, num_pillars=50)
    scans, gt = simulate_sequence(num_frames=4, seed=2, world=world,
                                  step_xy=0.8, sensor_noise=0.01)
    odo = LidarOdometry(
        PatchworkConfig(filtering_radius=80.0, max_levels=1),
        OdometryConfig(capacity=32768, obstacle_samples=1024,
                       ground_samples=512))
    assert odo.device.type == "cuda"
    before = dict(fit_cuda.LAUNCHES)
    odo.add_scans(scans, parallel_icp=True)
    assert odo._frames.stacked["obst"].is_cuda
    assert fit_cuda.LAUNCHES["level"] > before["level"]
    assert odo.trajectory_error(gt) < 0.15
