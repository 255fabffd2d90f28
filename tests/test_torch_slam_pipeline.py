"""The port's SLAM pipeline against the JAX package, on the CPU:
landmark extraction and association, the synthetic drive, odometry
checkpoints, the odometry itself, loop closures, BA refinement and the map.

The same NumPy inputs go through ``patchwork_tpu`` (JAX on the CPU) and
``patchwork_tpu_torch`` (``device="cpu"``: the plain versions of the
kernels).  Each scan's sample comes from a ``torch.Generator``, not JAX's
threefry, so trajectories are compared by ATE, not bit for bit.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from patchwork_tpu.core.config import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.io import synthetic as jsyn  # noqa: E402
from patchwork_tpu.slam import landmarks as jlm  # noqa: E402
from patchwork_tpu.slam import se3 as jse3  # noqa: E402
from patchwork_tpu.slam.odometry import (  # noqa: E402
    LidarOdometry as JaxOdometry, OdometryConfig as JaxOdoConfig)
from patchwork_tpu.utils import checkpoint as jckpt  # noqa: E402
from patchwork_tpu_torch import PatchworkConfig  # noqa: E402
from patchwork_tpu_torch.io import synthetic as tsyn  # noqa: E402
from patchwork_tpu_torch.slam import landmarks as tlm  # noqa: E402
from patchwork_tpu_torch.slam import mapping as tmap  # noqa: E402
from patchwork_tpu_torch.slam.odometry import (  # noqa: E402
    LidarOdometry, OdometryConfig)
from patchwork_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# landmarks, synthetic data, checkpoints
# ---------------------------------------------------------------------------

def _obstacle_stack(k=6, c=2048, seed=4):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-60, 60, (60, 2)).astype(np.float32)
    pts = np.zeros((k, c, 3), np.float32)
    pts[:, :, :2] = centers[rng.integers(0, 60, (k, c))] + rng.normal(
        0, 0.3, (k, c, 2))
    pts[:, :, 2] = rng.uniform(0.0, 3.0, (k, c))
    valid = rng.random((k, c)) < 0.8
    valid[3] = False                      # an empty keyframe
    pts[~valid] = 0.0
    return pts, valid


def test_extract_observations_matches_jax():
    pts, valid = _obstacle_stack()
    cj, nj, rj = (np.asarray(a) for a in jlm.make_extract_observations_batched()(
        jnp.asarray(pts), jnp.asarray(valid)))
    ct, nt, rt = (a.numpy() for a in tlm.make_extract_observations_batched()(
        _t(pts), _t(valid)))
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(rt, rj)
    assert nt[3] == 0
    for i in range(len(pts)):
        np.testing.assert_allclose(ct[i, :nt[i]], cj[i, :nj[i]], rtol=1e-6,
                                   atol=1e-6)
        host_t = tlm.extract_observations(pts[i][valid[i]])
        host_j = jlm.extract_observations(pts[i][valid[i]])
        np.testing.assert_array_equal(host_t, host_j)
        np.testing.assert_allclose(np.sort(host_t, 0), np.sort(ct[i, :nt[i]], 0),
                                   rtol=1e-5, atol=1e-4)


def test_build_ba_problem_equal_arrays():
    rng = np.random.default_rng(6)
    world = rng.uniform(-30, 30, (200, 3)).astype(np.float32)
    k = 12
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 20, k)
    obs = []
    for i in range(k):
        sel = world[rng.random(len(world)) < 0.3]
        obs.append((sel - poses[i][:3, 3]
                    + rng.normal(0, 0.05, sel.shape)).astype(np.float32))
    obs[5] = np.zeros((0, 3), np.float32)
    pj, nj = jlm.build_ba_problem(poses, obs, gate=1.0)
    pt, nt = tlm.build_ba_problem(poses, obs, gate=1.0, device=CPU)
    assert nt == nj and nt > 100
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assoc_t, assoc_j = tlm._BatchedAssociator(1.0), jlm._BatchedAssociator(1.0)
    for o in obs:
        w = (o + poses[0][:3, 3]).astype(np.float32)
        np.testing.assert_array_equal(assoc_t.associate(w),
                                      assoc_j.associate(w))


@pytest.mark.parametrize("what", ["world", "sequence"])
def test_simulate_bitwise(what):
    if what == "world":
        for kw in ({}, {"seed": 3, "num_pillars": 70}):
            np.testing.assert_array_equal(tsyn.simulate_world(**kw),
                                          jsyn.simulate_world(**kw))
        return
    st, gt_t = tsyn.simulate_sequence(num_frames=4, seed=2, step_xy=0.8)
    sj, gt_j = jsyn.simulate_sequence(num_frames=4, seed=2, step_xy=0.8)
    np.testing.assert_array_equal(gt_t, gt_j)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)


class _Odo:
    """The attributes the checkpoint reads."""

    def __init__(self, pw, cfg, poses, edges):
        self.pw, self.cfg, self.poses, self.edges = pw, cfg, poses, edges


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(8)
    poses = [np.asarray(jse3.se3_exp(jnp.asarray(x)))
             for x in rng.normal(0, 0.3, (5, 6)).astype(np.float32)]
    edges = [(i, i + 1, poses[i]) for i in range(4)] + [(0, 4, poses[2])]
    pwj = JaxConfig(filtering_radius=80.0, max_levels=1)
    path = str(tmp_path / "odo.npz")
    jckpt.save_odometry(path, _Odo(pwj, JaxOdoConfig(capacity=32768), poses,
                                   edges), extra={"run": "x"})
    p, e, cfg = tckpt.load_odometry(path)
    np.testing.assert_array_equal(p, np.stack(poses))
    assert [(i, j) for i, j, _ in e] == [(i, j) for i, j, _ in edges]
    for (_, _, a), (_, _, b) in zip(e, edges):
        np.testing.assert_array_equal(a, b)
    assert isinstance(cfg, PatchworkConfig)
    assert cfg.to_json() == PatchworkConfig(filtering_radius=80.0,
                                            max_levels=1).to_json()
    # and back: the port writes what the JAX package reads
    path2 = str(tmp_path / "odo_port.npz")
    tckpt.save_odometry(path2, _Odo(cfg, OdometryConfig(capacity=32768),
                                    list(p), e))
    p2, e2, cfg2 = jckpt.load_odometry(path2)
    np.testing.assert_array_equal(p2, p)
    assert cfg2 == pwj and len(e2) == len(e)


# ---------------------------------------------------------------------------
# the odometry pipeline
# ---------------------------------------------------------------------------

def _drive_config(port=True):
    pw = (PatchworkConfig if port else JaxConfig)(filtering_radius=80.0,
                                                  max_levels=2)
    cfg = (OdometryConfig if port else JaxOdoConfig)(
        capacity=32768, obstacle_samples=1024, ground_samples=512,
        icp_iters=10)
    return pw, cfg


def test_simulated_drive_both_packages():
    """tests/test_slam.py's 6-frame drive through both packages: each ATE
    under 0.15 m, and the port's parallel ICP within 1 mm of its chain;
    then the port's loop closures, graph, BA and map on the same session."""
    world = tsyn.simulate_world(seed=2, num_pillars=50)
    scans, gt = tsyn.simulate_sequence(num_frames=6, seed=2, world=world,
                                       step_xy=0.8, sensor_noise=0.01)
    jodo = JaxOdometry(*_drive_config(port=False))
    for i, s in enumerate(scans):
        jodo.add_scan(s, seed=i)
    assert jodo.trajectory_error(gt) < 0.15
    seq = LidarOdometry(*_drive_config(), device=CPU)
    seq.add_scans(scans)
    par = LidarOdometry(*_drive_config(), device=CPU)
    par.add_scans(scans, parallel_icp=True)
    assert seq.trajectory_error(gt) < 0.15
    assert par.trajectory_error(gt) < 0.15
    d = np.abs(np.stack(seq.poses) - np.stack(par.poses))[:, :3, 3].max()
    assert d < 1e-3, d
    with pytest.raises(ValueError):
        par.add_scans(scans[:2], parallel_icp=True)
    seq.add_loop_closure(0, 5)
    assert len(seq.edges) == 6
    acc = par.detect_loop_closures(radius=5.0, min_separation=4,
                                   min_inliers=100, pair_chunk=2)
    assert acc and all(j - i >= 4 for i, j in acc)
    assert len(par.edges) == 5 + len(acc)
    for odo in (seq, par):
        odo.optimize(iters=4, max_degree=2)
        assert odo.trajectory_error(gt) < 0.15
    timings = {}
    tlm.refine_with_ba(par, iters=2, timings=timings)
    assert timings["n_obs"] > 100 and par.trajectory_error(gt) < 0.15
    m = tmap.build_map(par)
    assert len(m["points"]) == len(m["classes"]) > 1000
    assert m["trajectory"].shape == (6, 3)
    assert set(np.unique(m["classes"])) == {0, 1}


def test_scan_sample_depends_on_its_own_seed():
    world = tsyn.simulate_world(seed=2, num_pillars=50)
    scans, _ = tsyn.simulate_sequence(num_frames=3, seed=2, world=world)
    pw, _ = _drive_config()
    cfg = OdometryConfig(capacity=24576, obstacle_samples=256,
                         ground_samples=128)
    odo = LidarOdometry(pw, cfg, device=CPU)
    xyz, valid = zip(*[odo._pad_host(s) for s in scans])
    xyz, valid = _t(np.stack(xyz)), _t(np.stack(valid))
    batch = odo._extract(xyz, valid, [7, 8, 9])
    alone = odo._extract(xyz[2:], valid[2:], [9])
    for a, b in zip(batch, alone):
        assert torch.equal(a[2], b[0])
    assert batch[1].sum() == 3 * 256 and batch[3].sum() == 3 * 128


def test_build_map_empty_odometry(tmp_path):
    odo = LidarOdometry(device=CPU)
    m = tmap.build_map(odo)
    assert m["points"].shape == (0, 3) and m["classes"].shape == (0,)
    assert m["trajectory"].shape == (0, 3) and m["poses"].shape == (0, 4, 4)
    assert tmap.save_map_ply(str(tmp_path / "m.ply"), odo) == 0
