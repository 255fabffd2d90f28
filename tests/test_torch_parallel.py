"""The port's multi-process execution (``patchwork_tpu_torch.parallel`` and
sharded bundle adjustment) against the JAX package, on the CPU.

Single-process tests use a world-size-1 gloo group on a ``FileStore`` in
``tmp_path``.  The multi-process tests run ``tools/torch_multihost_bench.py``
once, four gloo processes (a (2, 2) mesh for the point-sharded engines, a
(4, 1) mesh for the scan-sharded engine and bundle adjustment), on inputs
this module makes from seeds and hands over as ``.npz``; the spawned workers
import neither JAX nor this suite's conftest.  The JAX package runs the
same inputs on its virtual 8-device CPU mesh.  Tolerances, with their
reasons:

* masks: 0 differing bits against the JAX package's sharded engines, its
  single-device engine and the oracle (tests/test_parallel.py,
  tests/test_shardmap.py); the all-above-z_th scene of
  tests/test_shardmap.py is held bit for bit to the port's own
  single-device engines, as the JAX test holds it to the JAX package's
  (across packages it is the 3-point-seed exception, ROADMAP.md queue 3);
* bundle adjustment: poses within 5e-3 (dense) and 1e-3 (PCG) of the JAX
  package's sharded solver, as tests/test_ba.py holds the JAX package's
  sharded solver to its own; within the tool's ``ONE_PROCESS_TOL`` (1e-4
  dense, 1e-3 PCG) of the port's one-process solve, which is tighter
  where sound runs allow it, so that a partition fault that every rank
  shares (ranks summing the same block) fails;
* the free segment functions: min and max bit for bit; the sum bit for bit
  where its fixed order is ``jax.ops.segment_sum``'s (a segment's points
  in one tile of 256) or where every partial sum is exact, and within 1e-6
  relative elsewhere.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.io.synthetic import demo_point_cloud  # noqa: E402
from patchwork_tpu.oracle.reference import filter_ground_oracle  # noqa: E402
from patchwork_tpu.parallel import mesh as jmesh  # noqa: E402
from patchwork_tpu.parallel import sharded as jsharded  # noqa: E402
from patchwork_tpu.parallel.shardmap_engine import (  # noqa: E402
    make_shardmap_patchwork as jax_shardmap_patchwork)
from patchwork_tpu.segment.engine import (  # noqa: E402
    make_filter_ground as jax_make_filter_ground)
from patchwork_tpu.slam import ba as jba  # noqa: E402
from patchwork_tpu.slam import se3 as jse3  # noqa: E402

import torch.distributed as dist  # noqa: E402
from patchwork_tpu_torch import (  # noqa: E402
    PatchworkConfig, filter_ground_batched, make_filter_ground,
    make_filter_ground_batched)
from patchwork_tpu_torch.core import device as tdevice  # noqa: E402
from patchwork_tpu_torch.io.synthetic import split_terrain_cloud  # noqa: E402
from patchwork_tpu_torch.parallel import (  # noqa: E402
    host_summary, initialize_multihost, is_multihost, make_mesh,
    make_sharded_filter_ground, make_sharded_pipeline, make_shardmap_fused,
    make_shardmap_patchwork, replicated, scan_batch_sharding)
from patchwork_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from patchwork_tpu_torch.segment import segops  # noqa: E402
from patchwork_tpu_torch.slam import ba as tba  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_multihost_bench.py")
CFG = dict(filtering_radius=60.0, max_levels=3)
CFG_PW = dict(filtering_radius=60.0)
PROCS, BATCH, POINTS, BA_ITERS = 4, 4, 2048, 4
SPLIT_POINTS = 8192   # the split-heavy batch: 2 scans
BA_TOL = {"dense": 5e-3, "pcg": 1e-3}
sys.path.insert(0, os.path.join(REPO, "tools"))
from torch_multihost_bench import ONE_PROCESS_TOL  # noqa: E402
BA_SHAPES = {"dense": (6, 24), "pcg": (8, 32)}   # tests/test_ba.py's
TIE = BATCH - 1   # the explicit engine's all-above-z_th scan


@pytest.fixture
def group(tmp_path):
    """A world-size-1 gloo group, left again at teardown."""
    assert initialize_multihost(f"file://{tmp_path}/store", 1, 0,
                                backend="gloo")
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_multihost_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert is_multihost() is False
    assert "process 0/1" in host_summary()


def test_multihost_summary_in_group(group):
    assert is_multihost() is False
    assert host_summary() == "process 0/1: 1 local / 1 global devices"


def test_make_mesh(group):
    with pytest.raises(ValueError, match="dp\\*sp"):
        make_mesh(1, dp=2, sp=1, device_type="cpu")
    with pytest.raises(ValueError, match="world size"):
        make_mesh(2, dp=2, sp=1, device_type="cpu")
    m = make_mesh(device_type="cpu")
    assert m.mesh_dim_names == ("dp", "sp") and tuple(m.mesh.shape) == (1, 1)


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh(1, device_type="cpu")


def test_layouts_and_collectives_one_rank(group):
    m = make_mesh(device_type="cpu")
    t = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    for layout in (scan_batch_sharding(m), scan_batch_sharding(m, False),
                   replicated(m)):
        assert torch.equal(layout.join(layout.cut(t)), t)
    g = m.get_group("sp")
    x = torch.randn(5, 3)
    assert torch.equal(tmesh.ordered_sum(x, g), x)
    assert torch.equal(tmesh.all_min(x, g), x)
    assert torch.equal(tmesh.all_max(x, g), x)
    assert tmesh.replicated_max_diff(x, g) == 0.0


def test_device_introspection_without_a_card():
    have = torch.cuda.is_available()
    assert tdevice.accelerator_available() is have
    assert tdevice.initialize() is have
    tdevice.cleanup()
    if not have:
        assert tdevice.device_info() == []


def _seg_inputs(n, c, s, seed, integer=False):
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 10, (n, c) if c else (n,)).astype(np.float32)
    if integer:
        data = np.round(data).astype(np.float32)
    seg = rng.integers(0, s - 2, n).astype(np.int32)   # the last two empty
    return data, seg


@pytest.mark.parametrize("which", ["min", "max"])
@pytest.mark.parametrize("c", [0, 3, 11])
def test_free_seg_minmax_bitwise(which, c):
    data, seg = _seg_inputs(3000, c, 40, seed=c)
    jfn = getattr(jax.ops, f"segment_{which}")
    want = np.asarray(jfn(jnp.asarray(data), jnp.asarray(seg),
                          num_segments=40))
    got = getattr(segops, f"seg_{which}")(torch.from_numpy(data),
                                          torch.from_numpy(seg), 40).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,c,integer", [(200, 0, False), (256, 5, False),
                                         (5000, 0, True), (5000, 11, True)])
def test_free_seg_sum_bitwise(n, c, integer):
    data, seg = _seg_inputs(n, c, 40, seed=n + c, integer=integer)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg),
                                          num_segments=40))
    got = segops.seg_sum(torch.from_numpy(data), torch.from_numpy(seg),
                         40).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_free_seg_sum_many_tiles():
    data, seg = _seg_inputs(5000, 4, 40, seed=7)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg),
                                          num_segments=40))
    got = segops.seg_sum(torch.from_numpy(data), torch.from_numpy(seg), 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    # the plain version of kernel #6, in its tile order, bit for bit
    from patchwork_tpu_torch.kernels import fit_cuda

    rows = torch.from_numpy(data).T.contiguous()[None]
    plain = fit_cuda.seg_sum_plain(rows, torch.from_numpy(seg)[None], 40)
    assert torch.equal(got, plain[0].T)


@pytest.mark.parametrize("impl", [None, "scatter"])
def test_make_filter_ground_matches_jax(impl):
    cfg, jcfg = PatchworkConfig(**CFG), JaxConfig(**CFG)
    xyz = np.stack([demo_point_cloud(POINTS, seed=i) for i in range(2)])
    valid = np.ones(xyz.shape[:2], bool)
    single = jax_make_filter_ground(jcfg, impl="scatter")
    want = np.stack([np.asarray(single(jnp.asarray(x), jnp.asarray(v)).ground)
                     for x, v in zip(xyz, valid)])
    batched = make_filter_ground_batched(cfg, impl=impl)(
        torch.from_numpy(xyz), torch.from_numpy(valid)).ground.numpy()
    one = make_filter_ground(cfg, impl=impl)(
        torch.from_numpy(xyz[1]), torch.from_numpy(valid[1])).ground.numpy()
    np.testing.assert_array_equal(batched, want)
    np.testing.assert_array_equal(one, want[1])


def test_explicit_engine_restrictions(group):
    m = make_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="single-level configs only"):
        make_shardmap_patchwork(PatchworkConfig(), m)
    with pytest.raises(ValueError, match="adaptive seeds only"):
        make_shardmap_patchwork(
            PatchworkConfig.patchwork(adaptive_seed_height=False), m)


def test_one_rank_engines_equal_the_engine(group):
    """On one rank every sharded entry point is the unsharded computation."""
    m = make_mesh(device_type="cpu")
    cfg = PatchworkConfig(**CFG)
    xyz = torch.from_numpy(np.stack([demo_point_cloud(POINTS, seed=i)
                                     for i in range(2)]))
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool)
    want = filter_ground_batched(xyz, valid, cfg).ground
    res, g_cnt, ng_cnt = make_shardmap_fused(cfg, m, with_counts=True)(
        xyz, valid)
    assert torch.equal(res.ground, want)
    assert torch.equal(g_cnt, want.sum(1, dtype=torch.int32))
    res, g_cnt, _ = make_sharded_pipeline(cfg, m)(xyz, valid)
    assert torch.equal(res.ground, filter_ground_batched(
        xyz, valid, cfg.replace(segment_impl="scatter")).ground)
    assert torch.equal(g_cnt, res.ground.sum(1, dtype=torch.int32))
    cfg_pw = PatchworkConfig.patchwork(**CFG_PW)
    assert torch.equal(make_shardmap_patchwork(cfg_pw, m)(xyz, valid),
                       filter_ground_batched(xyz, valid, cfg_pw).ground)


def _ba_arrays(k, l, seed):
    """tests/test_ba.py's problem: every keyframe sees every landmark,
    padded to a multiple of 8 with obs_w = 0, perturbed from ground
    truth."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((k, 6), np.float32)
    xi[:, 0] = np.arange(k)
    xi[:, 5] = 0.05 * np.arange(k)
    gt = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    pts = rng.uniform(-10, 10, (l, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 3.0, l)
    inv = np.linalg.inv(gt)
    ok = np.repeat(np.arange(k), l)
    ol = np.tile(np.arange(l), k)
    op = (np.einsum("oij,oj->oi", inv[ok, :3, :3], pts[ol]) + inv[ok, :3, 3]
          + rng.normal(0, 0.01, (k * l, 3)))
    pad = (-(k * l)) % 8
    w = np.r_[np.ones(k * l), np.zeros(pad)].astype(np.float32)
    ok = np.r_[ok, np.zeros(pad)].astype(np.int32)
    ol = np.r_[ol, np.zeros(pad)].astype(np.int32)
    op = np.concatenate([op, np.zeros((pad, 3))]).astype(np.float32)
    pert = rng.normal(0, 0.05, (k, 6)).astype(np.float32)
    init = gt.copy()
    init[1:] = init[1:] @ np.asarray(jse3.se3_exp(jnp.asarray(pert[1:])))
    pts0 = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    return (init.astype(np.float32), pts0, ok, ol, op, w)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_one_rank_sharded_ba_equals_bundle_adjust(group, solver):
    m = make_mesh(device_type="cpu")
    prob = tba.BAProblem.from_numpy(*_ba_arrays(*BA_SHAPES[solver], seed=3),
                                    device="cpu")
    a = tba.bundle_adjust_sharded(prob, m, iters=3, solver=solver)
    b = tba.bundle_adjust(prob, iters=3, solver=solver)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)
    with pytest.raises(ValueError, match="unknown solver"):
        tba.bundle_adjust_sharded(prob, m, solver="qr")


def test_refine_with_ba_takes_a_mesh(group):
    """refine_with_ba(mesh=) routes to the sharded solver: on one rank its
    poses equal the one-process refinement's, bit for bit."""
    from patchwork_tpu_torch.io import synthetic as tsyn
    from patchwork_tpu_torch.slam import LidarOdometry, OdometryConfig
    from patchwork_tpu_torch.slam import landmarks as tlm

    world = tsyn.simulate_world(seed=2, num_pillars=50)
    scans, _ = tsyn.simulate_sequence(num_frames=4, seed=2, world=world,
                                      step_xy=0.8, sensor_noise=0.01)
    odo = LidarOdometry(
        PatchworkConfig(filtering_radius=80.0, max_levels=1),
        OdometryConfig(capacity=32768, obstacle_samples=1024,
                       ground_samples=512, icp_iters=6), device="cpu")
    odo.add_scans(scans, parallel_icp=True)
    twin = copy.deepcopy(odo)
    t_mesh, t_one = {}, {}
    a = tlm.refine_with_ba(odo, iters=2, mesh=make_mesh(device_type="cpu"),
                           timings=t_mesh)
    b = tlm.refine_with_ba(twin, iters=2, timings=t_one)
    assert t_mesh["n_obs"] == t_one["n_obs"] > 50
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# four processes: tools/torch_multihost_bench.py
# ---------------------------------------------------------------------------

def _tie_scene(n=2048):
    """tests/test_shardmap.py's scene: every point above z_th, so the
    3-lowest fallback must pick the global lowest indices across shards."""
    rng = np.random.default_rng(9)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = rng.uniform(2, 40, n)
    pts[:, 1] = rng.uniform(-40, 40, n)
    pts[:, 2] = rng.uniform(1.6, 3.5, n)
    return pts


@pytest.fixture(scope="module")
def inputs():
    xyz = np.stack([demo_point_cloud(POINTS, seed=i) for i in range(BATCH)])
    xyz_pw = np.stack([demo_point_cloud(POINTS, seed=100 + i)
                       for i in range(BATCH - 1)] + [_tie_scene()])
    xyz_split = np.stack([split_terrain_cloud(SPLIT_POINTS, 7 + i)
                          for i in range(2)])
    arrays = {"xyz": xyz, "valid": np.ones(xyz.shape[:2], bool),
              "xyz_pw": xyz_pw, "valid_pw": np.ones(xyz_pw.shape[:2], bool),
              "xyz_split": xyz_split}
    for solver, (k, l) in BA_SHAPES.items():
        for key, a in zip(("poses", "points", "obs_k", "obs_l", "obs_p",
                           "obs_w"), _ba_arrays(k, l, seed=k)):
            arrays[f"ba_{solver}_{key}"] = a
    return arrays


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    """One run of the tool: (its document, rank 0's arrays)."""
    tmp = tmp_path_factory.mktemp("multihost")
    np.savez(tmp / "in.npz", **inputs)
    proc = subprocess.run(
        [sys.executable, TOOL, "--procs", str(PROCS), "--device", "cpu",
         "--backend", "gloo", "--batch", str(BATCH), "--points", str(POINTS),
         "--inputs", str(tmp / "in.npz"), "--config-json", json.dumps(CFG),
         "--pw-config-json", json.dumps(CFG_PW), "--ba-iters", str(BA_ITERS),
         "--timeout", "240", "--json-out", str(tmp / "out.json"),
         "--arrays-out", str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:] + proc.stdout[-2000:]
    doc = json.loads((tmp / "out.json").read_text())
    return doc, dict(np.load(tmp / "out.npz"))


def _jax_mesh(dp, sp):
    return jmesh.make_mesh(dp * sp, dp=dp, sp=sp)


def _oracle(xyz, cfg):
    return np.stack([filter_ground_oracle(x, cfg)[0] for x in xyz])


def test_workers_agree_with_one_process(run):
    doc, _ = run
    assert doc["all_ok"] and len(doc["workers"]) == PROCS
    for r, w in enumerate(doc["workers"]):
        assert w["summary"] == f"process {r}/{PROCS}: 1 local / {PROCS} " \
                               "global devices"
        assert w["mesh_sp"] == [2, 2] and w["sp_impl"] == "scatter"
        for key in ("dp", "pipeline", "sp", "sp_pct", "sp_split", "explicit",
                    "explicit_vs_engine"):
            assert w[f"{key}_bit_errors"] == 0, (r, key)
        assert w["pipeline_count_errors"] == 0
        # the split-heavy batch remapped and took its medians across the sp
        # pair, five histogram rounds each; the percentile arm its seeds
        os_split, os_pct = w["order_stats"]["sp_split"], w["order_stats"][
            "sp_pct"]
        assert os_split["median"] >= 2 and os_split["percentile"] == 0
        assert os_split["histograms"] == 5 * os_split["median"]
        assert os_pct["percentile"] >= 1
        assert os_pct["histograms"] == 5 * (os_pct["percentile"]
                                            + os_pct["median"])
        assert w["order_stats"]["sp"]["histograms"] == 5 * w["order_stats"][
            "sp"]["median"]


@pytest.mark.parametrize("engine", ["dp", "pipeline", "sp", "sp_pct",
                                    "sp_split"])
def test_sharded_engines_match_jax_and_oracle(run, inputs, engine):
    """sp: the point-sharded engine on the engines' batch; sp_pct: the same
    with percentile seeds (adaptive_seed_height=False); sp_split: on the
    split-heavy batch under the default configuration (remap levels, the
    median across ranks)."""
    _, out = run
    jcfg = JaxConfig(**CFG)
    xyz, valid = jnp.asarray(inputs["xyz"]), jnp.asarray(inputs["valid"])
    if engine == "sp_pct":
        jcfg = JaxConfig(**CFG, adaptive_seed_height=False)
    elif engine == "sp_split":
        jcfg = JaxConfig()
        xyz = jnp.asarray(inputs["xyz_split"])
        valid = jnp.ones(xyz.shape[:2], bool)
    m = _jax_mesh(2, 2)
    if engine == "pipeline":
        res, g_cnt, _ = jsharded.make_sharded_pipeline(
            jcfg, m, shard_points=False)(xyz, valid)
        np.testing.assert_array_equal(np.asarray(g_cnt),
                                      out[engine].sum(1))
    else:
        res = jsharded.make_sharded_filter_ground(
            jcfg, m, shard_points=engine.startswith("sp"))(xyz, valid)
    np.testing.assert_array_equal(out[engine], np.asarray(res.ground))
    np.testing.assert_array_equal(out[engine], _oracle(np.asarray(xyz), jcfg))


def test_explicit_engine_matches_jax(run, inputs):
    _, out = run
    jcfg = JaxConfig.patchwork(**CFG_PW)
    xyz, valid = inputs["xyz_pw"], inputs["valid_pw"]
    want = np.asarray(jax_shardmap_patchwork(jcfg, _jax_mesh(2, 2))(
        jnp.asarray(xyz), jnp.asarray(valid)))
    np.testing.assert_array_equal(out["explicit"][:TIE], want[:TIE])


@pytest.mark.parametrize("scan", range(BATCH))
def test_explicit_engine_matches_single_device(run, inputs, scan):
    """Against the JAX package's single-device engine and the oracle; the
    all-above-z_th scene (the global tie-break across shards) against the
    port's own single-device engines.  Across packages that scene is the
    standing 3-point-seed exception (ROADMAP.md queue 3): its patch 68
    seeds on three near-collinear points (eigenvalues 7.5e-4 and 40.3 of
    their scatter), and the two packages' fits part there."""
    _, out = run
    xyz = inputs["xyz_pw"][scan]
    valid = inputs["valid_pw"][scan]
    if scan == TIE:
        cfg = PatchworkConfig.patchwork(**CFG_PW)
        x, v = torch.from_numpy(xyz[None]), torch.from_numpy(valid[None])
        from patchwork_tpu_torch.parallel.shardmap_engine import \
            patchwork_level
        np.testing.assert_array_equal(out["explicit"][scan],
                                      patchwork_level(cfg, x, v)[0].numpy())
        np.testing.assert_array_equal(
            out["explicit"][scan],
            filter_ground_batched(x, v, cfg).ground[0].numpy())
        return
    jcfg = JaxConfig.patchwork(**CFG_PW)
    single = jax_make_filter_ground(jcfg, impl="scatter")
    want = np.asarray(single(jnp.asarray(xyz), jnp.asarray(valid)).ground)
    np.testing.assert_array_equal(out["explicit"][scan], want)
    np.testing.assert_array_equal(out["explicit"][scan],
                                  filter_ground_oracle(xyz, jcfg)[0])


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_sharded_ba_matches_jax(run, inputs, solver):
    doc, out = run
    arrays = [inputs[f"ba_{solver}_{k}"] for k in ("poses", "points", "obs_k",
                                                   "obs_l", "obs_p", "obs_w")]
    jprob = jba.BAProblem(*(jnp.asarray(a) for a in arrays))
    want = jba.bundle_adjust_sharded(jprob, _jax_mesh(PROCS, 1), axis="dp",
                                     iters=BA_ITERS, solver=solver)
    got = out[f"ba_{solver}_poses"]
    np.testing.assert_allclose(got, np.asarray(want.poses),
                               atol=BA_TOL[solver])
    one = tba.bundle_adjust(tba.BAProblem.from_numpy(*arrays, device="cpu"),
                            iters=BA_ITERS, solver=solver)
    np.testing.assert_allclose(got, one.poses.numpy(),
                               atol=ONE_PROCESS_TOL[solver])
    for w in doc["workers"]:
        assert w[f"ba_{solver}_runs_equal"]
        assert w[f"ba_{solver}_pose_max_abs_diff"] <= ONE_PROCESS_TOL[solver]
        assert w[f"ba_{solver}_shape"] == [BA_SHAPES[solver][0],
                                           BA_SHAPES[solver][1],
                                           len(arrays[2])]
