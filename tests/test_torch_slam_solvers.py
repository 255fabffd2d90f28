"""The port's SLAM solvers against the JAX package, on the CPU: bundle
adjustment, its segment sums and the pose graph.

The same NumPy inputs, made from a seed, go through ``patchwork_tpu.slam``
(JAX on the CPU, as its own tests run it) and ``patchwork_tpu_torch.slam``
(``device="cpu"``: the plain versions of the kernels).  Tolerances, with
their reasons:

* bundle adjustment and the pose graph: poses within 1e-4 (float32
  Gauss-Newton, sums in another order);
* segment sums: 1e-5 relative to JAX's scatter.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from patchwork_tpu.slam import ba as jba  # noqa: E402
from patchwork_tpu.slam import pose_graph as jpg  # noqa: E402
from patchwork_tpu.slam import se3 as jse3  # noqa: E402
from patchwork_tpu_torch.slam import ba as tba  # noqa: E402
from patchwork_tpu_torch.slam import pose_graph as tpg  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))

# ---------------------------------------------------------------------------
# bundle adjustment
# ---------------------------------------------------------------------------

def _ba_problem(k=6, l=40, seed=11, noise=0.01):
    rng = np.random.default_rng(seed)
    xi = np.zeros((k, 6), np.float32)
    xi[:, 0] = np.arange(k)
    xi[:, 5] = 0.05 * np.arange(k)
    gt = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    pts = rng.uniform(-10, 10, (l, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 3.0, l)
    ok, ol, op = [], [], []
    for ki in range(k):
        inv = np.linalg.inv(gt[ki])
        for li in rng.permutation(l)[: int(0.8 * l)]:
            ok.append(ki)
            ol.append(li)
            op.append(inv[:3, :3] @ pts[li] + inv[:3, 3]
                      + rng.normal(0, noise, 3))
    n = len(ok)
    pad = (-n) % 8
    w = np.r_[np.ones(n), np.zeros(pad)].astype(np.float32)
    ok = np.r_[ok, np.zeros(pad)].astype(np.int32)
    ol = np.r_[ol, np.zeros(pad)].astype(np.int32)
    op = np.concatenate([np.asarray(op), np.zeros((pad, 3))]).astype(np.float32)
    init = gt.copy()
    pert = rng.normal(0, 0.05, (k, 6)).astype(np.float32)
    init[1:] = init[1:] @ np.asarray(jse3.se3_exp(jnp.asarray(pert[1:])))
    pts0 = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    return (init, pts0, ok, ol, op, w), gt


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_bundle_adjust_matches_jax(solver):
    arrays, gt = _ba_problem()
    pj = jba.BAProblem(*[jnp.asarray(a) for a in arrays])
    pt = tba.BAProblem.from_numpy(*arrays, device=CPU)
    outj = jba.bundle_adjust(pj, iters=5, solver=solver)
    outt = tba.bundle_adjust(pt, iters=5, solver=solver)
    np.testing.assert_allclose(outt.poses.numpy(), np.asarray(outj.poses),
                               atol=1e-4)
    np.testing.assert_allclose(outt.points.numpy(), np.asarray(outj.points),
                               atol=1e-3)
    err = np.abs(outt.poses.numpy()[:, :3, 3] - gt[:, :3, 3]).max()
    assert err < 0.05, err


@pytest.mark.parametrize("impl", ["sort", "onehot", "scatter"])
def test_seg_sums_match_jax_scatter(impl):
    rng = np.random.default_rng(5)
    n, o = 37, 3000
    idx = rng.integers(0, n, o).astype(np.int32)
    vals = rng.normal(0, 1, (o, 6, 3)).astype(np.float32)
    want = np.asarray(jba._make_seg_sums(jnp.asarray(idx), n, "scatter")(
        jnp.asarray(vals)))
    got = tba._make_seg_sums(_t(idx), n, impl)(_t(vals)).numpy()
    scale = np.abs(vals).sum(0).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_seg_sum_default_impl_by_device():
    idx = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    vals = torch.arange(4, dtype=torch.float32)
    # the CPU's default is the sorted prefix sum, as in the JAX package
    assert torch.equal(tba._make_seg_sums(idx, 3)(vals),
                       torch.tensor([0.0, 3.0, 3.0]))
    with pytest.raises(ValueError):
        tba._make_seg_sums(idx, 3, "mxu")


def test_ba_blocks_and_inverses():
    arrays, _ = _ba_problem(k=5, l=16)
    pt = tba.BAProblem.from_numpy(*arrays, device=CPU)
    pj = jba.BAProblem(*[jnp.asarray(a) for a in arrays])
    an = tba._obs_blocks(pt.poses, pt.points, pt)
    fw = tba._obs_blocks(pt.poses, pt.points, pt, jacobian="jacfwd")
    jx = jba._obs_blocks(pj.poses, pj.points, pj)
    for a, f, j in zip(an, fw, jx):
        np.testing.assert_allclose(a.numpy(), f.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tba.ba_residuals(pt.poses, pt.points, pt).numpy(),
        np.asarray(jba.ba_residuals(pj.poses, pj.points, pj)), atol=1e-5)
    rng = np.random.default_rng(2)
    for d in (3, 6):
        a = rng.normal(0, 1, (20, d, d)).astype(np.float32)
        spd = a @ a.transpose(0, 2, 1) + d * np.eye(d, dtype=np.float32)
        closed = tba._batched_inv(_t(spd)).numpy()
        np.testing.assert_allclose(closed, tba._batched_inv(
            _t(spd), "lapack").numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(closed, np.asarray(
            jba._batched_inv(jnp.asarray(spd))), rtol=1e-5, atol=1e-6)


def test_pcg_checked_every_16_equals_every_iteration(monkeypatch):
    # the stopping rule read every 16 iterations freezes each quantity at
    # the first iteration that meets it: the same bits as reading it always
    arrays, _ = _ba_problem(seed=3)
    pt = tba.BAProblem.from_numpy(*arrays, device=CPU)
    runs = []
    for every in (1, tba._CG_CHECK_EVERY):
        monkeypatch.setattr(tba, "_CG_CHECK_EVERY", every)
        runs.append(tba.bundle_adjust(pt, iters=2, solver="pcg",
                                      cg_tol=1e-4).poses)
    assert torch.equal(runs[0], runs[1])


def test_auto_solver_and_cg_iters():
    assert tba._auto_solver(200, 400) == jba._auto_solver(200, 400) == "dense"
    assert tba._auto_solver(1000, 339) == jba._auto_solver(1000, 339) == "pcg"
    assert tba._auto_solver(100, 20000) == "pcg"


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _chain_graph(k=12, drift=0.05, seed=5):
    rng = np.random.default_rng(seed)
    step = np.asarray(jse3.se3_exp(jnp.asarray(
        [1.0, 0, 0, 0, 0, 2 * np.pi / k], jnp.float32)))
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(k - 1):
        gt.append((gt[-1] @ step).astype(np.float32))
    gt = np.stack(gt)
    noise = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, drift, (k - 1, 6)).astype(np.float32))))
    ei = list(range(k - 1)) + [0, 0, 2]
    ej = list(range(1, k)) + [k - 1, k // 2, k - 2]
    eT = [np.linalg.inv(gt[i]) @ gt[i + 1] @ noise[i] for i in range(k - 1)]
    eT += [np.linalg.inv(gt[a]) @ gt[b] for a, b in zip(ei[k - 1:], ej[k - 1:])]
    init = [np.eye(4, dtype=np.float32)]
    for i in range(k - 1):
        init.append((init[-1] @ eT[i]).astype(np.float32))
    info = np.tile(np.eye(6, dtype=np.float32) * 100.0, (len(ei), 1, 1))
    info[-3:] *= np.array([100.0, 50.0, 10.0], np.float32)[:, None, None]
    return (np.stack(init), np.array(ei, np.int32), np.array(ej, np.int32),
            np.stack(eT).astype(np.float32), info), gt


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_pose_graph_matches_jax(solver):
    arrays, gt = _chain_graph()
    gj = jpg.optimize_pose_graph(jpg.PoseGraph(*[jnp.asarray(a)
                                                 for a in arrays]),
                                 iters=6, solver=solver)
    gt_ = tpg.optimize_pose_graph(tpg.PoseGraph.from_numpy(*arrays,
                                                           device=CPU),
                                  iters=6, solver=solver)
    np.testing.assert_allclose(gt_.poses.numpy(), np.asarray(gj.poses),
                               atol=1e-4)
    ate = float(tpg.ate_rmse(gt_.poses, _t(gt)))
    np.testing.assert_allclose(ate, float(jpg.ate_rmse(gj.poses,
                                                       jnp.asarray(gt))),
                               atol=1e-5)
    assert ate < float(tpg.ate_rmse(_t(arrays[0]), _t(gt)))


def test_edge_residuals_and_jacobians_match_jax():
    arrays, _ = _chain_graph(k=6, drift=0.15)
    rng = np.random.default_rng(3)
    poses = arrays[0] @ np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.2, (6, 6)).astype(np.float32))))
    arrays = (poses.astype(np.float32),) + arrays[1:]
    gt_ = tpg.PoseGraph.from_numpy(*arrays, device=CPU)
    gj = jpg.PoseGraph(*[jnp.asarray(a) for a in arrays])
    an = tpg._edge_jacobians(gt_.poses, gt_)
    fw = tpg._edge_jacobians(gt_.poses, gt_, jacobian="jacfwd")
    jx = jpg._edge_jacobians(gj.poses, gj)
    for a, f, j, name in zip(an, fw, jx, ("r", "Ji", "Jj")):
        np.testing.assert_allclose(a.numpy(), f.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_sparsify_pose_graph_equal_edges():
    rng = np.random.default_rng(9)
    k = 40
    ei = np.r_[np.arange(k - 1), rng.integers(0, k, 150)].astype(np.int32)
    ej = np.r_[np.arange(1, k), rng.integers(0, k, 150)].astype(np.int32)
    e = len(ei)
    eT = np.tile(np.eye(4, dtype=np.float32), (e, 1, 1))
    eT[:, 0, 3] = np.arange(e)
    info = np.tile(np.eye(6, dtype=np.float32), (e, 1, 1))
    info *= rng.integers(1, 5, e).astype(np.float32)[:, None, None]
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    sj = jpg.sparsify_pose_graph(jpg.PoseGraph(
        *[jnp.asarray(a) for a in (poses, ei, ej, eT, info)]), max_degree=3)
    st = tpg.sparsify_pose_graph(tpg.PoseGraph.from_numpy(
        poses, ei, ej, eT, info, device=CPU), max_degree=3)
    assert len(st.edge_i) < e
    for a, b in zip(st[1:], sj[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
