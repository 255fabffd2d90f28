"""The port's SE(3) algebra and scan matching against the JAX package, on
the CPU.

The same NumPy inputs, made from a seed, go through ``patchwork_tpu.slam``
(JAX on the CPU, as its own tests run it) and ``patchwork_tpu_torch.slam``
(``device="cpu"``: the plain versions of the kernels).  Tolerances, with
their reasons:

* se3: rtol 1e-5, atol 1e-6 (sin/cos/acos come from other math libraries
  and the 3x3 products add in another order; the gaps are a few ulp, see
  ``_ulps``);
* nearest neighbours: indices equal away from ties, d2 within 1e-5 on
  unit-scale points (the cross term's three products add in another order);
* ICP: 1e-4 m and 1e-5 rad after 12 Gauss-Newton steps from the same
  features;
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from patchwork_tpu.slam import scan_matching as jsm  # noqa: E402
from patchwork_tpu.slam import se3 as jse3  # noqa: E402
from patchwork_tpu_torch.slam import scan_matching as tsm  # noqa: E402
from patchwork_tpu_torch.slam import se3 as tse3  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-2 ** 31) - ai, ai)
    bi = np.where(bi < 0, np.int64(-2 ** 31) - bi, bi)
    return int(np.abs(ai - bi).max())


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

def _twists(seed=0, n=64):
    """Random twists with small-angle (0, 1e-7, 1e-4) and near-pi rows."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[0, 3:] = 0.0
    xi[1, 3:] = [1e-7, 0.0, 0.0]
    xi[2, 3:] = [0.0, 1e-4, -1e-4]
    xi[3, 3:] = [3.1, 0.0, 0.0]
    xi[4, 3:] = np.array([1.0, 1.0, 1.0], np.float32) * np.float32(3.13 / np.sqrt(3))
    return xi


def _poses(seed=1, n=64):
    return np.asarray(jse3.se3_exp(jnp.asarray(_twists(seed, n))))


_SE3_CASES = {
    "so3_exp": lambda m: (m.so3_exp, (_twists()[:, 3:],)),
    "so3_log": lambda m: (m.so3_log, (_poses()[:, :3, :3],)),
    "_left_jacobian": lambda m: (m._left_jacobian, (_twists()[:, 3:],)),
    "se3_exp": lambda m: (m.se3_exp, (_twists(),)),
    "se3_log": lambda m: (m.se3_log, (_poses(),)),
    "se3_inverse": lambda m: (m.se3_inverse, (_poses(),)),
    "se3_compose": lambda m: (m.se3_compose, (_poses(1), _poses(2))),
    "se3_apply": lambda m: (m.se3_apply, (
        _poses(), np.random.default_rng(3).normal(0, 10, (64, 5, 3))
        .astype(np.float32))),
    "se3_adjoint": lambda m: (m.se3_adjoint, (_poses(),)),
    "so3_left_jacobian_inv": lambda m: (m.so3_left_jacobian_inv,
                                        (_twists()[:, 3:],)),
    "_se3_Q": lambda m: (m._se3_Q, (_twists()[:, :3], _twists()[:, 3:])),
    "se3_left_jacobian_inv": lambda m: (m.se3_left_jacobian_inv,
                                        (_twists(),)),
    "se3_right_jacobian_inv": lambda m: (m.se3_right_jacobian_inv,
                                         (_twists(),)),
}


@pytest.mark.parametrize("name", sorted(_SE3_CASES))
def test_se3_matches_jax(name):
    fj, args = _SE3_CASES[name](jse3)
    ft, _ = _SE3_CASES[name](tse3)
    want = np.asarray(fj(*[jnp.asarray(a) for a in args]))
    got = ft(*[_t(a) for a in args]).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=f"{name}: {_ulps(got, want)} ulp")


def test_se3_identity_and_jacfwd_at_zero():
    assert torch.equal(tse3.se3_identity(), torch.eye(4))
    assert torch.allclose(tse3.se3_log(torch.eye(4)), torch.zeros(6))
    from torch.func import jacfwd

    for f in (tse3.se3_exp, lambda x: tse3.se3_log(tse3.se3_exp(x)),
              tse3.se3_right_jacobian_inv):
        assert torch.isfinite(jacfwd(f)(torch.zeros(6))).all()


# ---------------------------------------------------------------------------
# scan matching
# ---------------------------------------------------------------------------

def test_nearest_neighbors_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.normal(0, 1, (300, 3)).astype(np.float32)
    tgt = rng.normal(0, 1, (500, 3)).astype(np.float32)
    valid = rng.random(500) > 0.3
    ij, dj = (np.asarray(a) for a in jsm.nearest_neighbors(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid)))
    it, dt = (a.numpy() for a in tsm.nearest_neighbors(
        _t(src), _t(tgt), _t(valid)))
    # a tie: the two nearest targets within rounding of each other
    full = ((src[:, None] - tgt[None]) ** 2).sum(-1)
    full[:, ~valid] = np.inf
    part = np.sort(full, 1)
    clear = part[:, 1] - part[:, 0] > 1e-4
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(it[clear], ij[clear])
    np.testing.assert_allclose(dt, dj, atol=1e-5)
    assert valid[it].all()


def test_nearest_neighbors_default_precision():
    rng = np.random.default_rng(1)
    tgt = rng.normal(0, 1, (256, 3)).astype(np.float32)
    src = tgt[:64] + rng.normal(0, 1e-3, (64, 3)).astype(np.float32)
    hi = tsm.nearest_neighbors(_t(src), _t(tgt), torch.ones(256, dtype=bool))
    lo = tsm.nearest_neighbors(_t(src), _t(tgt), torch.ones(256, dtype=bool),
                               precision="default")
    assert torch.equal(lo[0], torch.arange(64))
    # d2 of the chosen pair is exact, not the bfloat16 search's
    np.testing.assert_allclose(lo[1].numpy(), ((src - tgt[:64]) ** 2).sum(1),
                               rtol=1e-5, atol=1e-9)
    assert torch.equal(hi[0], lo[0])
    none = tsm.nearest_neighbors(_t(src), _t(tgt), torch.zeros(256, dtype=bool),
                                 precision="default")[1]
    assert torch.isinf(none).all()


def _icp_problem(xi, seed=3, n_obst=800, n_ground=600, noise=0.01):
    rng = np.random.default_rng(seed)
    obst = np.empty((n_obst, 3), np.float32)
    obst[:, :2] = rng.uniform(-20, 20, (n_obst, 2))
    obst[:, 2] = rng.uniform(0.5, 3.0, n_obst)
    ground = np.empty((n_ground, 3), np.float32)
    ground[:, :2] = rng.uniform(-20, 20, (n_ground, 2))
    ground[:, 2] = rng.normal(0, 0.02, n_ground)
    inv = np.linalg.inv(np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32))))
    src_obst = obst @ inv[:3, :3].T + inv[:3, 3]
    src_ground = ground @ inv[:3, :3].T + inv[:3, 3]
    src_obst += rng.normal(0, noise, src_obst.shape)
    src_ground += rng.normal(0, noise, src_ground.shape)
    v_o = rng.random(n_obst) > 0.05
    v_g = rng.random(n_ground) > 0.05
    return [a.astype(np.float32) if a.dtype != bool else a
            for a in (src_obst, v_o, src_ground, v_g, obst, v_o.copy(),
                      ground, v_g.copy())]


_ICP_XI = [[0.3, -0.2, 0.05, 0.0, 0.0, 0.05],
           [0.5, 0.4, -0.1, 0.02, -0.02, 0.1]]


@pytest.mark.parametrize("xi", _ICP_XI)
def test_icp_matches_jax(xi):
    args = _icp_problem(xi)
    rj = jsm.icp_ground_constrained(*[jnp.asarray(a) for a in args], iters=12)
    rt = tsm.icp_ground_constrained(*[_t(a) for a in args], iters=12)
    Tj, Tt = np.asarray(rj.transform), rt.transform.numpy()
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-4)
    rot = np.asarray(jse3.so3_log(jnp.asarray(Tj[:3, :3].T @ Tt[:3, :3])))
    assert np.abs(rot).max() < 1e-5, rot
    assert int(rt.num_inliers) == int(rj.num_inliers)
    # d2 = |p|^2 + |q|^2 - 2 p.q at 20 m loses ~1e-4 m^2 to cancellation,
    # against an RMSE^2 of ~3e-4 m^2
    np.testing.assert_allclose(float(rt.rmse), float(rj.rmse), rtol=1e-2)


def test_icp_pairs_equal_per_pair_calls():
    probs = [_icp_problem(xi, seed=s) for s, xi in enumerate(
        _ICP_XI + [[0.1, 0.0, 0.0, 0.0, 0.0, -0.03]])]
    init = torch.from_numpy(np.asarray(jse3.se3_exp(jnp.asarray(
        [[0.1, 0, 0, 0, 0, 0.01]] * 3, jnp.float32))))
    batched = tsm.icp_ground_constrained(
        *[torch.stack([_t(p[i]) for p in probs]) for i in range(8)],
        init=init, iters=8)
    # not bitwise: a batched product adds in another order than a single
    # one (gaps of up to 9e-8 seen)
    for n, p in enumerate(probs):
        one = tsm.icp_ground_constrained(*[_t(a) for a in p], init=init[n],
                                         iters=8)
        np.testing.assert_allclose(batched.transform[n].numpy(),
                                   one.transform.numpy(), rtol=0, atol=1e-6)
        assert int(batched.num_inliers[n]) == int(one.num_inliers)


def test_icp_jacfwd_matches_analytic():
    args = [_t(a) for a in _icp_problem([0.4, -0.3, 0.05, 0.01, 0.0, 0.08])]
    a = tsm.icp_ground_constrained(*args, iters=6).transform
    f = tsm.icp_ground_constrained(*args, iters=6, jacobian="jacfwd").transform
    np.testing.assert_allclose(a.numpy(), f.numpy(), rtol=1e-4, atol=1e-4)
