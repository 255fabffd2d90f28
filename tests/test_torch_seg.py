"""The port's segment-op backend against the JAX Pallas segment kernels.

seg_gather and seg_minmax (kernels/seg_cuda.py) run their plain versions on
the CPU; here they are held to seg_gather_pallas / seg_minmax_pallas,
interpreted on the CPU as tests/test_pallas.py runs them.  Both are exact,
so results must be equal.  Min and max compare with ``==``: the port orders
-0.0 below +0.0 (order-preserving keys) and XLA's min may return either.
tests/test_torch_cuda.py holds the CUDA kernels against the plain versions.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu.kernels.seg_pallas import (  # noqa: E402
    seg_gather_pallas, seg_minmax_pallas)
from patchwork_tpu_torch.kernels import seg_cuda  # noqa: E402
from patchwork_tpu_torch.segment.segops import (  # noqa: E402
    SegOps, default_impl, f32_key, key_f32)

torch.set_num_threads(1)

N, S = 4096, 161


def _case(seed, c):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, S, N).astype(np.int32)
    vals = rng.normal(0, 30, (N, c)).astype(np.float32)
    vals[::13] = 0.0
    vals[1::17] = -0.0
    vals[2::19] = np.float32(1e-40)
    mask = rng.random(N) < 0.7
    return seg, vals, mask


@pytest.mark.parametrize("c", [3, 1])
def test_gather_vs_pallas(c):
    seg, _, _ = _case(c, c)
    table = np.random.default_rng(9).normal(0, 5, (S, c)).astype(np.float32)
    ref = np.asarray(seg_gather_pallas(jnp.asarray(table), jnp.asarray(seg)))
    got = seg_cuda.seg_gather(torch.from_numpy(table.T.copy())[None],
                              torch.from_numpy(seg)[None])[0].numpy()
    np.testing.assert_array_equal(got, ref.T)


@pytest.mark.parametrize("c", [3, 1])
def test_minmax_vs_pallas(c):
    seg, vals, mask = _case(10 + c, c)
    mask[seg == 7] = False            # an empty segment: +inf / -inf
    mins, maxs = seg_minmax_pallas(jnp.asarray(vals), jnp.asarray(seg),
                                   jnp.asarray(mask), S)
    gm, gx = seg_cuda.seg_minmax(torch.from_numpy(vals.T.copy())[None],
                                 torch.from_numpy(seg)[None],
                                 torch.from_numpy(mask)[None], S)
    assert (gm[0].numpy() == np.asarray(mins)).all()
    assert (gx[0].numpy() == np.asarray(maxs)).all()
    assert np.isposinf(gm[0, :, 7].numpy()).all()
    assert np.isneginf(gx[0, :, 7].numpy()).all()


def test_minmax_orders_signed_zero():
    vals = torch.tensor([[[0.0, -0.0, 0.0]]])
    seg = torch.zeros((1, 3), dtype=torch.int32)
    mins, maxs = seg_cuda.seg_minmax(vals, seg, torch.ones((1, 3), dtype=bool),
                                     1)
    assert np.signbit(mins.item()) and not np.signbit(maxs.item())


def test_keys_round_trip():
    v = torch.tensor([-3e38, -1.0, -1e-40, -0.0, 0.0, 1e-40, 1.0, 3e38,
                      float("inf"), float("-inf")])
    k = f32_key(v)
    assert torch.equal(key_f32(k).view(torch.int32), v.view(torch.int32))
    order = torch.argsort(k[:8])
    assert torch.equal(order, torch.arange(8))


def test_segops_backends_agree():
    # a batch of two scans: "pallas" (fixed-order sums, key min/max) and
    # "scatter" give equal counts, extents and gathers, and close sums
    rng = np.random.default_rng(3)
    seg = torch.from_numpy(rng.integers(0, S, (2, N)))
    xyz = torch.from_numpy(rng.normal(0, 20, (2, 3, N)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, N)) < 0.5)
    ops_p, ops_s = SegOps(seg, S, "pallas"), SegOps(seg, S, "scatter")
    np.testing.assert_allclose(ops_p.sum(xyz).numpy(), ops_s.sum(xyz).numpy(),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(ops_p.count(mask), ops_s.count(mask))
    for a, b in zip(ops_p.bbox(xyz, mask), ops_s.bbox(xyz, mask)):
        assert torch.equal(a, b)
    table = torch.from_numpy(rng.normal(0, 1, (2, 4, S)).astype(np.float32))
    assert torch.equal(ops_p.gather(table), ops_s.gather(table))
    flag = table[:, 0] > 0
    assert torch.equal(ops_p.gather_bool(flag), ops_s.gather_bool(flag))
    assert torch.equal(SegOps(seg, S, "onehot").sum(xyz), ops_s.sum(xyz))
    assert default_impl() == "fused"
    with pytest.raises(ValueError):
        SegOps(seg, S, "fused")
