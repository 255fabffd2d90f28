"""The port's kernel plain versions against the JAX Pallas kernels.

On the CPU every wrapper of patchwork_tpu_torch.kernels.fit_cuda runs its
plain PyTorch version, which adds in the CUDA kernel's order; here those
are held against the Pallas kernels of patchwork_tpu (interpreted on the
CPU, as the JAX package's own tests run them).  Sums are taken in another
order than the MXU's, so float sums get a tolerance (rtol 1e-5, atol 1e-3);
masks, counts and order statistics are exact.  tests/test_torch_cuda.py
holds each CUDA kernel against its plain version on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu.kernels.fit_pallas import (  # noqa: E402
    fit_pack, fused_apply, fused_moments2, level_megakernel, seg_order_stat,
    sp_width,
)
from patchwork_tpu_torch import PatchworkConfig  # noqa: E402
from patchwork_tpu_torch.kernels import fit_cuda  # noqa: E402
from patchwork_tpu_torch.segment import engine  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3


def _order_stat_case():
    rng = np.random.default_rng(0)
    n, s = 5000, 37
    seg = rng.integers(0, s, n).astype(np.int32)
    vals = rng.normal(0, 50, n).astype(np.float32)
    vals[::7] = 0.0
    vals[1::13] = -0.0
    vals[2::11] = vals[0]
    vals[3::17] = np.float32(1e-42)
    valid = rng.random(n) > 0.2
    k = np.zeros(s, np.int32)
    has = np.zeros(s, bool)
    for i in range(s):
        c = int(((seg == i) & valid).sum())
        if c:
            k[i] = min(c - 1, int(0.3 * c))
            has[i] = True
    return vals, seg, valid, k, s, has


class TestSegOrderStat:
    def test_vs_pallas_and_sort(self):
        vals, seg, valid, k, s, has = _order_stat_case()
        got = fit_cuda.seg_order_stat(
            torch.from_numpy(vals)[None], torch.from_numpy(seg)[None],
            torch.from_numpy(valid)[None], torch.from_numpy(k)[None], s)[0]
        ref = np.asarray(seg_order_stat(jnp.asarray(vals), jnp.asarray(seg),
                                        jnp.asarray(valid), jnp.asarray(k), s))
        got = got.numpy()
        np.testing.assert_array_equal(got[has].view(np.int32),
                                      ref[has].view(np.int32))
        for i in np.nonzero(has)[0]:
            assert got[i] == np.sort(vals[(seg == i) & valid])[k[i]]

    @pytest.mark.parametrize("k", range(8))
    def test_extreme_magnitudes(self, k):
        vals = np.array([-3e38, -1.0, -1e-40, 0.0, 1e-40, 1.0, 3e38, 2.0],
                        np.float32)
        got = fit_cuda.seg_order_stat(
            torch.from_numpy(vals)[None], torch.zeros((1, 8), dtype=torch.int32),
            torch.ones((1, 8), dtype=torch.bool),
            torch.tensor([[k]], dtype=torch.int32), 1)
        ref = np.asarray(seg_order_stat(
            jnp.asarray(vals), jnp.zeros(8, jnp.int32), jnp.ones(8, bool),
            jnp.asarray([k], np.int32), 1))
        assert got[0, 0].item() == ref[0] == np.sort(vals)[k]

    def test_signed_zero_order(self):
        vals = np.array([0.0, -0.0, 1.0], np.float32)
        got = fit_cuda.seg_order_stat(
            torch.from_numpy(vals)[None], torch.zeros((1, 3), dtype=torch.int32),
            torch.ones((1, 3), dtype=torch.bool),
            torch.tensor([[0]], dtype=torch.int32), 1)
        assert np.signbit(got[0, 0].item())   # -0.0 sorts first


def _sweep_scene(seed, n=4096, s=81):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 20, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.normal(0, 0.3, n).astype(np.float32)
    seg = rng.integers(0, s, n).astype(np.int32)
    g = (rng.random(n) < 0.5).astype(np.float32)
    sp = sp_width(s)
    tab = np.zeros((8, sp), np.float32)
    tab[0:3, :s] = rng.normal(0, 5, (3, s))
    nrm = rng.normal(0, 1, (3, s))
    tab[3:6, :s] = nrm / np.linalg.norm(nrm, axis=0)
    tab[6, :s] = rng.random(s) < 0.7
    tab[7, :s] = rng.uniform(0.1, 0.4, s)
    # the port's layouts: pts (1,8,N) rows [x,y,z,...], state (1,4,N) rows
    # [g, done, chosen, seg]; trash beyond every segment -> all live
    pts = np.zeros((1, 8, n), np.float32)
    pts[0, 0:3] = xyz.T
    state = np.zeros((1, 4, n), np.float32)
    state[0, 0] = g
    state[0, 3] = seg
    return xyz, seg, g, tab, s, sp, pts, state


class TestSweeps:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_apply_vs_fused_apply(self, seed):
        xyz, seg, g, tab, s, sp, pts, state = _sweep_scene(seed)
        tau_pt = tab[7][seg]
        p = fit_pack(jnp.asarray(xyz), jnp.asarray(tau_pt),
                     jnp.ones(len(seg), bool), jnp.asarray(seg))
        jtab = tab.copy()
        jtab[7] = 0.0
        g_out, stats = fused_apply(p, jnp.asarray(g)[None], jnp.asarray(jtab), s)
        st = torch.from_numpy(state)
        got = fit_cuda.apply_sweep(torch.from_numpy(pts), st,
                                   torch.from_numpy(tab)[None], sp, False)[0]
        stats = np.asarray(stats)
        np.testing.assert_array_equal(st[0, 0].numpy(), np.asarray(g_out)[0])
        np.testing.assert_array_equal(got[0].numpy(), stats[0])   # count
        np.testing.assert_array_equal(got[5].numpy(), stats[5])   # changed
        np.testing.assert_allclose(got[1:5].numpy(), stats[1:5], rtol=RTOL,
                                   atol=ATOL)

    def test_moments2_vs_fused_moments2(self):
        xyz, seg, g, tab, s, sp, pts, state = _sweep_scene(5)
        p = fit_pack(jnp.asarray(xyz), jnp.zeros(len(seg)),
                     jnp.ones(len(seg), bool), jnp.asarray(seg))
        ctab = tab.copy()
        ctab[3:] = 0.0
        ref = np.asarray(fused_moments2(p, jnp.asarray(g)[None],
                                        jnp.asarray(ctab), s))
        got = fit_cuda.moments2_sweep(torch.from_numpy(pts),
                                      torch.from_numpy(state),
                                      torch.from_numpy(tab[None, 0:3].copy()),
                                      sp)[0]
        np.testing.assert_allclose(got.numpy(), ref[:6], rtol=RTOL, atol=ATOL)

    def test_tile_sums_order(self):
        # the plain sum adds in the kernels' order: per tile in point order,
        # then tiles in order -- check it against that loop written out
        rng = np.random.default_rng(1)
        n, s = 2 * fit_cuda.TILE, 5
        rows = rng.normal(0, 1e3, (1, 2, n)).astype(np.float32)
        seg = rng.integers(0, s, (1, n)).astype(np.int32)
        got = fit_cuda.seg_sum(torch.from_numpy(rows), torch.from_numpy(seg),
                               s)[0].numpy()
        exp = np.zeros((2, s), np.float32)
        for t0 in range(0, n, fit_cuda.TILE):
            part = np.zeros((2, s), np.float32)
            for i in range(t0, t0 + fit_cuda.TILE):
                part[:, seg[0, i]] += rows[0, :, i]
            exp += part
        np.testing.assert_array_equal(got, exp)


def _bimodal_far_scene(n, seed=5):
    """Zero-noise bimodal z at far range: patches split under both seed
    modes (the JAX suite's split/seed-matrix scene)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(90, 149, n)
    a = rng.uniform(0, 2 * np.pi, n)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = r * np.cos(a)
    pts[:, 1] = r * np.sin(a)
    pts[:, 2] = 0.528 * (rng.random(n) > 0.5)
    return pts.astype(np.float32)


def _level_calls(cfg, pts, monkeypatch):
    """Run the port's engine and keep every level's inputs."""
    calls = []

    def capture(p, t, *args, **kw):
        calls.append((p.clone(), t.clone(), args, kw))
        return engine.level_reference(p, t, *args, **kw)

    monkeypatch.setattr(engine, "level", capture)
    xyz = torch.from_numpy(pts)[None]
    engine.filter_ground_batched(xyz, torch.ones(xyz.shape[:2], dtype=torch.bool),
                                 cfg)
    return calls


class TestLevel:
    @pytest.mark.parametrize("fast,adaptive", [(False, True), (True, True),
                                               (False, False)],
                             ids=["exact", "fast", "percentile"])
    def test_level_reference_vs_level_megakernel(self, fast, adaptive,
                                                 monkeypatch):
        cfg = PatchworkConfig(th_dist=0.24, th_seeds=0.9, max_iter=1,
                              fast_covariance=fast,
                              adaptive_seed_height=adaptive)
        calls = _level_calls(cfg, _bimodal_far_scene(2048), monkeypatch)
        assert len(calls) >= 2, "scene must reach a remap level"
        for p, t, args, kw in calls[:2]:
            state, stats = engine.level_reference(p, t, *args, **kw)
            sj, aj = level_megakernel(jnp.asarray(p[0].numpy()),
                                      jnp.asarray(t[0].numpy()), *args, **kw)
            sj, aj = np.asarray(sj), np.asarray(aj)
            np.testing.assert_array_equal(state[0].numpy(), sj)
            a = stats[0].numpy()
            live = a[3] > 0   # zth of empty nodes is garbage when percentile
            for row in (0, 1, 3, 4, 5):
                np.testing.assert_array_equal(a[row], aj[row])
            np.testing.assert_array_equal(a[6][live], aj[6][live])
            np.testing.assert_allclose(a[2], aj[2], rtol=RTOL)

