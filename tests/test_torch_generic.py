"""The port's generic level engine against the JAX generic engine and the
recursive NumPy oracle, on the CPU.

The generic path is ``_level_body`` / ``_child_remap`` (segment/engine.py),
taken under ``segment_impl`` "scatter", "onehot" and "pallas", and under
"fused" above the fit gate.  Exact-mode masks are held bit for bit to the
oracle and to the JAX package's generic engine.  JAX's interpreted "pallas"
engine is slow on the 24k-point split scene (about 20 s), so there the port
is held to JAX's "scatter" engine, which the JAX suite holds bit-equal to
its "pallas" and "onehot" engines.  ``fit_level_plain`` is held to the
interpreted ``fit_level_megakernel`` with the tolerance of
tests/test_torch_kernels.py for sums (the MXU adds in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import patchwork_tpu.kernels.fit_pallas as jax_fit  # noqa: E402
from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.oracle.reference import filter_ground_oracle  # noqa: E402
from patchwork_tpu.segment.engine import make_filter_ground  # noqa: E402
from patchwork_tpu_torch import (  # noqa: E402
    PatchworkConfig, filter_ground, filter_ground_batched)
from patchwork_tpu_torch.io.synthetic import demo_point_cloud  # noqa: E402
from patchwork_tpu_torch.kernels import fit_cuda  # noqa: E402
from patchwork_tpu_torch.segment import engine  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3


def _split_terrain(n, seed=7):
    """Sloped ground with a 0.5 m step and box obstacles: residuals split
    patches to depth 3 (the parity suite's recursion scene, any size)."""
    rng = np.random.default_rng(seed)
    n_obst = n // 6
    g = np.empty((n - n_obst, 3), np.float32)
    g[:, 0] = rng.uniform(-80, 80, len(g))
    g[:, 1] = rng.uniform(-80, 80, len(g))
    g[:, 2] = 0.08 * g[:, 0] + 0.5 * (g[:, 1] > 20) + rng.normal(0, 0.05, len(g))
    obst = np.column_stack([rng.uniform(-40, 40, (n_obst, 2)),
                            rng.uniform(0.5, 3.0, n_obst)])
    return np.concatenate([g, obst]).astype(np.float32)


def _split_scene():
    # tests/test_torch_engine.py's split scene: 20000 ground + 4000 boxes
    rng = np.random.default_rng(7)
    n = 20000
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-80, 80, n)
    pts[:, 1] = rng.uniform(-80, 80, n)
    pts[:, 2] = 0.08 * pts[:, 0] + 0.5 * (pts[:, 1] > 20) + rng.normal(0, 0.05, n)
    obst = rng.uniform(-40, 40, (4000, 2))
    oz = rng.uniform(0.5, 3.0, 4000)
    return np.concatenate(
        [pts, np.column_stack([obst, oz]).astype(np.float32)]).astype(np.float32)


PALLAS_SCENE = (lambda: demo_point_cloud(2048, seed=13),   # test_pallas.py:84-96
                dict(filtering_radius=50.0, max_levels=2, num_sectors=8))


def _gate_below_256(n, sp):
    return sp < 256


def _port_gates_below_256(monkeypatch):
    """The port's two gates as if only Sp 128 passed: the path gate sends
    the scan to the generic path, the card's gate admits one-launch fits at
    Sp 128 only, so deeper levels take the loop of sweeps."""
    monkeypatch.setattr(fit_cuda, "megakernel_fits", _gate_below_256)
    monkeypatch.setattr(
        fit_cuda, "fit_level_fits",
        lambda sp, fast, device, level=False: sp < 256)


def _port(pts, kw, **over):
    return filter_ground(torch.from_numpy(pts),
                         torch.ones(len(pts), dtype=torch.bool),
                         PatchworkConfig(**kw, **over)).ground.numpy()


def _jax(pts, kw, impl):
    res = make_filter_ground(JaxConfig(**kw), impl=impl)(
        jnp.asarray(pts), jnp.ones(len(pts), bool))
    return np.asarray(res.ground)


def _no_level_path(monkeypatch):
    def fail(*args, **kwargs):
        raise AssertionError("the level path ran")

    monkeypatch.setattr(engine, "level", fail)
    monkeypatch.setattr(engine, "level_reference", fail)


def _count(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("impl", ["scatter", "pallas"])
def test_pallas_scene_matches_jax_and_oracle(impl, monkeypatch):
    make, kw = PALLAS_SCENE
    pts = make()
    g_o = filter_ground_oracle(pts, JaxConfig(**kw))[0]
    _no_level_path(monkeypatch)
    g = _port(pts, kw, segment_impl=impl)
    np.testing.assert_array_equal(g, g_o)
    np.testing.assert_array_equal(g, _jax(pts, kw, impl))


@pytest.mark.parametrize("impl", ["scatter", "pallas", "onehot"])
def test_split_scene_matches_jax_and_oracle(impl, monkeypatch):
    pts = _split_scene()
    g_o = filter_ground_oracle(pts, JaxConfig())[0]
    calls = {}
    _count(monkeypatch, engine, "_child_remap", calls)
    _no_level_path(monkeypatch)
    g = _port(pts, {}, segment_impl=impl)
    assert calls["_child_remap"] >= 2, "the scene must recurse"
    np.testing.assert_array_equal(g, g_o)
    np.testing.assert_array_equal(g, _jax(pts, {}, "scatter"))


def test_non_adaptive_seeds(monkeypatch):
    pts = demo_point_cloud(8000, seed=42)
    kw = dict(adaptive_seed_height=False, filtering_radius=60.0)
    g_o = filter_ground_oracle(pts, JaxConfig(**kw))[0]
    _no_level_path(monkeypatch)
    g = _port(pts, kw, segment_impl="pallas")
    np.testing.assert_array_equal(g, g_o)
    np.testing.assert_array_equal(g, _jax(pts, kw, "scatter"))


@pytest.mark.parametrize("scene", ["pallas_scene", "split"])
def test_fused_above_gate(scene, monkeypatch):
    # both gates at sp < 256: level 0 (Sp 128) fits in one fit_level launch,
    # deeper levels (Sp 256) take the loop of sweeps
    if scene == "split":
        pts, kw = _split_scene(), {}
    else:
        pts, kw = PALLAS_SCENE[0](), PALLAS_SCENE[1]
    g_level = _port(pts, kw, segment_impl="fused")      # the level path
    g_o = filter_ground_oracle(pts, JaxConfig(**kw))[0]
    monkeypatch.setattr(jax_fit, "megakernel_fits", _gate_below_256)
    g_jax = _jax(pts, kw, "fused")
    _port_gates_below_256(monkeypatch)
    _no_level_path(monkeypatch)
    calls = {}
    _count(monkeypatch, fit_cuda, "fit_level", calls)
    _count(monkeypatch, fit_cuda, "apply_sweep", calls)
    g = _port(pts, kw, segment_impl="fused")
    assert calls["fit_level"] >= 1
    if scene == "split":
        assert calls["apply_sweep"] >= 2, "no level took the sweep loop"
    np.testing.assert_array_equal(g, g_o)
    np.testing.assert_array_equal(g, g_jax)
    np.testing.assert_array_equal(g, g_level)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_fit_level_plain_vs_megakernel(fast, monkeypatch):
    # a real level-0 input: a demo cloud's binning, seeded mask, tau per patch
    pts = demo_point_cloud(4096, seed=0)
    _port_gates_below_256(monkeypatch)
    seen = []
    orig = fit_cuda.fit_level

    def capture(p, g0, *args, **kw):
        seen.append((p.clone(), g0.clone(), args, kw))
        return orig(p, g0, *args, **kw)

    monkeypatch.setattr(fit_cuda, "fit_level", capture)
    _port(pts, {}, segment_impl="fused", fast_covariance=fast)
    p, g0, (num_segs, max_iter), kw = seen[0]
    assert max_iter == 100 and kw["fast"] == fast
    g, stats = fit_cuda.fit_level_plain(p, g0, num_segs, max_iter, fast)
    gj, sj = jax_fit.fit_level_megakernel(jnp.asarray(p[0].numpy()),
                                          jnp.asarray(g0[0].numpy()),
                                          num_segs, max_iter, fast=fast)
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(gj))
    assert not np.array_equal(g[0].numpy(), g0[0].numpy()), "no refit ran"
    np.testing.assert_allclose(stats[0].numpy(), np.asarray(sj), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_batch_equals_solo_runs(impl, monkeypatch):
    # one scan that splits and two that do not: the shared loops re-run
    # finished scans, which must leave them unchanged
    if impl == "fused":
        _port_gates_below_256(monkeypatch)
    cfg = PatchworkConfig(segment_impl=impl)
    scans = [_split_terrain(4096)] + [demo_point_cloud(4096, seed=s)
                                     for s in (1, 2)]
    calls = {}
    _count(monkeypatch, engine, "_child_remap", calls)
    solo = []
    for pts in scans:
        calls.clear()
        solo.append(_port(pts, {}, segment_impl=impl))
        solo_remaps = calls.get("_child_remap", 0)
        assert (solo_remaps > 0) == (len(solo) == 1)
    xyz = torch.from_numpy(np.stack(scans))
    g = filter_ground_batched(xyz, torch.ones(xyz.shape[:2], dtype=torch.bool),
                              cfg).ground.numpy()
    for i in range(3):
        np.testing.assert_array_equal(g[i], solo[i])


def test_unknown_impl_raises():
    pts = torch.from_numpy(demo_point_cloud(256, seed=0))
    with pytest.raises(ValueError, match="segment impl"):
        filter_ground(pts, torch.ones(256, dtype=torch.bool),
                      PatchworkConfig(segment_impl="cuda"))


def test_fast_flag_ignored_off_fused(monkeypatch):
    # scatter keeps exact semantics with the flag set, as in the JAX
    # package (tests/test_fast_mode.py:94-100): no patch-center shift and
    # no fast fit, so the masks are the oracle's
    pts = demo_point_cloud(4096, seed=4)
    cfg = PatchworkConfig(segment_impl="scatter", fast_covariance=True)
    shifts = {}
    _count(monkeypatch, engine, "_shift_to_patch_centers", shifts)
    _no_level_path(monkeypatch)
    g = _port(pts, {}, segment_impl="scatter", fast_covariance=True)
    np.testing.assert_array_equal(g, filter_ground_oracle(pts, cfg)[0])
    assert not shifts
