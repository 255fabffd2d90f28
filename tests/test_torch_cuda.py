"""Every CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and skip without one.  They import no JAX, so
they run where only PyTorch is installed; the repository's conftest.py
imports JAX, hence:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The plain versions add in the kernels' order and the kernels are built with
``-fmad=false``, so kernel and plain version are held to the same bits.
"""

import numpy as np
import pytest
import torch

from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
from patchwork_tpu_torch.io.synthetic import velodyne_like_cloud
from patchwork_tpu_torch.kernels import fit_cuda

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from patchwork_tpu_torch.core.device import cuda_device

    return cuda_device()


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (NaN == NaN, -0.0 != +0.0)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def test_order_stat_matches_plain_and_sort(dev):
    # several blocks per scan (N > the kernel's chunk), two scans, 200
    # segments, with ties, signed zeros, denormals and +-3e38
    rng = np.random.default_rng(0)
    b, n, s = 2, 20000, 200
    vals = rng.normal(0, 50, (b, n)).astype(np.float32)
    vals[:, ::7] = 0.0
    vals[:, 1::13] = -0.0
    vals[:, 2::11] = vals[:, :1]
    vals[:, 3::17] = np.float32(1e-42)
    vals[:, 4::101] = np.float32(3e38)
    vals[:, 5::103] = np.float32(-3e38)
    seg = rng.integers(0, s, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) > 0.2
    cnt = np.stack([np.bincount(seg[i][valid[i]], minlength=s) for i in range(b)])
    k = np.floor(rng.random((b, s)) * cnt).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (vals, seg, valid, k)]

    fit_cuda.reset_launches()
    got = fit_cuda.seg_order_stat(*args, s).cpu().numpy()
    assert fit_cuda.LAUNCHES["seg_order_stat"] == 1
    ref = fit_cuda.plain.seg_order_stat(*args, s).cpu().numpy()
    has = cnt > 0
    np.testing.assert_array_equal(got[has].view(np.int32), ref[has].view(np.int32))
    for i, j in zip(*np.nonzero(has)):   # np.sort leaves -0.0 == 0.0 unordered
        assert got[i, j] == np.sort(vals[i][(seg[i] == j) & valid[i]])[k[i, j]]


def test_order_stat_every_rank_of_extremes(dev):
    vals = np.array([-3e38, -1.0, -1e-40, -0.0, 0.0, 1e-40, 1.0, 3e38],
                    np.float32)
    perm = np.random.default_rng(1).permutation(8)
    v = torch.from_numpy(np.tile(vals[perm], 8))[None].to(dev)
    seg = torch.arange(8, dtype=torch.int32).repeat_interleave(8)[None].to(dev)
    valid = torch.ones_like(seg, dtype=torch.bool)
    k = torch.arange(8, dtype=torch.int32)[None].to(dev)
    got = fit_cuda.seg_order_stat(v, seg, valid, k, 8)[0].cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32), vals.view(np.int32))


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_seg_sum_matches_plain(dev, rows):
    rng = np.random.default_rng(rows)
    b, n, s = 2, 1000, 81          # n is padded to a tile multiple
    vals = torch.from_numpy(rng.normal(0, 1e3, (b, rows, n)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, s, (b, n)).astype(np.int32))
    got = fit_cuda.seg_sum(vals.to(dev), seg.to(dev), s)
    ref = fit_cuda.plain.seg_sum(vals.to(dev), seg.to(dev), s)
    assert got.shape == (b, rows, s)
    assert _equal(got, ref)


def _sweep_inputs(dev, seed, b=2, n=4096, s=81):
    rng = np.random.default_rng(seed)
    sp = fit_cuda.sp_width(s)
    trash = s - 1
    pts = np.zeros((b, 8, n), np.float32)
    pts[:, 0:2] = rng.normal(0, 20, (b, 2, n))
    pts[:, 2] = rng.normal(0, 0.3, (b, n))
    state = np.zeros((b, 4, n), np.float32)
    state[:, 0] = rng.random((b, n)) < 0.5
    state[:, 3] = rng.integers(0, s, (b, n))      # seg == trash: not live
    tab = np.zeros((b, 8, sp), np.float32)
    tab[:, 0:3, :s] = rng.normal(0, 5, (b, 3, s))
    nrm = rng.normal(0, 1, (b, 3, s))
    tab[:, 3:6, :s] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    tab[:, 6, :s] = rng.random((b, s)) < 0.7
    tab[:, 7, :s] = rng.uniform(0.1, 0.4, (b, s))
    return [torch.from_numpy(a).to(dev) for a in (pts, state, tab)] + [trash]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_apply_sweep_matches_plain(dev, fast):
    pts, state, tab, trash = _sweep_inputs(dev, 3)
    st_k, st_p = state.clone(), state.clone()
    got = fit_cuda.apply_sweep(pts, st_k, tab, trash, fast)
    ref = fit_cuda.plain.apply_sweep(pts, st_p, tab, trash, fast)
    assert got.shape == (2, 12 if fast else 6, tab.shape[2])
    assert _equal(st_k, st_p)
    assert not torch.equal(st_k, state), "the sweep must re-threshold points"
    assert _equal(got, ref)


def test_moments2_sweep_matches_plain(dev):
    pts, state, tab, trash = _sweep_inputs(dev, 5)
    ctab = tab[:, 0:3].contiguous()
    got = fit_cuda.moments2_sweep(pts, state, ctab, trash)
    ref = fit_cuda.plain.moments2_sweep(pts, state, ctab, trash)
    assert _equal(got, ref)


def _split_terrain(n, seed):
    """Sloped ground with a 0.5 m step and box obstacles: residuals split
    patches, so the run reaches the remap levels."""
    rng = np.random.default_rng(seed)
    n_obst = n // 6
    g = np.empty((n - n_obst, 3), np.float32)
    g[:, 0] = rng.uniform(-80, 80, len(g))
    g[:, 1] = rng.uniform(-80, 80, len(g))
    g[:, 2] = 0.08 * g[:, 0] + 0.5 * (g[:, 1] > 20) + rng.normal(0, 0.05, len(g))
    obst = np.column_stack([rng.uniform(-40, 40, (n_obst, 2)),
                            rng.uniform(0.5, 3.0, n_obst)])
    return np.concatenate([g, obst]).astype(np.float32)


SCENES = {"velodyne": velodyne_like_cloud, "split": _split_terrain}
MODES = {"exact": {}, "fast": {"fast_covariance": True},
         "percentile": {"adaptive_seed_height": False}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_slice_matches_plain(dev, scene, mode):
    cfg = PatchworkConfig(**MODES[mode])
    xyz = torch.from_numpy(np.stack([SCENES[scene](16384, seed=i)
                                     for i in range(2)])).to(dev)
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    fit_cuda.reset_launches()
    g_k = filter_ground_batched(xyz, valid, cfg).ground
    launches = dict(fit_cuda.LAUNCHES)
    g_p = filter_ground_batched(xyz, valid, cfg, plain=True).ground
    assert torch.equal(g_k, g_p)
    assert fit_cuda.LAUNCHES == launches, "the plain path launched a kernel"
    for fam in ("seg_sum", "apply_sweep", "level"):
        assert launches[fam] > 0, fam
    if mode == "exact":
        assert launches["moments2_sweep"] > 0
    if scene == "split" or mode == "percentile":
        assert launches["seg_order_stat"] > 0


def _extreme_values(rng, shape):
    vals = rng.normal(0, 50, shape).astype(np.float32)
    vals[..., ::7] = 0.0
    vals[..., 1::13] = -0.0
    vals[..., 2::11] = np.float32(1e-42)
    vals[..., 3::17] = np.float32(-1e-42)
    vals[..., 4::101] = np.float32(3e38)
    vals[..., 5::103] = np.float32(-3e38)
    return vals


@pytest.mark.parametrize("b", [1, 3, 8])
def test_seg_gather_and_minmax_match_plain(dev, b):
    from patchwork_tpu_torch.kernels import seg_cuda

    rng = np.random.default_rng(b)
    n, s = 20000, 161
    seg = torch.from_numpy(rng.integers(0, s, (b, n)).astype(np.int32)).to(dev)
    for c in (1, 3):
        table = torch.from_numpy(_extreme_values(rng, (b, c, s))).to(dev)
        vals = torch.from_numpy(_extreme_values(rng, (b, c, n))).to(dev)
        mask = torch.from_numpy(rng.random((b, n)) < 0.6).to(dev)
        mask[seg == 5] = False                 # an empty segment
        fit_cuda.reset_launches()
        got = seg_cuda.seg_gather(table, seg)
        mins, maxs = seg_cuda.seg_minmax(vals, seg, mask, s)
        assert fit_cuda.LAUNCHES["seg_gather"] == 1
        assert fit_cuda.LAUNCHES["seg_minmax"] == 1
        assert _equal(got, seg_cuda.plain.seg_gather(table, seg))
        ref_min, ref_max = seg_cuda.plain.seg_minmax(vals, seg, mask, s)
        assert _equal(mins, ref_min) and _equal(maxs, ref_max)
        assert torch.isposinf(mins[:, :, 5]).all()
        assert torch.isneginf(maxs[:, :, 5]).all()


def _above_gate(n, sp):
    """The fit gate as if the scan were above the level path's limit:
    level 0 (Sp 128) takes fit_level, deeper levels the loop of sweeps."""
    return sp < 256


def _scans(scene, n=16384):
    return torch.from_numpy(np.stack([SCENES[scene](n, seed=i)
                                      for i in range(2)]))


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_fit_level_matches_plain(dev, monkeypatch, scene, fast):
    # a level-0 input of the generic path: binning, seeded mask, tau per patch
    seen = []
    orig = fit_cuda.fit_level

    def capture(p, g0, *args, **kw):
        seen.append((p.clone(), g0.clone(), args, kw))
        return orig(p, g0, *args, **kw)

    monkeypatch.setattr(fit_cuda, "megakernel_fits", _above_gate)
    monkeypatch.setattr(fit_cuda, "fit_level", capture)
    xyz = _scans(scene).to(dev)
    filter_ground_batched(xyz, torch.ones(xyz.shape[:2], dtype=torch.bool,
                                          device=dev),
                          PatchworkConfig(fast_covariance=fast))
    p, g0, (num_segs, max_iter), kw = seen[0]
    assert kw["fast"] == fast
    fit_cuda.reset_launches()
    g_k, s_k = orig(p, g0, num_segs, max_iter, fast=fast)
    assert fit_cuda.LAUNCHES["fit_level"] == 1
    g_p, s_p = fit_cuda.plain.fit_level(p, g0, num_segs, max_iter, fast)
    assert _equal(g_k, g_p) and _equal(s_k, s_p)
    assert not torch.equal(g_k, g0), "no refit ran"


@pytest.mark.parametrize("impl", ["pallas", "fused"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_generic_path_matches_plain(dev, monkeypatch, scene, impl):
    from patchwork_tpu_torch.segment import engine

    def no_level_path(*args, **kwargs):
        raise AssertionError("the level path ran")

    if impl == "fused":
        monkeypatch.setattr(fit_cuda, "megakernel_fits", _above_gate)
    monkeypatch.setattr(engine, "level", no_level_path)
    monkeypatch.setattr(engine, "level_reference", no_level_path)
    cfg = PatchworkConfig(segment_impl=impl)
    xyz = _scans(scene).to(dev)
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    fit_cuda.reset_launches()
    g_k = filter_ground_batched(xyz, valid, cfg).ground
    launches = dict(fit_cuda.LAUNCHES)
    g_p = filter_ground_batched(xyz, valid, cfg, plain=True).ground
    assert torch.equal(g_k, g_p)
    assert fit_cuda.LAUNCHES == launches, "the plain path launched a kernel"
    for fam in ("seg_sum", "seg_gather", "seg_minmax"):
        assert launches[fam] > 0, fam
    if impl == "fused":
        assert launches["fit_level"] > 0
        if scene == "split":
            assert launches["apply_sweep"] > 0


def test_wrappers_reject_bad_cuda_inputs(dev):
    pts, state, tab, trash = _sweep_inputs(dev, 7)
    with pytest.raises(ValueError):     # N not a tile multiple
        fit_cuda.apply_sweep(pts[..., :100].contiguous(),
                             state[..., :100].contiguous(), tab, trash, False)
    with pytest.raises(ValueError):     # not contiguous
        fit_cuda.moments2_sweep(pts, state, tab[:, 0:3], trash)
    with pytest.raises(ValueError):     # mixed devices
        fit_cuda.apply_sweep(pts, state.cpu(), tab, trash, False)
    with pytest.raises(TypeError):      # not float32
        fit_cuda.apply_sweep(pts.double(), state, tab, trash, False)


@pytest.mark.parametrize("seed", [0, 1])
def test_fusion_on_cuda_equals_cpu(dev, seed):
    from patchwork_tpu_torch.fusion.fusion import LidarFusion
    from patchwork_tpu_torch.io.synthetic import (
        fused_iac_cloud, iac_three_lidar_scene)

    clouds = iac_three_lidar_scene(20000, seed=seed)
    g, c = LidarFusion(device=dev).fuse(clouds), LidarFusion().fuse(clouds)
    assert g.xyz.is_cuda
    assert _equal(g.xyz.cpu(), c.xyz) and torch.equal(g.valid.cpu(), c.valid)
    np.testing.assert_array_equal(fused_iac_cloud(60000, seed, device=dev),
                                  fused_iac_cloud(60000, seed))


def test_bev_images_on_cuda_equal_cpu(dev):
    from patchwork_tpu_torch.viz import bev

    rng = np.random.default_rng(3)
    xyz = np.column_stack([rng.uniform(-200, 200, 50000),
                           rng.uniform(-100, 100, 50000),
                           rng.uniform(-4, 4, 50000)]).astype(np.float32)
    xyz[:4, :2] = [[-150.0, -75.0], [149.99, 74.99], [150.0, 0.0], [np.nan, 0]]
    mask = rng.random(50000) > 0.3
    ground = mask & (np.arange(50000) % 2 == 0)
    c = [torch.from_numpy(a) for a in (xyz, mask, ground, mask & ~ground)]
    g = [t.to(dev) for t in c]
    for fn, args in ((bev.bev_height_image, (0, 1)),
                     (bev.bev_enhanced_image, (0, 1)),
                     (bev.bev_ground_nonground_image, (0, 2, 3))):
        img_g = fn(*(g[i] for i in args))
        assert img_g.is_cuda
        assert torch.equal(img_g.cpu(), fn(*(c[i] for i in args)))
