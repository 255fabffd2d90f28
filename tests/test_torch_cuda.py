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
    """Bitwise equality: -0.0 != +0.0, and a NaN equals only a NaN of the
    same sign and payload."""
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
    for fam in ("seg_sum", "level"):
        assert launches[fam] > 0, fam
    # every fit of the level path is one launch of the level family
    assert launches["apply_sweep"] == 0 and launches["moments2_sweep"] == 0
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
    """The path gate as if the scan were above the level path's limit."""
    return sp < 256


def _gates_above(monkeypatch):
    """The generic path, with the card's gate as if only Sp 128 passed:
    level 0 takes fit_level, deeper levels the loop of sweeps."""
    monkeypatch.setattr(fit_cuda, "megakernel_fits", _above_gate)
    monkeypatch.setattr(fit_cuda, "fit_level_fits",
                        lambda sp, fast, device, level=False: sp < 256)


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

    _gates_above(monkeypatch)
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
        _gates_above(monkeypatch)
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
    for fam in ("seg_sum", "seg_gather", "seg_minmax", "seg_plan"):
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
    g, c = LidarFusion(device=dev).fuse(clouds), LidarFusion(
        device="cpu").fuse(clouds)
    assert g.xyz.is_cuda
    assert _equal(g.xyz.cpu(), c.xyz) and torch.equal(g.valid.cpu(), c.valid)
    np.testing.assert_array_equal(fused_iac_cloud(60000, seed, device=dev),
                                  fused_iac_cloud(60000, seed, device="cpu"))


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


# ---------------------------------------------------------------------------
# the sweep plan, the planned apply sweep and the co-operative fit_level
# ---------------------------------------------------------------------------

def _order_ids(state, order):
    """Node ids of ``state`` row 3 sorted (a few nodes per tile, as in an
    azimuth-ordered scan) or left shuffled (up to a tile's width of them)."""
    if order == "sorted":
        state[:, 3] = torch.sort(state[:, 3], dim=1).values
    return state


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("s", [81, 200], ids=["sp128", "sp256"])
def test_sweep_plan_matches_plain(dev, s, order):
    _, state, tab, _ = _sweep_inputs(dev, 11, b=3, n=66 * 256, s=s)
    state = _order_ids(state, order)
    sp = tab.shape[2]
    fit_cuda.reset_launches()
    plan = fit_cuda.sweep_plan(state, sp)
    assert fit_cuda.LAUNCHES["sweep_plan"] == 1
    again = fit_cuda.sweep_plan(state, sp)
    want = fit_cuda.sweep_plan_plain(state, sp)
    for got, twice, ref in zip(plan.tensors(), again.tensors(),
                               want.tensors()):
        assert torch.equal(got, ref) and torch.equal(got, twice)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("s", [81, 200], ids=["sp128", "sp256"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_apply_sweep_with_shared_plan_matches_plain(dev, b, s, order, fast):
    pts, state, tab, trash = _sweep_inputs(dev, 13 + b, b=b, n=9 * 256, s=s)
    state = _order_ids(state, order)
    plan = fit_cuda.sweep_plan(state, tab.shape[2])
    st_p = state.clone()
    ref = fit_cuda.plain.apply_sweep(pts, st_p, tab, trash, fast)
    fit_cuda.reset_launches()
    for _ in range(2):      # the same plan, the same bits, run after run
        st_k = state.clone()
        got = fit_cuda.apply_sweep(pts, st_k, tab, trash, fast, plan)
        assert _equal(got, ref) and _equal(st_k, st_p)
    assert fit_cuda.LAUNCHES["apply_sweep"] == 2
    assert fit_cuda.LAUNCHES["sweep_plan"] == 0
    assert int(plan.done.abs().sum()) == 0, "the node counters must reset"
    # a second fit's sweeps through the same plan: the table changes
    tab2 = tab.clone()
    tab2[:, 7] *= 0.5
    st_k, st_p = state.clone(), state.clone()
    assert _equal(fit_cuda.apply_sweep(pts, st_k, tab2, trash, fast, plan),
                  fit_cuda.plain.apply_sweep(pts, st_p, tab2, trash, fast))
    assert _equal(st_k, st_p)


def test_apply_sweep_rejects_a_plan_of_other_points(dev):
    pts, state, tab, trash = _sweep_inputs(dev, 7)
    other = fit_cuda.sweep_plan(state[..., :2048].contiguous(), tab.shape[2])
    with pytest.raises(ValueError):
        fit_cuda.apply_sweep(pts, state, tab, trash, False, other)
    with pytest.raises(ValueError):
        fit_cuda.moments2_sweep(pts, state, tab[:, :3].contiguous(), trash,
                                other)


def _special_points(pts, seed):
    """-0.0, infinities and NaN among the coordinates."""
    rng = np.random.default_rng(seed)
    pts = pts.clone()
    n = pts.shape[2]
    for value, every in ((-0.0, 5), (np.inf, 41), (-np.inf, 53), (np.nan, 67)):
        at = torch.from_numpy(rng.permutation(n)[:n // every]).to(pts.device)
        pts[:, int(rng.integers(0, 3)), at] = value
    return pts


@pytest.mark.parametrize("values", ["normal", "special"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("s", [81, 200], ids=["sp128", "sp256"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_moments2_sweep_with_and_without_plan_matches_plain(dev, b, s, order,
                                                            values):
    pts, state, tab, trash = _sweep_inputs(dev, 17 + b, b=b, n=9 * 256, s=s)
    state = _order_ids(state, order)
    if values == "special":
        pts = _special_points(pts, b)
    ctab = tab[:, :3].contiguous()
    sp = tab.shape[2]
    ref = fit_cuda.plain.moments2_sweep(pts, state, ctab, trash)
    plan = fit_cuda.sweep_plan(state, sp)
    fit_cuda.reset_launches()
    for _ in range(2):      # the same plan, the same bits, run after run
        assert _equal(fit_cuda.moments2_sweep(pts, state, ctab, trash, plan),
                      ref)
    assert fit_cuda.LAUNCHES["moments2_sweep"] == 2
    assert fit_cuda.LAUNCHES["sweep_plan"] == 0
    assert int(plan.done.abs().sum()) == 0, "the node counters must reset"
    assert _equal(fit_cuda.moments2_sweep(pts, state, ctab, trash), ref)
    assert fit_cuda.LAUNCHES["sweep_plan"] == 1, "no plan given: it builds one"
    if values == "special":
        assert torch.isnan(ref).any() and not torch.isnan(ref).all()


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("s", [81, 200], ids=["sp128", "sp256"])
def test_moments2_and_apply_sweeps_share_one_plan(dev, s, order):
    # a fit's sequence on one plan: apply, moments2, apply (fast rows, a
    # larger scratch), moments2 ...; each leaves the shared counts at zero
    pts, state, tab, trash = _sweep_inputs(dev, 23, b=3, n=33 * 256, s=s)
    state = _order_ids(state, order)
    plan = fit_cuda.sweep_plan(state, tab.shape[2])
    st_k, st_p = state.clone(), state.clone()
    for step in range(4):
        fast = step == 2
        tab[:, 7] *= 0.8
        got = fit_cuda.apply_sweep(pts, st_k, tab, trash, fast, plan)
        ref = fit_cuda.plain.apply_sweep(pts, st_p, tab, trash, fast)
        assert _equal(got, ref) and _equal(st_k, st_p)
        c = (got[:, 1:4] / torch.clamp(got[:, 0:1], min=1.0)).contiguous()
        assert _equal(fit_cuda.moments2_sweep(pts, st_k, c, trash, plan),
                      fit_cuda.plain.moments2_sweep(pts, st_p, c, trash))
    assert int(plan.done.abs().sum()) == 0


@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("n", [4096, 4095, 4094, 4093, 1027, 5, 1])
def test_seg_gather_tails_and_channels(dev, c, n):
    from patchwork_tpu_torch.kernels import seg_cuda

    rng = np.random.default_rng(n + c)
    b, s = 3, 161
    seg = torch.from_numpy(rng.integers(0, s, (b, n)).astype(np.int32)).to(dev)
    table = torch.from_numpy(_extreme_values(rng, (b, c, s))).to(dev)
    got = seg_cuda.seg_gather(table, seg)
    assert got.shape == (b, c, n)
    assert _equal(got, seg_cuda.plain.seg_gather(table, seg))
    # views that start off a 16-byte boundary take the one-point path
    if n > 8:
        assert _equal(seg_cuda.seg_gather(table[1:], seg[1:]),
                      seg_cuda.plain.seg_gather(table[1:], seg[1:]))
        off = seg.reshape(-1)[1:1 + n - n % 4 - 4].reshape(1, -1)
        assert off.is_contiguous()
        assert _equal(seg_cuda.seg_gather(table[:1], off),
                      seg_cuda.plain.seg_gather(table[:1], off))


@pytest.mark.parametrize("c,s", [(3, 4096), (8, 1536), (8, 1537), (16, 4000)],
                         ids=["48KB", "48KB-c8", "above-48KB", "250KB"])
def test_seg_gather_table_sizes(dev, c, s):
    # up to 48 KB the table is staged in shared memory, above it is read
    # through the read-only cache
    from patchwork_tpu_torch.kernels import seg_cuda

    rng = np.random.default_rng(s)
    for n in (8192, 8191):
        seg = torch.from_numpy(rng.integers(0, s, (2, n)).astype(np.int32))
        table = torch.from_numpy(_extreme_values(rng, (2, c, s)))
        got = seg_cuda.seg_gather(table.to(dev), seg.to(dev))
        assert _equal(got.cpu(), seg_cuda.plain.seg_gather(table, seg))


def test_entry_points_default_to_the_card(dev):
    from patchwork_tpu_torch import (LidarFusion, PointCloud,
                                     RecursivePatchwork)
    from patchwork_tpu_torch.io.synthetic import (
        demo_point_cloud, fused_iac_cloud, iac_three_lidar_scene)
    from patchwork_tpu_torch.node import PatchworkNode, run_stream

    pts = demo_point_cloud(3000, seed=0)
    rp = RecursivePatchwork()
    assert rp.device.type == "cuda" and rp.segment(pts)[0].ground.is_cuda
    node = PatchworkNode(capacity=4096)
    assert node.device.type == "cuda" and node._pad([pts], 1)[0].is_cuda
    fit_cuda.reset_launches()
    assert len(run_stream(iter([pts]), capacity=4096, verbose=False)) == 1
    assert fit_cuda.LAUNCHES["level"] > 0, "run_stream ran no kernel"
    fusion = LidarFusion()
    assert fusion.device.type == "cuda"
    assert fusion.fuse(iac_three_lidar_scene(2000, seed=0)).xyz.is_cuda
    assert PointCloud.from_numpy(pts).xyz.is_cuda
    assert not PointCloud.from_numpy(pts, device="cpu").xyz.is_cuda
    np.testing.assert_array_equal(fused_iac_cloud(3000, 0),
                                  fused_iac_cloud(3000, 0, device="cpu"))


# NumPy in, NumPy out: that a call ran on the card shows in the card's
# allocator; "bits": the card's result equals the CPU's bit for bit
_NUMPY_ENTRY_POINTS = [
    ("remove_nan_points", (), "bits"),
    ("filter_by_distance", (5.0, 30.0), "bits"),
    ("filter_by_height", (0.2, 1.7), "bits"),
    ("compute_centroid", (), 1e-4),
    ("compute_covariance", (), 1e-4),
    ("compute_pca", (), 1e-3),
    ("compute_distances_to_plane", ([1.0, 2.0, 0.5], [0.1, 0.2, 0.97]), 1e-5),
    ("compute_point_to_plane_distance", ([1.0, 2.0, 0.5], [0.0, 0.0, 1.0]),
     1e-6),
    ("random_subsample", (700, 5), "shape"),
    ("voxel_grid_filter", (2.0,), "bits"),
    ("rotate_points_2d", (37.5,), "bits"),
    ("remove_ego_vehicle", (4.0,), "bits"),
]


@pytest.mark.parametrize("name,args,how", _NUMPY_ENTRY_POINTS,
                         ids=[e[0] for e in _NUMPY_ENTRY_POINTS])
def test_numpy_entry_points_default_to_the_card(dev, name, args, how):
    from patchwork_tpu_torch import PointCloudProcessor, RecursivePatchwork
    from patchwork_tpu_torch.io.synthetic import demo_point_cloud

    pts = demo_point_cloud(3000, seed=1)
    if name == "remove_nan_points":
        pts[::97] = np.nan
    fn = getattr(RecursivePatchwork if name in ("rotate_points_2d",
                                                "remove_ego_vehicle")
                 else PointCloudProcessor, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fn(pts, *args)
    assert torch.cuda.max_memory_allocated() > base, "nothing ran on the card"
    want = fn(pts, *args, device="cpu")
    for g, w in zip(*[x if isinstance(x, tuple) else (x,)
                      for x in (got, want)]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if how == "bits":
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        elif how != "shape":
            np.testing.assert_allclose(np.abs(g), np.abs(w), rtol=how,
                                       atol=how)


def _fit_inputs(dev, seed, b, n, s, order):
    """A fit layout with planar patches: ground near z = 0 plus clutter, a
    tau per point, every point free to update, half of them seeded."""
    rng = np.random.default_rng(seed)
    xyz = np.empty((b, 3, n), np.float32)
    xyz[:, 0:2] = rng.normal(0, 20, (b, 2, n))
    clutter = rng.random((b, n)) < 0.3
    xyz[:, 2] = np.where(clutter, rng.uniform(0.3, 2.0, (b, n)),
                         rng.normal(0, 0.03, (b, n)))
    seg = rng.integers(0, s, (b, n))
    if order == "sorted":
        seg = np.sort(seg, axis=1)
    tau = np.full((b, n), 0.125, np.float32)
    amask = seg < s - 1
    g0 = ((rng.random((b, n)) < 0.5) & amask).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (xyz, tau, amask, seg, g0)]
    return fit_cuda.fit_pack(*t[:4]), t[4][:, None].contiguous()


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("max_iter", [1, 2, 30])
@pytest.mark.parametrize("blocks", [0, 1, 7, 33, 25, 100],
                         ids=["auto", "one", "ragged", "two_tiles",
                              "two_or_three_tiles", "empty_shares"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_fit_level_blocks_batches_and_exits(dev, b, blocks, max_iter, fast):
    # 66 tiles over 7 blocks: shares of 9 and 10 tiles, 81 nodes over 7;
    # over 33 and 25 blocks shares of two and three; of 100 blocks 34 have
    # no tile and 19 no node
    p, g0 = _fit_inputs(dev, 3 * b + max_iter, b, 66 * 256, 81, "sorted")
    g_p, s_p = fit_cuda.plain.fit_level(p, g0, 81, max_iter, fast)
    # the card holds 8 x 82 blocks of 100 a scan: still more than tiles
    blocks = min(blocks, fit_cuda._fit_level_held(128, fast, False) // b)
    fit_cuda.reset_launches()
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    for _ in range(2):
        g_k, s_k = fit_cuda.fit_level(p, g0, 81, max_iter, fast=fast,
                                      _blocks_per_scan=blocks,
                                      sweeps_out=sweeps)
        assert torch.equal(g_k, g_p) and _equal(s_k, s_p)
    assert fit_cuda.LAUNCHES["fit_level"] == 2
    assert not torch.equal(g_k, g0), "no refit ran"
    k = sweeps.cpu().numpy()
    assert np.all(k >= 2) and np.all(k <= max_iter + 2)
    if max_iter <= 2:
        assert np.all(k == max_iter + 2), "a max_iter exit adds the final fit"
    if b > 1:       # a scan's result does not depend on its batch
        g_1, s_1 = fit_cuda.fit_level(p[1:2].contiguous(),
                                      g0[1:2].contiguous(), 81, max_iter,
                                      fast=fast, _blocks_per_scan=blocks)
        assert torch.equal(g_1[0], g_k[1]) and _equal(s_1[0], s_k[1])


@pytest.mark.parametrize("s", [81, 200], ids=["sp128", "sp256"])
def test_fit_level_shuffled_cloud(dev, s):
    p, g0 = _fit_inputs(dev, s, 2, 20 * 256, s, "shuffled")
    for fast in (False, True):
        g_k, s_k = fit_cuda.fit_level(p, g0, s, 5, fast=fast)
        g_p, s_p = fit_cuda.plain.fit_level(p, g0, s, 5, fast)
        assert torch.equal(g_k, g_p) and _equal(s_k, s_p)


def test_fit_level_uses_the_card_and_refuses_what_it_cannot_hold(dev):
    n = 600 * 256
    assert fit_cuda.fit_level_blocks(1, n, 81) > 1
    assert fit_cuda.fit_level_blocks(8, n, 81) > 1
    p, g0 = _fit_inputs(dev, 5, 2, 8 * 256, 81, "sorted")
    fit_cuda.reset_launches()
    with pytest.raises(RuntimeError):   # more blocks than can be resident
        fit_cuda.fit_level(p, g0, 81, 2, _blocks_per_scan=1_000_000)
    assert fit_cuda.LAUNCHES["fit_level"] == 0, "a refused launch is no launch"
    with pytest.raises(ValueError):
        fit_cuda.fit_level(p, g0, 81, 2, _blocks_per_scan=-1)
    with pytest.raises(ValueError):
        fit_cuda.fit_level(p, g0, 81, 2, sweeps_out=torch.zeros(
            3, dtype=torch.int32, device=dev))


def test_fit_level_cuts_a_batch_the_card_cannot_hold(dev):
    held = fit_cuda._fit_level_held(fit_cuda.sp_width(81), False, False)
    b = held + 3
    p, g0 = _fit_inputs(dev, 9, b, 2 * 256, 81, "sorted")
    fit_cuda.reset_launches()
    sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
    g_k, s_k = fit_cuda.fit_level(p, g0, 81, 3, sweeps_out=sweeps)
    assert fit_cuda.LAUNCHES["fit_level"] == 2
    g_p, s_p = fit_cuda.plain.fit_level(p, g0, 81, 3, False)
    assert torch.equal(g_k, g_p) and _equal(s_k, s_p)
    assert int(sweeps.min()) >= 2


# ---------------------------------------------------------------------------
# the level path's level, its fit loop included, in one launch
# ---------------------------------------------------------------------------

def _level_fit_inputs(dev, seed, b, n, s, order, fast, special=False,
                      remap=False, max_iter=100):
    """level_core's arguments on a level layout with planar nodes: ground
    near z = 0 plus clutter, parked points on the trash id (some of them
    ground from a level before), most nodes fitting, a tenth deficient
    (their zth below every point); on a remap level the ids are parents,
    about half of them split, with medians and axes.  ``special``: NaN,
    +-inf and -0.0 coordinates too."""
    rng = np.random.default_rng(seed)
    sp = fit_cuda.sp_width(s)
    trash = s - 1
    pts = np.zeros((b, 8, n), np.float32)
    pts[:, 0:2] = rng.normal(0, 20, (b, 2, n))
    clutter = rng.random((b, n)) < 0.3
    pts[:, 2] = np.where(clutter, rng.uniform(0.3, 2.0, (b, n)),
                         rng.normal(0, 0.03, (b, n)))
    if special:
        flat = pts[:, 0:3].reshape(b, -1)
        for j, v in enumerate((np.nan, np.inf, -np.inf, -0.0)):
            flat[:, 5 + j::997] = v
    seg = rng.integers(0, s, (b, n))
    if order == "sorted":
        seg = np.sort(seg, axis=1)
    parked = seg == trash
    pts[:, 3] = seg
    pts[:, 4] = parked & (rng.random((b, n)) < 0.5)
    pts[:, 5] = parked
    pts[:, 6] = np.arange(n)
    tables = np.zeros((b, 8, sp), np.float32)
    tables[:, 0, :s] = rng.uniform(0.1, 0.15, (b, s))
    tables[:, 1, :s] = np.where(rng.random((b, s)) < 0.1, -10.0,
                                rng.uniform(0.0, 0.05, (b, s)))
    tables[:, 2, :trash] = 1.0
    tables[:, 3] = 0.05
    tables[:, 4] = 10.0
    tables[:, 5] = 1.0
    if remap:
        tables[:, 6, :trash] = rng.random((b, trash)) < 0.5
    state = np.zeros((b, 4, n), np.float32)
    state[:, 0:2] = pts[:, 4:6]
    if not remap:
        state[:, 3] = seg
    pts, state, tables = [torch.from_numpy(a).to(dev)
                          for a in (pts, state, tables)]
    split = None
    if remap:
        split = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in
                      (rng.normal(0, 5, (b, sp)), rng.random((b, sp)) < 0.5))
    return (pts, state, tables, trash, max_iter, not remap, 3, 25.0, 0.05, 20,
            fast, split, None, None)


def _cut(args, lo, hi):
    """level_core's arguments of scans lo..hi."""
    pts, state, tables, *rest = args
    split = rest[8]
    rest[8] = None if split is None else tuple(t[lo:hi].contiguous()
                                               for t in split)
    return (pts[lo:hi].contiguous(), state[lo:hi].contiguous(),
            tables[lo:hi].contiguous(), *rest)


def _level_fit_both(args, blocks=0, sweeps=None, max_iter=None):
    """(stats, state) of the one launch and of its plain version."""
    pts, state, tables, trash, mi, *rest = args
    mi = mi if max_iter is None else max_iter
    st_k, st_p = state.clone(), state.clone()
    s_k = fit_cuda.level_core(pts, st_k, tables, trash, mi, *rest,
                              sweeps_out=sweeps, _blocks_per_scan=blocks)
    s_p = fit_cuda.plain.level_core(pts, st_p, tables, trash, mi, *rest)
    return (s_k, st_k), (s_p, st_p)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("max_iter", [0, 2, 30])
@pytest.mark.parametrize("blocks", [0, 1, 7, 100],
                         ids=["auto", "one", "ragged", "empty_shares"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_level_fit_blocks_batches_and_exits(dev, b, blocks, max_iter, fast):
    # 66 tiles over 7 blocks: shares of 9 and 10 tiles, 81 nodes over 7; of
    # 100 blocks 34 have no tile and 19 no node; level 0 and a remap level
    for remap in (False, True):
        args = _level_fit_inputs(dev, 3 * b + max_iter, b, 66 * 256, 81,
                                 "sorted", fast, remap=remap,
                                 max_iter=max_iter)
        g = min(blocks, fit_cuda._fit_level_held(128, fast, True) // b)
        fit_cuda.reset_launches()
        sweeps = torch.zeros(b, dtype=torch.int32, device=dev)
        for _ in range(2):
            (s_k, st_k), (s_p, st_p) = _level_fit_both(args, g, sweeps)
            assert s_k.shape == (b, 8, 128)
            assert _equal(st_k, st_p) and _equal(s_k, s_p)   # every column
        assert fit_cuda.LAUNCHES["level"] == 2
        assert fit_cuda.LAUNCHES["apply_sweep"] == 0
        assert fit_cuda.LAUNCHES["moments2_sweep"] == 0
        assert fit_cuda.LAUNCHES["sweep_plan"] == 0
        # sweep 0 (the seeds' sums) included
        k = sweeps.cpu().numpy()
        assert np.all(k >= 2) and np.all(k <= max_iter + 2)
        if max_iter <= 2:
            assert np.all(k == max_iter + 2), "a max_iter exit adds a fit"
        if max_iter:
            (s_0, st_0), _ = _level_fit_both(args, g, max_iter=0)
            assert not torch.equal(st_k[:, 0], st_0[:, 0]), "no refit ran"
        if remap:
            assert not torch.equal(st_k[:, 3], args[1][:, 3])
        if b > 1:       # a scan's result does not depend on its batch
            (s_1, st_1), _ = _level_fit_both(_cut(args, 1, 2), g)
            assert _equal(s_1[0], s_k[1]) and _equal(st_1[0], st_k[1])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("s", [81, 200, 300], ids=["sp128", "sp256", "sp384"])
def test_level_fit_widths_orders_and_special_values(dev, s, order, fast):
    for special in (False, True):
        for remap in (False, True):
            args = _level_fit_inputs(dev, s, 2, 20 * 256, s, order, fast,
                                     special, remap, 5)
            (s_k, st_k), (s_p, st_p) = _level_fit_both(args)
            assert _equal(st_k, st_p) and _equal(s_k, s_p)
            assert (st_p[:, 2] > 0.5).any(), "no deficient pick"
            if special:     # the non-finite coordinates reach the result
                fin = (torch.nan_to_num(args[0], 0.0, 1.0, -1.0),) + args[1:]
                (s_f, _), _ = _level_fit_both(fin)
                assert not _equal(s_k, s_f)


def test_level_fit_one_tile_and_a_scan_that_converges_at_once(dev):
    args = _level_fit_inputs(dev, 1, 3, 256, 81, "shuffled", False)
    # scan 1 holds parked points only: nothing fits, nothing changes
    for t in (args[0][1:2, 3], args[1][1:2, 3]):
        t.fill_(80.0)
    args[0][1, 5] = 1.0
    args[1][1, 1] = 1.0
    sweeps = torch.zeros(3, dtype=torch.int32, device=dev)
    (s_k, st_k), (s_p, st_p) = _level_fit_both(args, 0, sweeps)
    assert _equal(st_k, st_p) and _equal(s_k, s_p)
    assert int(sweeps[1]) == 2 and int(sweeps[0]) > 2
    assert torch.equal(st_k[1], args[1][1])
    # a restart from the converged masks, on the loop of sweeps (the route
    # that takes a mask): one sweep, the same sums
    pts, state, tables, trash, _, is0, min_seed, area, dz, minpts = args[:10]
    p, sp = fit_cuda.plain, tables.shape[2]
    tau, zth = tables[:, 0].contiguous(), tables[:, 1].contiguous()
    st = state.clone()
    ns = p.node_stats(pts, st, zth, trash, sp)
    flags, any_def = p.early_outs(ns, tables, zth, is0, area, dz, minpts,
                                  min_seed)
    for _ in range(min_seed):
        p.deficient_round(pts, st, flags, any_def, trash)
    m1 = p.seed_init(pts, st, flags, trash, False)
    fit = flags[:, 2].contiguous()
    sf = fit_cuda.fit_sweep_loop(fit_cuda, pts, st, m1, fit, tau, trash, 100,
                                 False)
    assert torch.equal(st[:, 0], st_k[:, 0])
    m1c = p.apply_sweep(pts, st.clone(), pts.new_zeros(3, 8, sp), trash,
                        False)
    st2 = st.clone()
    fit_cuda.reset_launches()
    sf2 = fit_cuda.fit_sweep_loop(fit_cuda, pts, st2, m1c, fit, tau, trash,
                                  100, False)
    assert fit_cuda.LAUNCHES["apply_sweep"] == 1
    assert _equal(st2, st) and _equal(sf2, sf)


def test_level_fit_gate_refusals_and_cut_batches(dev):
    assert fit_cuda.fit_level_fits(256, False, dev, level=True)
    assert fit_cuda.fit_level_fits(2560, True, dev)
    assert not fit_cuda.fit_level_fits(4224, False, dev, level=True)
    assert fit_cuda.fit_level_blocks(8, 131072, 81, level=True) > 1
    # above the gate the launch is refused, and a refused launch is none
    wide = _level_fit_inputs(dev, 2, 1, 2 * 256, 4200, "shuffled", False,
                             max_iter=2)
    fit_cuda.reset_launches()
    with pytest.raises(RuntimeError):
        _level_fit_both(wide)
    assert fit_cuda.LAUNCHES["level"] == 0
    # the phases one by one around the loop of sweeps take that width
    pts, state, tables, *rest = wide
    st_k, st_p = state.clone(), state.clone()
    a = fit_cuda.level_sequence(fit_cuda, pts, st_k, tables, *rest)
    b = fit_cuda.level_sequence(fit_cuda.plain, pts, st_p, tables, *rest)
    assert _equal(a, b) and _equal(st_k, st_p)
    assert 1 <= fit_cuda.LAUNCHES["apply_sweep"] <= 3
    assert fit_cuda.LAUNCHES["sweep_plan"] == 1
    # a batch above the card's co-resident blocks is cut, not refused
    held = fit_cuda._fit_level_held(128, False, True)
    args = _level_fit_inputs(dev, 9, held + 3, 2 * 256, 81, "sorted", False,
                             remap=True, max_iter=3)
    fit_cuda.reset_launches()
    sweeps = torch.zeros(held + 3, dtype=torch.int32, device=dev)
    (s_k, st_k), (s_p, st_p) = _level_fit_both(args, 0, sweeps)
    assert fit_cuda.LAUNCHES["level"] == 2
    assert _equal(st_k, st_p) and _equal(s_k, s_p)
    assert int(sweeps.min()) >= 2
    with pytest.raises(ValueError):
        _level_fit_both(args[:2] + (args[2][:, :3],) + args[3:])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_level_fit_at_the_widest_table_the_gate_admits(dev, fast):
    # the kernel's shared memory is sized in one place, in Python
    # (fit_level_smem_bytes); with one block a scan that block owns every
    # node, the most the kernel's carve-up takes
    sp = max(w for w in range(128, 8192, 128)
             if fit_cuda.fit_level_fits(w, fast, dev, level=True))
    assert sp >= 2560
    args = _level_fit_inputs(dev, sp, 2, 64 * 256, sp - 3, "shuffled", fast,
                             remap=True, max_iter=3)
    for blocks in (1, 0):
        (s_k, st_k), (s_p, st_p) = _level_fit_both(args, blocks)
        assert _equal(st_k, st_p) and _equal(s_k, s_p)
    (_, st_0), _ = _level_fit_both(args, max_iter=0)
    assert not torch.equal(st_k[:, 0], st_0[:, 0]), "no refit ran"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_level_path_fit_is_one_launch_a_level(dev, mode):
    # velodyne: no patch splits, one level: one launch of the level family,
    # no sweep and no plan of its own
    xyz = torch.from_numpy(np.stack([velodyne_like_cloud(16384, seed=i)
                                     for i in range(2)])).to(dev)
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    fit_cuda.reset_launches()
    filter_ground_batched(xyz, valid, PatchworkConfig(**MODES[mode]))
    assert fit_cuda.LAUNCHES["apply_sweep"] == 0
    assert fit_cuda.LAUNCHES["moments2_sweep"] == 0
    assert fit_cuda.LAUNCHES["sweep_plan"] == 0
    # percentile seeds count the nodes twice ahead of the launch
    assert fit_cuda.LAUNCHES["level"] == 1 + 2 * (mode == "percentile")


# ---------------------------------------------------------------------------
# the order statistic, redesigned
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("s", [128, 256, 384])
def test_order_stat_widths_ranks_and_empty_segments(dev, s, order):
    rng = np.random.default_rng(s)
    b, n = 3, 30000
    vals = rng.normal(0, 50, (b, n)).astype(np.float32)
    vals[:, ::7] = 0.0
    vals[:, 1::13] = -0.0
    vals[:, 2::11] = vals[:, :1]                 # ties
    vals[:, 3::17] = np.float32(1e-42)           # denormals
    vals[:, 4::101] = np.float32(3e38)
    vals[:, 5::103] = np.float32(-3e38)
    seg = rng.integers(0, s - 20, (b, n))        # 20 segments stay empty
    seg[0, : n // 2] = 3                         # one large segment
    if order == "sorted":
        seg = np.sort(seg, axis=1)
    seg = seg.astype(np.int32)
    valid = rng.random((b, n)) > 0.2
    cnt = np.stack([np.bincount(seg[i][valid[i]], minlength=s)
                    for i in range(b)])
    k = np.floor(rng.random((b, s)) * cnt).astype(np.int32)
    k[:, 0] = 0                                  # the smallest
    k[:, 1] = np.maximum(cnt[:, 1] - 1, 0)       # the largest
    k[:, 5] = cnt[:, 5]                          # out of range, above
    k[:, 6] = -1                                 # and below
    k[:, 7] = 2 ** 31 - 1
    args = [torch.from_numpy(a).to(dev) for a in (vals, seg, valid, k)]
    got = fit_cuda.seg_order_stat(*args, s)
    ref = fit_cuda.plain.seg_order_stat(*args, s).cpu().numpy()
    # out of range is garbage by contract, but the same garbage every run:
    # it is a function of the counts
    assert _equal(got, fit_cuda.seg_order_stat(*args, s))
    got = got.cpu().numpy()
    ok = (k >= 0) & (k < cnt)
    assert ok.sum() > b * (s - 30)
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  ref[ok].view(np.int32))
    for i, j in zip(*np.nonzero(ok)):
        if j < 8:
            assert got[i, j] == np.sort(
                vals[i][(seg[i] == j) & valid[i]])[k[i, j]]


def test_order_stat_main_path_size_and_nothing_valid(dev):
    rng = np.random.default_rng(5)
    b, n, s = 8, 131072, 256
    vals = torch.from_numpy(rng.normal(0, 30, (b, n)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 200, (b, n)).astype(np.int32))
    valid = torch.from_numpy(rng.random((b, n)) > 0.1)
    valid[2] = False                             # a scan with no candidate
    cnt = torch.stack([torch.bincount(seg[i][valid[i]].long(), minlength=s)
                       for i in range(b)])
    k = (cnt // 2).to(torch.int32)
    args = [a.to(dev) for a in (vals, seg, valid, k)]
    got = fit_cuda.seg_order_stat(*args, s)
    ref = fit_cuda.plain.seg_order_stat(*args, s)
    ok = (cnt > 0).to(dev)
    assert _equal(got[ok], ref[ok])
    with pytest.raises(ValueError):
        fit_cuda.seg_order_stat(*args, 7000)     # beyond the shared counters


# ---------------------------------------------------------------------------
# the voxel filter's in-order sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("voxel", [0.25, 2.0, 30.0])
def test_voxel_grid_filter_same_bits_run_after_run(dev, voxel):
    from patchwork_tpu_torch.io.synthetic import demo_point_cloud
    from patchwork_tpu_torch.kernels import seg_cuda
    from patchwork_tpu_torch.ops.sampling import voxel_grid_filter

    pts = torch.from_numpy(demo_point_cloud(50000, seed=3))
    valid = torch.from_numpy(np.random.default_rng(3).random(50000) > 0.1)
    fit_cuda.reset_launches()
    runs = [voxel_grid_filter(pts.to(dev), valid.to(dev), voxel)
            for _ in range(3)]
    assert fit_cuda.LAUNCHES["run_sum"] == 3
    for c, v in runs[1:]:
        assert _equal(c, runs[0][0]) and torch.equal(v, runs[0][1])
    # and they are the CPU's bits: the same sort, the same order of adds
    c_cpu, v_cpu = voxel_grid_filter(pts, valid, voxel)
    assert torch.equal(runs[0][1].cpu(), v_cpu)
    assert _equal(runs[0][0].cpu(), c_cpu)
    # the kernel against its plain version on the card
    n = 20000
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.normal(0, 1e3, (n, 3)).astype(np.float32))
    live = torch.arange(n) < n - 500
    first = torch.from_numpy(rng.random(n) < 1.0 / (1 + voxel)) & live
    first[0] = True
    run = (torch.cumsum(first.long(), 0) - 1).to(torch.int32)
    a = [t.to(dev) for t in (rows, first, live, run)]
    for x, y in zip(seg_cuda.run_sum(*a), seg_cuda.plain.run_sum(*a)):
        assert _equal(x, y)


# ---- the segment ops over a binding's plan (#6 seg_sum, #8 seg_minmax) ----

SEG_SHAPES = {   # label: (B, N, S): binning, the generic path's deeper
    # levels, the wide table's binding and width, a ragged N
    "binning": (8, 131072, 81),
    "generic deeper": (8, 153600, 161),
    "wide 4097": (2, 32768, 4097),
    "wide 4224": (2, 32768, 4224),
    "ragged": (3, 5000, 161),
}


def _seg_case(dev, label, order, seed):
    b, n, s = SEG_SHAPES[label]
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, s, (b, n))
    if order == "sorted":
        seg = np.sort(seg, axis=1)
    seg[:, ::97] = s - 1                         # a trash node, as the engine
    seg = np.where(seg % 7 == 3, s - 1, seg)     # empty segments
    return torch.from_numpy(seg.astype(np.int32)).to(dev), rng


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("label", sorted(SEG_SHAPES))
def test_seg_sum_routes_match_plain(dev, label, order):
    # without a plan (the dense route) and over a plan built for the call
    # or once for a binding, each twice, every bit of the plain version
    seg, rng = _seg_case(dev, label, order, 1)
    b, n, s = SEG_SHAPES[label]
    for r in (1, 2, 8):
        rows = torch.from_numpy(_extreme_values(rng, (b, r, n))).to(dev)
        want = fit_cuda.plain.seg_sum(rows, seg, s)
        plan = fit_cuda.seg_plan(seg, s)
        fit_cuda.reset_launches()
        got = [fit_cuda.seg_sum(rows, seg, s) for _ in range(2)]
        got += [fit_cuda.seg_sum(rows, seg, s, plan=fit_cuda.seg_plan(seg, s))
                for _ in range(2)]
        got += [fit_cuda.seg_sum(rows, seg, s, plan=plan) for _ in range(2)]
        assert fit_cuda.LAUNCHES["seg_sum"] == 6
        assert fit_cuda.LAUNCHES["seg_plan"] == 2
        for g in got:
            assert g.shape == (b, r, s) and _equal(g, want), r
        assert int(plan.done.abs().sum()) == 0, "the counters must reset"


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("label", sorted(SEG_SHAPES))
def test_seg_minmax_matches_plain_at_main_path_shapes(dev, label, order):
    from patchwork_tpu_torch.kernels import seg_cuda

    seg, rng = _seg_case(dev, label, order, 2)
    b, n, s = SEG_SHAPES[label]
    for c in (1, 3):
        vals = torch.from_numpy(_extreme_values(rng, (b, c, n)))
        vals[..., 6::59] = float("nan")
        vals[..., 8::61] = -float("nan")
        vals = vals.to(dev)
        mask = torch.from_numpy(rng.random((b, n)) < 0.6).to(dev)
        mask[seg == 5] = False                   # all of a segment masked
        want = seg_cuda.plain.seg_minmax(vals, seg, mask, s)
        fit_cuda.reset_launches()
        got = [seg_cuda.seg_minmax(vals, seg, mask, s) for _ in range(2)]
        assert fit_cuda.LAUNCHES["seg_minmax"] == 2
        for mins, maxs in got:
            assert _equal(mins, want[0]) and _equal(maxs, want[1]), c
        assert torch.isposinf(want[0][:, :, 5]).all()
        assert torch.isneginf(want[1][:, :, 5]).all()


def test_segops_binding_builds_one_plan(dev):
    from patchwork_tpu_torch.segment.segops import SegOps

    seg, rng = _seg_case(dev, "generic deeper", "sorted", 3)
    b, n, s = SEG_SHAPES["generic deeper"]
    xyz = torch.from_numpy(_extreme_values(rng, (b, 3, n))).to(dev)
    mask = torch.from_numpy(rng.random((b, n)) < 0.5).to(dev)
    ops = SegOps(seg, s, "pallas")
    ref = SegOps(seg, s, "pallas", plain=True)
    fit_cuda.reset_launches()
    calls = [("sum", (xyz,)), ("count", (mask,)), ("min", (xyz[:, 2], mask)),
             ("max", (xyz[:, 0], mask)), ("bbox", (xyz, mask))]
    for name, args in calls:
        before = dict(fit_cuda.LAUNCHES)
        got = getattr(ops, name)(*args)
        d = {k: v - before[k] for k, v in fit_cuda.LAUNCHES.items()
             if v != before[k]}
        # the sums build the plan once; min, max and bbox take none
        fam = "seg_minmax" if name in ("min", "max", "bbox") else "seg_sum"
        plans = {"seg_plan": 1} if name == "sum" else {}
        assert d.pop(fam) == 1 and d == plans, (name, d)
        want = getattr(ref, name)(*args)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        assert all(_equal(g, w) for g, w in zip(got, want)), name
    assert fit_cuda.LAUNCHES["seg_plan"] == 1, "one plan for the binding"
    assert ops.plan is not None and ref.plan is None
    # another stream orders itself after the plan's last use
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        again = ops.sum(xyz)
    side.synchronize()
    assert _equal(again, ref.sum(xyz))


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("scene", ["split", "percentile_split"])
def test_card_masks_match_the_numpy_oracle(dev, scene, impl):
    # the card's exact masks against the port's own NumPy oracle, every bit
    # of all four masks (chip_smoke.py phase 10 runs every parity scene)
    from patchwork_tpu_torch.oracle.reference import filter_ground_oracle
    from patchwork_tpu_torch.oracle.scenes import PARITY_SCENES

    make, kw = PARITY_SCENES[scene]
    pts = make()
    outs = filter_ground_oracle(pts, PatchworkConfig(**kw))
    x = torch.from_numpy(pts)[None].to(dev)
    v = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
    res = filter_ground_batched(x, v, PatchworkConfig(segment_impl=impl, **kw))
    for name, want in zip(("ground", "valid", "in_zone", "in_patch"), outs):
        np.testing.assert_array_equal(getattr(res, name)[0].cpu().numpy(),
                                      want, err_msg=name)
