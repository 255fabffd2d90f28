"""The point-sharded engine's own pieces, on the CPU: kernel #2's per-round
order statistic with its histograms summed over in-process ranks, the
engine on a world-size-1 group, and the size of what crosses the ranks.

The four-process runs against the JAX package's GSPMD engine are in
tests/test_torch_parallel.py (one spawn of tools/torch_multihost_bench.py).
Tolerances: none; every comparison is bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
from patchwork_tpu_torch.io.synthetic import (demo_point_cloud,
                                              split_terrain_cloud)
from patchwork_tpu_torch.kernels import fit_cuda
from patchwork_tpu_torch.parallel import (initialize_multihost, make_mesh,
                                          make_sharded_filter_ground,
                                          make_sharded_pipeline)
from patchwork_tpu_torch.parallel import mesh as tmesh
from patchwork_tpu_torch.segment import segops

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import rounds_in_parts  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def group(tmp_path):
    """A world-size-1 gloo group, left again at teardown."""
    assert initialize_multihost(f"file://{tmp_path}/store", 1, 0,
                                backend="gloo")
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the order statistic's rounds across in-process ranks
# ---------------------------------------------------------------------------

def _order_stat_inputs(kind: str, seed: int, b=2, n=3000, s=40):
    """(vals, seg, valid, k, cnt): values of one kind, segment 0 on the first
    tenth of each scan only (empty on every other block), the last two
    segments empty, k in range wherever a segment has points and -1 where
    it has none."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 10, (b, n)).astype(np.float32)
    if kind == "ties":
        vals = np.round(vals / 4).astype(np.float32)
    elif kind == "signed zeros":
        vals = np.where(rng.random((b, n)) < 0.5, np.float32(0.0),
                        np.float32(-0.0)) * (rng.random((b, n)) < 0.8)
        vals[:, ::7] = rng.normal(0, 1e-3, vals[:, ::7].shape)
    elif kind == "denormals":
        vals = (rng.integers(-50, 50, (b, n)) * np.float32(1e-42)).astype(
            np.float32)
    elif kind == "extremes":
        pick = rng.integers(0, 4, (b, n))
        vals = np.choose(pick, [np.float32(3e38), np.float32(-3e38),
                                vals, np.float32(-0.0)]).astype(np.float32)
    seg = rng.integers(1, s - 2, (b, n)).astype(np.int32)
    seg[:, :n // 10] = 0
    seg[:, n // 10:][seg[:, n // 10:] == 0] = 1
    valid = rng.random((b, n)) < 0.9
    cnt = np.stack([np.bincount(seg[i][valid[i]], minlength=s)
                    for i in range(b)])
    k = np.where(cnt > 0, rng.integers(0, 1 << 30, (b, s)) % np.maximum(cnt, 1),
                 -1).astype(np.int32)
    k[:, 1] = np.where(cnt[:, 1] > 0, 0, -1)                 # the smallest
    k[:, 2] = np.where(cnt[:, 2] > 0, cnt[:, 2] - 1, -1)     # the largest
    return (torch.from_numpy(vals), torch.from_numpy(seg),
            torch.from_numpy(valid), torch.from_numpy(k), cnt)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("kind", ["normal", "ties", "signed zeros",
                                  "denormals", "extremes"])
def test_rounds_across_ranks_equal_the_sort(kind, parts):
    s = 40
    vals, seg, valid, k, cnt = _order_stat_inputs(kind, seed=parts, s=s)
    want = fit_cuda.seg_order_stat_plain(vals, seg, valid, k, s)
    used = torch.from_numpy(k.numpy() >= 0)
    assert used.sum() > 0 and (~used).sum() > 0
    outs = rounds_in_parts(fit_cuda.seg_order_stat, (vals, seg, valid, k, s),
                           parts)
    for got in outs:
        np.testing.assert_array_equal(_bits(got[used]), _bits(want[used]))
        np.testing.assert_array_equal(_bits(got[~used]),
                                      np.zeros(int((~used).sum()), np.int32))
    # the sort-based order statistic of segops, as the engine takes it in
    # one process
    ss = segops.sort_by_segment(
        segops.flatten_batch(torch.where(valid, seg, s), s + 1),
        vals.reshape(-1), 2 * (s + 1))
    ref = ss.order_stat(torch.cat([k, k[:, :1]], 1).reshape(-1)).reshape(
        2, s + 1)[:, :s]
    np.testing.assert_array_equal(_bits(outs[0][used]), _bits(ref[used]))


def test_rounds_out_of_range_agree_across_ranks():
    """A rank out of range (k >= the count, an empty segment) indexes
    nothing out of bounds and gives every rank the same bits."""
    s = 12
    vals, seg, valid, _, cnt = _order_stat_inputs("normal", seed=5, s=s)
    k = torch.from_numpy(np.stack([cnt[0] + 3, cnt[1] * 0]).astype(np.int32))
    one = rounds_in_parts(fit_cuda.seg_order_stat, (vals, seg, valid, k, s),
                          1)[0]
    for got in rounds_in_parts(fit_cuda.seg_order_stat,
                               (vals, seg, valid, k, s), 4):
        np.testing.assert_array_equal(_bits(got), _bits(one))


def test_all_sum_takes_integers_only(group):
    g = make_mesh(device_type="cpu").get_group("sp")
    t = torch.arange(6, dtype=torch.int32)
    assert torch.equal(tmesh.all_sum(t, g), t)
    with pytest.raises(TypeError, match="ordered_sum"):
        tmesh.all_sum(t.to(torch.float32), g)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _batch(gen, n, seeds):
    xyz = torch.from_numpy(np.stack([gen(n, s) for s in seeds]))
    return xyz, torch.ones(xyz.shape[:2], dtype=torch.bool)


@pytest.mark.parametrize("cfg", [
    {}, {"adaptive_seed_height": False},
    {"filtering_radius": 60.0, "max_levels": 3, "segment_impl": "pallas"}],
    ids=["default", "percentile", "pallas"])
def test_one_rank_equals_the_engine(group, cfg):
    """On a world-size-1 group the point-sharded engine is
    filter_ground_batched with the impl it forces, bit for bit; the order
    statistics take kernel #2's per-round entry (its plain version here)."""
    cfg = PatchworkConfig(**cfg)
    m = make_mesh(device_type="cpu")
    xyz, valid = _batch(split_terrain_cloud, 16384, [3, 4])
    before = dict(segops.ORDER_STATS)
    res, g_cnt, ng_cnt = make_sharded_pipeline(cfg, m)(xyz, valid)
    taken = {k: v - before[k] for k, v in segops.ORDER_STATS.items()}
    want = filter_ground_batched(xyz, valid, cfg.replace(
        segment_impl=cfg.segment_impl or "scatter"))
    for field in ("ground", "valid", "in_zone", "in_patch"):
        assert torch.equal(getattr(res, field), getattr(want, field))
    assert torch.equal(g_cnt, want.ground.sum(1, dtype=torch.int32))
    assert torch.equal(ng_cnt, (want.valid & ~want.ground).sum(
        1, dtype=torch.int32))
    if cfg.adaptive_seed_height:
        assert taken["median"] >= 1, "the scene must remap"
        assert taken["percentile"] == 0
    else:   # percentile seeds fit this scene's slope: a level, no split
        assert taken["percentile"] == taken["median"] + 1
    assert taken["histograms"] == 5 * (taken["median"]
                                       + taken["percentile"])


def _payloads(monkeypatch, fn, *args):
    """Run fn, recording the shape of every collective's payload of
    parallel/mesh.py (its all_gather and all_reduce helpers, which a group
    of one rank enters too), in call order."""
    seen = []
    gather, reduce = tmesh.all_gather, tmesh._all_reduce

    def rec_gather(t, group):
        seen.append(tuple(t.shape))
        return gather(t, group)

    def rec_reduce(t, group, op):
        seen.append(tuple(t.shape))
        return reduce(t, group, op)

    monkeypatch.setattr(tmesh, "all_gather", rec_gather)
    monkeypatch.setattr(tmesh, "_all_reduce", rec_reduce)
    fn(*args)
    monkeypatch.setattr(tmesh, "all_gather", gather)
    monkeypatch.setattr(tmesh, "_all_reduce", reduce)
    return seen


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "percentile"])
def test_no_points_cross(group, monkeypatch, adaptive):
    """Every collective but the final join of the masks (over sp, then dp)
    carries a per-node block.  The scans at 2N points are those at N with
    every point twice: the engine makes the same collectives with the same
    payloads, but for the order statistic's (M, 128) histograms, whose M
    counts the nodes that split or fit (at most B x S), and the join, which
    doubles."""
    cfg = PatchworkConfig(filtering_radius=60.0, max_levels=3,
                          adaptive_seed_height=adaptive)
    b, n = 2, 8192
    nodes = b * (max(cfg.max_active_nodes, cfg.num_patches) + 1)
    m = make_mesh(device_type="cpu")
    base = np.stack([split_terrain_cloud(n, s) for s in (5, 6)])
    runs = []
    for rep in (1, 2):
        xyz = torch.from_numpy(np.concatenate([base] * rep, 1))
        valid = torch.ones(xyz.shape[:2], dtype=torch.bool)
        runs.append(_payloads(monkeypatch, make_sharded_filter_ground(cfg, m),
                              xyz, valid))
    one, two = runs
    assert one[-2:] == [(b, n, 4)] * 2 and two[-2:] == [(b, 2 * n, 4)] * 2
    assert len(one) == len(two) > 20
    hist = 0
    for a, c in zip(one[:-2], two[:-2]):
        if a != c:
            assert a[1:] == c[1:] == (128,) and max(a[0], c[0]) <= nodes
            hist += 1
        assert np.prod(a) <= 128 * nodes
    assert hist >= 5


def test_deficient_ties_by_global_index(group, monkeypatch):
    """The deficient fallback picks by (z, global index): a scene whose
    every point is above the seed height gives the one-process mask on a
    world-size-1 group however its first index is offset, since every
    rank's offset is added before the MIN."""
    from patchwork_tpu_torch.parallel.shardmap_engine import patchwork_level

    rng = np.random.default_rng(9)
    pts = np.empty((2048, 3), np.float32)
    pts[:, 0] = rng.uniform(2, 40, 2048)
    pts[:, 1] = rng.uniform(-40, 40, 2048)
    pts[:, 2] = np.round(rng.uniform(1.6, 3.5, 2048), 1)   # ties in z
    xyz = torch.from_numpy(pts[None])
    valid = torch.ones((1, 2048), dtype=torch.bool)
    cfg = PatchworkConfig.patchwork(filtering_radius=60.0)
    g = make_mesh(device_type="cpu").get_group("sp")
    want = filter_ground_batched(xyz, valid, cfg).ground
    assert torch.equal(patchwork_level(cfg, xyz, valid), want)
    assert torch.equal(patchwork_level(cfg, xyz, valid, 4096, g), want)
    assert want.any()


def test_ranks_take_three_reductions_or_none():
    ident = lambda t: t   # noqa: E731
    with pytest.raises(ValueError, match="all three"):
        segops.Ranks(sum=ident, min=ident)
    one = tmesh.ranks_over(None, 7)
    assert not one.across and one.first == 7


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "percentile"])
def test_in_process_reductions_equal_the_engine(adaptive):
    """Ranks holding identity reductions take every cross-rank route (the
    per-round order statistic, its need masks) with no process group, and
    give the one-process masks bit for bit."""
    ident = lambda t: t   # noqa: E731
    cfg = PatchworkConfig(segment_impl="scatter",
                          adaptive_seed_height=adaptive)
    xyz, valid = _batch(split_terrain_cloud, 8192, [11])
    before = dict(segops.ORDER_STATS)
    got = filter_ground_batched(xyz, valid, cfg, ranks=segops.Ranks(
        sum=ident, min=ident, histograms=ident))
    assert segops.ORDER_STATS["histograms"] > before["histograms"]
    want = filter_ground_batched(xyz, valid, cfg)
    for field in ("ground", "valid", "in_zone", "in_patch"):
        assert torch.equal(getattr(got, field), getattr(want, field))


def test_points_split_over_processes_take_the_generic_path():
    xyz, valid = _batch(split_terrain_cloud, 512, [0])
    with pytest.raises(ValueError, match="generic path"):
        filter_ground_batched(xyz, valid, PatchworkConfig(),
                              ranks=segops.Ranks())


def test_demo_cloud_one_rank(group):
    """make_sharded_filter_ground on the demo cloud at N not a multiple of
    the tile equals the engine with the forced impl."""
    cfg = PatchworkConfig(filtering_radius=60.0)
    xyz, valid = _batch(lambda n, s: demo_point_cloud(n, seed=s), 3000, [0, 1])
    got = make_sharded_filter_ground(cfg, make_mesh(device_type="cpu"))(
        xyz, valid)
    want = filter_ground_batched(xyz, valid, cfg.replace(
        segment_impl="scatter"))
    assert torch.equal(got.ground, want.ground)
