"""One engine level in one launch (``fit_cuda.level_core``): what the CPU
can prove, and its card-only cases.

* ``level_core``'s plain version (``level_sequence`` over the plain
  functions) equals the phase sequence the engine ran before the one launch
  (a copy of it is kept below), in every bit of the state and the stats, for
  exact, fast and percentile seeds, at level 0 and at a remap level.
* The one launch sums in other orders than the dense tile sums it replaced:
  R1 and R1b with the segment sum's no-plan route (each tile's runs, then
  the tiles that hold a node, in tile order), the seeds' sums over the sweep
  plan.  The dense sums are rebuilt here as plain references (each tile's
  sums for every node, then every tile in order), and NumPy models of the
  two new orders must give their bits, NaN and +-inf included.
* The JAX package's ``level_megakernel`` (interpreted on the CPU, as
  tests/test_torch_kernels.py runs it) equals the port's level through the
  new wrapper on the remap levels of a scene whose patches split.

The card-only cases (marked ``cuda``; they skip without a card) hold the
kernels against their plain versions bit for bit:

    python -m pytest --noconftest tests/test_torch_level_core.py -q

Inputs come from numpy seeds, B <= 2 and N <= 4096 on the CPU.
"""

import numpy as np
import pytest
import torch

from patchwork_tpu_torch import PatchworkConfig, filter_ground_batched
from patchwork_tpu_torch.io.synthetic import (split_terrain_cloud,
                                              velodyne_like_cloud)
from patchwork_tpu_torch.kernels import fit_cuda
from patchwork_tpu_torch.segment import engine

torch.set_num_threads(1)

TILE = fit_cuda.TILE
MODES = {"exact": {}, "fast": {"fast_covariance": True},
         "percentile": {"adaptive_seed_height": False}}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.int32)


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
    return pts


def _with_special_values(xyz):
    """Some points of every scan get NaN, +inf, -inf or -0.0 coordinates."""
    xyz = xyz.copy()
    flat = xyz.reshape(xyz.shape[0], -1)
    for j, v in enumerate((np.nan, np.inf, -np.inf, -0.0)):
        flat[:, 7 + 3 * j::331] = v
    return xyz


def _level_calls(xyz, cfg, device="cpu"):
    """Every level the engine ran on ``xyz`` (B, N, 3): (pts, tables, args,
    kwargs) of its ``engine.level`` call, cloned."""
    calls = []
    orig = engine.level

    def capture(p, t, *args, **kw):
        calls.append((p.clone(), t.clone(), args, kw))
        return orig(p, t, *args, **kw)

    engine.level = capture
    try:
        x = torch.from_numpy(np.ascontiguousarray(xyz)).to(device)
        filter_ground_batched(x, torch.ones(x.shape[:2], dtype=torch.bool,
                                            device=device), cfg)
    finally:
        engine.level = orig
    return calls


def _level_before(pts, tables, num_segs, max_iter, is_level0, min_seed,
                  flat_area, flat_dz, flat_minpts, fast=False, adaptive=True,
                  seed_percentile=0.1, th_seeds=0.15, remap=False):
    """The engine's level as it stood before the one launch: its phases one
    by one through the plain functions, the fit as the loop of plain sweeps
    from seed_init's sums."""
    k = fit_cuda.plain
    b, _, n = pts.shape
    sp = tables.shape[2]
    trash = num_segs - 1
    state = torch.empty((b, 4, n), dtype=torch.float32)
    state[:, 0:2] = pts[:, 4:6]
    state[:, 2] = 0.0
    if not remap:
        state[:, 3] = pts[:, 3]
        tau_row = tables[:, 0].contiguous()
        zth_row = tables[:, 1].contiguous()
    else:
        m1 = k.remap_r1(pts, trash, sp, fast)
        pcnt = m1[:, 0]
        safe_n = torch.clamp(pcnt, min=1.0)
        if fast:
            vx = m1[:, 3] - m1[:, 1] * m1[:, 1] / safe_n
            vy = m1[:, 4] - m1[:, 2] * m1[:, 2] / safe_n
        else:
            cxy = torch.stack([m1[:, 1] / safe_n, m1[:, 2] / safe_n], 1)
            v2 = k.remap_r1b(pts, cxy, trash)
            vx, vy = v2[:, 0], v2[:, 1]
        axis_x = (vx > vy).to(torch.float32)
        pseg = pts[:, 3]
        ps = pseg.to(torch.int64)
        ax = torch.gather(axis_x, 1, ps)
        vals = ax * pts[:, 0] + (1.0 - ax) * pts[:, 1]
        k_med = torch.floor(pcnt * 0.5).to(torch.int32)
        median = k.seg_order_stat(vals, ps.to(torch.int32).contiguous(),
                                  (pseg < trash).contiguous(), k_med, sp)
        pnode, tz = k.remap_nodes(tables, median, axis_x, trash)
        tau_row, zth_row = tz[:, 0].contiguous(), tz[:, 1].contiguous()
        k.remap_points(pts, state, pnode, trash)
    nstats = k.node_stats(pts, state, zth_row if adaptive else None, trash, sp)
    if not adaptive:
        seg_i = state[:, 3].to(torch.int32).contiguous()
        k_seed = torch.floor(float(np.float32(seed_percentile))
                             * nstats[:, 0])
        zstat = k.seg_order_stat(pts[:, 2].contiguous(), seg_i,
                                 (state[:, 3] < trash).contiguous(),
                                 k_seed.to(torch.int32), sp)
        zth_row = zstat + float(np.float32(th_seeds))
        seeded = k.node_stats(pts, state, zth_row, trash, sp)
        nstats = torch.cat([nstats[:, 0:1], seeded[:, 1:2], nstats[:, 2:]], 1)
    flags, any_def = k.early_outs(nstats, tables, zth_row, is_level0,
                                  flat_area, flat_dz, flat_minpts, min_seed)
    for _ in range(min_seed):
        k.deficient_round(pts, state, flags, any_def, trash)
    m1 = k.seed_init(pts, state, flags, trash, fast)
    sf = fit_cuda.level_fit_plain(pts, state, m1, flags[:, 2].contiguous(),
                                  tau_row.contiguous(), trash, max_iter, fast)
    sd = k.split_decision(sf, nstats, flags, tables)
    k.finish_nodes(state, flags, sd, trash)
    stats = torch.stack([sd[:, 0], sd[:, 1], sd[:, 2], nstats[:, 0],
                         nstats[:, 1], tau_row, zth_row,
                         torch.zeros_like(tau_row)], 1)
    return state, stats


_CALLS: dict = {}


def _levels(mode):
    """The levels of a small batch whose patches split under ``mode``:
    level 0 and the remap levels (split terrain; the bimodal scene for
    percentile seeds)."""
    if mode not in _CALLS:
        if mode == "percentile":
            xyz = np.stack([_bimodal_far_scene(2048, s) for s in (5, 6)])
            cfg = PatchworkConfig(th_dist=0.24, th_seeds=0.9, max_iter=1,
                                  **MODES[mode])
        else:
            xyz = np.stack([split_terrain_cloud(4096, seed=s)
                            for s in range(2)])
            cfg = PatchworkConfig(**MODES[mode])
        _CALLS[mode] = _level_calls(xyz, cfg)
    return _CALLS[mode]


@pytest.mark.parametrize("which", ["level0", "remap"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_level_core_plain_is_the_phase_sequence_before(mode, which):
    calls = _levels(mode)
    assert len(calls) >= 2, "the scene must reach a remap level"
    chosen = [c for c in calls if c[3]["remap"] == (which == "remap")][:2]
    assert chosen
    for p, t, args, kw in chosen:
        state, stats = engine.level_reference(p, t, *args, **kw)
        want_state, want_stats = _level_before(p.clone(), t, *args, **kw)
        np.testing.assert_array_equal(_bits(state), _bits(want_state))
        np.testing.assert_array_equal(_bits(stats), _bits(want_stats))
        # the wrapper on CPU tensors is the plain version
        again = engine.level(p, t, *args, **kw)
        np.testing.assert_array_equal(_bits(again[0]), _bits(want_state))
        np.testing.assert_array_equal(_bits(again[1]), _bits(want_stats))


def test_level_core_plain_takes_deficient_rounds_and_special_values():
    # all seed thresholds below the points: every fitting node deficient;
    # then NaN and +-inf coordinates on top
    xyz = np.stack([split_terrain_cloud(4096, seed=s) for s in range(2)])
    xyz[..., 2] += 3.0
    for data in (xyz, _with_special_values(xyz)):
        calls = _level_calls(data, PatchworkConfig())
        p, t, args, kw = calls[0]
        state, stats = engine.level_reference(p, t, *args, **kw)
        want_state, want_stats = _level_before(p.clone(), t, *args, **kw)
        np.testing.assert_array_equal(_bits(state), _bits(want_state))
        np.testing.assert_array_equal(_bits(stats), _bits(want_stats))
        assert (state[:, 2] > 0.5).sum() >= 3, "no deficient pick ran"


# ---------------------------------------------------------------------------
# the orders of the sums: the dense tile sums rebuilt, and the new orders
# ---------------------------------------------------------------------------

def _dense_tile_sums(rows, seg, sp):
    """The dense sums the one launch replaced (pw_tile_accumulate, then
    pw_reduce_tiles): in each tile every node's sum of its points in point
    order from +0.0, then every tile's sums in tile order from +0.0.
    rows (B, R, N) float32, seg (B, N) -> (B, R, sp)."""
    b, r, n = rows.shape
    out = np.zeros((b, r, sp), np.float32)
    for i in range(b):
        for t0 in range(0, n, TILE):
            acc = np.zeros((sp, r), np.float32)
            np.add.at(acc, seg[i, t0:t0 + TILE], rows[i, :, t0:t0 + TILE].T)
            out[i] = out[i] + acc.T
    return out


def _no_plan_sums(rows, seg, sp):
    """pw_dense_sum_tile's order: in each tile the runs of its present nodes
    in point order from +0.0, then a node's partials of the tiles that hold
    it, in tile order from +0.0 (a tile without the node adds nothing)."""
    b, r, n = rows.shape
    out = np.zeros((b, r, sp), np.float32)
    for i in range(b):
        for t0 in range(0, n, TILE):
            s = seg[i, t0:t0 + TILE]
            acc = np.zeros((sp, r), np.float32)
            np.add.at(acc, s, rows[i, :, t0:t0 + TILE].T)
            here = np.unique(s)
            out[i][:, here] = out[i][:, here] + acc[here].T
    return out


def _planned_sums(rows, plan):
    """The sums over a sweep plan as the seed kernel adds them: a tile's
    rows staged at their places, each slot's run added in point order from
    +0.0 into its entry's place, then each node's entries (its tiles', in
    tile order) from +0.0."""
    rows = rows.numpy()
    b, r, n = rows.shape
    sp = plan.sp
    pos, start = plan.pos.numpy(), plan.start.numpy()
    tile_off, node_off = plan.tile_off.numpy(), plan.node_off.numpy()
    dest = plan.dest.numpy()
    out = np.zeros((b, r, sp), np.float32)
    for i in range(b):
        part = np.zeros((dest.shape[1], r), np.float32)
        for tile in range(n // TILE):
            lo = tile * TILE
            staged = np.empty((TILE, r), np.float32)
            staged[pos[i, lo:lo + TILE]] = rows[i, :, lo:lo + TILE].T
            k = tile_off[i, tile + 1] - tile_off[i, tile]
            runs = list(start[i, lo:lo + k]) + [TILE]
            for q in range(k):
                acc = np.zeros(r, np.float32)
                for e in range(runs[q], runs[q + 1]):
                    acc = acc + staged[e]
                part[dest[i, tile_off[i, tile] + q]] = acc
        for s in range(sp):
            acc = np.zeros(r, np.float32)
            for e in range(node_off[i, s], node_off[i, s + 1]):
                acc = acc + part[e]
            out[i, :, s] = acc
    return out


def _remap_level_pts(special):
    """The pts of the first remap level of a small split-terrain batch."""
    xyz = np.stack([split_terrain_cloud(4096, seed=s) for s in range(2)])
    if special:
        xyz = _with_special_values(xyz)
    calls = _level_calls(xyz, PatchworkConfig())
    p, t, args, kw = next(c for c in calls if c[3]["remap"])
    pts = p.clone()
    if special:         # non-finite coordinates on live parents too
        for i in range(pts.shape[0]):
            live = np.nonzero(pts[i, 3].numpy() < args[0] - 1)[0]
            for j, v in enumerate((np.nan, np.inf, -np.inf)[:len(live)]):
                pts[i, j % 2, live[(5 + 40 * j) % len(live)]] = v
        assert not torch.isfinite(pts[:, :2]).all()
    return pts, t.shape[2], args[0] - 1


@pytest.mark.parametrize("special", [False, True], ids=["finite", "nan_inf"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_remap_sums_in_the_no_plan_order_equal_the_dense_sums(fast, special):
    pts, sp, trash = _remap_level_pts(special)
    x, y, pseg = pts[:, 0].numpy(), pts[:, 1].numpy(), pts[:, 3].numpy()
    seg = pseg.astype(np.int64)
    a = (pseg < trash).astype(np.float32)
    xa, ya = x * a, y * a
    rows = [a, xa, ya] + ([x * xa, y * ya] if fast else [])
    r1 = np.stack(rows, 1).astype(np.float32)
    dense = _dense_tile_sums(r1, seg, sp)
    np.testing.assert_array_equal(_no_plan_sums(r1, seg, sp).view(np.int32),
                                  dense.view(np.int32))
    got = fit_cuda.remap_r1(pts, trash, sp, fast)
    np.testing.assert_array_equal(_bits(got), dense.view(np.int32))
    if special:
        assert not np.isfinite(dense).all()
    # R1b about the parents' centroids
    n = np.maximum(dense[:, 0], np.float32(1.0))
    cxy = np.stack([dense[:, 1] / n, dense[:, 2] / n], 1).astype(np.float32)
    c = np.take_along_axis(cxy, np.repeat(seg[:, None], 2, 1), 2)
    dx = (x - c[:, 0]) * a
    dy = (y - c[:, 1]) * a
    r1b = np.stack([dx * dx, dy * dy], 1).astype(np.float32)
    dense_b = _dense_tile_sums(r1b, seg, sp)
    np.testing.assert_array_equal(_no_plan_sums(r1b, seg, sp).view(np.int32),
                                  dense_b.view(np.int32))
    got_b = fit_cuda.remap_r1b(pts, torch.from_numpy(cxy), trash)
    np.testing.assert_array_equal(_bits(got_b), dense_b.view(np.int32))


def _seed_inputs(special, fast):
    """(pts, state, flags, trash) of seed_init on a remap level of a small
    batch, captured where the level's phases run one by one."""
    xyz = np.stack([split_terrain_cloud(4096, seed=s) for s in range(2)])
    if special:
        xyz = _with_special_values(xyz)
    seen = []
    orig = fit_cuda.plain.seed_init

    def capture(pts, state, flags, trash, fast, plan=None):
        seen.append((pts.clone(), state.clone(), flags.clone(), trash))
        return orig(pts, state, flags, trash, fast, plan)

    fit_cuda.plain.seed_init = capture
    try:
        filter_ground_batched(torch.from_numpy(xyz),
                              torch.ones(xyz.shape[:2], dtype=torch.bool),
                              PatchworkConfig(fast_covariance=fast))
    finally:
        fit_cuda.plain.seed_init = orig
    pts, state, flags, trash = seen[1]
    if special:         # non-finite coordinates of live points
        for i in range(pts.shape[0]):
            live = np.nonzero(state[i, 3].numpy() < trash)[0]
            for j, v in enumerate((np.nan, np.inf, -np.inf)[:len(live)]):
                pts[i, j, live[(3 + 50 * j) % len(live)]] = v
        assert not torch.isfinite(pts[:, :3]).all()
    return pts, state, flags, trash


@pytest.mark.parametrize("special", [False, True], ids=["finite", "nan_inf"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_seed_sums_over_the_sweep_plan_equal_seed_init_plain(fast, special):
    pts, state, flags, trash = _seed_inputs(special, fast)
    sp = flags.shape[2]
    st = state.clone()
    want = fit_cuda.seed_init_plain(pts, st, flags, trash, fast)
    # the rows the seed kernel stages, from the labelled state
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    act = (st[:, 3] < trash).to(torch.float32)
    gm = st[:, 0] * act
    xg, yg, zg = x * gm, y * gm, z * gm
    zero = torch.zeros_like(gm)
    rows = [gm, xg, yg, zg, zero, zero]
    if fast:
        rows += [x * xg, y * xg, z * xg, y * yg, z * yg, z * zg]
    plan = fit_cuda.sweep_plan_plain(st, sp)
    got = _planned_sums(torch.stack(rows, 1), plan)
    np.testing.assert_array_equal(got.view(np.int32), _bits(want))
    dense = _dense_tile_sums(torch.stack(rows, 1).numpy(),
                             st[:, 3].numpy().astype(np.int64), sp)
    np.testing.assert_array_equal(dense.view(np.int32), _bits(want))
    if special:
        assert torch.isnan(want).any() and not torch.isnan(want).all()


def test_plain_stats_and_deficient_min_take_the_kernels_key_order():
    # the kernels take min and max as integer atomics on order-preserving
    # keys: -0.0 orders below +0.0, +NaN above +inf (a min never takes it,
    # a max does); the plain versions give the same bits
    n, sp, trash = 256, 128, 127
    pts = torch.zeros((1, 8, n))
    state = torch.zeros((1, 4, n))
    state[0, 3, 4:] = trash
    pts[0, 6] = torch.arange(n, dtype=torch.float32)
    pts[0, 0, :4] = torch.tensor([0.0, -0.0, float("nan"), 1.0])
    pts[0, 1, :4] = torch.tensor([-0.0, 0.0, 2.0, 3.0])
    pts[0, 2, :4] = torch.tensor([float("nan"), 0.5, 0.25, 0.75])
    ns = fit_cuda.node_stats_plain(pts, state, None, trash, sp)[0, :, 0]
    bits = _bits(ns)
    assert bits[2] == np.float32(-0.0).view(np.int32)             # xmin
    assert np.isnan(ns[5]) and bits[5] == _bits(pts[0, 0, 2])     # xmax
    assert bits[3] == np.float32(-0.0).view(np.int32)             # ymin
    assert ns[4] == 0.25 and np.isnan(ns[7])                      # z
    # the deficient round's lowest z skips the +NaN: point 2 (z 0.25)
    flags = torch.zeros((1, 5, sp))
    flags[0, 3, 0] = 1.0
    st = state.clone()
    fit_cuda.deficient_round_plain(pts, st, flags,
                                   torch.ones(1, dtype=torch.int32), trash)
    assert st[0, 2].nonzero().flatten().tolist() == [2]


# ---------------------------------------------------------------------------
# the JAX package's level megakernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_level_through_the_wrapper_vs_level_megakernel(mode):
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from patchwork_tpu.kernels.fit_pallas import level_megakernel

    cfg = PatchworkConfig(th_dist=0.24, th_seeds=0.9, max_iter=1,
                          **MODES[mode])
    calls = _level_calls(_bimodal_far_scene(2048)[None], cfg)
    remaps = [c for c in calls if c[3]["remap"]]
    assert remaps, "the scene must reach a remap level"
    seen = []
    orig = fit_cuda.level_core

    def counted(*a, **kw):
        seen.append(1)
        return orig(*a, **kw)

    fit_cuda.level_core = counted
    try:
        outs = [engine.level(p, t, *args, **kw) for p, t, args, kw in remaps]
    finally:
        fit_cuda.level_core = orig
    assert len(seen) == len(remaps)
    with jax.default_device(jax.devices("cpu")[0]):
        for (p, t, args, kw), (state, stats) in zip(remaps, outs):
            sj, aj = level_megakernel(jnp.asarray(p[0].numpy()),
                                      jnp.asarray(t[0].numpy()), *args, **kw)
            sj, aj = np.asarray(sj), np.asarray(aj)
            np.testing.assert_array_equal(state[0].numpy(), sj)
            a = stats[0].numpy()
            live = a[3] > 0   # zth of empty nodes is garbage when percentile
            for row in (0, 1, 3, 4, 5):
                np.testing.assert_array_equal(a[row], aj[row])
            np.testing.assert_array_equal(a[6][live], aj[6][live])
            np.testing.assert_allclose(a[2], aj[2], rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from patchwork_tpu_torch.core.device import cuda_device

    return cuda_device()


def _core_inputs(dev, mode, scene, special=False, n=16384):
    """level_core's arguments at every level of a two-scan batch."""
    seen = []
    orig = fit_cuda.level_core

    def capture(pts, state, tables, *rest):
        seen.append((pts.clone(), state.clone(), tables.clone(),
                     *[r.clone() if isinstance(r, torch.Tensor)
                       else tuple(x.clone() for x in r)
                       if isinstance(r, tuple) else r for r in rest]))
        return orig(pts, state, tables, *rest)

    gen = {"velodyne": velodyne_like_cloud, "split": split_terrain_cloud,
           "deficient": split_terrain_cloud}
    xyz = np.stack([gen[scene](n, seed=s) for s in range(2)])
    if scene == "deficient":     # every seed threshold below the points
        xyz[..., 2] += 3.0
    if special:
        xyz = _with_special_values(xyz)
    fit_cuda.level_core = capture
    try:
        x = torch.from_numpy(xyz).to(dev)
        filter_ground_batched(x, torch.ones(x.shape[:2], dtype=torch.bool,
                                            device=dev),
                              PatchworkConfig(**MODES[mode]))
    finally:
        fit_cuda.level_core = orig
    return seen


def _core_both(a, blocks=0, sweeps=None):
    """(stats, state) of the kernel and of its plain version."""
    pts, state, tables, *rest = a
    st_k, st_p = state.clone(), state.clone()
    s_k = fit_cuda.level_core(pts, st_k, tables, *rest, sweeps_out=sweeps,
                              _blocks_per_scan=blocks)
    s_p = fit_cuda.level_core_plain(pts, st_p, tables, *rest)
    return (s_k, st_k), (s_p, st_p)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("scene", ["velodyne", "split", "deficient",
                                   "special"])
def test_level_core_matches_plain_on_the_card(dev, scene, mode):
    special = scene == "special"
    levels = _core_inputs(dev, mode, "split" if special else scene, special)
    assert levels
    picks = 0
    for a in levels[:3]:
        for blocks in (0, 7):
            sweeps = torch.zeros(2, dtype=torch.int32, device=dev)
            fit_cuda.reset_launches()
            (s_k, st_k), (s_p, st_p) = _core_both(a, blocks, sweeps)
            assert fit_cuda.LAUNCHES["level"] == 1
            (s_2, st_2), _ = _core_both(a, blocks)
            torch.cuda.synchronize()
            assert np.array_equal(_bits(s_k), _bits(s_p))
            assert np.array_equal(_bits(st_k), _bits(st_p))
            assert np.array_equal(_bits(s_k), _bits(s_2))
            assert np.array_equal(_bits(st_k), _bits(st_2))
            assert int(sweeps.min()) >= 1
            picks += int((st_p[:, 2] > 0.5).sum())
    if scene == "deficient":
        assert picks > 0, "no deficient round picked a point"


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_remap_sums_and_seed_sums_match_plain_on_the_card(dev, fast):
    pts, sp, trash = _remap_level_pts(True)
    pts = pts.to(dev)
    got = fit_cuda.remap_r1(pts, trash, sp, fast)
    want = fit_cuda.remap_r1_plain(pts, trash, sp, fast)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(fit_cuda.remap_r1(pts, trash, sp,
                                                              fast)))
    cxy = (got[:, 1:3] / torch.clamp(got[:, 0:1], min=1.0)).contiguous()
    assert np.array_equal(_bits(fit_cuda.remap_r1b(pts, cxy, trash)),
                          _bits(fit_cuda.remap_r1b_plain(pts, cxy, trash)))
    p, state, flags, trash = (t.to(dev) if isinstance(t, torch.Tensor) else t
                              for t in _seed_inputs(True, fast))
    st_k, st_p = state.clone(), state.clone()
    plan = fit_cuda.sweep_plan(st_k, flags.shape[2])
    got = fit_cuda.seed_init(p, st_k, flags, trash, fast, plan)
    want = fit_cuda.seed_init_plain(p, st_p, flags, trash, fast)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(st_k), _bits(st_p))
