"""The level path's fit loop in one launch, on the CPU: what can be proven
without the card.

* The level path's one launch (``level_core``) runs ``fit_level``'s device
  code reading the level layout.  That the two layouts describe the same
  fit is shown here with the plain versions: ``fit_level_plain`` on level
  inputs mapped to the fit layout equals the loop of plain sweeps bit for
  bit, in the mask and in the sums of every live column (the trash column
  is where the layouts differ: the level sums carry the factor ``act``,
  which the kernel keeps).
* The level's plain fit (``level_fit_plain``, the loop of sweeps that
  ``level_sequence`` runs) is the loop of sweeps the engine ran before (a
  copy of it is kept below).
* Both sides of the card's gate give the engine the same bits, and the path
  gate no longer decides how a fit runs.
* The voxel filter's in-order run sums, and the patch-id flips of the
  port's binning against the JAX package's.

Inputs come from numpy seeds; the level inputs are captured from the engine
on small scans (level 0 at Sp 128, remap levels at Sp 256).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu import PatchworkConfig as JaxConfig  # noqa: E402
from patchwork_tpu.ops import sampling as jsam  # noqa: E402
from patchwork_tpu.segment import binning as jbin  # noqa: E402
from patchwork_tpu_torch import (  # noqa: E402
    PatchworkConfig, filter_ground_batched)
from patchwork_tpu_torch.io.synthetic import (  # noqa: E402
    demo_point_cloud, velodyne_like_cloud)
from patchwork_tpu_torch.kernels import fit_cuda, seg_cuda  # noqa: E402
from patchwork_tpu_torch.ops import sampling as tsam  # noqa: E402
from patchwork_tpu_torch.segment import binning, engine  # noqa: E402

torch.set_num_threads(1)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.int32)


def _split_terrain(n, seed):
    """Sloped ground with a step and box obstacles: its patches split."""
    rng = np.random.default_rng(seed)
    n_obst = n // 6
    n_g = n - n_obst
    g = np.empty((n_g, 3), np.float32)
    g[:, 0] = rng.uniform(-80, 80, n_g)
    g[:, 1] = rng.uniform(-80, 80, n_g)
    g[:, 2] = 0.08 * g[:, 0] + 0.5 * (g[:, 1] > 20) + rng.normal(0, 0.05, n_g)
    obst = rng.uniform(-40, 40, (n_obst, 2))
    oz = rng.uniform(0.5, 3.0, n_obst)
    return np.concatenate([g, np.column_stack([obst, oz])]).astype(np.float32)


def _batch(n=4096):
    scans = [_split_terrain(n, 0), demo_point_cloud(n, seed=1),
             _split_terrain(n, 2)]
    xyz = torch.from_numpy(np.stack(scans))
    return xyz, torch.ones(xyz.shape[:2], dtype=torch.bool)


_CAPTURED: dict = {}


def _level_inputs(fast: bool, sp: int):
    """(pts, state, m1, fit_row, tau_row, trash) of a fit loop the engine
    ran on the small batch (the plain level's loop of sweeps): level 0 for
    Sp 128, the first remap level for Sp 256."""
    if fast not in _CAPTURED:
        seen = []
        orig = fit_cuda.fit_sweep_loop

        def capture(k, pts, state, m1, *rest):
            seen.append((pts.clone(), state.clone(), m1.clone(), *rest[:5]))
            return orig(k, pts, state, m1, *rest)

        fit_cuda.fit_sweep_loop = capture
        try:
            filter_ground_batched(*_batch(), PatchworkConfig(
                fast_covariance=fast))
        finally:
            fit_cuda.fit_sweep_loop = orig
        _CAPTURED[fast] = seen
    for pts, state, m1, fit_row, tau_row, trash, _, f in _CAPTURED[fast]:
        if fit_row.shape[1] == sp:
            assert f == fast and fit_row.sum() > 0
            return pts, state, m1, fit_row, tau_row, trash
    raise AssertionError(f"no level of width {sp} ran")


def _fit_loop_before(k, pts, state, m1, fit_row, tau_row, trash, max_iter,
                     fast):
    """The engine's fit loop as it stood before the one-launch fit: plane
    table then apply sweep until no scan changed or max_iter, the final
    can = 0 sweep only on a max_iter exit."""
    def make_tab(m1, with_can):
        c = (m1[:, 1:4] / torch.clamp(m1[:, 0:1], min=1.0)).contiguous()
        m2 = None if fast else k.moments2_sweep(pts, state, c, trash)
        return k.plane_table(m1.contiguous(), c, m2,
                             fit_row if with_can else None, tau_row, fast)

    changed = True
    sweeps = 0
    for _ in range(max_iter):
        m1 = k.apply_sweep(pts, state, make_tab(m1, True), trash, fast)
        sweeps += 1
        changed = bool((m1[:, 5] > 0.0).any())
        if not changed:
            break
    if changed:
        m1 = k.apply_sweep(pts, state, make_tab(m1, False), trash, fast)
        sweeps += 1
    return m1, sweeps, changed


def _to_fit_layout(pts, state, fit_row, tau_row, trash):
    """The level layout's fit inputs as fit_level's: who may change is
    act * fit_row[seg], tau is the node's."""
    seg = state[:, 3]
    idx = seg.to(torch.int64)
    act = (seg < trash).to(torch.float32)
    amask = act * torch.gather(fit_row, 1, idx)
    tau = torch.gather(tau_row, 1, idx)
    zero = torch.zeros_like(seg)
    p = torch.cat([pts[:, 0:3], torch.stack([tau, amask, seg, zero, zero],
                                            1)], 1).contiguous()
    return p, state[:, 0:1].clone()


def _with_a_converged_scan(pts, state, fit_row, tau_row, trash, fast):
    """Scan 1 starts from scan 0's converged mask (on scan 0's points), so
    it converges at once; returns the batch and its seeded sums."""
    pts, state = pts.clone(), state.clone()
    fit_row, tau_row = fit_row.clone(), tau_row.clone()
    for t in (pts, state, fit_row, tau_row):
        t[1] = t[0]
    zero_tab = pts.new_zeros(pts.shape[0], 8, fit_row.shape[1])
    solo = state[0:1].clone()
    m1 = fit_cuda.apply_sweep_plain(pts[0:1], solo, zero_tab[0:1], trash,
                                    fast)
    fit_cuda.level_fit_plain(pts[0:1], solo, m1, fit_row[0:1], tau_row[0:1],
                             trash, 100, fast)
    state[1, 0] = solo[0, 0]
    # the sums of a seeded mask: a sweep with a zero table, as seed_init's
    m1 = fit_cuda.apply_sweep_plain(pts, state.clone(), zero_tab, trash, fast)
    return pts, state, m1, fit_row, tau_row


@pytest.mark.parametrize("max_iter", [0, 2, 100])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("sp", [128, 256], ids=["sp128", "sp256"])
def test_fit_layout_map_equals_loop_of_sweeps(sp, fast, max_iter):
    pts, state, _, fit_row, tau_row, trash = _level_inputs(fast, sp)
    pts, state, m1, fit_row, tau_row = _with_a_converged_scan(
        pts, state, fit_row, tau_row, trash, fast)
    live = [s for s in range(sp) if s != trash]
    for rows in (slice(0, 3), slice(0, 1)):            # B = 3 and B = 1
        st = state[rows].clone()
        want, sweeps, hit_cap = _fit_loop_before(
            fit_cuda.plain, pts[rows], st, m1[rows], fit_row[rows],
            tau_row[rows], trash, max_iter, fast)
        p, g0 = _to_fit_layout(pts[rows], state[rows], fit_row[rows],
                               tau_row[rows], trash)
        g, stats = fit_cuda.fit_level_plain(p, g0, sp, max_iter, fast)
        np.testing.assert_array_equal(_bits(g[:, 0]), _bits(st[:, 0]))
        np.testing.assert_array_equal(_bits(stats[:, :6, live]),
                                      _bits(want[:, :6, live]))
        # the exits under test: the cap with 0 and 2, convergence with 100
        assert hit_cap == (max_iter < 100)
        assert sweeps == max_iter + 1 if hit_cap else 1 < sweeps <= max_iter
        if max_iter:
            assert not torch.equal(st[:, 0], state[rows, 0]), "no refit ran"


@pytest.mark.parametrize("max_iter", [0, 2, 100])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("sp", [128, 256], ids=["sp128", "sp256"])
def test_level_fit_plain_is_the_loop_before(sp, fast, max_iter):
    pts, state, m1, fit_row, tau_row, trash = _level_inputs(fast, sp)
    st_a, st_b = state.clone(), state.clone()
    want, _, _ = _fit_loop_before(fit_cuda.plain, pts, st_a, m1, fit_row,
                                  tau_row, trash, max_iter, fast)
    # the level's plain fit, and the loop of sweeps over the plain
    # namespace as the level's plain phases call it
    got = fit_cuda.level_fit_plain(pts, st_b, m1, fit_row, tau_row, trash,
                                   max_iter, fast)
    assert got.shape == (pts.shape[0], 12 if fast else 6, sp)
    np.testing.assert_array_equal(_bits(got), _bits(want))   # every column
    np.testing.assert_array_equal(_bits(st_b), _bits(st_a))
    st_c = state.clone()
    again = fit_cuda.fit_sweep_loop(fit_cuda.plain, pts, st_c, m1, fit_row,
                                    tau_row, trash, max_iter, fast, None)
    np.testing.assert_array_equal(_bits(again), _bits(want))
    np.testing.assert_array_equal(_bits(st_c), _bits(st_a))


def test_a_scan_in_a_batch_equals_the_scan_alone():
    pts, state, m1, fit_row, tau_row, trash = _level_inputs(False, 256)
    st = state.clone()
    sf = fit_cuda.level_fit_plain(pts, st, m1, fit_row, tau_row, trash, 100,
                                  False)
    for i in range(pts.shape[0]):
        s1 = state[i:i + 1].clone()
        one = fit_cuda.level_fit_plain(pts[i:i + 1], s1, m1[i:i + 1],
                                       fit_row[i:i + 1], tau_row[i:i + 1],
                                       trash, 100, False)
        np.testing.assert_array_equal(_bits(one), _bits(sf[i:i + 1]))
        np.testing.assert_array_equal(_bits(s1), _bits(st[i:i + 1]))


def _count(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_level_path_both_sides_of_the_card_gate(fast, monkeypatch):
    cfg = PatchworkConfig(fast_covariance=fast)
    calls = {}
    _count(monkeypatch, fit_cuda, "level_core", calls)
    _count(monkeypatch, fit_cuda, "apply_sweep", calls)
    below = filter_ground_batched(*_batch(), cfg).ground
    assert calls.get("level_core", 0) >= 2 and "apply_sweep" not in calls
    calls.clear()
    monkeypatch.setattr(fit_cuda, "fit_level_fits",
                        lambda sp, fast, device, level=False: False)
    above = filter_ground_batched(*_batch(), cfg).ground
    assert "level_core" not in calls and calls["apply_sweep"] >= 2
    assert torch.equal(below, above)


def test_generic_fit_takes_one_launch_whatever_the_path_gate(monkeypatch):
    # above the path gate at any N: the generic path, and every level's fit
    # is fit_level (before, the path gate also sent Sp 256 to the sweeps)
    level = filter_ground_batched(*_batch(), PatchworkConfig()).ground
    monkeypatch.setattr(fit_cuda, "megakernel_fits", lambda n, sp: False)
    calls = {}
    for name in ("fit_level", "apply_sweep", "level_core"):
        _count(monkeypatch, fit_cuda, name, calls)
    _count(monkeypatch, engine, "_level_body", calls)
    one = filter_ground_batched(*_batch(), PatchworkConfig()).ground
    assert calls["_level_body"] >= 2
    assert calls["fit_level"] == calls["_level_body"]
    assert "apply_sweep" not in calls and "level_core" not in calls
    # above the card's gate the same fits run as loops of sweeps
    calls.clear()
    monkeypatch.setattr(fit_cuda, "fit_level_fits",
                        lambda sp, fast, device, level=False: False)
    loop = filter_ground_batched(*_batch(), PatchworkConfig()).ground
    assert "fit_level" not in calls and calls["apply_sweep"] >= 2
    assert torch.equal(one, loop)
    # scans 0 and 2 hold 3-point seeds whose planes rounding picks: across
    # the two paths they agree at IoU level only; scan 1 bit for bit
    assert torch.equal(one[1], level[1])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_card_gate_is_shared_memory_not_the_vmem_budget(fast):
    # an H100 grants a block 227 KB; a CPU tensor is gated as on that card
    for sp in (128, 256, 384, 640, 2560):
        for level in (False, True):
            assert fit_cuda.fit_level_fits(sp, fast, "cpu", level)
            assert fit_cuda.fit_level_fits(sp, fast, torch.device("cpu"),
                                           level)
    assert not fit_cuda.fit_level_fits(4224, fast, "cpu")
    assert not fit_cuda.fit_level_fits(4224, fast, "cpu", level=True)
    # the bytes grow with the table only, and the level layout's table has
    # one row more
    a = fit_cuda.fit_level_smem_bytes(256, fast, level=True)
    assert a - fit_cuda.fit_level_smem_bytes(256, fast) == 256 * 4
    assert a < 48 * 1024
    # the JAX package's budget refuses what the card's gate admits
    assert not fit_cuda.megakernel_fits(262144, 256)
    assert fit_cuda.fit_level_fits(256, fast, "cpu")


# ---------------------------------------------------------------------------
# the voxel filter's in-order sums
# ---------------------------------------------------------------------------

def _voxel_cloud(n=6000, seed=4):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    pts[:100] = pts[100:200]
    return pts, rng.random(n) > 0.1


@pytest.mark.parametrize("voxel", [0.25, 0.7, 3.0])
def test_voxel_centroids_equal_jax_bit_for_bit(voxel):
    pts, valid = _voxel_cloud()
    c, v = tsam.voxel_grid_filter(torch.from_numpy(pts),
                                  torch.from_numpy(valid), voxel)
    jc, jv = jsam.voxel_grid_filter(jnp.asarray(pts), jnp.asarray(valid),
                                    voxel)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert v.sum() > 10
    np.testing.assert_array_equal(_bits(c), np.asarray(jc).view(np.int32))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_run_sum_plain_adds_each_run_in_order(c):
    rng = np.random.default_rng(c)
    n = 3000
    rows = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)
                            * np.float32(1e3))
    live = torch.arange(n) < 2600                    # the tail is parked
    first = torch.from_numpy(rng.random(n) < 0.05) & live
    first[0] = True
    first[7:10] = True                               # runs of one point
    run = (torch.cumsum(first.to(torch.int64), 0) - 1).to(torch.int32)
    sums, cnts = seg_cuda.run_sum(rows, first, live, run)
    # a sequential add per run, written out
    want = np.zeros((n, c), np.float32)
    want_n = np.zeros(n, np.float32)
    r = -1
    for i in range(2600):
        if first[i]:
            r += 1
        want[r] = want[r] + rows[i].numpy()
        want_n[r] += 1
    np.testing.assert_array_equal(_bits(sums), want.view(np.int32))
    np.testing.assert_array_equal(cnts.numpy(), want_n)
    # index_add_ on the CPU adds in index order too: the bits it gave before
    old = torch.zeros_like(rows).index_add_(
        0, run.long()[:2600], rows[:2600])
    np.testing.assert_array_equal(_bits(sums), _bits(old))


def test_run_sum_of_nothing():
    rows = torch.zeros((5, 3))
    none = torch.zeros(5, dtype=torch.bool)
    sums, cnts = seg_cuda.run_sum(rows, none, none,
                                  torch.zeros(5, dtype=torch.int32))
    assert not sums.any() and not cnts.any()


# ---------------------------------------------------------------------------
# patch-id flips of the port's binning against the JAX package's
# ---------------------------------------------------------------------------

# flips found, per cloud of 131072 points (seed 0): the port's CPU binning
# (torch.atan2) against patchwork_tpu/segment/binning.py (XLA's atan2)
FLIPS_FOUND = {"velodyne": 0, "split": 0}


@pytest.mark.parametrize("scene", sorted(FLIPS_FOUND))
def test_patch_id_flips_against_the_jax_binning(scene):
    n = 131072
    pts = (velodyne_like_cloud(n, seed=0) if scene == "velodyne"
           else _split_terrain(n, 0))
    valid = np.ones(n, bool)
    pa = binning.assign_patches(torch.from_numpy(pts)[None],
                                torch.from_numpy(valid)[None],
                                PatchworkConfig())
    ja = jbin.assign_patches(jnp.asarray(pts), jnp.asarray(valid),
                             JaxConfig())
    np.testing.assert_array_equal(pa.in_zone[0].numpy(),
                                  np.asarray(ja.in_zone))
    flips = int((pa.patch[0].numpy() != np.asarray(ja.patch)).sum())
    assert flips == FLIPS_FOUND[scene]
