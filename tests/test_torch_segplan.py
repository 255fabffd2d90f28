"""The segment ops of a binding on the CPU: the order the port's segment-sum
and min/max kernels work in, emulated here, against their plain versions
bit for bit; the plain segment sum against the JAX package's Pallas kernel;
and that a binding builds no plan where the plain versions run.

A binding's sums add over the tile plan of its ids (``fit_cuda.seg_plan``,
csrc/tile_sums.cuh): ``_planned_sums`` below does what the kernel does,
step for step; a sum with no plan takes the dense route (``_dense_sums``).
Min and max keep each key as its distance from the identity
(``_minmax``).  Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from patchwork_tpu.kernels.seg_pallas import seg_sum_pallas  # noqa: E402
from patchwork_tpu_torch.kernels import fit_cuda, seg_cuda  # noqa: E402
from patchwork_tpu_torch.kernels.fit_cuda import TILE  # noqa: E402
from patchwork_tpu_torch.segment.segops import SegOps, f32_key  # noqa: E402

torch.set_num_threads(1)

POS_INF_KEY, NEG_INF_KEY = 0x7F800000, -0x7F800001


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.int32)


def _ids(kind: str, rng, b: int, n: int, s: int) -> np.ndarray:
    if kind == "sorted":             # azimuth order: a few nodes a tile
        ids = np.sort(rng.integers(0, s, (b, n)), axis=1)
    elif kind == "shuffled":
        ids = rng.integers(0, s, (b, n))
    elif kind == "gaps":             # every third segment empty
        ids = 3 * rng.integers(0, (s + 2) // 3, (b, n))
    else:
        raise ValueError(kind)
    return ids.astype(np.int32)


def _values(kind: str, rng, shape) -> np.ndarray:
    vals = rng.normal(0, 100, shape).astype(np.float32)
    if kind == "special":            # -0.0, infinities, NaN of both signs
        vals[..., ::5] = -0.0
        vals[..., 3::41] = np.inf
        vals[..., 7::53] = -np.inf
        vals[..., 11::67] = np.nan
        vals[..., 13::71] = -np.float32(np.nan)
        vals[..., 17::29] = np.float32(1e-42)
    return vals


def _runs(plan, i):
    """Scan i's entries: their count and each one's run [lo, hi) in the
    tile sorted by slot, as pw_tile_runs reads them."""
    off = plan.tile_off[i].to(torch.int64)
    nt = off.numel() - 1
    k = off[1:] - off[:-1]
    total = int(off[-1])
    tile = torch.repeat_interleave(torch.arange(nt), k)
    slot = torch.arange(total) - off[tile]
    lo = tile * TILE + plan.start[i].to(torch.int64)[tile * TILE + slot]
    hi = torch.where(slot + 1 == k[tile], (tile + 1) * TILE,
                     torch.cat([lo[1:], lo.new_zeros(1)]))
    return total, lo, hi


def _sorted_rows(rows_i, plan, i):
    """(R, N) rows of scan i at their planned places."""
    n = rows_i.shape[1]
    base = torch.arange(n // TILE).repeat_interleave(TILE) * TILE
    srt = torch.empty_like(rows_i)
    srt[:, base + plan.pos[i].to(torch.int64)] = rows_i
    return srt


def _planned_sums(rows, seg, s):
    """pw_seg_sum_planned on the CPU: rows (B, R, N) and ids padded to a
    TILE multiple, the binding's plan; a thread per (run, row) adds its
    run in point order from +0.0, the partials land at their places, and
    a node's chain adds them in tile order from +0.0."""
    rows, seg = fit_cuda._pad_tiles(rows, seg)
    plan = fit_cuda.seg_plan(seg, s)
    b, r, _ = rows.shape
    out = rows.new_zeros(b, r, s)
    for i in range(b):
        srt = _sorted_rows(rows[i], plan, i)
        total, lo, hi = _runs(plan, i)
        run = rows.new_zeros(r, total)
        for j in range(int((hi - lo).max()) if total else 0):
            m = lo + j < hi
            run[:, m] = run[:, m] + srt[:, (lo + j)[m]]
        part = torch.empty_like(run)
        part[:, plan.dest[i, :total].to(torch.int64)] = run
        noff = plan.node_off[i].to(torch.int64)
        cnt = noff[1:] - noff[:-1]
        for j in range(int(cnt.max()) if total else 0):
            m = j < cnt
            out[i][:, m] = out[i][:, m] + part[:, (noff[:-1] + j)[m]]
    return out


def _dense_sums(rows, seg, s):
    """pw_seg_sum (no binding) on the CPU: each tile's nodes add their
    points in point order from +0.0 into a (tiles, S) partial that exists
    only where the tile holds the node; the last block adds, per node, the
    tiles marked in its bitmap row in tile order from +0.0."""
    rows, seg = fit_cuda._pad_tiles(rows, seg)
    b, r, n = rows.shape
    nt = n // TILE
    v = rows.reshape(b, r, nt, TILE)
    ids = seg.to(torch.int64).reshape(b, nt, TILE)
    part = torch.full((b, r, nt, s), float("nan"))      # never filled
    present = torch.zeros((b, nt, s), dtype=torch.bool)
    present.scatter_(2, ids, True)
    part[present[:, None].expand(b, r, nt, s)] = 0.0
    idx = ids[:, None].expand(b, r, nt, TILE)
    for t in range(TILE):
        at = idx[..., t:t + 1]
        part.scatter_(3, at, part.gather(3, at) + v[..., t:t + 1])
    out = rows.new_zeros(b, r, s)
    for j in range(nt):
        out = torch.where(present[:, None, j], out + part[:, :, j], out)
    return out


SUM_CASES = [
    # ids, values, B, N, S, R
    ("sorted", "normal", 1, 2048, 81, 2),
    ("sorted", "special", 3, 1000, 81, 8),
    ("shuffled", "normal", 3, 1024, 81, 1),
    ("shuffled", "special", 1, 1500, 161, 2),
    ("sorted", "normal", 3, 2048, 161, 8),
    ("gaps", "special", 1, 1024, 161, 1),
    ("shuffled", "normal", 1, 2048, 256, 8),
    ("gaps", "normal", 3, 700, 256, 2),
    ("sorted", "special", 1, 3000, 256, 1),
]
SUM_IDS = [f"{c[0]}-{c[1]}-B{c[2]}-N{c[3]}-S{c[4]}-R{c[5]}" for c in SUM_CASES]


def _sum_inputs(case):
    ids, values, b, n, s, r = case
    rng = np.random.default_rng(SUM_CASES.index(case))
    seg = torch.from_numpy(_ids(ids, rng, b, n, s))
    rows = torch.from_numpy(_values(values, rng, (b, r, n)))
    return rows, seg, s


@pytest.mark.parametrize("case", SUM_CASES, ids=SUM_IDS)
def test_planned_sum_order_equals_plain_bitwise(case):
    rows, seg, s = _sum_inputs(case)
    want = fit_cuda.seg_sum_plain(rows, seg, s)
    got = _planned_sums(rows, seg, s)
    assert got.shape == want.shape == (rows.shape[0], rows.shape[1], s)
    # bit patterns: -0.0 and +0.0 apart, a NaN's sign and payload included
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if case[0] == "gaps":            # empty segments sum to +0.0
        assert not _bits(want)[..., 1::3].any()


@pytest.mark.parametrize("case", SUM_CASES[::2], ids=SUM_IDS[::2])
def test_dense_sum_order_equals_plain_bitwise(case):
    rows, seg, s = _sum_inputs(case)
    np.testing.assert_array_equal(_bits(_dense_sums(rows, seg, s)),
                                  _bits(fit_cuda.seg_sum_plain(rows, seg, s)))


@pytest.mark.parametrize("s", [81, 161])
def test_plain_seg_sum_vs_pallas(s):
    # the JAX kernel adds a one-hot matmul per tile of up to 2048 points,
    # the port 256-point tiles in point order: equal to float rounding
    rng = np.random.default_rng(s)
    b, r, n = 2, 3, 4096
    seg = rng.integers(0, s, (b, n)).astype(np.int32)
    rows = rng.normal(0, 30, (b, r, n)).astype(np.float32)
    got = fit_cuda.seg_sum_plain(torch.from_numpy(rows),
                                 torch.from_numpy(seg), s).numpy()
    for i in range(b):
        ref = np.asarray(seg_sum_pallas(jnp.asarray(rows[i].T),
                                        jnp.asarray(seg[i]), s))
        np.testing.assert_allclose(got[i], ref.T, rtol=1e-5, atol=1e-3)


def _keys_to_f32(k64: torch.Tensor) -> torch.Tensor:
    k = k64.to(torch.int32)
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _minmax(vals, seg, mask, s):
    """pw_seg_minmax on the CPU: every masked point's key as
    uint32 distances from the identities, the largest distance per
    segment (a zeroed table: zero is the identity), decoded back."""
    b, c, n = vals.shape
    key = f32_key(vals).numpy().astype(np.int64)          # (B, C, N)
    d_lo = (POS_INF_KEY - np.minimum(key, POS_INF_KEY)) % 2 ** 32
    d_hi = (np.maximum(key, NEG_INF_KEY) - NEG_INF_KEY) % 2 ** 32
    assert d_lo.max() < 2 ** 32 and d_hi.max() < 2 ** 32
    t_lo = np.zeros((b, c, s), np.int64)
    t_hi = np.zeros((b, c, s), np.int64)
    m = mask.numpy()
    ids = seg.numpy()
    for i in range(b):
        for ch in range(c):
            np.maximum.at(t_lo[i, ch], ids[i][m[i]], d_lo[i, ch][m[i]])
            np.maximum.at(t_hi[i, ch], ids[i][m[i]], d_hi[i, ch][m[i]])
    k_lo = (POS_INF_KEY - t_lo + 2 ** 31) % 2 ** 32 - 2 ** 31
    k_hi = (t_hi + NEG_INF_KEY + 2 ** 31) % 2 ** 32 - 2 ** 31
    return _keys_to_f32(torch.from_numpy(k_lo)), \
        _keys_to_f32(torch.from_numpy(k_hi))


MINMAX_CASES = [
    # ids, values, B, N, S, C
    ("sorted", "special", 1, 2048, 81, 3),
    ("shuffled", "special", 3, 1000, 81, 1),
    ("gaps", "special", 3, 1024, 161, 3),
    ("shuffled", "normal", 1, 1500, 161, 1),
    ("sorted", "special", 3, 700, 256, 3),
]
MINMAX_IDS = [f"{c[0]}-{c[1]}-B{c[2]}-N{c[3]}-S{c[4]}-C{c[5]}"
              for c in MINMAX_CASES]


def _minmax_inputs(case):
    ids, values, b, n, s, c = case
    rng = np.random.default_rng(100 + MINMAX_CASES.index(case))
    seg = torch.from_numpy(_ids(ids, rng, b, n, s))
    vals = torch.from_numpy(_values(values, rng, (b, c, n)))
    mask = torch.from_numpy(rng.random((b, n)) < 0.6)
    mask[seg == 1] = False           # a segment with points, all masked out
    return vals, seg, mask, s


@pytest.mark.parametrize("case", MINMAX_CASES, ids=MINMAX_IDS)
def test_minmax_distances_equal_plain_bitwise(case):
    vals, seg, mask, s = _minmax_inputs(case)
    want = seg_cuda.seg_minmax_plain(vals, seg, mask, s)
    got = _minmax(vals, seg, mask, s)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (vals.shape[0], vals.shape[1], s)
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert torch.isposinf(want[0][:, :, 1]).all()
    assert torch.isneginf(want[1][:, :, 1]).all()


def test_minmax_keys_of_the_extremes():
    # +NaN orders above +inf (so no min takes it), -NaN below -inf (no max
    # takes it), -0.0 below +0.0; a segment of NaN only is +inf / NaN
    vals = torch.tensor([[[np.nan, 1.0, -np.float32(np.nan), -0.0, 0.0,
                           np.nan, np.inf, -np.inf]]], dtype=torch.float32)
    seg = torch.tensor([[0, 0, 1, 1, 1, 2, 3, 3]], dtype=torch.int32)
    mask = torch.ones((1, 8), dtype=torch.bool)
    want = seg_cuda.seg_minmax_plain(vals, seg, mask, 4)
    for g, w in zip(_minmax(vals, seg, mask, 4), want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    mins, maxs = want[0][0, 0], want[1][0, 0]
    assert mins[0] == 1.0 and torch.isnan(maxs[0])
    assert torch.isnan(mins[1]) and _bits(maxs[1:2])[0] == 0   # +0.0
    assert torch.isposinf(mins[2]) and torch.isnan(maxs[2])


@pytest.mark.parametrize("n", [1024, 1000])
def test_seg_plan_of_padded_ids(n):
    # the binding's plan covers the ids zero-padded to a tile multiple, at
    # width num_segs; its runs partition every tile
    rng = np.random.default_rng(n)
    s = 161
    seg = torch.from_numpy(_ids("shuffled", rng, 2, n, s))
    plan = fit_cuda.seg_plan(seg, s)
    npad = -(-n // TILE) * TILE
    assert plan.pos.shape == (2, npad) and plan.sp == s
    assert plan.node_off.shape == (2, s + 1)
    assert plan.cap == (npad // TILE) * min(TILE, s)
    padded = fit_cuda._pad_ids(seg)
    assert padded.shape == (2, npad) and not padded[:, n:].any()
    for i in range(2):
        counts = torch.bincount(padded[i].long(), minlength=s)
        entries = plan.node_off[i, 1:] - plan.node_off[i, :-1]
        tiles = torch.stack([torch.bincount(t.long(), minlength=s) > 0
                             for t in padded[i].reshape(-1, TILE)])
        assert torch.equal(entries, tiles.sum(0).to(torch.int32))
        assert int(counts.sum()) == npad


@pytest.mark.parametrize("plain", [False, True], ids=["cpu", "plain"])
def test_segops_builds_no_plan_off_the_card(plain):
    # on the CPU, and with plain=True anywhere, the plain versions run and
    # no plan is built; the results are the plain versions'
    rng = np.random.default_rng(5)
    s = 81
    seg = torch.from_numpy(_ids("sorted", rng, 2, 1024, s))
    xyz = torch.from_numpy(_values("special", rng, (2, 3, 1024)))
    mask = torch.from_numpy(rng.random((2, 1024)) < 0.5)
    ops = SegOps(seg, s, "pallas", plain=plain)
    got = [ops.sum(xyz), ops.count(mask), ops.min(xyz[:, 0], mask),
           ops.max(xyz[:, 1], mask), *ops.bbox(xyz, mask)]
    assert ops.plan is None
    mins, maxs = seg_cuda.seg_minmax_plain(xyz, seg, mask, s)
    want = [fit_cuda.seg_sum_plain(xyz, seg, s),
            fit_cuda.seg_sum_plain(mask[:, None].float(), seg,
                                   s)[:, 0].to(torch.int32),
            mins[:, 0], maxs[:, 1], mins, maxs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g) if g.is_floating_point()
                                      else g.numpy(),
                                      _bits(w) if w.is_floating_point()
                                      else w.numpy())
