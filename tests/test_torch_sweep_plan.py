"""The sweep plan of the port's apply sweep and one-launch fit loop, on the
CPU: its invariants, and that sums which walk only the tiles that hold a
node (``_plan_sums`` below, the order the planned CUDA kernels add in)
equal the dense tile sums (``fit_cuda._tile_sums``) bit for bit.  Inputs
come from numpy seeds."""

import numpy as np
import pytest
import torch

from patchwork_tpu_torch.kernels import fit_cuda
from patchwork_tpu_torch.kernels.fit_cuda import TILE

torch.set_num_threads(1)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.int32)


def _ids(kind: str, rng, b: int, n: int, sp: int, num_segs: int) -> np.ndarray:
    trash = num_segs - 1
    if kind == "sorted":            # azimuth order: a few nodes per tile
        ids = np.sort(rng.integers(0, num_segs, (b, n)), axis=1)
    elif kind == "shuffled":
        ids = rng.integers(0, num_segs, (b, n))
    elif kind == "one_node":
        ids = np.full((b, n), 7)
    elif kind == "all_distinct":    # a tile holds min(TILE, sp) nodes
        ids = np.stack([np.concatenate([rng.permutation(sp)
                                        for _ in range(n // min(TILE, sp))])[:n]
                        for _ in range(b)])
    elif kind == "trash":           # mostly the trash id, whole tiles of it
        ids = np.where(rng.random((b, n)) < 0.8, trash,
                       rng.integers(0, num_segs, (b, n)))
        ids[:, :TILE] = trash
    else:
        raise ValueError(kind)
    return ids.astype(np.float32)


def _plan_sums(rows: torch.Tensor, plan) -> torch.Tensor:
    """(B, R, N) rows summed per node -> (B, R, sp) the way the planned
    kernels add: each run of a tile sorted by slot in point order from
    +0.0, then each node's partials in tile order from +0.0.  Equal to
    ``fit_cuda._tile_sums`` bit for bit."""
    b, r, n = rows.shape
    nt = n // TILE
    out = rows.new_zeros(b, r, plan.sp)
    base = torch.arange(nt, device=rows.device).repeat_interleave(TILE) * TILE
    for i in range(b):
        place = base + plan.pos[i].to(torch.int64)
        srt = torch.empty_like(rows[i])
        srt[:, place] = rows[i]
        off = plan.tile_off[i].to(torch.int64)
        total = int(off[-1])
        tile = torch.repeat_interleave(torch.arange(nt, device=rows.device),
                                       off[1:] - off[:-1])
        slot = torch.arange(total, device=rows.device) - off[tile]
        lo = tile * TILE + plan.start[i].to(torch.int64)[tile * TILE + slot]
        last = slot + 1 == (off[1:] - off[:-1])[tile]
        hi = torch.where(last, (tile + 1) * TILE,
                         torch.cat([lo[1:], lo.new_zeros(1)]))
        run = rows.new_zeros(r, total)
        for j in range(int((hi - lo).max()) if total else 0):
            m = lo + j < hi
            run[:, m] = run[:, m] + srt[:, (lo + j)[m]]
        part = torch.empty_like(run)
        part[:, plan.dest[i, :total].to(torch.int64)] = run
        noff = plan.node_off[i].to(torch.int64)
        cnt = noff[1:] - noff[:-1]
        for j in range(int(cnt.max())):
            m = j < cnt
            out[i][:, m] = out[i][:, m] + part[:, (noff[:-1] + j)[m]]
    return out


def _state(ids: np.ndarray) -> torch.Tensor:
    b, n = ids.shape
    state = np.zeros((b, 4, n), np.float32)
    state[:, 3] = ids
    return torch.from_numpy(state)


def _values(kind: str, rng, shape) -> np.ndarray:
    vals = rng.normal(0, 100, shape).astype(np.float32)
    if kind == "special":           # -0.0, infinities and NaN among the rows
        vals[..., ::5] = -0.0
        vals[..., 3::41] = np.inf
        vals[..., 7::53] = -np.inf
        vals[..., 11::67] = np.nan
        vals[..., 2::3] = np.where(vals[..., 2::3] == 0, -0.0, vals[..., 2::3])
    elif kind == "negzero":         # a node whose every addend is -0.0
        vals[...] = -0.0
    return vals


CASES = [
    # ids, values, B, N, num_segs, R
    ("sorted", "normal", 1, 2048, 81, 6),
    ("sorted", "special", 3, 1024, 81, 12),
    ("shuffled", "normal", 3, 1024, 81, 6),
    ("shuffled", "special", 1, 2048, 200, 12),
    ("shuffled", "normal", 1, 1024, 256, 6),
    ("one_node", "normal", 1, 1024, 81, 6),
    ("one_node", "special", 3, 512, 200, 12),
    ("one_node", "negzero", 1, 512, 81, 6),
    ("all_distinct", "normal", 1, 1024, 256, 12),
    ("all_distinct", "special", 3, 512, 256, 6),
    ("trash", "normal", 3, 1024, 81, 6),
    ("trash", "special", 1, 2048, 161, 12),
]


@pytest.mark.parametrize("ids,values,b,n,num_segs,r", CASES,
                         ids=[f"{c[0]}-{c[1]}-B{c[2]}-S{c[4]}-R{c[5]}"
                              for c in CASES])
def test_plan_sums_equal_tile_sums_bitwise(ids, values, b, n, num_segs, r):
    rng = np.random.default_rng(CASES.index((ids, values, b, n, num_segs, r)))
    sp = fit_cuda.sp_width(num_segs)
    seg = _ids(ids, rng, b, n, sp, num_segs)
    rows = torch.from_numpy(_values(values, rng, (b, r, n)))
    plan = fit_cuda.sweep_plan(_state(seg), sp)
    got = _plan_sums(rows, plan)
    want = fit_cuda._tile_sums(rows, torch.from_numpy(seg), sp)
    assert got.shape == (b, r, sp)
    # bit patterns: -0.0 and +0.0 apart, a NaN's sign and payload included
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ids", ["sorted", "shuffled", "one_node",
                                 "all_distinct", "trash"])
@pytest.mark.parametrize("num_segs", [81, 256])
def test_plan_invariants(ids, num_segs):
    rng = np.random.default_rng(num_segs)
    b, n = 2, 1536
    nt = n // TILE
    sp = fit_cuda.sp_width(num_segs)
    seg = _ids(ids, rng, b, n, sp, num_segs).astype(np.int64)
    plan = fit_cuda.sweep_plan(_state(seg.astype(np.float32)), sp)
    assert plan.pos.dtype == torch.uint8 and plan.start.dtype == torch.uint8
    assert plan.cap == nt * min(TILE, sp)
    pos = plan.pos.numpy().astype(np.int64)
    start = plan.start.numpy().astype(np.int64)
    tile_off = plan.tile_off.numpy()
    node_off = plan.node_off.numpy()
    dest = plan.dest.numpy()
    tile_node = plan.tile_node.numpy()
    for i in range(b):
        entry_node, entry_tile = [], []
        for j in range(nt):
            s = seg[i, j * TILE:(j + 1) * TILE]
            p = pos[i, j * TILE:(j + 1) * TILE]
            # slots follow first occurrence
            _, first = np.unique(s, return_index=True)
            slots = s[np.sort(first)]
            k = len(slots)
            assert tile_off[i, j + 1] - tile_off[i, j] == k
            # every point has a place, and the places are a permutation
            assert sorted(p) == list(range(TILE))
            # sorted by place, the tile is its slots' runs, each in point order
            order = np.argsort(p)
            runs = start[i, j * TILE:j * TILE + k]
            assert runs[0] == 0 and np.all(np.diff(runs) > 0)
            assert not start[i, j * TILE + k:(j + 1) * TILE].any()
            np.testing.assert_array_equal(
                tile_node[i, j * TILE:(j + 1) * TILE],
                np.append(slots, np.zeros(TILE - k, np.int64)))
            ends = np.append(runs[1:], TILE)
            for slot, (lo, hi) in enumerate(zip(runs, ends)):
                members = order[lo:hi]
                assert np.all(s[members] == slots[slot])
                assert np.all(np.diff(members) > 0)
                assert hi - lo == np.sum(s == slots[slot])
            entry_node += list(slots)
            entry_tile += [j] * k
        entry_node, entry_tile = np.array(entry_node), np.array(entry_tile)
        total = tile_off[i, nt]
        assert total == len(entry_node) and node_off[i, sp] == total
        assert not dest[i, total:].any()
        # the entries' places are a permutation; inc lists, place by place,
        # the entry that lies there
        assert sorted(dest[i, :total]) == list(range(total))
        inc = np.argsort(dest[i, :total])
        for node in range(sp):
            mine = inc[node_off[i, node]:node_off[i, node + 1]]
            # a node's incidences: exactly its entries, in tile order
            assert np.all(entry_node[mine] == node)
            assert len(mine) == np.sum(entry_node == node)
            assert np.all(np.diff(entry_tile[mine]) > 0)


def _sweep_inputs(seed, b=2, n=1024, s=81):
    rng = np.random.default_rng(seed)
    sp = fit_cuda.sp_width(s)
    pts = np.zeros((b, 8, n), np.float32)
    pts[:, 0:2] = rng.normal(0, 20, (b, 2, n))
    pts[:, 2] = rng.normal(0, 0.3, (b, n))
    state = np.zeros((b, 4, n), np.float32)
    state[:, 0] = rng.random((b, n)) < 0.5
    state[:, 3] = np.sort(rng.integers(0, s, (b, n)), axis=1)
    tab = np.zeros((b, 8, sp), np.float32)
    tab[:, 0:3, :s] = rng.normal(0, 5, (b, 3, s))
    nrm = rng.normal(0, 1, (b, 3, s))
    tab[:, 3:6, :s] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    tab[:, 6, :s] = rng.random((b, s)) < 0.7
    tab[:, 7, :s] = rng.uniform(0.1, 0.4, (b, s))
    return [torch.from_numpy(a) for a in (pts, state, tab)] + [s - 1]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_apply_sweep_same_with_and_without_plan(fast):
    pts, state, tab, trash = _sweep_inputs(11)
    plan = fit_cuda.sweep_plan(state, tab.shape[2])
    st_a, st_b = state.clone(), state.clone()
    a = fit_cuda.apply_sweep(pts, st_a, tab, trash, fast)
    b = fit_cuda.apply_sweep(pts, st_b, tab, trash, fast, plan)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(st_a), _bits(st_b))
    assert not torch.equal(st_a, state), "the sweep must re-threshold points"
    # the planned order on the sweep's own rows gives the sweep's sums
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    gm = st_a[:, 0] * (state[:, 3] < trash)
    rows = torch.stack([gm, x * gm, y * gm, z * gm], 1)
    np.testing.assert_array_equal(_bits(_plan_sums(rows, plan)),
                                  _bits(a[:, :4]))


def _m2_rows(pts, state, ctab, trash):
    """The six rows the moments2 sweep adds per node, as its plain version
    computes them (fit_cuda.moments2_sweep_plain)."""
    seg, act = fit_cuda._live(state, trash)
    g = state[:, 0] * act
    c = fit_cuda._gather_rows(ctab, seg)
    dx = (pts[:, 0] - c[:, 0]) * g
    dy = (pts[:, 1] - c[:, 1]) * g
    dz = (pts[:, 2] - c[:, 2]) * g
    return torch.stack([dx * dx, dx * dy, dx * dz, dy * dy, dy * dz,
                        dz * dz], 1)


@pytest.mark.parametrize("ids", ["sorted", "shuffled", "trash"])
@pytest.mark.parametrize("values", ["normal", "special"])
@pytest.mark.parametrize("b,num_segs", [(1, 81), (3, 81), (1, 256), (3, 256)],
                         ids=["B1-Sp128", "B3-Sp128", "B1-Sp256", "B3-Sp256"])
def test_moments2_planned_order_equals_tile_sums_bitwise(ids, values, b,
                                                         num_segs):
    # the order the planned moments2 kernel adds its six rows in (_plan_sums)
    # gives the bits of the dense order (the sweep's plain version), with
    # -0.0, infinities and NaN among the coordinates; and a plan handed to
    # the wrapper changes nothing
    rng = np.random.default_rng(7 * b + num_segs)
    n = 1024
    sp = fit_cuda.sp_width(num_segs)
    trash = num_segs - 1
    pts = np.zeros((b, 8, n), np.float32)
    pts[:, 0:3] = _values(values, rng, (b, 3, n))
    state = _state(_ids(ids, rng, b, n, sp, num_segs))
    state[:, 0] = torch.from_numpy(
        (rng.random((b, n)) < 0.6).astype(np.float32))
    ctab = np.zeros((b, 3, sp), np.float32)
    ctab[:, :, :num_segs] = rng.normal(0, 50, (b, 3, num_segs))
    if values == "special":
        ctab[:, :, ::9] = -0.0
    pts, ctab = torch.from_numpy(pts), torch.from_numpy(ctab)
    plan = fit_cuda.sweep_plan(state, sp)
    want = fit_cuda.moments2_sweep(pts, state, ctab, trash)
    with_plan = fit_cuda.moments2_sweep(pts, state, ctab, trash, plan)
    got = _plan_sums(_m2_rows(pts, state, ctab, trash), plan)
    assert want.shape == got.shape == (b, 6, sp)
    # bit patterns: -0.0 and +0.0 apart, a NaN's sign and payload included
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(with_plan), _bits(want))
    if values == "special":
        assert torch.isnan(want).any() and not torch.isnan(want).all()


@pytest.mark.parametrize("kernels", [fit_cuda, fit_cuda.plain],
                         ids=["wrappers", "plain"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_fit_loop_same_with_and_without_plan(kernels, fast):
    pts, state, tab, trash = _sweep_inputs(13)
    sp = tab.shape[2]
    fit_row = (tab[:, 6] > 0).to(torch.float32).contiguous()
    tau_row = tab[:, 7].contiguous()
    outs = []
    for plan in (None, fit_cuda.sweep_plan(state, sp)):
        st = state.clone()
        m1 = kernels.apply_sweep(pts, st, pts.new_zeros(2, 8, sp), trash, fast)
        sf = fit_cuda.fit_sweep_loop(kernels, pts, st, m1, fit_row, tau_row,
                                     trash, 4, fast, plan)
        outs.append((sf, st))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert not torch.equal(outs[0][1][:, 0], state[:, 0])


def test_plain_namespace_takes_no_plan():
    # the plain path adds densely: its plan is None and its sweep ignores one
    pts, state, tab, trash = _sweep_inputs(17)
    assert fit_cuda.plain.sweep_plan(state, tab.shape[2]) is None
    st_a, st_b = state.clone(), state.clone()
    a = fit_cuda.plain.apply_sweep(pts, st_a, tab, trash, False)
    b = fit_cuda.plain.apply_sweep(pts, st_b, tab, trash, False,
                                   fit_cuda.sweep_plan(state, tab.shape[2]))
    np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(st_a), _bits(st_b))
    ctab = tab[:, :3].contiguous()
    np.testing.assert_array_equal(
        _bits(fit_cuda.plain.moments2_sweep(pts, state, ctab, trash)),
        _bits(fit_cuda.plain.moments2_sweep(
            pts, state, ctab, trash, fit_cuda.sweep_plan(state, tab.shape[2]))))
