"""Hand-written CUDA kernels of the engine's main path, with their plain
PyTorch versions.

Port of ``patchwork_tpu/kernels/fit_pallas.py`` for an NVIDIA H100
(sources in ``patchwork_tpu_torch/csrc/``, built by :mod:`._build`).  Four
TPU kernels are on the main path, and each becomes a family here:

=================  ==================================================
family             replaces (patchwork_tpu/kernels/...)
=================  ==================================================
``seg_order_stat`` fit_pallas.py ``seg_order_stat`` / ``_orderstat_kernel``
``apply_sweep``    fit_pallas.py ``fused_apply`` / ``_apply_kernel``
``moments2_sweep`` fit_pallas.py ``fused_moments2`` / ``_moments2_kernel``
``level``          fit_pallas.py ``level_megakernel`` / ``_level_kernel``
``fit_level``      fit_pallas.py ``fit_level_megakernel`` / ``_mega_kernel``
=================  ==================================================

plus ``seg_sum`` (seg_pallas.py ``seg_sum_pallas``), the fixed-order
segment sum that binning and the remap prologue use.  The other two
seg_pallas.py kernels are in :mod:`.seg_cuda`.

The TPU kernels keep the whole cloud in VMEM and turn every segment op
into a one-hot matmul on the MXU.  None of that carries over: here the
cloud stays in device memory (8 packed scans of 131072 points are 34 MB,
inside the 50 MB L2), segment sums are sequential per-node sums inside a
tile of ``TILE`` points followed by a sum of the tiles in index order, and
min/max/counts use integer atomics, which are exact in any order.  No sweep
uses float atomics, so two runs give the same bits, and every plain
version below adds in exactly the kernel's order: on the same device a
kernel and its plain version agree bit for bit.

Every wrapper takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches per family.
"""

from __future__ import annotations

import types

import torch

from ..core.device import true_div
from ..segment.segops import SegOps, flatten_batch, sort_by_segment

__all__ = [
    "TILE", "sp_width", "LAUNCHES", "reset_launches", "plain",
    "seg_order_stat", "seg_sum", "apply_sweep", "moments2_sweep",
    "remap_r1", "remap_r1b", "remap_nodes", "remap_points", "node_stats",
    "early_outs", "deficient_round", "seed_init", "plane_table",
    "split_decision", "finish_nodes", "fit_pack", "megakernel_fits",
    "fit_level",
]

TILE = 256           # points per partial sum (one CUDA block per tile)
_EPS = 1e-12
_TWO_PI_3 = 2.0943951023931953
_BIG = 3.0e38
_HIST_SMEM_LIMIT = 200 * 1024    # bytes of one order-stat block's histogram


LAUNCHES = {"seg_order_stat": 0, "apply_sweep": 0, "moments2_sweep": 0,
            "level": 0, "seg_sum": 0, "fit_level": 0, "seg_gather": 0,
            "seg_minmax": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sp_width(num_segs: int) -> int:
    """Node-table width: the segment count rounded up to 128 (as the TPU
    kernels lay it out, so tables compare column for column)."""
    return max(128, ((num_segs + 127) // 128) * 128)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _on_card(*tensors: torch.Tensor | None) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors, after
    checking they share one device and are contiguous.  Anything else raises."""
    ts = [t for t in tensors if t is not None]
    dev = ts[0].device
    if dev.type == "cpu":
        if any(t.device.type != "cpu" for t in ts):
            raise ValueError("tensors on mixed devices")
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError("tensors on mixed devices")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return True


def _f32(*ts: torch.Tensor) -> None:
    for t in ts:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")


def _launch(family: str, fn_name: str, *args) -> None:
    from . import _build

    fn = getattr(_build.load(), fn_name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor)
            else (None if a is None else a) for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")
    LAUNCHES[family] += 1


def _check_points(pts: torch.Tensor, state: torch.Tensor | None = None):
    if pts.dim() != 3 or pts.shape[1] != 8:
        raise ValueError(f"pts must be (B, 8, N), got {tuple(pts.shape)}")
    if pts.shape[2] % TILE:
        raise ValueError(f"N={pts.shape[2]} is not a multiple of {TILE}")
    if state is not None and (state.shape[0] != pts.shape[0]
                              or state.shape[1] != 4
                              or state.shape[2] != pts.shape[2]):
        raise ValueError(f"state must be (B, 4, N), got {tuple(state.shape)}")
    _f32(pts, state)


# ---------------------------------------------------------------------------
# plain building blocks
# ---------------------------------------------------------------------------

def _tile_sums(rows: torch.Tensor, seg: torch.Tensor, sp: int) -> torch.Tensor:
    """(B, R, N) rows summed per segment -> (B, R, sp), in the kernels'
    order: inside each tile of TILE points a sequential sum per segment in
    point order, then the tiles' partial sums in tile order."""
    b, r, n = rows.shape
    nt = n // TILE
    v = rows.reshape(b, r, nt, TILE)
    s = seg.to(torch.int64).reshape(b, 1, nt, TILE).expand(b, r, nt, TILE)
    acc = rows.new_zeros(b, r, nt, sp)
    for t in range(TILE):
        idx = s[..., t:t + 1]
        acc.scatter_(3, idx, acc.gather(3, idx) + v[..., t:t + 1])
    out = rows.new_zeros(b, r, sp)
    for j in range(nt):
        out = out + acc[:, :, j]
    return out


def _gather_rows(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(B, R, sp) node rows -> (B, R, N) per-point rows of node ``seg``."""
    idx = seg.to(torch.int64)[:, None, :].expand(-1, table.shape[1], -1)
    return torch.gather(table, 2, idx)


def _live(state: torch.Tensor, trash: int):
    """(live seg as int64, activity as 0/1 float) from state row 3."""
    segf = state[:, 3]
    return segf.to(torch.int64), (segf < trash).to(torch.float32)


# ---------------------------------------------------------------------------
# seg_order_stat  (fit_pallas.py:691-731 seg_order_stat -> _orderstat_kernel)
# ---------------------------------------------------------------------------

def seg_order_stat_plain(vals, seg, valid, k, num_segs):
    """Exact per-segment k-th smallest value, by a (segment, key) sort."""
    b, n = vals.shape
    flat = flatten_batch(seg, num_segs)
    flat = torch.where(valid.reshape(-1), flat,
                       torch.full_like(flat, b * num_segs))
    ss = sort_by_segment(flat, vals.reshape(-1), b * num_segs)
    return ss.order_stat(k.reshape(-1)).reshape(b, num_segs)


def seg_order_stat(vals: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                   k: torch.Tensor, num_segs: int) -> torch.Tensor:
    """Exact per-segment k-th smallest value, ``sorted(vals of seg)[k]``.

    vals (B, N) f32, seg (B, N) int32 in [0, num_segs), valid (B, N) bool,
    k (B, num_segs) int32.  Returns (B, num_segs) f32; segments with no
    candidate or k out of range return garbage (mask downstream).

    CUDA: 5 rounds of a 128-bucket histogram over order-preserving int32
    keys (7 key bits per round, 4 in the last), as ``_orderstat_rounds``.
    Each block counts a chunk of one scan's points into a shared-memory
    (segment, bucket) histogram with integer atomics and adds its nonzero
    bins to global memory; one thread per segment then picks the bucket
    that holds rank k.  Bound by the atomics of the counting pass; the
    shared histogram keeps global atomics to one per touched bin per block.
    """
    if not _on_card(vals, seg, valid, k):
        return seg_order_stat_plain(vals, seg, valid, k, num_segs)
    _f32(vals)
    if seg.dtype != torch.int32 or k.dtype != torch.int32:
        raise TypeError("seg and k must be int32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    b, n = vals.shape
    if seg.shape != (b, n) or valid.shape != (b, n) or k.shape != (b, num_segs):
        raise ValueError("seg_order_stat: shape mismatch")
    if num_segs * 128 * 4 > _HIST_SMEM_LIMIT:
        raise ValueError(f"num_segs={num_segs} exceeds the shared histogram")
    out = torch.empty((b, num_segs), dtype=torch.float32, device=vals.device)
    hist = torch.zeros((b, num_segs, 128), dtype=torch.int32,
                       device=vals.device)
    lo = torch.empty((b, num_segs), dtype=torch.int32, device=vals.device)
    kw = torch.empty_like(lo)
    _launch("seg_order_stat", "pw_seg_order_stat", vals, seg, valid, k, out,
            hist, lo, kw, b, n, num_segs)
    return out


# ---------------------------------------------------------------------------
# seg_sum  (seg_pallas.py:74-93 seg_sum_pallas -> _seg_sum_kernel)
# ---------------------------------------------------------------------------

def _pad_tiles(rows: torch.Tensor, seg: torch.Tensor):
    pad = (-rows.shape[2]) % TILE
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
        seg = torch.nn.functional.pad(seg, (0, pad))
    return rows.contiguous(), seg.contiguous()


def seg_sum_plain(rows, seg, num_segs):
    rows, seg = _pad_tiles(rows, seg)
    return _tile_sums(rows, seg, num_segs)


def seg_sum(rows: torch.Tensor, seg: torch.Tensor, num_segs: int) -> torch.Tensor:
    """Fixed-order segment sum: rows (B, R, N) f32, seg (B, N) int32 in
    [0, num_segs) -> (B, R, num_segs).  N is zero-padded to a TILE multiple.

    CUDA: one block per (tile, scan) stages its tile in shared memory; the
    thread of node s adds the tile's points of s in point order; a second
    kernel adds the per-tile partials in tile order.  Bound by reading the
    rows once and writing/reading the (tiles, R, S) partials.
    """
    if not _on_card(rows, seg):
        return seg_sum_plain(rows, seg, num_segs)
    _f32(rows)
    if seg.dtype != torch.int32:
        raise TypeError("seg must be int32")
    b, r, _ = rows.shape
    if not 1 <= r <= 8:
        raise ValueError("seg_sum takes 1..8 rows")
    rows, seg = _pad_tiles(rows, seg)
    n = rows.shape[2]
    partial = torch.empty((b, n // TILE, r, num_segs), dtype=torch.float32,
                          device=rows.device)
    out = torch.empty((b, r, num_segs), dtype=torch.float32, device=rows.device)
    _launch("seg_sum", "pw_seg_sum", rows, seg, partial, out, b, r, n,
            num_segs)
    return out


# ---------------------------------------------------------------------------
# apply_sweep  (fit_pallas.py:179-216 fused_apply -> _apply_kernel; the
# level kernel's inner `sweep`, fit_pallas.py:1305-1336)
# ---------------------------------------------------------------------------

def _sweep_rows(fast: bool) -> int:
    return 12 if fast else 6


def apply_sweep_plain(pts, state, tab, trash, fast):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    seg, act = _live(state, trash)
    g = state[:, 0].clone()
    gat = _gather_rows(tab, seg)
    dx, dy, dz = x - gat[:, 0], y - gat[:, 1], z - gat[:, 2]
    dist = torch.abs(dx * gat[:, 3] + dy * gat[:, 4] + dz * gat[:, 5])
    apply_m = act * gat[:, 6]
    new_g = (dist < gat[:, 7]).to(torch.float32)
    g2 = apply_m * new_g + (1.0 - apply_m) * g
    state[:, 0] = g2
    gm = g2 * act
    xg, yg, zg = x * gm, y * gm, z * gm
    rows = [gm, xg, yg, zg, dist * g * act,
            apply_m * torch.abs(new_g - g)]
    if fast:
        rows += [x * xg, y * xg, z * xg, y * yg, z * yg, z * zg]
    return _tile_sums(torch.stack(rows, 1), seg, tab.shape[2])


def apply_sweep(pts: torch.Tensor, state: torch.Tensor, tab: torch.Tensor,
                trash: int, fast: bool) -> torch.Tensor:
    """One apply sweep of the fit loop; updates ``state`` row 0 in place.

    pts (B, 8, N) rows [x, y, z, ...]; state (B, 4, N) rows [ground, done,
    chosen, seg]; tab (B, 8, Sp) rows [cx, cy, cz, nx, ny, nz, can, tau].
    Per point: distance to its node's plane, ``ground = dist < tau`` where
    the point is live (seg < trash) and its node may update (can), the
    expression of fit_pallas.py:1314-1319.  Returns per-node sums
    (B, R, Sp), R = 6 rows [cnt, sx, sy, sz (of the new mask), distsum
    (old mask), changed], plus 6 raw second moments [xx, xy, xz, yy, yz,
    zz] of the new mask in fast mode (R = 12).

    CUDA: one block per (tile, scan); each thread computes one point and
    stages its rows in shared memory; the thread of node s sums the tile's
    points of s in point order; a second kernel sums the tiles in order.
    Bound by memory: ~28 bytes read and 4 written per point, plus the
    (tiles, R, Sp) partials.
    """
    if not _on_card(pts, state, tab):
        return apply_sweep_plain(pts, state, tab, trash, fast)
    _check_points(pts, state)
    _f32(tab)
    b, _, n = pts.shape
    sp = tab.shape[2]
    r = _sweep_rows(fast)
    partial = torch.empty((b, n // TILE, r, sp), dtype=torch.float32,
                          device=pts.device)
    out = torch.empty((b, r, sp), dtype=torch.float32, device=pts.device)
    _launch("apply_sweep", "pw_apply_sweep", pts, state, tab, partial, out,
            b, n, sp, trash, int(fast))
    return out


# ---------------------------------------------------------------------------
# moments2_sweep  (fit_pallas.py:219-244 fused_moments2 -> _moments2_kernel;
# the level kernel's `m2_sweep`, fit_pallas.py:1338-1355)
# ---------------------------------------------------------------------------

def moments2_sweep_plain(pts, state, ctab, trash):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    seg, act = _live(state, trash)
    g = state[:, 0] * act
    c = _gather_rows(ctab, seg)
    dx = (x - c[:, 0]) * g
    dy = (y - c[:, 1]) * g
    dz = (z - c[:, 2]) * g
    rows = [dx * dx, dx * dy, dx * dz, dy * dy, dy * dz, dz * dz]
    return _tile_sums(torch.stack(rows, 1), seg, ctab.shape[2])


def moments2_sweep(pts: torch.Tensor, state: torch.Tensor, ctab: torch.Tensor,
                   trash: int) -> torch.Tensor:
    """Centered second-moment sums [xx, xy, xz, yy, yz, zz] per node of the
    live ground mask about the node centroids ctab (B, 3, Sp) -> (B, 6, Sp).

    CUDA: the same tile scheme as :func:`apply_sweep`; bound by memory.
    """
    if not _on_card(pts, state, ctab):
        return moments2_sweep_plain(pts, state, ctab, trash)
    _check_points(pts, state)
    _f32(ctab)
    b, _, n = pts.shape
    sp = ctab.shape[2]
    partial = torch.empty((b, n // TILE, 6, sp), dtype=torch.float32,
                          device=pts.device)
    out = torch.empty((b, 6, sp), dtype=torch.float32, device=pts.device)
    _launch("moments2_sweep", "pw_moments2_sweep", pts, state, ctab, partial,
            out, b, n, sp, trash)
    return out


# ---------------------------------------------------------------------------
# level family  (fit_pallas.py:1465-1558 level_megakernel -> _level_kernel):
# the kernels of one engine level other than the sweeps above.  Per-point
# kernels are bound by memory (one pass over the packed points each);
# per-node kernels are one thread per node and bound by launch latency.
# ---------------------------------------------------------------------------

def remap_r1_plain(pts, trash, sp, fast):
    x, y = pts[:, 0], pts[:, 1]
    pseg = pts[:, 3]
    a = (pseg < trash).to(torch.float32)
    xa, ya = x * a, y * a
    rows = [a, xa, ya] + ([x * xa, y * ya] if fast else [])
    return _tile_sums(torch.stack(rows, 1), pseg.to(torch.int64), sp)


def remap_r1(pts: torch.Tensor, trash: int, sp: int, fast: bool) -> torch.Tensor:
    """R1 (fit_pallas.py:885-903): per-parent sums [cnt, sx, sy] of the live
    points (parent id = pts row 3), plus raw [xx, yy] in fast mode."""
    if not _on_card(pts):
        return remap_r1_plain(pts, trash, sp, fast)
    _check_points(pts)
    b, _, n = pts.shape
    r = 5 if fast else 3
    partial = torch.empty((b, n // TILE, r, sp), dtype=torch.float32,
                          device=pts.device)
    out = torch.empty((b, r, sp), dtype=torch.float32, device=pts.device)
    _launch("level", "pw_remap_r1", pts, partial, out, b, n, sp, trash,
            int(fast))
    return out


def remap_r1b_plain(pts, cxy, trash):
    x, y = pts[:, 0], pts[:, 1]
    pseg = pts[:, 3]
    ps = pseg.to(torch.int64)
    a = (pseg < trash).to(torch.float32)
    c = _gather_rows(cxy, ps)
    dx = (x - c[:, 0]) * a
    dy = (y - c[:, 1]) * a
    return _tile_sums(torch.stack([dx * dx, dy * dy], 1), ps, cxy.shape[2])


def remap_r1b(pts: torch.Tensor, cxy: torch.Tensor, trash: int) -> torch.Tensor:
    """R1 second pass, exact mode (fit_pallas.py:910-928): per-parent
    centered [sum dx^2, sum dy^2] about the parent centroid cxy (B, 2, Sp)."""
    if not _on_card(pts, cxy):
        return remap_r1b_plain(pts, cxy, trash)
    _check_points(pts)
    _f32(cxy)
    b, _, n = pts.shape
    sp = cxy.shape[2]
    partial = torch.empty((b, n // TILE, 2, sp), dtype=torch.float32,
                          device=pts.device)
    out = torch.empty((b, 2, sp), dtype=torch.float32, device=pts.device)
    _launch("level", "pw_remap_r1b", pts, cxy, partial, out, b, n, sp, trash)
    return out


def remap_nodes_plain(tables, median, axis, trash):
    b, _, sp = tables.shape
    split = tables[:, 6]
    rank = torch.cumsum(split, dim=1) - split
    base = 2.0 * rank
    okp = split * ((base + 1.0) < trash).to(torch.float32)
    pnode = torch.stack([median, okp, base, axis], 1)
    dest = torch.where(okp > 0.5, base.to(torch.int64),
                       torch.full_like(base, sp, dtype=torch.int64))
    dest = dest[:, None, :].expand(b, 2, sp)
    tz = tables.new_zeros(b, 2, sp + 2)
    tz.scatter_(2, dest, tables[:, 0:2])
    tz.scatter_(2, dest + 1, tables[:, 0:2])
    return pnode, tz[:, :, :sp].contiguous()


def remap_nodes(tables: torch.Tensor, median: torch.Tensor, axis: torch.Tensor,
                trash: int):
    """R3 + R4 (fit_pallas.py:961-982), one thread per scan walking the
    parents: compact child slots (2 * #earlier split parents; overflow
    keeps its mask) and the children's inherited tau/zth rows.

    Returns (pnode (B, 4, Sp) rows [median, ok, base_slot, axis_x] per
    parent, tz (B, 2, Sp) rows [tau, zth] per child slot)."""
    if not _on_card(tables, median, axis):
        return remap_nodes_plain(tables, median, axis, trash)
    _f32(tables, median, axis)
    b, _, sp = tables.shape
    pnode = torch.empty((b, 4, sp), dtype=torch.float32, device=tables.device)
    tz = torch.empty((b, 2, sp), dtype=torch.float32, device=tables.device)
    _launch("level", "pw_remap_nodes", tables, median, axis, pnode, tz, b, sp,
            trash)
    return pnode, tz


def remap_points_plain(pts, state, pnode, trash):
    x, y = pts[:, 0], pts[:, 1]
    pseg = pts[:, 3]
    a = (pseg < trash).to(torch.float32)
    g = _gather_rows(pnode, pseg.to(torch.int64))
    med, okg, slot, ax = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    v = ax * x + (1.0 - ax) * y
    gr = (v > med).to(torch.float32)
    newseg = okg * (slot + gr) + (1.0 - okg) * trash
    state[:, 3] = a * newseg + (1.0 - a) * trash
    state[:, 1] = torch.maximum(state[:, 1], a * (1.0 - okg))


def remap_points(pts: torch.Tensor, state: torch.Tensor, pnode: torch.Tensor,
                 trash: int) -> None:
    """R5 (fit_pallas.py:984-1010): each live point moves to its parent's
    left (value <= median) or right child slot; points of overflowing
    parents are done.  Writes state rows 1 and 3 in place."""
    if not _on_card(pts, state, pnode):
        return remap_points_plain(pts, state, pnode, trash)
    _check_points(pts, state)
    _f32(pnode)
    b, _, n = pts.shape
    _launch("level", "pw_remap_points", pts, state, pnode, b, n,
            pnode.shape[2], trash)


def node_stats_plain(pts, state, zth, trash, sp):
    seg, act = _live(state, trash)
    live = act > 0.5
    ops = SegOps(seg, sp)
    cnt = ops.count(live).to(torch.float32)
    if zth is None:
        seed = torch.zeros_like(cnt)
    else:
        seedm = live & (pts[:, 2] < torch.gather(zth, 1, seg))
        seed = ops.count(seedm).to(torch.float32)
    mins, maxs = ops.bbox(pts[:, 0:3], live)
    return torch.cat([cnt[:, None], seed[:, None], mins, maxs], 1)


def node_stats(pts: torch.Tensor, state: torch.Tensor, zth: torch.Tensor | None,
               trash: int, sp: int) -> torch.Tensor:
    """Phase 1 (fit_pallas.py:1012-1054): per live node (B, 8, Sp) rows
    [cnt, seed_cnt, xmin, ymin, zmin, xmax, ymax, zmax]; seed_cnt counts
    z < zth[node] (zeros when ``zth`` is None).  Empty nodes: +inf mins,
    -inf maxs.  CUDA: shared-memory integer atomics per block (counts, and
    min/max on order-preserving int keys), one global atomic per touched
    node per block."""
    if not _on_card(pts, state, zth):
        return node_stats_plain(pts, state, zth, trash, sp)
    _check_points(pts, state)
    _f32(zth)
    b, _, n = pts.shape
    work = torch.empty((b, 8, sp), dtype=torch.int32, device=pts.device)
    out = torch.empty((b, 8, sp), dtype=torch.float32, device=pts.device)
    _launch("level", "pw_node_stats", pts, state, zth, work, out, b, n, sp,
            trash)
    return out


def early_out_masks(cnt, seed, mins, maxs, real, is_level0, flat_area,
                    flat_dz, flat_minpts, min_seed):
    """Early-outs in the reference's order (cpp:111-140), per node: from the
    counts (B, S), bbox (B, 3, S) each and the real-node mask, the bool
    masks (finished, label, fit, deficient)."""
    too_small = cnt < 3.0
    area = (maxs[:, 0] - mins[:, 0]) * (maxs[:, 1] - mins[:, 1])
    if is_level0:
        flat_a = torch.zeros_like(too_small)
    else:
        flat_a = (area < flat_area) & ~too_small
    flat_z = (maxs[:, 2] - mins[:, 2]) < flat_dz
    flat_z = flat_z & (cnt > float(flat_minpts)) & ~too_small & ~flat_a
    finished = real & (too_small | flat_a | flat_z)
    fit = real & ~finished
    return finished, flat_a | flat_z, fit, fit & (seed < float(min_seed))


def early_outs_plain(nstats, tables, zth, is_level0, flat_area, flat_dz,
                     flat_minpts, min_seed):
    finished, label, fit, deficient = early_out_masks(
        nstats[:, 0], nstats[:, 1], nstats[:, 2:5], nstats[:, 5:8],
        tables[:, 2] > 0.5, is_level0, flat_area, flat_dz, flat_minpts,
        min_seed)
    flags = torch.stack([finished.float(), label.float(), fit.float(),
                         deficient.float(), zth], 1)
    return flags, deficient.any(dim=1).to(torch.int32)


def early_outs(nstats: torch.Tensor, tables: torch.Tensor, zth: torch.Tensor,
               is_level0: bool, flat_area: float, flat_dz: float,
               flat_minpts: int, min_seed: int):
    """Phase 2 (fit_pallas.py:1104-1118), one thread per node, in the
    reference's order (cpp:111-140).  Returns (flags (B, 5, Sp) rows
    [finished, label, fit, deficient, zth], any_deficient (B,) int32)."""
    if not _on_card(nstats, tables, zth):
        return early_outs_plain(nstats, tables, zth, is_level0, flat_area,
                                flat_dz, flat_minpts, min_seed)
    _f32(nstats, tables, zth)
    b, _, sp = nstats.shape
    flags = torch.empty((b, 5, sp), dtype=torch.float32, device=nstats.device)
    any_def = torch.zeros((b,), dtype=torch.int32, device=nstats.device)
    _launch("level", "pw_early_outs", nstats, tables, zth, flags, any_def, b,
            sp, int(is_level0), float(flat_area), float(flat_dz),
            int(flat_minpts), int(min_seed))
    return flags, any_def


def deficient_round_plain(pts, state, flags, any_def, trash):
    sp = flags.shape[2]
    z, idx = pts[:, 2], pts[:, 6]
    seg, act = _live(state, trash)
    def_pt = torch.gather(flags[:, 3], 1, seg) > 0.5
    chosen = state[:, 2]
    cand = (act > 0.5) & def_pt & (chosen < 0.5)
    ops = SegOps(seg, sp)
    m = ops.min(z, cand)
    m_pt = ops.gather(torch.where(torch.isfinite(m), m, _BIG))
    is_min = cand & (z == m_pt)
    mi = ops.min(idx, is_min)
    mi_pt = ops.gather(torch.where(torch.isfinite(mi), mi, _BIG))
    pick = is_min & (idx == mi_pt)
    state[:, 2] = torch.maximum(chosen, pick.to(torch.float32))


def deficient_round(pts: torch.Tensor, state: torch.Tensor, flags: torch.Tensor,
                    any_def: torch.Tensor, trash: int) -> None:
    """One round of phase 3 (fit_pallas.py:1120-1193): every deficient node
    picks its lowest-z not yet chosen point (ties: lowest index) into state
    row 2.  CUDA: min z, then min index, by integer atomics; scans without
    a deficient node return at once."""
    if not _on_card(pts, state, flags, any_def):
        return deficient_round_plain(pts, state, flags, any_def, trash)
    _check_points(pts, state)
    b, _, n = pts.shape
    sp = flags.shape[2]
    zmin = torch.empty((b, sp), dtype=torch.int32, device=pts.device)
    imin = torch.empty_like(zmin)
    _launch("level", "pw_deficient_round", pts, state, flags, any_def, zmin,
            imin, b, n, sp, trash)


def seed_init_plain(pts, state, flags, trash, fast):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    seg, act = _live(state, trash)
    f = _gather_rows(flags, seg)
    fin_pt, lab_pt, fit_pt, def_pt, zth_pt = (f[:, 0], f[:, 1], f[:, 2],
                                              f[:, 3], f[:, 4])
    seed = act * (z < zth_pt).to(torch.float32)
    chosen = state[:, 2]
    seed = (def_pt * chosen + (1.0 - def_pt) * seed) * act
    g = state[:, 0]
    w_fin = act * fin_pt
    g = w_fin * lab_pt + (1.0 - w_fin) * g
    w_fit = act * fit_pt
    g = w_fit * seed + (1.0 - w_fit) * g
    state[:, 0] = g
    state[:, 1] = torch.maximum(state[:, 1], w_fin)
    gm = g * act
    xg, yg, zg = x * gm, y * gm, z * gm
    zero = torch.zeros_like(gm)
    rows = [gm, xg, yg, zg, zero, zero]
    if fast:
        rows += [x * xg, y * xg, z * xg, y * yg, z * yg, z * zg]
    return _tile_sums(torch.stack(rows, 1), seg, flags.shape[2])


def seed_init(pts: torch.Tensor, state: torch.Tensor, flags: torch.Tensor,
              trash: int, fast: bool) -> torch.Tensor:
    """Phase 4 fused with the fit loop's first moment sweep
    (fit_pallas.py:1371-1409): early-out labels and seeds into state rows
    0-1, then the same (B, R, Sp) sums as :func:`apply_sweep` with zero
    distance and changed rows."""
    if not _on_card(pts, state, flags):
        return seed_init_plain(pts, state, flags, trash, fast)
    _check_points(pts, state)
    _f32(flags)
    b, _, n = pts.shape
    sp = flags.shape[2]
    r = _sweep_rows(fast)
    partial = torch.empty((b, n // TILE, r, sp), dtype=torch.float32,
                          device=pts.device)
    out = torch.empty((b, r, sp), dtype=torch.float32, device=pts.device)
    _launch("level", "pw_seed_init", pts, state, flags, partial, out, b, n,
            sp, trash, int(fast))
    return out


def _normal_rows(m2: torch.Tensor, gcnt: torch.Tensor):
    """``_plane_rows`` (fit_pallas.py:311-377) term for term, with acos in
    place of the TPU's polynomial ``_acos``: (B, 6, Sp) centered second
    moment sums -> unit normals (vx, vy, vz), flipped to +Z."""
    denom = torch.clamp(gcnt - 1.0, min=1.0)
    a00, a01, a02 = m2[:, 0] / denom, m2[:, 1] / denom, m2[:, 2] / denom
    a11, a12, a22 = m2[:, 3] / denom, m2[:, 4] / denom, m2[:, 5] / denom

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = true_div(a00 + a11 + a22, 3.0)
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(true_div(p2, 6.0), min=0.0))
    safe_p = torch.clamp(p, min=_EPS)
    b00, b11, b22 = d0 / safe_p, d1 / safe_p, d2 / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = true_div(torch.acos(r), 3.0)
    two_pi_3 = torch.tensor(_TWO_PI_3, dtype=torch.float32, device=m2.device)
    e_lo = q + 2.0 * p * torch.cos(phi + two_pi_3)
    diag_min = torch.minimum(a00, torch.minimum(a11, a22))
    e_min = torch.where(p <= _EPS, diag_min, e_lo)

    r0x, r0y, r0z = a00 - e_min, a01, a02
    r1x, r1y, r1z = a01, a11 - e_min, a12
    r2x, r2y, r2z = a02, a12, a22 - e_min
    c0x = r0y * r1z - r0z * r1y
    c0y = r0z * r1x - r0x * r1z
    c0z = r0x * r1y - r0y * r1x
    c1x = r0y * r2z - r0z * r2y
    c1y = r0z * r2x - r0x * r2z
    c1z = r0x * r2y - r0y * r2x
    c2x = r1y * r2z - r1z * r2y
    c2y = r1z * r2x - r1x * r2z
    c2z = r1x * r2y - r1y * r2x

    n0 = torch.sqrt(c0x * c0x + c0y * c0y + c0z * c0z)
    n1 = torch.sqrt(c1x * c1x + c1y * c1y + c1z * c1z)
    n2 = torch.sqrt(c2x * c2x + c2y * c2y + c2z * c2z)
    sel0 = (n0 >= n1) & (n0 >= n2)
    sel1 = ~sel0 & (n1 >= n2)
    vx = torch.where(sel0, c0x, torch.where(sel1, c1x, c2x))
    vy = torch.where(sel0, c0y, torch.where(sel1, c1y, c2y))
    vz = torch.where(sel0, c0z, torch.where(sel1, c1z, c2z))
    nn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    ok = nn > 1e-20
    sn = torch.clamp(nn, min=1e-30)
    zero, one = torch.zeros_like(vx), torch.ones_like(vx)
    vx = torch.where(ok, vx / sn, zero)
    vy = torch.where(ok, vy / sn, zero)
    vz = torch.where(ok, vz / sn, one)
    flip = vz < 0
    return (torch.where(flip, -vx, vx), torch.where(flip, -vy, vy),
            torch.where(flip, -vz, vz))


def _centered_m2(m1: torch.Tensor) -> torch.Tensor:
    """Raw fast-sweep moments -> centered sums, ``_centered_m2``
    (fit_pallas.py:380-396): cov sums = M2 - S S^T / n."""
    n = torch.clamp(m1[:, 0], min=1.0)
    sx, sy, sz = m1[:, 1], m1[:, 2], m1[:, 3]
    return torch.stack([m1[:, 6] - sx * sx / n, m1[:, 7] - sx * sy / n,
                        m1[:, 8] - sx * sz / n, m1[:, 9] - sy * sy / n,
                        m1[:, 10] - sy * sz / n, m1[:, 11] - sz * sz / n], 1)


def plane_table_plain(m1, c, m2, fit, tau, fast):
    gcnt = m1[:, 0]
    if fast:
        m2 = _centered_m2(m1)
    vx, vy, vz = _normal_rows(m2, gcnt)
    if fit is None:
        can = torch.zeros_like(gcnt)
    else:
        can = fit * (gcnt >= 3.0).to(torch.float32)
    return torch.stack([c[:, 0], c[:, 1], c[:, 2], vx, vy, vz, can, tau], 1)


def plane_table(m1: torch.Tensor, c: torch.Tensor, m2: torch.Tensor | None,
                fit: torch.Tensor | None, tau: torch.Tensor,
                fast: bool) -> torch.Tensor:
    """``make_tab`` (fit_pallas.py:1357-1369), one thread per node: the
    (B, 8, Sp) plane table [cx, cy, cz, nx, ny, nz, can, tau] the next sweep
    reads.  c (B, 3, Sp) centroids; m2 (B, 6, Sp) centered sums in exact
    mode, None in fast mode (taken from m1's raw rows); ``fit`` None gives
    can = 0 (the final residual sweep)."""
    if not _on_card(m1, c, m2, fit, tau):
        return plane_table_plain(m1, c, m2, fit, tau, fast)
    _f32(m1, c, m2, fit, tau)
    if (m2 is None) != fast:
        raise ValueError("m2 is given exactly in exact mode")
    b, r, sp = m1.shape
    tab = torch.empty((b, 8, sp), dtype=torch.float32, device=m1.device)
    _launch("level", "pw_plane_table", m1, c, m2, fit, tau, tab, b, sp, r,
            int(fast))
    return tab


def split_decision_plain(sf, nstats, flags, tables):
    gcnt = sf[:, 0]
    resid = sf[:, 4] / torch.clamp(gcnt, min=1.0)
    resid = torch.where(gcnt >= 3.0, resid, torch.full_like(resid, float("inf")))
    split = ((flags[:, 2] > 0.5) & (resid > tables[:, 3])
             & (nstats[:, 0] >= tables[:, 4]) & (tables[:, 5] > 0.5))
    return torch.stack([split.to(torch.float32), gcnt, resid], 1)


def split_decision(sf: torch.Tensor, nstats: torch.Tensor, flags: torch.Tensor,
                   tables: torch.Tensor) -> torch.Tensor:
    """Phase 6 (fit_pallas.py:1427-1439), one thread per node: from the
    final sweep's sums -> (B, 3, Sp) rows [split, gcnt, resid]; resid is
    +inf below 3 ground points."""
    if not _on_card(sf, nstats, flags, tables):
        return split_decision_plain(sf, nstats, flags, tables)
    _f32(sf, nstats, flags, tables)
    b, r, sp = sf.shape
    out = torch.empty((b, 3, sp), dtype=torch.float32, device=sf.device)
    _launch("level", "pw_split_decision", sf, nstats, flags, tables, out, b,
            sp, r)
    return out


def finish_nodes_plain(state, flags, sd, trash):
    seg, act = _live(state, trash)
    fit_pt = torch.gather(flags[:, 2], 1, seg) > 0.5
    split_pt = torch.gather(sd[:, 0], 1, seg) < 0.5
    fin2 = (act > 0.5) & fit_pt & split_pt
    state[:, 1] = torch.maximum(state[:, 1], fin2.to(torch.float32))


def finish_nodes(state: torch.Tensor, flags: torch.Tensor, sd: torch.Tensor,
                 trash: int) -> None:
    """Phase 7 (fit_pallas.py:1441-1458): points of fitted nodes that do
    not split are done (state row 1, in place)."""
    if not _on_card(state, flags, sd):
        return finish_nodes_plain(state, flags, sd, trash)
    _f32(state, flags, sd)
    b, _, n = state.shape
    _launch("level", "pw_finish_nodes", state, flags, sd, b, n,
            flags.shape[2], trash)


# ---------------------------------------------------------------------------
# fit_level  (fit_pallas.py:523-560 fit_level_megakernel -> _mega_kernel):
# one level's whole fit loop in one launch, for the generic level engine
# ---------------------------------------------------------------------------

def fit_pack(xyz: torch.Tensor, tau_pt: torch.Tensor, amask: torch.Tensor,
             seg: torch.Tensor) -> torch.Tensor:
    """The fit layout (fit_pallas.py:70-86): xyz (B, 3, N), tau (B, N),
    apply-mask (B, N) bool, seg (B, N) -> (B, 8, N) rows [x, y, z, tau,
    amask, seg (exact as f32), 0, 0]."""
    rows = [tau_pt.to(torch.float32), amask.to(torch.float32),
            seg.to(torch.float32)]
    zero = torch.zeros_like(rows[0])
    return torch.cat([xyz.to(torch.float32),
                      torch.stack(rows + [zero, zero], 1)], 1).contiguous()


def megakernel_fits(n_padded: int, sp: int) -> bool:
    """The JAX package's VMEM gate (fit_pallas.py:516-520), carried over
    verbatim: it is the port's path choice, so the port takes the JAX
    package's path at every N and the two can be held against each other
    path by path.  In exact mode it changes no result (every path adds in
    the sweeps' order); fast mode is honoured only by the level path and
    :func:`fit_level`."""
    point_bytes = (8 + 3) * 4 * n_padded          # packed rows + in/out masks
    onehot_bytes = 2 * sp * 4096 * 2              # (Sp, T) bf16, double-ish
    return point_bytes + onehot_bytes + 64 * sp * 4 < 10 * 1024 * 1024


def _fit_sweep_plain(p, g, tab, sp, fast):
    x, y, z, tau, am = p[:, 0], p[:, 1], p[:, 2], p[:, 3], p[:, 4]
    seg = p[:, 5].to(torch.int64)
    gat = _gather_rows(tab, seg)
    dx, dy, dz = x - gat[:, 0], y - gat[:, 1], z - gat[:, 2]
    dist = torch.abs(dx * gat[:, 3] + dy * gat[:, 4] + dz * gat[:, 5])
    apply_m = am * gat[:, 6]
    new_g = (dist < tau).to(torch.float32)
    g2 = apply_m * new_g + (1.0 - apply_m) * g
    xg, yg, zg = x * g2, y * g2, z * g2
    rows = [g2, xg, yg, zg, dist * g, apply_m * torch.abs(new_g - g)]
    if fast:
        rows += [x * xg, y * xg, z * xg, y * yg, z * yg, z * zg]
    return g2, _tile_sums(torch.stack(rows, 1), seg, sp)


def _fit_table_plain(p, g, m1, sp, fast, with_can):
    gcnt = m1[:, 0]
    c = m1[:, 1:4] / torch.clamp(gcnt[:, None], min=1.0)
    if fast:
        m2 = _centered_m2(m1)
    else:
        cg = _gather_rows(c, p[:, 5].to(torch.int64))
        dx = (p[:, 0] - cg[:, 0]) * g
        dy = (p[:, 1] - cg[:, 1]) * g
        dz = (p[:, 2] - cg[:, 2]) * g
        m2 = _tile_sums(torch.stack([dx * dx, dx * dy, dx * dz, dy * dy,
                                     dy * dz, dz * dz], 1),
                        p[:, 5].to(torch.int64), sp)
    vx, vy, vz = _normal_rows(m2, gcnt)
    can = ((gcnt >= 3.0) & with_can).to(torch.float32)
    return torch.stack([c[:, 0], c[:, 1], c[:, 2], vx, vy, vz, can], 1)


def fit_level_plain(p, g0, num_segs, max_iter, fast):
    b, _, n = p.shape
    sp = sp_width(num_segs)
    g, m1 = _fit_sweep_plain(p, g0[:, 0], p.new_zeros(b, 7, sp), sp, fast)
    changed = True
    for _ in range(max_iter):
        g, m1 = _fit_sweep_plain(p, g, _fit_table_plain(p, g, m1, sp, fast,
                                                        True), sp, fast)
        changed = bool((m1[:, 5] > 0.0).any())
        if not changed:
            break
    if changed:
        g, m1 = _fit_sweep_plain(p, g, _fit_table_plain(p, g, m1, sp, fast,
                                                        False), sp, fast)
    return g[:, None], torch.cat([m1[:, :6], p.new_zeros(b, 2, sp)], 1)


def fit_level(p: torch.Tensor, g0: torch.Tensor, num_segs: int,
              max_iter: int, fast: bool = False):
    """One level's complete fit loop (``_mega_kernel``) in one launch.

    p (B, 8, N) fit layout (:func:`fit_pack`), N a multiple of TILE; g0
    (B, 1, N) seeded 0/1 mask.  Returns (g (B, 1, N) converged mask,
    stats (B, 8, Sp) rows [cnt, sx, sy, sz, distsum (old mask), changed, 0,
    0] of the final fit).  ``fast`` accumulates raw second moments in the
    apply sweep (one sweep per iteration; expects patch-center-shifted
    coordinates).

    CUDA: one block per scan loops on the device until its mask stops
    changing or max_iter, so each scan converges on its own and the level's
    fit is one launch.  Per-node sums, moments and plane table live in
    shared memory; sums keep the sweeps' order, so the kernel equals its
    plain version (and the level path's fit) bit for bit.  Bound by one
    block per scan: at small B most SMs idle.
    """
    if not _on_card(p, g0):
        return fit_level_plain(p, g0, num_segs, max_iter, fast)
    _check_points(p)
    _f32(g0)
    b, _, n = p.shape
    if g0.shape != (b, 1, n):
        raise ValueError(f"g0 must be ({b}, 1, {n}), got {tuple(g0.shape)}")
    sp = sp_width(num_segs)
    g = torch.empty_like(g0)
    stats = torch.empty((b, 8, sp), dtype=torch.float32, device=p.device)
    _launch("fit_level", "pw_fit_level", p, g0, g, stats, b, n, sp,
            int(max_iter), int(fast))
    return g, stats


# The plain versions under the wrappers' names: what the engine calls to
# run the level with no kernel on any device.
plain = types.SimpleNamespace(
    seg_order_stat=seg_order_stat_plain, seg_sum=seg_sum_plain,
    apply_sweep=apply_sweep_plain, moments2_sweep=moments2_sweep_plain,
    remap_r1=remap_r1_plain, remap_r1b=remap_r1b_plain,
    remap_nodes=remap_nodes_plain, remap_points=remap_points_plain,
    node_stats=node_stats_plain, early_outs=early_outs_plain,
    deficient_round=deficient_round_plain, seed_init=seed_init_plain,
    plane_table=plane_table_plain, split_decision=split_decision_plain,
    finish_nodes=finish_nodes_plain, fit_level=fit_level_plain,
)
