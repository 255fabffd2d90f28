"""The Recursive Patchwork engine on PyTorch.

Port of ``patchwork_tpu/segment/engine.py``: binning, the fast-mode
patch-center shift (engine.py:579-604) and two level engines, chosen as the
JAX package chooses them (engine.py:568-625):

* the level path, ``_fused_levels`` (engine.py:207-315), with its
  ``pack``/``tables`` row contracts and its level loop.  Each level runs
  :func:`level`, the port of the TPU's ``level_megakernel``
  (kernels/fit_pallas.py:1465-1558): on a CUDA tensor one co-operative
  launch (``fit_cuda.level_core``) after a remap level's per-parent sums
  and medians, on a CPU tensor the same phases through their plain
  versions (:func:`level_reference`).  ``segment_impl="fused"`` (the
  default) takes it while the path gate admits the scan;
* the generic path, ``_level_body`` / ``_child_remap`` and the generic
  branch of ``filter_ground`` (engine.py:318-664), built on segment ops
  (segops.SegOps).  ``"scatter"``, ``"onehot"`` and ``"pallas"`` take it,
  and so does ``"fused"`` above the path gate (``_fused_fit_resid``).

Two gates, two questions.  *Level path or generic path* is :func:`_gate`,
the JAX package's ``megakernel_fits``, so both packages take the same path
at every N and are held against each other path by path; in exact mode it
changes no bit.  *One launch or a loop of sweeps, inside a fit* is the
card's own gate, ``fit_cuda.fit_level_fits``: the shared memory of the
one-launch kernel at this table width against what the card grants a
block.  Below it a level is one co-operative launch on the level path
(``fit_cuda.level_core``, the fit and the phases around it) and a level's
fit loop one on the generic path (``fit_cuda.fit_level``, at every N);
above it (a table some 2700 nodes wide on an H100, reached only through a
large ``max_active_nodes_cfg``) a level path's phases run one by one
(``fit_cuda.level_sequence``) and the fit is ``fit_cuda.fit_sweep_loop``,
a loop of apply and moments2 sweeps that takes any width.
``megakernel_fits`` has no say in that.

The batch is a real dimension: every kernel's grid carries the scan.  Each
scan converges on its own: the loops that JAX runs under ``vmap`` share one
counter and stop when no scan changed, which is correct because a converged
scan re-fits idempotently (same mask -> same plane -> same mask, bit for
bit) and a scan with no split passes a deeper level unchanged, so every
scan gets exactly its solo result.  Inside a one-launch fit each scan
leaves the loop on its own and the host reads nothing; the loop of sweeps
reads one flag per iteration.  The host reads one flag per level.

Inside a caller's span (``core.timing``; the node's "engine") the engine
opens its own: "engine.binning", one "engine.level" a level with its
"engine.level.remap", "engine.level.seeds" and "engine.level.fit", and an
"engine.read" at every place the host waits for the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import timing
from ..core.config import PatchworkConfig
from ..core.types import GroundResult
from ..kernels import fit_cuda
from ..kernels.fit_cuda import TILE, sp_width
from .binning import assign_patches
from .segops import IMPLS, Ranks, SegOps, default_impl

__all__ = ["level", "level_reference", "filter_ground",
           "filter_ground_batched", "make_filter_ground",
           "make_filter_ground_batched"]

_F32 = np.float32
_BIG = 3.0e38   # finite sentinel of the deficient loop (engine.py:420)


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float: a tensor op with it
    computes in float32 exactly as the JAX reference's ``_F32(v)`` does."""
    return float(np.float32(v))


def _level(pts, tables, num_segs, max_iter, is_level0, min_seed, flat_area,
           flat_dz, flat_minpts, fast, adaptive, seed_percentile, th_seeds,
           remap, k):
    """One engine level over a batch (``_level_kernel``,
    fit_pallas.py:789-1462); ``k`` holds the kernels or their plain
    versions under the same names.

    pts (B, 8, N) rows [x, y, z, seg, ground, done, index, 0] (seg is the
    PARENT id on remap levels); tables (B, 8, Sp) rows [tau, zth, real,
    split_thresh, min_split_size, depth_ok, parent_split, 0].  Returns
    state (B, 4, N) rows [ground, done, chosen, seg_out] and stats
    (B, 8, Sp) rows [split, gcnt, resid, cnt, seed_cnt, tau_out, zth_out, 0].

    Ahead of the level, a remap level's per-parent sums (R1, R1b), split
    axis and medians (R2); for percentile seeds also R3-R5, node stats and
    the order statistic of the seed heights.  The rest is ``k.level_core``,
    one launch on the card, where the card's gate admits the table width,
    else ``fit_cuda.level_sequence`` (the phases one by one around the loop
    of sweeps).
    """
    b, _, n = pts.shape
    sp = tables.shape[2]
    trash = num_segs - 1
    state = torch.empty((b, 4, n), dtype=torch.float32, device=pts.device)
    state[:, 0:2] = pts[:, 4:6]
    state[:, 2] = 0.0
    if not remap:
        state[:, 3] = pts[:, 3]

    # ---- phase 0: split execution of the parent level (cpp:237-304) ----
    split = None
    if remap:
        with timing.span("engine.level.remap"):
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
            # R2: exact per-parent median sorted[cnt // 2] (cpp:253-269)
            pseg = pts[:, 3]
            ps = pseg.to(torch.int64)
            ax = torch.gather(axis_x, 1, ps)
            vals = ax * pts[:, 0] + (1.0 - ax) * pts[:, 1]
            k_med = torch.floor(pcnt * 0.5).to(torch.int32)
            median = k.seg_order_stat(vals, ps.to(torch.int32).contiguous(),
                                      (pseg < trash).contiguous(), k_med, sp)
            split = (median, axis_x)

    # ---- phase 1b: percentile seeds (cpp:156-159), ahead of the level ----
    tz = nstats = None
    if not adaptive:
        with timing.span("engine.level.seeds"):
            tau_row = tables[:, 0]
            if split is not None:
                pnode, tz = k.remap_nodes(tables, *split, trash)
                k.remap_points(pts, state, pnode, trash)
                tau_row, split = tz[:, 0], None
            nstats = k.node_stats(pts, state, None, trash, sp)
            seg_i = state[:, 3].to(torch.int32).contiguous()
            k_seed = torch.floor(_f32(seed_percentile) * nstats[:, 0])
            zstat = k.seg_order_stat(pts[:, 2].contiguous(), seg_i,
                                     (state[:, 3] < trash).contiguous(),
                                     k_seed.to(torch.int32), sp)
            zth_row = zstat + _f32(th_seeds)
            seeded = k.node_stats(pts, state, zth_row, trash, sp)
            nstats = torch.cat([nstats[:, 0:1], seeded[:, 1:2],
                                nstats[:, 2:]], 1)
            tz = torch.stack([tau_row, zth_row], 1)

    # ---- R3-R5, stats, early-outs, deficient, seeds, fit, split, finish --
    args = (pts, state, tables, trash, max_iter, is_level0, min_seed,
            flat_area, flat_dz, flat_minpts, fast, split, tz, nstats)
    with timing.span("engine.level.fit"):
        if fit_cuda.fit_level_fits(sp, fast, pts.device, level=True):
            return state, k.level_core(*args)
        return state, fit_cuda.level_sequence(k, *args)


def level(pts: torch.Tensor, tables: torch.Tensor, num_segs: int,
          max_iter: int, is_level0: bool, min_seed: int, flat_area: float,
          flat_dz: float, flat_minpts: int, fast: bool = False,
          adaptive: bool = True, seed_percentile: float = 0.1,
          th_seeds: float = 0.15, remap: bool = False):
    """One engine level: the CUDA kernels on a CUDA tensor, their plain
    versions on a CPU tensor.  Arguments as ``level_megakernel``; pts and
    tables carry a leading batch dimension, N is a multiple of TILE."""
    return _level(pts, tables, num_segs, max_iter, is_level0, min_seed,
                  flat_area, flat_dz, flat_minpts, fast, adaptive,
                  seed_percentile, th_seeds, remap, fit_cuda)


def level_reference(pts: torch.Tensor, tables: torch.Tensor, num_segs: int,
                    max_iter: int, is_level0: bool, min_seed: int,
                    flat_area: float, flat_dz: float, flat_minpts: int,
                    fast: bool = False, adaptive: bool = True,
                    seed_percentile: float = 0.1, th_seeds: float = 0.15,
                    remap: bool = False):
    """The plain PyTorch version of :func:`level` on any device: the same
    phases through the kernels' plain versions (``fit_cuda.plain``)."""
    return _level(pts, tables, num_segs, max_iter, is_level0, min_seed,
                  flat_area, flat_dz, flat_minpts, fast, adaptive,
                  seed_percentile, th_seeds, remap, fit_cuda.plain)


def _fused_levels(cfg, xyz, pa, tau_patch, zth_patch, run):
    """All levels (engine.py:207-315); returns the (B, N) ground mask."""
    b, n, _ = xyz.shape
    dev = xyz.device
    n_pad = (-n) % TILE
    num_p = cfg.num_patches
    cap_a = max(cfg.max_active_nodes, num_p)
    eff_levels = cfg.effective_levels

    def pack(seg, ground, done, trash):
        pad = torch.nn.functional.pad
        rows = [pad(seg, (0, n_pad), value=float(trash)),
                pad(ground.to(torch.float32), (0, n_pad)),
                pad(done.to(torch.float32), (0, n_pad), value=1.0),
                idx_row.expand(b, -1), torch.zeros_like(idx_row).expand(b, -1)]
        return torch.cat([xyz_t, torch.stack(rows, 1)], 1).contiguous()

    def tables(tau_row, zth_row, sp, num_segs, lvl, split_row):
        real = (torch.arange(sp, device=dev) < num_segs - 1).to(torch.float32)
        thresh = _F32(cfg.th_dist) * (
            _F32(1.0) + _F32(cfg.split_residual_slope) * _F32(lvl))
        min_sz = (_F32(cfg.split_min_points_base)
                  + _F32(cfg.split_min_points_slope) * _F32(lvl))
        depth_ok = float(lvl < min(cfg.max_split_depth, eff_levels - 1))

        def full(v):
            return torch.full((b, sp), float(v), dtype=torch.float32,
                              device=dev)

        return torch.stack([tau_row, zth_row, real.expand(b, -1), full(thresh),
                            full(min_sz), full(depth_ok), split_row,
                            full(0.0)], 1).contiguous()

    def run_level(pts, tabs, num_segs, lvl0, remap):
        return run(pts, tabs, num_segs, cfg.max_iter, lvl0,
                   cfg.min_seed_points, cfg.flat_area_m2, cfg.flat_dz,
                   cfg.flat_min_points, fast=cfg.fast_covariance,
                   adaptive=cfg.adaptive_seed_height,
                   seed_percentile=cfg.seed_percentile, th_seeds=cfg.th_seeds,
                   remap=remap)

    def padded(v, sp):
        return torch.nn.functional.pad(v, (0, sp - v.shape[1]))

    # ---- level 0: node id == patch id; a level's span holds its inputs'
    # layout and its outputs' unpacking ----
    with timing.span("engine.level"):
        idx_row = torch.arange(n + n_pad, dtype=torch.float32, device=dev)
        xyz_t = torch.nn.functional.pad(xyz.permute(0, 2, 1), (0, n_pad))
        sp0 = sp_width(num_p + 1)
        seg0 = torch.where(pa.in_patch, pa.patch.to(torch.float32),
                           torch.full_like(xyz[..., 0], float(num_p)))
        state, stats = run_level(
            pack(seg0, torch.zeros_like(pa.in_patch), ~pa.in_patch, num_p),
            tables(padded(tau_patch, sp0), padded(zth_patch, sp0), sp0,
                   num_p + 1, 0, torch.zeros((b, sp0), device=dev)),
            num_p + 1, True, False)
        ground = state[:, 0, :n] > 0.5
        done = state[:, 1, :n] > 0.5
        if eff_levels <= 1:
            return ground

        # ---- deeper levels: compact child-slot space, trash = cap_a ----
        spd = sp_width(cap_a + 1)
        trash_d = float(cap_a)
        seg = state[:, 3, :n]
        seg = torch.where(seg >= num_p, torch.full_like(seg, trash_d), seg)
        split_row = padded(stats[:, 0], spd)
        tau_row = padded(stats[:, 5], spd)
        zth_row = padded(stats[:, 6], spd)
        more = (split_row > 0.5).any()      # a level's last output
    lvl = 1
    while lvl < eff_levels and timing.read(more):
        with timing.span("engine.level"):
            seg_live = torch.where(done, torch.full_like(seg, trash_d), seg)
            state, stats = run_level(
                pack(seg_live, ground, done, cap_a),
                tables(tau_row, zth_row, spd, cap_a + 1, lvl, split_row),
                cap_a + 1, False, True)
            lvl += 1
            seg = state[:, 3, :n]
            done = state[:, 1, :n] > 0.5
            ground = state[:, 0, :n] > 0.5
            split_row, tau_row = stats[:, 0], stats[:, 5]
            zth_row = stats[:, 6]
            if lvl < eff_levels:
                more = (split_row > 0.5).any()
    return ground


def _shift_to_patch_centers(cfg, xyz, pa):
    """Fast mode (engine.py:593-604): move every point by its base patch's
    polar center; per-node computations are invariant under it, and the
    bounded coordinates make the raw-moment covariance safe."""
    ring = (pa.patch // cfg.num_sectors).to(torch.float32)
    sec = (pa.patch % cfg.num_sectors).to(torch.float32)
    ln_r = math.log(cfg.filtering_radius / cfg.r_min) / cfg.num_rings
    r_c = _f32(0.5 * cfg.r_min * (1.0 + math.exp(ln_r))) * torch.exp(
        ring * _f32(ln_r))
    a_c = (sec + 0.5) * _f32(2.0 * math.pi / cfg.num_sectors)
    w = pa.in_patch.to(torch.float32) * r_c
    shift = torch.stack([w * torch.cos(a_c), w * torch.sin(a_c),
                         torch.zeros_like(w)], -1)
    return xyz - shift


# ---------------------------------------------------------------------------
# the generic level engine (engine.py:65-204, 318-556, 627-664)
# ---------------------------------------------------------------------------

def _gate(n: int, sp: int) -> bool:
    """The path gate, level path or generic path: ``megakernel_fits`` on
    the point count padded as the JAX package pads it (to 128), so both
    packages take the same path at every N."""
    return fit_cuda.megakernel_fits(n + (-n) % 128, sp)


def _cov_normal(m2: torch.Tensor, gcnt: torch.Tensor) -> torch.Tensor:
    """(B, 6, S) centered second-moment sums -> (B, 3, S) plane normals
    flipped to +Z (engine.py:65-82): the eigensolve of ops.geometry in the
    row form the kernels' plane table computes, so every path gets the same
    bits from the same sums."""
    return torch.stack(fit_cuda._normal_rows(m2, gcnt), 1)


def _plane_dist(ops: SegOps, ranks: Ranks, xyz: torch.Tensor,
                g: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """Each point's distance to its own node's plane (engine.py:85-108),
    from the mask ``g`` (B, N) float and its sums ``m1`` (B, 4, S) rows
    [gcnt, Σx, Σy, Σz]: the centered products' pass, then the plane."""
    gcnt = m1[:, 0]
    d_all = xyz - ops.gather(m1[:, 1:4] / torch.clamp(gcnt[:, None], min=1.0))
    d = d_all * g[:, None]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    m2 = ranks.sum(ops.sum(torch.stack([dx * dx, dx * dy, dx * dz, dy * dy,
                                        dy * dz, dz * dz], 1)))
    n_pt = ops.gather(_cov_normal(m2, gcnt))
    # the sweeps' expression, so every path computes the same bits
    return torch.abs(d_all[:, 0] * n_pt[:, 0] + d_all[:, 1] * n_pt[:, 1]
                     + d_all[:, 2] * n_pt[:, 2])


def _fit_rows(g: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """The rows [g, x g, y g, z g] of a mask's first sums."""
    return torch.cat([g[:, None], xyz * g[:, None]], 1)


def _generic_fit(cfg, ops, ranks, xyz, ground, active, fit_pt, tau_pt,
                 resid):
    """The batched iterative plane fit (cpp:186-217; the generic ``_body``
    of engine.py:449-465) and, with ``resid``, the final fit's residual
    (cpp:219-228).  Returns (ground, resid (B, S) or None).

    Each iteration's changed points ride as one more row of the next
    iteration's first sums, so an iteration reduces twice, and the sums of
    the last mask are those of the final fit; the loop ends when that row
    sums to 0 or at ``max_iter``, as the JAX while-loop."""
    g = (ground & active).to(torch.float32)
    m1 = ranks.sum(ops.sum(_fit_rows(g, xyz)))
    for _ in range(cfg.max_iter):
        dist = _plane_dist(ops, ranks, xyz, g, m1)
        can_pt = ops.gather((m1[:, 0] >= 3.0).to(torch.float32)) > 0.5
        new_g = dist < tau_pt
        apply_pt = active & fit_pt & can_pt
        changed = (apply_pt & (new_g != ground)).to(torch.float32)
        ground = torch.where(apply_pt, new_g, ground)
        g = (ground & active).to(torch.float32)
        m1c = ranks.sum(ops.sum(torch.cat([changed[:, None],
                                           _fit_rows(g, xyz)], 1)))
        m1 = m1c[:, 1:]
        if not timing.read((m1c[:, 0] > 0.0).any()):
            break
    if not resid:
        return ground, None
    gcnt = m1[:, 0]
    dist = _plane_dist(ops, ranks, xyz, g, m1)
    r = ranks.sum(ops.sum(dist * g)) / torch.clamp(gcnt, min=1.0)
    return ground, torch.where(gcnt >= 3.0, r, torch.full_like(r, math.inf))


def _pad_sp(v: torch.Tensor, sp: int) -> torch.Tensor:
    return torch.nn.functional.pad(v, (0, sp - v.shape[1])).contiguous()


def _fused_fit_resid(cfg, xyz, seg, tau_pt, active, fit_pt, ground, tau_node,
                     fit_node, num_segs, plain):
    """The fit loop and final residual of one level under ``"fused"``
    (engine.py:111-204): one :func:`fit_cuda.fit_level` launch where the
    card's gate (``fit_cuda.fit_level_fits``) admits the table width, at
    every N, else a loop of the level path's sweeps.

    The loop of sweeps maps the fit layout onto the level sweeps' rows:
    points outside the apply-mask park on the trash id (so ``live`` is the
    apply-mask) and the table carries can = fit_node * (gcnt >= 3) and tau
    per node.  The sums of fitted nodes are those of the fit layout; other
    nodes' sums are not read.  The loop is exact two-pass in both modes, as
    the JAX package's fallback is; only ``fit_level`` honours fast mode.

    Returns (ground (B, N) bool, gcnt (B, S), resid (B, S) with +inf below
    3 ground points).
    """
    k = fit_cuda.plain if plain else fit_cuda
    b, _, n = xyz.shape
    sp = sp_width(num_segs)
    trash = num_segs - 1
    amask = active & fit_pt
    n_pad = (-n) % TILE

    def pad(v, value=0.0):
        return torch.nn.functional.pad(v, (0, n_pad), value=value)

    p = pad(fit_cuda.fit_pack(xyz, tau_pt, amask, seg)).contiguous()
    g0 = pad(ground.to(torch.float32))
    if fit_cuda.fit_level_fits(sp, cfg.fast_covariance, xyz.device):
        g, sf = k.fit_level(p, g0[:, None].contiguous(), num_segs,
                            cfg.max_iter, fast=cfg.fast_covariance)
        g = g[:, 0]
    else:
        seg_fit = pad(torch.where(amask, seg, trash).to(torch.float32),
                      float(trash))
        zero = torch.zeros_like(g0)
        state = torch.stack([g0, zero, zero, seg_fit], 1)
        plan = k.sweep_plan(state, sp)
        m1 = k.apply_sweep(p, state, p.new_zeros(b, 8, sp), trash, False,
                           plan)
        sf = fit_cuda.fit_sweep_loop(
            k, p, state, m1, _pad_sp(fit_node.to(torch.float32), sp),
            _pad_sp(tau_node, sp), trash, cfg.max_iter, False, plan)
        g = state[:, 0]
    gcnt = sf[:, 0, :num_segs]
    resid = sf[:, 4, :num_segs] / torch.clamp(gcnt, min=1.0)
    resid = torch.where(gcnt >= 3.0, resid, torch.full_like(resid, math.inf))
    return g[:, :n] > 0.5, gcnt, resid


def _ops_impl(impl: str) -> str:
    # "fused" takes the kernel segment ops: the Hopper counterpart of the
    # TPU's "onehot" choice at engine.py:341 / :510
    return "pallas" if impl == "fused" else impl


def _level_body(cfg, impl, xyz, pa, tau_patch, zth_patch, lvl, num_segs,
                is_level0, node, node_patch, done, ground, plain, ranks):
    """Stats -> early-outs -> seeds -> iterative fit -> split flags for one
    level of every active node (engine.py:318-490); split execution is
    :func:`_child_remap`.  xyz (B, 3, N); node (B, N) int64; node_patch
    (B, S) or None at level 0.  Every per-node statistic is this process's
    partial reduced through ``ranks`` (segops.Ranks).  Returns (done,
    ground, split (B, S) bool).
    """
    b, _, n = xyz.shape
    z = xyz[:, 2]
    dev = xyz.device
    trash = num_segs - 1
    if is_level0:
        node_patch = torch.arange(num_segs, device=dev).expand(b, -1)
    tau_node = torch.gather(tau_patch, 1, node_patch)
    zth_node = torch.gather(zth_patch, 1, node_patch)

    active = pa.in_patch & ~done
    seg = torch.where(active, node, trash)
    ops = SegOps(seg, num_segs, _ops_impl(impl), plain=plain)
    real = torch.arange(num_segs, device=dev) < trash
    mins, maxs = ranks.bbox(*ops.bbox(xyz, active))

    def early_outs(cnt, seed_cnt):
        return fit_cuda.early_out_masks(
            cnt.to(torch.float32), seed_cnt.to(torch.float32), mins, maxs,
            real, is_level0, _f32(cfg.flat_area_m2), _f32(cfg.flat_dz),
            cfg.flat_min_points, cfg.min_seed_points)

    with timing.span("engine.level.seeds"):
        # ---- stats + seed candidates ----
        if cfg.adaptive_seed_height:
            tg = ops.gather(torch.stack([zth_node, tau_node], 1))
            zth_pt, tau_pt = tg[:, 0], tg[:, 1]
            seed = active & (z < zth_pt)
            cnts = ranks.sum(ops.sum(torch.stack(
                [active.to(torch.float32), seed.to(torch.float32)], 1)))
            cnt_i = cnts[:, 0].to(torch.int32)
            seed_cnt = cnts[:, 1].to(torch.int32)
        else:
            cnt_i = ranks.sum(ops.count(active))
            k10 = (_f32(cfg.seed_percentile) * cnt_i.to(torch.float32)).to(
                torch.int32)
            # across processes only fitting nodes are histogrammed (fit
            # needs no seed count); one process takes the sort and reads no
            # mask
            need = early_outs(cnt_i, cnt_i)[2] if ranks.across else None
            z_th = ranks.order_stat(seg, z, active, k10, num_segs, need,
                                    "percentile") + _f32(cfg.th_seeds)
            tg = ops.gather(torch.stack([z_th, tau_node], 1))
            zth_pt, tau_pt = tg[:, 0], tg[:, 1]
            seed = active & (z < zth_pt)
            seed_cnt = ranks.sum(ops.count(seed))

        # ---- early-outs, in reference order (cpp:111-140) ----
        finished, label, fit_node, deficient = early_outs(cnt_i, seed_cnt)
        t1 = ops.gather(torch.stack([finished, label, fit_node, deficient],
                                    1).to(torch.float32)) > 0.5
        finished_pt, label_pt, fit_pt, deficient_pt = t1.unbind(1)

        # ---- "min_seed_points lowest-z points" of deficient nodes
        # (cpp:171-182), by (z, global index)
        if timing.read(deficient.any()):
            idx_f = float(ranks.first) + torch.arange(
                n, dtype=torch.float32, device=dev).expand(b, -1)
            chosen = torch.zeros_like(seed)
            for _ in range(cfg.min_seed_points):
                cand = active & deficient_pt & ~chosen
                m = ranks.min(ops.min(z, cand))
                m_pt = ops.gather(torch.where(torch.isfinite(m), m, _BIG))
                is_min = cand & (z == m_pt)
                mi = ranks.min(ops.min(idx_f, is_min))
                mi_pt = ops.gather(torch.where(torch.isfinite(mi), mi, _BIG))
                chosen = chosen | (is_min & (idx_f == mi_pt))
            seed = torch.where(deficient_pt, chosen, seed)
        seed = seed & active

        # ---- early-out labels; fitting nodes start from their seeds ----
        ground = torch.where(active & finished_pt, label_pt, ground)
        ground = torch.where(active & fit_pt, seed, ground)
        done = done | (active & finished_pt)

    # ---- iterative plane fitting (cpp:186-217), residual (cpp:219-228);
    # no residual where no node may split ----
    depth_ok = lvl < min(cfg.max_split_depth, cfg.effective_levels - 1)
    with timing.span("engine.level.fit"):
        if impl == "fused":
            ground, _, resid = _fused_fit_resid(
                cfg, xyz, seg, tau_pt, active, fit_pt, ground, tau_node,
                fit_node, num_segs, plain)
        else:
            ground, resid = _generic_fit(cfg, ops, ranks, xyz, ground,
                                         active, fit_pt, tau_pt, depth_ok)

    # ---- split decision (cpp:231-235) ----
    split_thresh = _F32(cfg.th_dist) * (
        _F32(1.0) + _F32(cfg.split_residual_slope) * _F32(lvl))
    min_sz = cfg.split_min_points_base + cfg.split_min_points_slope * lvl
    if depth_ok:
        split = fit_node & (resid > float(split_thresh)) & (cnt_i >= min_sz)
    else:
        split = torch.zeros_like(fit_node)
    # fitting nodes that do not split are finished with their mask
    done = done | (active & fit_pt & ~ops.gather_bool(split))
    return done, ground, split


def _child_remap(cfg, impl, xyz, pa, node, node_patch, done, split, plain,
                 ranks):
    """Execute the parent level's splits (engine.py:493-556): variance
    axis, exact per-node median, compact child slots.  ``split`` (B,
    cap_a + 1) is the parent level's split mask; the only active points are
    those of split nodes.  Sums and the median cross ``ranks``.  Returns
    (node, node_patch (B, cap_a + 1), done).
    """
    b, _, n = xyz.shape
    x, y = xyz[:, 0], xyz[:, 1]
    num_p = cfg.num_patches
    cap_a = max(cfg.max_active_nodes, num_p)
    num_segs = cap_a + 1
    trash = cap_a

    active = pa.in_patch & ~done
    seg = torch.where(active, node, trash)
    ops = SegOps(seg, num_segs, _ops_impl(impl), plain=plain)
    w = active.to(torch.float32)

    # population-variance axis about the full-node centroid (cpp:237-250);
    # the count is the first row of the centroid's sums
    sums = ranks.sum(ops.sum(torch.stack([w, x * w, y * w], 1)))
    cnt_i = sums[:, 0].to(torch.int32)
    c_pt = ops.gather(sums[:, 1:] / torch.clamp(cnt_i.to(torch.float32),
                                                min=1.0)[:, None])
    dx = (x - c_pt[:, 0]) * w
    dy = (y - c_pt[:, 1]) * w
    var = ranks.sum(ops.sum(torch.stack([dx * dx, dy * dy], 1)))
    axis_is_x = var[:, 0] > var[:, 1]

    # compact child slots; overflowing nodes keep their converged mask
    split = split[:, :num_segs]
    split_i = split.to(torch.int64)
    base_slot = 2 * (torch.cumsum(split_i, 1) - split_i)
    ok = split & (base_slot + 1 < cap_a)

    # exact per-node median: sorted[cnt // 2] (cpp:253-269); read only
    # where a node splits into its slots
    val = torch.where(ops.gather_bool(axis_is_x), x, y)
    median = ranks.order_stat(seg, val, active, cnt_i // 2, num_segs, ok,
                              "median")

    t2 = ops.gather(torch.stack([median, ok.to(torch.float32),
                                 base_slot.to(torch.float32)], 1))
    median_pt, ok_pt = t2[:, 0], t2[:, 1] > 0.5
    slot_pt = t2[:, 2].to(torch.int64)
    done = done | (active & ~ok_pt)
    go_right = (val > median_pt).to(torch.int64)   # val <= median -> left
    node = torch.where(active & ok_pt, slot_pt + go_right, node)

    # next level's node -> patch table (unused slots -> P)
    idx0 = torch.where(ok, base_slot, cap_a + 1)
    src = torch.where(ok, node_patch[:, :num_segs], num_p)
    np_next = torch.full((b, cap_a + 3), num_p, dtype=torch.int64,
                         device=xyz.device)
    np_next.scatter_(1, idx0, src)
    np_next.scatter_(1, idx0 + 1, src)
    return node, np_next[:, :cap_a + 1], done


def _generic_levels(cfg, impl, xyz, pa, tau_patch, zth_patch, plain, ranks):
    """All levels on the generic engine (engine.py:627-659) over the (B, N,
    3) points; returns the (B, N) ground mask.  Every loop bound is read
    from values reduced through ``ranks``, so every process runs the same
    levels."""
    b = xyz.shape[0]
    num_p = cfg.num_patches
    cap_a = max(cfg.max_active_nodes, num_p)
    # level 0's span holds the points' layout, as the level path's does
    with timing.span("engine.level"):
        xyz = xyz.permute(0, 2, 1).contiguous()
        node = pa.patch.to(torch.int64)
        done = ~pa.in_patch
        ground = torch.zeros_like(done)
        done, ground, split = _level_body(
            cfg, impl, xyz, pa, tau_patch, zth_patch, 0, num_p + 1, True,
            node, None, done, ground, plain, ranks)
        if cfg.effective_levels <= 1:
            return ground
        split = torch.nn.functional.pad(split, (0, cap_a - num_p))
        node_patch = torch.full((b, cap_a + 1), num_p, dtype=torch.int64,
                                device=xyz.device)
        node_patch[:, :num_p + 1] = torch.arange(num_p + 1, device=xyz.device)
        more = split.any()                  # a level's last output
    lvl = 1
    while lvl < cfg.effective_levels and timing.read(more):
        with timing.span("engine.level"):
            with timing.span("engine.level.remap"):
                node, node_patch, done = _child_remap(
                    cfg, impl, xyz, pa, node, node_patch, done, split, plain,
                    ranks)
            done, ground, split = _level_body(
                cfg, impl, xyz, pa, tau_patch, zth_patch, lvl, cap_a + 1,
                False, node, node_patch, done, ground, plain, ranks)
            lvl += 1
            if lvl < cfg.effective_levels:
                more = split.any()
    return ground


def filter_ground_batched(xyz: torch.Tensor, valid: torch.Tensor,
                          cfg: PatchworkConfig, plain: bool = False,
                          ranks: Ranks | None = None) -> GroundResult:
    """Segment (B, N, 3) float32 scans with (B, N) bool validity.

    Runs on the device the tensors are on: the CUDA kernels on a CUDA
    tensor, their plain versions on a CPU tensor.  ``plain=True`` runs the
    plain versions on any device (the reference the kernels are held to).
    ``cfg.segment_impl`` picks the engine as in the JAX package
    (engine.py:568-625): ``"fused"`` (the default, :func:`.default_impl`)
    takes the level path while the path gate (:func:`_gate`, the JAX
    package's ``megakernel_fits``) admits the scan and the generic path
    above it; inside either, a fit is one launch wherever the card's gate
    (``fit_cuda.fit_level_fits``) admits its table width; ``"scatter"``,
    ``"onehot"`` and ``"pallas"`` take the generic path.  Fast mode
    (``fast_covariance``) applies only under ``"fused"``; the others keep
    exact semantics.

    ``ranks`` (segops.Ranks): the points of each scan are split over the
    processes of its group, this one holding (B, n) of them; binning and
    the generic path run on them alone and every per-node statistic crosses
    the group (the point-sharded engine, ``parallel/sharded.py``).  It
    takes a segment impl other than ``"fused"``.
    """
    impl = cfg.segment_impl or default_impl()
    if impl not in IMPLS:
        raise ValueError(f"unknown segment impl {impl!r}")
    if ranks is None:
        ranks = Ranks()
    elif impl == "fused":
        raise ValueError("points split over processes take the generic "
                         "path: name a segment impl other than 'fused'")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"xyz must be (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    if valid.shape != xyz.shape[:2] or valid.dtype != torch.bool:
        raise ValueError("valid must be (B, N) bool")
    with timing.span("engine.binning"):
        pa = assign_patches(xyz, valid, cfg, plain=plain, ranks=ranks)
        xyz = torch.where(pa.finite[..., None], xyz, torch.zeros_like(xyz))
        if cfg.fast_covariance and impl == "fused":
            xyz = _shift_to_patch_centers(cfg, xyz, pa)
        tau_patch = _f32(cfg.th_dist) * (
            1.0 + _f32(cfg.tau_slope) * pa.rel_dist)
        zth_patch = (_f32(cfg.sensor_height)
                     + _f32(cfg.seed_slope) * pa.rel_dist)
    num_p = cfg.num_patches
    cap_a = max(cfg.max_active_nodes, num_p)
    sp_max = sp_width((cap_a if cfg.effective_levels > 1 else num_p) + 1)
    if impl == "fused" and _gate(xyz.shape[1], sp_max):
        run = level_reference if plain else level
        ground = _fused_levels(cfg, xyz, pa, tau_patch.contiguous(),
                               zth_patch.contiguous(), run)
    else:
        ground = _generic_levels(cfg, impl, xyz, pa, tau_patch, zth_patch,
                                 plain, ranks)
    return GroundResult(ground=ground & pa.in_patch, valid=pa.finite,
                        in_zone=pa.in_zone, in_patch=pa.in_patch)


def filter_ground(xyz: torch.Tensor, valid: torch.Tensor, cfg: PatchworkConfig,
                  plain: bool = False) -> GroundResult:
    """Segment one (N, 3) scan; masks of shape (N,)."""
    res = filter_ground_batched(xyz[None], valid[None], cfg, plain=plain)
    return GroundResult(ground=res.ground[0], valid=res.valid[0],
                        in_zone=res.in_zone[0], in_patch=res.in_patch[0])


def _with_impl(cfg: PatchworkConfig, impl: str | None) -> PatchworkConfig:
    return cfg if impl is None else dataclasses.replace(cfg, segment_impl=impl)


def make_filter_ground(cfg: PatchworkConfig, impl: str | None = None):
    """Single-scan engine (xyz (N, 3), valid (N,)) -> GroundResult, with
    ``impl`` (when given) in place of ``cfg.segment_impl``.  The JAX
    package's jit-compiled factory (engine.py:667); here a closure, since
    nothing is compiled per shape."""
    cfg = _with_impl(cfg, impl)

    def fn(xyz: torch.Tensor, valid: torch.Tensor) -> GroundResult:
        return filter_ground(xyz, valid, cfg)

    return fn


def make_filter_ground_batched(cfg: PatchworkConfig, impl: str | None = None):
    """Batched engine (xyz (B, N, 3), valid (B, N)) -> GroundResult, as
    :func:`make_filter_ground` (engine.py:677)."""
    cfg = _with_impl(cfg, impl)

    def fn(xyz: torch.Tensor, valid: torch.Tensor) -> GroundResult:
        return filter_ground_batched(xyz, valid, cfg)

    return fn
