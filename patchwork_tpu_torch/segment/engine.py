"""The Recursive Patchwork engine on PyTorch, driven level by level.

Port of the main path of ``patchwork_tpu/segment/engine.py``: binning, the
fast-mode patch-center shift (engine.py:579-604) and ``_fused_levels``
(engine.py:207-315), with its ``pack``/``tables`` row contracts and its
level loop.  Each level runs :func:`level`, the port of the TPU's
``level_megakernel`` (kernels/fit_pallas.py:1465-1558): a short sequence
of CUDA kernels driven from Python on a CUDA tensor, or the same sequence
of their plain versions (:func:`level_reference`) on a CPU tensor.

The batch is a real dimension: every kernel's grid carries the scan.  Each
scan converges on its own: the fit loop shares one iteration counter and
stops when no scan changed, and a converged scan re-fits idempotently
(same mask -> same plane -> same mask, bit for bit), so every scan gets
exactly its solo result.  The host reads one flag per fit iteration and
one per level.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import PatchworkConfig
from ..core.types import GroundResult
from ..kernels import fit_cuda
from ..kernels.fit_cuda import TILE, sp_width
from .binning import assign_patches

__all__ = ["level", "level_reference", "filter_ground",
           "filter_ground_batched"]

_F32 = np.float32


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
    """
    b, _, n = pts.shape
    sp = tables.shape[2]
    trash = num_segs - 1
    state = torch.empty((b, 4, n), dtype=torch.float32, device=pts.device)
    state[:, 0:2] = pts[:, 4:6]
    state[:, 2] = 0.0

    # ---- phase 0: split execution of the parent level (cpp:237-304) ----
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
        # R2: exact per-parent median sorted[cnt // 2] (cpp:253-269)
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

    # ---- phase 1: per-node stats; 1b: percentile seeds (cpp:156-159) ----
    nstats = k.node_stats(pts, state, zth_row if adaptive else None, trash, sp)
    if not adaptive:
        seg_i = state[:, 3].to(torch.int32).contiguous()
        k_seed = torch.floor(_f32(seed_percentile) * nstats[:, 0])
        zstat = k.seg_order_stat(pts[:, 2].contiguous(), seg_i,
                                 (state[:, 3] < trash).contiguous(),
                                 k_seed.to(torch.int32), sp)
        zth_row = zstat + _f32(th_seeds)
        seeded = k.node_stats(pts, state, zth_row, trash, sp)
        nstats = torch.cat([nstats[:, 0:1], seeded[:, 1:2], nstats[:, 2:]], 1)

    # ---- phase 2: early-outs; 3: deficient "3 lowest-z" fallback --------
    flags, any_def = k.early_outs(nstats, tables, zth_row, is_level0,
                                  flat_area, flat_dz, flat_minpts, min_seed)
    for _ in range(min_seed):
        k.deficient_round(pts, state, flags, any_def, trash)

    # ---- phase 4+5: seed init fused with the first sweep; fit loop ------
    fit_row = flags[:, 2].contiguous()

    def make_tab(m1, with_can):
        c = (m1[:, 1:4] / torch.clamp(m1[:, 0:1], min=1.0)).contiguous()
        m2 = None if fast else k.moments2_sweep(pts, state, c, trash)
        return k.plane_table(m1.contiguous(), c, m2,
                             fit_row if with_can else None, tau_row, fast)

    m1 = k.seed_init(pts, state, flags, trash, fast)
    for _ in range(max_iter):
        m1 = k.apply_sweep(pts, state, make_tab(m1, True), trash, fast)
        if not bool((m1[:, 5] > 0.0).any()):
            break

    # ---- phase 6: final fit, residual, split; 7: finish non-split -------
    sf = k.apply_sweep(pts, state, make_tab(m1, False), trash, fast)
    sd = k.split_decision(sf, nstats, flags, tables)
    k.finish_nodes(state, flags, sd, trash)
    stats = torch.stack([sd[:, 0], sd[:, 1], sd[:, 2], nstats[:, 0],
                         nstats[:, 1], tau_row, zth_row,
                         torch.zeros_like(tau_row)], 1)
    return state, stats


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
    idx_row = torch.arange(n + n_pad, dtype=torch.float32, device=dev)
    xyz_t = torch.nn.functional.pad(xyz.permute(0, 2, 1), (0, n_pad))

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

    # ---- level 0: node id == patch id ----
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
    lvl = 1
    while lvl < eff_levels and bool((split_row > 0.5).any()):
        seg_live = torch.where(done, torch.full_like(seg, trash_d), seg)
        state, stats = run_level(
            pack(seg_live, ground, done, cap_a),
            tables(tau_row, zth_row, spd, cap_a + 1, lvl, split_row),
            cap_a + 1, False, True)
        lvl += 1
        seg = state[:, 3, :n]
        done = state[:, 1, :n] > 0.5
        ground = state[:, 0, :n] > 0.5
        split_row, tau_row, zth_row = stats[:, 0], stats[:, 5], stats[:, 6]
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


def filter_ground_batched(xyz: torch.Tensor, valid: torch.Tensor,
                          cfg: PatchworkConfig,
                          plain: bool = False) -> GroundResult:
    """Segment (B, N, 3) float32 scans with (B, N) bool validity.

    Runs on the device the tensors are on: the CUDA kernels on a CUDA
    tensor, their plain versions on a CPU tensor.  ``plain=True`` runs the
    plain versions on any device (the reference the kernels are held to).
    """
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"xyz must be (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    if valid.shape != xyz.shape[:2] or valid.dtype != torch.bool:
        raise ValueError("valid must be (B, N) bool")
    pa = assign_patches(xyz, valid, cfg, plain=plain)
    xyz = torch.where(pa.finite[..., None], xyz, torch.zeros_like(xyz))
    if cfg.fast_covariance:
        xyz = _shift_to_patch_centers(cfg, xyz, pa)
    tau_patch = _f32(cfg.th_dist) * (1.0 + _f32(cfg.tau_slope) * pa.rel_dist)
    zth_patch = _f32(cfg.sensor_height) + _f32(cfg.seed_slope) * pa.rel_dist
    run = level_reference if plain else level
    ground = _fused_levels(cfg, xyz, pa, tau_patch.contiguous(),
                           zth_patch.contiguous(), run)
    return GroundResult(ground=ground & pa.in_patch, valid=pa.finite,
                        in_zone=pa.in_zone, in_patch=pa.in_patch)


def filter_ground(xyz: torch.Tensor, valid: torch.Tensor, cfg: PatchworkConfig,
                  plain: bool = False) -> GroundResult:
    """Segment one (N, 3) scan; masks of shape (N,)."""
    res = filter_ground_batched(xyz[None], valid[None], cfg, plain=plain)
    return GroundResult(ground=res.ground[0], valid=res.valid[0],
                        in_zone=res.in_zone[0], in_patch=res.in_patch[0])
