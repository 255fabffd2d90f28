"""Explicit-collective engine: single-level Patchwork with points sharded.

Counterpart of ``patchwork_tpu/parallel/shardmap_engine.py``.  Points
shard over the mesh's ``sp`` axis (scans over ``dp``); every per-node
statistic is a local partial on each rank, combined by explicit
collectives over sp: :func:`.mesh.ordered_sum` for sums and counts (rank
order, so every rank holds the same bits), ``all_reduce`` MIN / MAX for
bounding boxes and both rounds of the lexicographic 3-lowest seed fallback,
which picks by (z, global point index).  What crosses between ranks is a
(B, C, nodes) block a reduction, never points.

The local partials are the port's segment ops over one ``SegOps(...,
"pallas")`` binding per rank's block of scans: on the card kernel #6 over
the binding's plan for the sums, #7 for the per-point gathers, #8 for the
bounding boxes and the fallback's minima; on the CPU their plain versions.
(The JAX package's bf16 one-hot einsums exist only for the MXU.)
Non-finite coordinates are zeroed before any sum.  The fit loop ends when
the reduced count of changed points is 0 or at ``max_iter``: one host read
an iteration, as the JAX package's ``while_loop``.

Restrictions (raised): ``effective_levels == 1`` and adaptive seeds, as in
the JAX package (shardmap_engine.py:58-62).
"""

from __future__ import annotations

import torch

from ..core.config import PatchworkConfig
from ..core.device import true_div
from ..segment.binning import bin_points
from ..segment.engine import _BIG, _cov_normal, _f32
from ..segment.segops import SegOps
from .mesh import (POINT_AXIS, all_max, all_min, axis_index, ordered_sum,
                   scan_batch_sharding)

__all__ = ["make_shardmap_patchwork", "patchwork_level"]


def patchwork_level(cfg: PatchworkConfig, xyz: torch.Tensor,
                    valid: torch.Tensor, shard_start: int = 0,
                    group=None) -> torch.Tensor:
    """One single-level Patchwork pass over this rank's points: xyz (B, n, 3)
    and valid (B, n), the points ``shard_start`` .. ``shard_start + n - 1``
    of each scan, the other shards on the other ranks of ``group`` (None:
    the whole scan, on this process alone).  Returns ground (B, n) bool."""
    b, n, _ = xyz.shape
    num_s = cfg.num_patches + 1
    trash = num_s - 1
    patch, in_patch, _, fin, d = bin_points(xyz, valid, cfg)
    xt = torch.where(fin[..., None], xyz, torch.zeros_like(xyz)).permute(
        0, 2, 1).contiguous()                                   # (B, 3, n)
    z = xt[:, 2]
    ops = SegOps(patch, num_s, "pallas")

    def psum(v):
        return ordered_sum(v, group)

    # per-patch mean distance, thresholds per node and per point
    w = in_patch.to(torch.float32)
    md = psum(ops.sum(torch.stack([d * w, w], 1)))
    rel = true_div(md[:, 0] / torch.clamp(md[:, 1], min=1.0),
                   cfg.filtering_radius)
    tau_node = _f32(cfg.th_dist) * (1.0 + _f32(cfg.tau_slope) * rel)
    zth_node = _f32(cfg.sensor_height) + _f32(cfg.seed_slope) * rel
    zth_pt, tau_pt = ops.gather(torch.stack([zth_node, tau_node], 1)).unbind(1)

    active = in_patch
    seed = active & (z < zth_pt)
    cnt, seed_cnt = psum(ops.sum(torch.stack(
        [active.to(torch.float32), seed.to(torch.float32)], 1))).unbind(1)
    mins, maxs = ops.bbox(xt, active)
    mins, maxs = all_min(mins, group), all_max(maxs, group)

    # early-outs at depth 0 (cpp:111-140; no area early-out, cpp:127)
    real = torch.arange(num_s, device=xyz.device) < trash
    too_small = cnt < 3.0
    flat_z = ((maxs[:, 2] - mins[:, 2]) < _f32(cfg.flat_dz)) \
        & (cnt > cfg.flat_min_points) & ~too_small
    finished = real & (too_small | flat_z)
    fit_node = real & ~finished
    deficient = fit_node & (seed_cnt < cfg.min_seed_points)
    finished_pt, label_pt, fit_pt, deficient_pt = (ops.gather(torch.stack(
        [finished, flat_z, fit_node, deficient], 1).to(torch.float32))
        > 0.5).unbind(1)

    # the min_seed_points lowest points of deficient nodes, by (z, global
    # index): two MIN rounds a pick
    if bool(deficient.any()):
        idx_f = float(shard_start) + torch.arange(
            n, dtype=torch.float32, device=xyz.device).expand(b, -1)
        chosen = torch.zeros_like(seed)
        for _ in range(cfg.min_seed_points):
            cand = active & deficient_pt & ~chosen
            m = all_min(ops.min(z, cand), group)
            m_pt = ops.gather(torch.where(torch.isfinite(m), m, _BIG))
            is_min = cand & (z == m_pt)
            mi = all_min(ops.min(idx_f, is_min), group)
            mi_pt = ops.gather(torch.where(torch.isfinite(mi), mi, _BIG))
            chosen = chosen | (is_min & (idx_f == mi_pt))
        seed = torch.where(deficient_pt, chosen, seed)
    seed = seed & active

    ground = active & fit_pt & seed
    ground = torch.where(active & finished_pt, label_pt, ground)

    # the fit loop: local moment partials, plane math on every rank
    for _ in range(cfg.max_iter):
        g = (ground & active).to(torch.float32)
        m1 = psum(ops.sum(torch.cat([g[:, None], xt * g[:, None]], 1)))
        gcnt = m1[:, 0]
        d_all = xt - ops.gather(m1[:, 1:4]
                                / torch.clamp(gcnt, min=1.0)[:, None])
        dx, dy, dz = (d_all * g[:, None]).unbind(1)
        m2 = psum(ops.sum(torch.stack([dx * dx, dx * dy, dx * dz, dy * dy,
                                       dy * dz, dz * dz], 1)))
        n_pt = ops.gather(_cov_normal(m2, gcnt))
        dist = torch.abs(d_all[:, 0] * n_pt[:, 0] + d_all[:, 1] * n_pt[:, 1]
                         + d_all[:, 2] * n_pt[:, 2])
        can_pt = ops.gather((gcnt >= 3.0).to(torch.float32)) > 0.5
        new_g = dist < tau_pt
        apply_pt = active & fit_pt & can_pt
        changed = psum((apply_pt & (new_g != ground)).sum(
            dtype=torch.int32).reshape(1))
        ground = torch.where(apply_pt, new_g, ground)
        if int(changed[0]) == 0:
            break
    return ground & in_patch


def make_shardmap_patchwork(cfg: PatchworkConfig, mesh):
    """fn(xyz (B, N, 3), valid (B, N)) -> ground (B, N) bool on every rank.

    B shards over "dp" and N over "sp"; N must divide over sp."""
    if cfg.effective_levels != 1:
        raise ValueError("shard_map engine supports single-level configs only "
                         "(use PatchworkConfig.patchwork())")
    if not cfg.adaptive_seed_height:
        raise ValueError("shard_map engine supports adaptive seeds only")
    layout = scan_batch_sharding(mesh, shard_points=True)
    group = mesh.get_group(POINT_AXIS)
    j = axis_index(mesh, POINT_AXIS)

    def fn(xyz: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        xb, vb = layout.cut(xyz), layout.cut(valid)
        return layout.join(patchwork_level(cfg, xb, vb, j * xb.shape[1],
                                           group))

    return fn
