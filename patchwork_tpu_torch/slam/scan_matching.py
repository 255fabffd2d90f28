"""Ground-constrained scan matching (frame-to-frame LiDAR odometry).

Counterpart of ``patchwork_tpu/slam/scan_matching.py``, with an explicit
leading pair dimension where the JAX package vmaps:

* correspondences by brute-force nearest neighbour over the downsampled
  obstacle points: the (N, M) squared distances |p|^2 + |q|^2 - 2 p.q with
  the cross term as one float32 matmul (TF32 off), then ``argmin`` over the
  masked row;
* residuals: point-to-point on obstacle correspondences (x, y, yaw) and
  point-to-plane against the target's ground plane from the segmentation
  masks (z, roll, pitch);
* Gauss-Newton on SE(3) with right perturbations, the closed-form
  Jacobians R [I | -[s]x] and [(R^T n)^T, (g x R^T n)^T], a damped 6x6
  solve, a fixed number of iterations.  ``jacobian="jacfwd"`` differentiates
  the residual with ``torch.func.jacfwd`` instead (the oracle the tests
  hold the closed form to).

No kernel of its own: the JAX package computes all of this outside any
Pallas kernel, and so does the port, in plain PyTorch on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.geometry import fit_plane_masked
from .se3 import se3_apply, se3_compose, se3_exp

__all__ = ["MatchResult", "nearest_neighbors", "icp_ground_constrained"]

_F32 = torch.float32


class MatchResult(NamedTuple):
    transform: torch.Tensor    # (..., 4, 4) mapping source frame -> target
    num_inliers: torch.Tensor  # (...,) int32
    rmse: torch.Tensor         # (...,) float32 inlier point-to-point RMSE


def nearest_neighbors(src: torch.Tensor, tgt: torch.Tensor,
                      tgt_valid: torch.Tensor, precision: str = "highest"):
    """Index and squared distance of each src point's nearest valid tgt
    point: src (..., N, 3), tgt (..., M, 3), tgt_valid (..., M) ->
    (idx (..., N) int64, d2 (..., N)).  Invalid targets are at +inf.

    ``precision="default"`` rounds the cross term's operands to bfloat16
    (what the TPU's default matmul precision does) and recomputes d2
    exactly from the chosen pair, so gating and RMSE stay float32-exact; a
    row with no valid target keeps d2 = inf.
    """
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "highest":
        cross = torch.matmul(src, tgt.transpose(-1, -2))
    else:
        cross = torch.matmul(src.to(torch.bfloat16),
                             tgt.transpose(-1, -2).to(torch.bfloat16)).to(_F32)
    d2 = ((src * src).sum(-1)[..., :, None] + (tgt * tgt).sum(-1)[..., None, :]
          - 2.0 * cross)
    d2 = torch.where(tgt_valid[..., None, :], d2,
                     torch.full_like(d2, float("inf")))
    idx = torch.argmin(d2, dim=-1)
    if precision == "highest":
        return idx, torch.gather(d2, -1, idx[..., None])[..., 0]
    q = torch.gather(tgt, -2, idx[..., None].expand(*idx.shape, 3))
    diff = src - q
    hit = torch.gather(tgt_valid, -1, idx)
    return idx, torch.where(hit, (diff * diff).sum(-1),
                            torch.full_like(diff[..., 0], float("inf")))


def _skew_rows(s: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) [s]x."""
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    o = torch.zeros_like(sx)
    return torch.stack([torch.stack([o, -sz, sy], dim=-1),
                        torch.stack([sz, o, -sx], dim=-1),
                        torch.stack([-sy, sx, o], dim=-1)], dim=-2)


def _normal_eqs_analytic(T, p, q, w_obst, pg, g_c, g_n, w_ground,
                         src_obst, src_ground):
    """H (P, 6, 6), b (P, 6) from the closed-form right-perturbation
    Jacobians d[(T exp(xi)) s]/dxi = R [I | -[s]x] and
    d[n . (T exp(xi)) g]/dxi = [(R^T n)^T, (g x R^T n)^T]."""
    R = T[:, :3, :3]
    r_pp = (p - q) * w_obst[..., None]
    r_pl = ((pg - g_c[:, None, :]) * g_n[:, None, :]).sum(-1) * w_ground
    eye = torch.eye(3, dtype=_F32, device=T.device).expand(
        *src_obst.shape[:2], 3, 3)
    Jpp = torch.cat([eye, -_skew_rows(src_obst)], dim=-1)      # (P, N, 3, 6)
    Jpp = torch.einsum("pij,pnjk->pnik", R, Jpp) * w_obst[..., None, None]
    nR = torch.einsum("pij,pi->pj", R, g_n)                      # R^T n
    nRb = nR[:, None, :].expand_as(src_ground)
    Jpl = torch.cat([nRb, torch.linalg.cross(src_ground, nRb, dim=-1)],
                    dim=-1) * w_ground[..., None]                # (P, G, 6)
    H = (torch.einsum("pnik,pnil->pkl", Jpp, Jpp)
         + torch.einsum("pgk,pgl->pkl", Jpl, Jpl))
    b = (torch.einsum("pnik,pni->pk", Jpp, r_pp)
         + torch.einsum("pgk,pg->pk", Jpl, r_pl))
    return H, b


def _normal_eqs_jacfwd(T, q, w_obst, g_c, g_n, w_ground, src_obst,
                       src_ground):
    """H, b from ``torch.func.jacfwd`` of the stacked residual at xi = 0."""
    from torch.func import jacfwd, vmap

    def residuals(xi, T, q, w_obst, g_c, g_n, w_ground, so, sg):
        Txi = se3_compose(T, se3_exp(xi))
        r_pp = (se3_apply(Txi, so) - q) * w_obst[:, None]
        r_pl = ((se3_apply(Txi, sg) - g_c) * g_n).sum(-1) * w_ground
        return torch.cat([r_pp.reshape(-1), r_pl])

    args = (T, q, w_obst, g_c, g_n, w_ground, src_obst, src_ground)
    xi0 = torch.zeros((T.shape[0], 6), dtype=_F32, device=T.device)
    r0 = vmap(residuals)(xi0, *args)
    J = vmap(jacfwd(residuals))(xi0, *args)                      # (P, R, 6)
    return (torch.einsum("pri,prj->pij", J, J),
            torch.einsum("pri,pr->pi", J, r0))


def icp_ground_constrained(
    src_obst: torch.Tensor,        # (..., N, 3) source obstacle points
    src_obst_valid: torch.Tensor,  # (..., N)
    src_ground: torch.Tensor,      # (..., G, 3) source ground points
    src_ground_valid: torch.Tensor,
    tgt_obst: torch.Tensor,        # (..., M, 3) target obstacle points
    tgt_obst_valid: torch.Tensor,
    tgt_ground: torch.Tensor,      # (..., G2, 3) target ground points
    tgt_ground_valid: torch.Tensor,
    init: torch.Tensor | None = None,   # (..., 4, 4) initial guess
    iters: int = 12,
    max_corr_dist: float = 2.0,
    ground_weight: float = 1.0,
    coarse_factor: float = 8.0,
    jacobian: str = "analytic",
    nn_precision: str = "highest",
) -> MatchResult:
    """Estimate T such that T . src ~= tgt, for every pair of the leading
    dimensions at once (each pair converges on its own).

    Coarse to fine: the correspondence gate anneals geometrically from
    ``coarse_factor * max_corr_dist`` down to ``max_corr_dist`` over the
    iterations.  ``jacobian``: "analytic" (closed form) or "jacfwd"
    (``torch.func``, the oracle).
    """
    if jacobian not in ("analytic", "jacfwd"):
        raise ValueError(f"unknown jacobian {jacobian!r}")
    lead = src_obst.shape[:-2]
    dev = src_obst.device

    def pairs(pts, valid):
        return (pts.reshape(-1, *pts.shape[-2:]),
                valid.reshape(-1, pts.shape[-2]))

    so, sov = pairs(src_obst, src_obst_valid)
    sg, sgv = pairs(src_ground, src_ground_valid)
    to, tov = pairs(tgt_obst, tgt_obst_valid)
    tg, tgv = pairs(tgt_ground, tgt_ground_valid)
    npair = so.shape[0]
    if init is None:
        T = torch.eye(4, dtype=_F32, device=dev).expand(npair, 4, 4)
    else:
        T = init.reshape(-1, 4, 4).expand(npair, 4, 4)
    T = T.to(_F32).contiguous()

    # target ground plane (centroid + normal) from the segmentation masks
    g_c, g_n, _, g_cnt = fit_plane_masked(tg, tgv)
    use_ground = (g_cnt >= 3).to(_F32)
    w_ground = sgv.to(_F32) * use_ground[:, None] * ground_weight
    anneal = max_corr_dist * (coarse_factor ** (
        1.0 - torch.arange(iters, dtype=_F32, device=dev) / max(iters - 1, 1)))
    eye6 = torch.eye(6, dtype=_F32, device=dev)
    n_in = rmse = None
    for it in range(iters):
        gate = anneal[it]
        p = se3_apply(T, so)
        nn_idx, nn_d2 = nearest_neighbors(p, to, tov, nn_precision)
        q = torch.gather(to, 1, nn_idx[..., None].expand(*nn_idx.shape, 3))
        w_obst = (sov & (nn_d2 < gate * gate)).to(_F32)
        pg = se3_apply(T, sg)
        if jacobian == "analytic":
            H, b = _normal_eqs_analytic(T, p, q, w_obst, pg, g_c, g_n,
                                        w_ground, so, sg)
        else:
            H, b = _normal_eqs_jacfwd(T, q, w_obst, g_c, g_n, w_ground, so,
                                      sg)
        # Levenberg damping for robustness on poor geometry
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + 1e-4 * eye6 * torch.clamp(tr / 6.0, min=1.0)[:, None, None]
        delta = -torch.linalg.solve_ex(H, b)[0]
        T = se3_compose(T, se3_exp(delta))
        wsum = w_obst.sum(-1)
        n_in = wsum.to(torch.int32)
        rmse = torch.sqrt((nn_d2 * w_obst).sum(-1) / torch.clamp(wsum, min=1.0))
    return MatchResult(transform=T.reshape(lead + (4, 4)),
                       num_inliers=n_in.reshape(lead),
                       rmse=rmse.reshape(lead))
