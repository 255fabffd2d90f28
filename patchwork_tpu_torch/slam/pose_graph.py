"""Keyframe pose-graph optimization.

Counterpart of ``patchwork_tpu/slam/pose_graph.py``.  State: K SE(3)
keyframe poses; constraints: relative-pose edges (odometry, loop closures)
with 6x6 information matrices.  Gauss-Newton with right perturbations and
closed-form edge Jacobians (``jacobian="jacfwd"``: ``torch.func.jacfwd``,
the oracle), all edges at once.  The normal equations are either assembled
densely (6K, 6K) and solved, or solved matrix-free by block-Jacobi PCG.
The edge sums are ``index_add_``, as the JAX package's ``.at[].add``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from .ba import _batched_inv, _pcg
from .se3 import (se3_adjoint, se3_compose, se3_exp, se3_inverse, se3_log,
                  se3_right_jacobian_inv)

__all__ = ["PoseGraph", "edge_residuals", "optimize_pose_graph",
           "sparsify_pose_graph", "ate_rmse"]

_F32 = torch.float32


class PoseGraph(NamedTuple):
    poses: torch.Tensor      # (K, 4, 4)
    edge_i: torch.Tensor     # (E,) int32 source keyframe index
    edge_j: torch.Tensor     # (E,) int32 target keyframe index
    edge_T: torch.Tensor     # (E, 4, 4) measured T_i^-1 T_j
    edge_info: torch.Tensor  # (E, 6, 6) information (weight) matrices

    @classmethod
    def from_numpy(cls, poses, edge_i, edge_j, edge_T, edge_info,
                   device=None) -> "PoseGraph":
        """A graph from NumPy arrays, on the card unless ``device`` says
        otherwise."""
        dev = resolve_device(device)

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        def i32(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

        return cls(f32(poses), i32(edge_i), i32(edge_j), f32(edge_T),
                   f32(edge_info))


def edge_residuals(poses: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """(E, 6) twist residuals r_e = log(T_meas^-1 T_i^-1 T_j)."""
    Ti = poses[g.edge_i.long()]
    Tj = poses[g.edge_j.long()]
    return se3_log(se3_compose(
        se3_compose(se3_inverse(g.edge_T), se3_inverse(Ti)), Tj))


def _edge_jacobians(poses: torch.Tensor, g: PoseGraph,
                    jacobian: str = "analytic"):
    """Per-edge residual and 6x6 Jacobian blocks wrt xi_i, xi_j.

    "analytic": with E = Tm^-1 Ti^-1 Tj and r = log(E), right perturbations
    give Jj = Jr^-1(r) and Ji = -Jr^-1(r) Ad(Tj^-1 Ti) (Barfoot §7.1.5);
    "jacfwd": ``torch.func.jacfwd`` through the log/compose/exp chain.
    """
    Ti = poses[g.edge_i.long()]
    Tj = poses[g.edge_j.long()]
    Tm = g.edge_T
    if jacobian == "jacfwd":
        from torch.func import jacfwd, vmap

        def res_one(xi_i, xi_j, Ti, Tj, Tm):
            return se3_log(se3_compose(se3_compose(
                se3_inverse(Tm), se3_inverse(se3_compose(Ti, se3_exp(xi_i)))),
                se3_compose(Tj, se3_exp(xi_j))))

        z = torch.zeros((Ti.shape[0], 6), dtype=_F32, device=Ti.device)
        return (vmap(res_one)(z, z, Ti, Tj, Tm),
                vmap(jacfwd(res_one, argnums=0))(z, z, Ti, Tj, Tm),
                vmap(jacfwd(res_one, argnums=1))(z, z, Ti, Tj, Tm))
    if jacobian != "analytic":
        raise ValueError(f"unknown jacobian {jacobian!r}")
    E = se3_compose(se3_compose(se3_inverse(Tm), se3_inverse(Ti)), Tj)
    r = se3_log(E)
    Jr_inv = se3_right_jacobian_inv(r)
    Ji = -torch.matmul(Jr_inv, se3_adjoint(se3_compose(se3_inverse(Tj), Ti)))
    return r, Ji, Jr_inv


def _edge_normal_blocks(poses, g: PoseGraph, jacobian: str = "analytic"):
    """Per-edge Gauss-Newton blocks: H_ii, H_ij, H_jj (E,6,6), b_i, b_j (E,6)."""
    r, Ji, Jj = _edge_jacobians(poses, g, jacobian)
    info = g.edge_info
    JiT_I = torch.einsum("eai,eab->eib", Ji, info)
    JjT_I = torch.einsum("eai,eab->eib", Jj, info)
    return (torch.einsum("eib,ebj->eij", JiT_I, Ji),
            torch.einsum("eib,ebj->eij", JiT_I, Jj),
            torch.einsum("eib,ebj->eij", JjT_I, Jj),
            torch.einsum("eib,eb->ei", JiT_I, r),
            torch.einsum("eib,eb->ei", JjT_I, r))


def _normal_equations(poses, g: PoseGraph, jacobian: str = "analytic"):
    """Assemble dense H (6K, 6K), b (6K,) from all edges."""
    k = poses.shape[0]
    H_ii, H_ij, H_jj, b_i, b_j = _edge_normal_blocks(poses, g, jacobian)
    ei, ej = g.edge_i.long(), g.edge_j.long()
    H = torch.zeros((k * k, 6, 6), dtype=_F32, device=poses.device)
    H.index_add_(0, ei * k + ei, H_ii)
    H.index_add_(0, ej * k + ej, H_jj)
    H.index_add_(0, ei * k + ej, H_ij)
    H.index_add_(0, ej * k + ei, H_ij.transpose(-1, -2))
    H = H.reshape(k, k, 6, 6).permute(0, 2, 1, 3)
    b = torch.zeros((k, 6), dtype=_F32, device=poses.device)
    b.index_add_(0, ei, b_i).index_add_(0, ej, b_j)
    return H.reshape(6 * k, 6 * k), b.reshape(6 * k)


def _pcg_solve(g, blocks, b, damping, anchor_weight, cg_iters, cg_tol):
    """Matrix-free block-Jacobi preconditioned CG for H delta = b (K, 6).

    H v applies the per-edge 6x6 blocks and sums them per pose, O(E * 36)
    a product; the preconditioner is the exact block diagonal of H
    (``ba._pcg``).
    """
    H_ii, H_ij, H_jj, _, _ = blocks
    k = b.shape[0]
    dev = b.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    anchor = torch.zeros((k, 1), dtype=_F32, device=dev)
    anchor[0, 0] = anchor_weight
    eye6 = torch.eye(6, dtype=_F32, device=dev)

    def hvp(v):  # v (K, 6)
        vi, vj = v[ei], v[ej]
        yi = (torch.einsum("eij,ej->ei", H_ii, vi)
              + torch.einsum("eij,ej->ei", H_ij, vj))
        yj = (torch.einsum("eji,ej->ei", H_ij, vi)
              + torch.einsum("eij,ej->ei", H_jj, vj))
        y = torch.zeros((k, 6), dtype=_F32, device=dev)
        y.index_add_(0, ei, yi).index_add_(0, ej, yj)
        return y + damping * v + anchor * v

    diag = torch.zeros((k, 6, 6), dtype=_F32, device=dev)
    diag.index_add_(0, ei, H_ii).index_add_(0, ej, H_jj)
    diag = diag + damping * eye6
    diag[0] += anchor_weight * eye6
    m_inv = _batched_inv(diag)

    def prec(r):
        return torch.einsum("kij,kj->ki", m_inv, r)

    return _pcg(hvp, prec, b, cg_iters, cg_tol)


def optimize_pose_graph(
    g: PoseGraph,
    iters: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
    solver: str | None = None,
    cg_iters: int | None = None,
    cg_tol: float = 1e-8,
    jacobian: str = "analytic",
) -> PoseGraph:
    """Gauss-Newton over all poses; pose 0 is gauge-anchored by a prior.

    solver: "dense" (LU on the assembled (6K, 6K) system), "cg" (matrix-free
    block-Jacobi PCG, for K >~ 500), or None to choose by K.  cg_iters
    defaults to 2K: chain-dominated graphs condition like a 1-D Laplacian.
    """
    k = g.poses.shape[0]
    if solver is None:
        solver = "cg" if k > 384 else "dense"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    if cg_iters is None:
        cg_iters = min(max(256, 2 * k), 4096)
    poses = g.poses
    dev = poses.device
    for _ in range(iters):
        if solver == "dense":
            H, b = _normal_equations(poses, g, jacobian)
            # gauge fixing: strong prior on pose 0 + Levenberg damping
            diag = torch.full((6 * k,), damping, dtype=_F32, device=dev)
            diag[:6] += anchor_weight
            H = H + torch.diag(diag)
            delta = -torch.linalg.solve_ex(H, b)[0].reshape(k, 6)
        else:
            blocks = _edge_normal_blocks(poses, g, jacobian)
            b = torch.zeros((k, 6), dtype=_F32, device=dev)
            b.index_add_(0, g.edge_i.long(), blocks[3])
            b.index_add_(0, g.edge_j.long(), blocks[4])
            delta = -_pcg_solve(g, blocks, b, damping, anchor_weight,
                                cg_iters, cg_tol)
        poses = se3_compose(poses, se3_exp(delta))
    return g._replace(poses=poses)


def sparsify_pose_graph(g: PoseGraph, max_degree: int = 6) -> PoseGraph:
    """Degree-capped loop-edge pruning for large keyframe graphs.

    Keeps the odometry chain (|i - j| == 1) and, per keyframe, at most
    ``max_degree`` further loop edges, the most informative first (largest
    information-matrix trace).  On the host, as graph construction is.
    """
    ei = g.edge_i.cpu().numpy()
    ej = g.edge_j.cpu().numpy()
    info = g.edge_info.cpu().numpy()
    keep = np.abs(ei - ej) == 1
    w = np.trace(info, axis1=-2, axis2=-1)
    order = np.argsort(-w, kind="stable")  # most informative first
    deg = np.zeros(int(g.poses.shape[0]), np.int32)
    for e in order:
        if keep[e]:
            continue
        i, j = int(ei[e]), int(ej[e])
        if deg[i] < max_degree and deg[j] < max_degree:
            keep[e] = True
            deg[i] += 1
            deg[j] += 1
    idx = torch.from_numpy(np.nonzero(keep)[0]).to(g.edge_i.device)
    return PoseGraph(poses=g.poses, edge_i=g.edge_i[idx], edge_j=g.edge_j[idx],
                     edge_T=g.edge_T[idx], edge_info=g.edge_info[idx])


def ate_rmse(poses: torch.Tensor, gt_poses: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error (translation RMSE) after aligning the
    first pose (no global alignment; keyframe 0 is the gauge)."""
    align = se3_compose(gt_poses[0], se3_inverse(poses[0]))
    d = se3_compose(align[None], poses)[:, :3, 3] - gt_poses[:, :3, 3]
    return torch.sqrt((d * d).sum(-1).mean())
