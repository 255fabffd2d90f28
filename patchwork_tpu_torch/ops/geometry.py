"""Masked centroid and covariance, the closed-form batched 3x3 symmetric
eigensolve, and the masked PCA plane fit, in plain PyTorch.

Counterpart of ``patchwork_tpu/ops/geometry.py``.  The eigensolve keeps
the JAX reference's expression tree, term for term, so results track it
to a few ulp (the trigonometric functions come from another math
library); the masked sums add in PyTorch's order, not XLA's dot order.
The engine's per-node plane normal (segment/engine.py, kernels/fit_cuda.py)
follows the row form of the same formulas.
"""

from __future__ import annotations

import torch

from ..core.device import true_div

__all__ = ["masked_centroid", "masked_covariance", "eigvals3x3",
           "smallest_eigenvector3x3", "eigh3x3", "fit_plane_masked"]

_EPS = 1e-12
_TWO_PI_3 = 2.0943951023931953


def masked_centroid(xyz: torch.Tensor, mask: torch.Tensor):
    """Mean of the masked points of (..., N, 3); zero when the mask is empty
    (point_cloud_processor.cpp:58-70).  Returns (centroid (..., 3), count
    (...,) float32)."""
    w = mask.to(torch.float32)
    n = w.sum(dim=-1)
    s = (w[..., None] * xyz).sum(dim=-2)
    c = s / torch.clamp(n, min=1.0)[..., None]
    return torch.where(n[..., None] > 0, c, torch.zeros_like(c)), n


def masked_covariance(xyz: torch.Tensor, mask: torch.Tensor,
                      centroid: torch.Tensor) -> torch.Tensor:
    """Two-pass sample covariance of the masked points, normalized by
    (n - 1); zero for n < 2 (point_cloud_processor.cpp:72-86)."""
    w = mask.to(torch.float32)
    n = w.sum(dim=-1)
    d = (xyz - centroid[..., None, :]) * w[..., None]
    cov = torch.einsum("...ni,...nj->...ij", d, d)
    cov = cov / torch.clamp(n - 1.0, min=1.0)[..., None, None]
    return torch.where((n > 1.5)[..., None, None], cov, torch.zeros_like(cov))


def eigvals3x3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending (Smith 1961)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = true_div(a00 + a11 + a22, 3.0)
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(true_div(p2, 6.0), min=0.0))
    safe_p = torch.clamp(p, min=_EPS)

    b00, b11, b22 = d0 / safe_p, d1 / safe_p, d2 / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = true_div(torch.acos(r), 3.0)

    two_pi_3 = torch.tensor(_TWO_PI_3, dtype=a.dtype, device=a.device)
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + two_pi_3)
    e_mid = 3.0 * q - e_hi - e_lo

    diag_sorted = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1).values
    vals = torch.stack([e_lo, e_mid, e_hi], dim=-1)
    return torch.where((p <= _EPS)[..., None], diag_sorted, vals)


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([uy * vz - uz * vy, uz * vx - ux * vz,
                        ux * vy - uy * vx], dim=-1)


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    n = torch.sqrt(x * x + y * y + z * z)
    return n[..., None] if keepdim else n


def smallest_eigenvector3x3(a: torch.Tensor, eig_min: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue: the largest cross
    product of rows of (A - e I); degenerate matrices fall back to +Z
    (src/recursive_patchwork.cpp:78-80)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    c = a - eig_min[..., None, None] * eye
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    cands = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)],
                        dim=-2)
    best = torch.argmax(_norm(cands), dim=-1)   # first max on ties
    v = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    n = _norm(v, keepdim=True)
    v = torch.where(n > 1e-20, v / torch.clamp(n, min=1e-30),
                    torch.zeros_like(v))
    up = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    return torch.where(n > 1e-20, v, up.expand_as(v))


def eigh3x3(a: torch.Tensor):
    """(eigenvalues ascending, smallest-eigenvalue eigenvector)."""
    vals = eigvals3x3(a)
    return vals, smallest_eigenvector3x3(a, vals[..., 0])


def fit_plane_masked(xyz: torch.Tensor, mask: torch.Tensor):
    """Batched masked PCA plane fit (src/recursive_patchwork.cpp:77-107).

    Centroid, covariance / (n - 1), the smallest-eigenvalue eigenvector
    flipped to +Z, and the mean |point-plane distance| over the masked
    points; for n < 3 the sentinel is centroid 0, normal +Z, residual +inf.
    Returns (centroid (..., 3), normal (..., 3), residual (...,), n (...,)).
    """
    centroid, n = masked_centroid(xyz, mask)
    cov = masked_covariance(xyz, mask, centroid)
    _, normal = eigh3x3(cov)
    normal = torch.where(normal[..., 2:3] < 0, -normal, normal)
    d = torch.abs(((xyz - centroid[..., None, :]) * normal[..., None, :])
                  .sum(dim=-1))
    resid = (d * mask.to(torch.float32)).sum(dim=-1) / torch.clamp(n, min=1.0)
    bad = n < 3
    up = torch.tensor([0.0, 0.0, 1.0], dtype=xyz.dtype, device=xyz.device)
    centroid = torch.where(bad[..., None], torch.zeros_like(centroid), centroid)
    normal = torch.where(bad[..., None], up.expand_as(normal), normal)
    resid = torch.where(bad, torch.full_like(resid, float("inf")), resid)
    return centroid, normal, resid, n
