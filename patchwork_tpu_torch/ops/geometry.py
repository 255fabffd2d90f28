"""Closed-form batched 3x3 symmetric eigensolve in plain PyTorch.

Counterpart of ``patchwork_tpu/ops/geometry.py:57-127`` with the same
expression tree, term for term, so results track the JAX reference to a
few ulp (the trigonometric functions come from another math library).
The engine's per-node plane normal (segment/engine.py, kernels/fit_cuda.py)
follows the row form of the same formulas.
"""

from __future__ import annotations

import torch

from ..core.device import true_div

__all__ = ["eigvals3x3", "smallest_eigenvector3x3", "eigh3x3"]

_EPS = 1e-12
_TWO_PI_3 = 2.0943951023931953


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
