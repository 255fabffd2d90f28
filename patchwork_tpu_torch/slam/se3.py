"""SE(3) Lie-group utilities, batched over leading dimensions, float32.

Counterpart of ``patchwork_tpu/slam/se3.py``.  The SLAM back end (scan
matching, pose graph, bundle adjustment) optimizes on SE(3) with right
perturbations T <- T @ exp(xi).  Every angle-dependent coefficient has a
Taylor branch near 0 chosen by ``torch.where`` with a dummy operand in the
other branch, so both branches stay finite and ``torch.func.jacfwd`` at
xi = 0 gives no NaN.

Products are float32 matmuls with TF32 off (``core.device.pin_fp32``): the
TPU package found that reduced-precision operands here doubled ICP drift.
"""

from __future__ import annotations

import torch

__all__ = ["so3_exp", "so3_log", "se3_exp", "se3_log", "se3_inverse",
           "se3_compose", "se3_apply", "se3_identity", "se3_adjoint",
           "so3_left_jacobian_inv", "se3_left_jacobian_inv",
           "se3_right_jacobian_inv"]

_EPS2 = 1e-12  # squared-angle cutoff for the Taylor branches


def _hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _safe_t2(w: torch.Tensor):
    """(t^2 as (..., 1, 1), safe mask, t^2 with 1.0 where not safe)."""
    t2 = (w * w).sum(dim=-1)[..., None, None]
    safe = t2 > _EPS2
    return t2, safe, torch.where(safe, t2, torch.ones_like(t2))


def _abc(w: torch.Tensor):
    """a = sin(t)/t, b = (1 - cos t)/t^2, c = (t - sin t)/t^3, with Taylor
    branches at t = 0."""
    t2, safe, t2s = _safe_t2(w)
    t = torch.sqrt(t2s)
    a = torch.where(safe, torch.sin(t) / t, 1.0 - t2 / 6.0)
    b = torch.where(safe, (1.0 - torch.cos(t)) / t2s, 0.5 - t2 / 24.0)
    c = torch.where(safe, (t - torch.sin(t)) / (t2s * t),
                    1.0 / 6.0 - t2 / 120.0)
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    a, b, _ = _abc(w)
    k = _hat(w)
    return _eye3(w) + a * k + b * torch.matmul(k, k)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (theta < pi)."""
    # kept (..., 1): forward AD of a 0-d tensor minus a Python float gives
    # a float64 tangent
    tr = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    safe = cos_t < 1.0 - 1e-6
    theta = torch.arccos(torch.where(safe, cos_t, torch.zeros_like(cos_t)))
    scale_exact = theta / (2.0 * torch.sin(theta))
    # near identity: theta^2 ~ 2(1 - cos), scale ~ 1/2 + (1 - cos)/6
    scale_taylor = 0.5 + (1.0 - cos_t) / 6.0
    return w * torch.where(safe, scale_exact, scale_taylor)


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V (couples translation in the se3 exp)."""
    _, b, c = _abc(w)
    k = _hat(w)
    return _eye3(w) + b * k + c * torch.matmul(k, k)


def _homogeneous(top: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with the row [0, 0, 0, 1] below."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [rho, phi] -> (..., 4, 4) homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = torch.matmul(_left_jacobian(phi), rho[..., None])
    return _homogeneous(torch.cat([so3_exp(phi), t], dim=-1))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    v_inv = torch.linalg.inv(_left_jacobian(phi))
    rho = torch.matmul(v_inv, T[..., :3, 3:])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    rt = T[..., :3, :3].transpose(-1, -2)
    t = -torch.matmul(rt, T[..., :3, 3:])
    return _homogeneous(torch.cat([rt, t], dim=-1))


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, B)


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) x (..., N, 3) -> (..., N, 3)."""
    return (torch.matmul(pts, T[..., :3, :3].transpose(-1, -2))
            + T[..., None, :3, 3])


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# closed-form Jacobians (Barfoot, "State Estimation for Robotics" §7.1.5,
# eq. 7.86): the pose-graph Gauss-Newton's d log / d xi at the linearization
# point, held against torch.func.jacfwd in the tests
# ---------------------------------------------------------------------------

def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6, 6) adjoint for xi = [rho, phi]:
    Ad(T) = [[R, hat(t) R], [0, R]]."""
    R = T[..., :3, :3]
    tR = torch.matmul(_hat(T[..., :3, 3]), R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3): J_l^{-1}(phi) = I - hat/2 + e hat^2,
    e = 1/t^2 - (1 + cos t)/(2 t sin t), Taylor 1/12 + t^2/720 at 0."""
    t2, safe, t2s = _safe_t2(phi)
    t = torch.sqrt(t2s)
    e_exact = 1.0 / t2s - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t))
    e = torch.where(safe, e_exact, 1.0 / 12.0 + t2 / 720.0)
    k = _hat(phi)
    return _eye3(phi) - 0.5 * k + e * torch.matmul(k, k)


def _se3_Q(rho: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(xi) block (eq. 7.86): the rho-phi coupling of the SE(3)
    left Jacobian J_l(xi) = [[J_l(phi), Q], [0, J_l(phi)]]."""
    t2, safe, t2s = _safe_t2(phi)
    t = torch.sqrt(t2s)
    st, ct = torch.sin(t), torch.cos(t)
    c1 = torch.where(safe, (t - st) / (t2s * t), 1.0 / 6.0 - t2 / 120.0)
    c2 = torch.where(safe, (t2s + 2.0 * ct - 2.0) / (2.0 * t2s * t2s),
                     1.0 / 24.0 - t2 / 720.0)
    c3 = torch.where(safe,
                     (2.0 * t - 3.0 * st + t * ct) / (2.0 * t2s * t2s * t),
                     1.0 / 120.0 - t2 / 2520.0)
    rx, px = _hat(rho), _hat(phi)
    mm = torch.matmul
    prp = mm(px, mm(rx, px))
    p2 = mm(px, px)
    return (0.5 * rx
            + c1 * (mm(px, rx) + mm(rx, px) + prp)
            + c2 * (mm(p2, rx) + mm(rx, p2) - 3.0 * prp)
            + c3 * (mm(prp, px) + mm(px, prp)))


def se3_left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 6, 6): J_l^{-1}(xi) =
    [[J^{-1}, -J^{-1} Q J^{-1}], [0, J^{-1}]] with J = J_l(phi)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    ji = so3_left_jacobian_inv(phi)
    tr = -torch.matmul(ji, torch.matmul(_se3_Q(rho, phi), ji))
    top = torch.cat([ji, tr], dim=-1)
    bot = torch.cat([torch.zeros_like(ji), ji], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """J_r^{-1}(xi) = J_l^{-1}(-xi): d/d eps log(exp(xi) exp(eps)) at 0."""
    return se3_left_jacobian_inv(-xi)
