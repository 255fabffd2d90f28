"""Bundle adjustment with Schur-complement reduction, on one device or with
the observations sharded over the ranks of a mesh.

Counterpart of ``patchwork_tpu/slam/ba.py``.  K keyframe poses (SE(3))
and L landmarks (3D points), observations (k, l, p_local): landmark l seen
from keyframe k at local coordinates p_local; residual r = T_k^-1 . X_l -
p_local.  Gauss-Newton normal equations

    [ A   B ] [dp]   [ba]
    [ B^T C ] [dx] = [bx]

with C block-diagonal over landmarks (3x3), eliminated by the Schur
complement S = A - B C^-1 B^T.  ``solver="dense"`` forms S and solves it;
``"pcg"`` never forms it: each product S v is two segment sums over the
observations plus block-diagonal terms, inside a block-Jacobi CG.

Every per-observation reduction is a segment sum over one of a few fixed
index vectors (keyframe ids, landmark ids, and for the dense solver the
(keyframe, landmark) pairs), summed thousands of times.  On the card each
is a binding of kernel #6 (``kernels/fit_cuda.seg_sum``, which replaces
``patchwork_tpu/kernels/seg_pallas.py:74``): one tile plan of its ids per
:func:`bundle_adjust` call (``fit_cuda.seg_plan``), then one launch of at
most eight rows per sum over that plan, in one fixed order and with no
float atomics, so two runs give the same bits.
:func:`bundle_adjust_sharded` keeps that: each rank sums its block of
observations over its own plans and the ranks' sums are added in rank
order (``parallel.mesh.ordered_sum``).  The JAX package's impl names stay:
``"onehot"`` (its accelerator route, the kernel here; the plain version on
the CPU), ``"sort"`` (its CPU route, a prefix sum over sorted
observations, kept for parity) and ``"scatter"`` (``index_add_``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import fit_cuda
from ..parallel.mesh import axis_index, axis_size, ordered_sum, \
    replicated_max_diff
from .se3 import se3_apply, se3_compose, se3_exp, se3_inverse

__all__ = ["BAProblem", "ba_residuals", "bundle_adjust",
           "bundle_adjust_sharded"]

_F32 = torch.float32
_CG_CHECK_EVERY = 16   # CG iterations between two reads of the stopping rule


class BAProblem(NamedTuple):
    poses: torch.Tensor    # (K, 4, 4) world_T_keyframe
    points: torch.Tensor   # (L, 3) landmark positions (world)
    obs_k: torch.Tensor    # (O,) int32 keyframe index
    obs_l: torch.Tensor    # (O,) int32 landmark index
    obs_p: torch.Tensor    # (O, 3) observed local coordinates
    obs_w: torch.Tensor    # (O,) observation weights (0 disables)

    @classmethod
    def from_numpy(cls, poses, points, obs_k, obs_l, obs_p, obs_w,
                   device=None) -> "BAProblem":
        """A problem from NumPy arrays, on the card unless ``device`` says
        otherwise."""
        dev = resolve_device(device)

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        def i32(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

        return cls(f32(poses), f32(points), i32(obs_k), i32(obs_l),
                   f32(obs_p), f32(obs_w))


def ba_residuals(poses, points, prob: BAProblem) -> torch.Tensor:
    """(O, 3) weighted residuals T_k^-1 X_l - p."""
    Tk = poses[prob.obs_k.long()]
    Xl = points[prob.obs_l.long()]
    local = se3_apply(se3_inverse(Tk), Xl[:, None, :])[:, 0, :]
    return (local - prob.obs_p) * prob.obs_w[:, None]


def _obs_blocks(poses, points, prob: BAProblem, jacobian: str = "analytic"):
    """Per-observation residual and Jacobian blocks (r (O, 3), Jp (O, 3, 6),
    Jx (O, 3, 3)).

    "analytic": the closed form of the right-perturbation residual: for
    T' = T exp(xi), xi = (v, omega), y = R^T (X - t): dr/dv = -w I,
    dr/domega = w [y]x, dr/dX = w R^T.  "jacfwd": ``torch.func.jacfwd``
    through se3_exp / compose / inverse / apply, the oracle.
    """
    Tk = poses[prob.obs_k.long()]
    Xl = points[prob.obs_l.long()]
    if jacobian == "jacfwd":
        from torch.func import jacfwd, vmap

        def res(xi, dx, Tk, Xl, p, w):
            T = se3_compose(Tk, se3_exp(xi))
            return (se3_apply(se3_inverse(T), (Xl + dx)[None, :])[0] - p) * w

        o = Tk.shape[0]
        z6 = torch.zeros((o, 6), dtype=_F32, device=Tk.device)
        z3 = torch.zeros((o, 3), dtype=_F32, device=Tk.device)
        args = (Tk, Xl, prob.obs_p, prob.obs_w)
        return (vmap(res)(z6, z3, *args),
                vmap(jacfwd(res, argnums=0))(z6, z3, *args),
                vmap(jacfwd(res, argnums=1))(z6, z3, *args))
    if jacobian != "analytic":
        raise ValueError(f"unknown jacobian {jacobian!r}")
    R = Tk[:, :3, :3]
    w = prob.obs_w[:, None]
    y = torch.einsum("oij,oi->oj", R, Xl - Tk[:, :3, 3])   # local coords
    r = (y - prob.obs_p) * w
    o = torch.zeros_like(y[:, 0])
    skew_y = torch.stack([
        torch.stack([o, -y[:, 2], y[:, 1]], dim=-1),
        torch.stack([y[:, 2], o, -y[:, 0]], dim=-1),
        torch.stack([-y[:, 1], y[:, 0], o], dim=-1),
    ], dim=-2)                                              # (O, 3, 3) [y]x
    eye = torch.eye(3, dtype=_F32, device=y.device).expand_as(skew_y)
    Jp = torch.cat([-eye, skew_y], dim=-1) * w[:, :, None]  # (O, 3, 6)
    Jx = R.transpose(-1, -2) * w[:, :, None]                # (O, 3, 3)
    return r, Jp, Jx


# ---------------------------------------------------------------------------
# segment sums over a fixed index vector
# ---------------------------------------------------------------------------

def _tile_rows(vals: torch.Tensor, width: int) -> torch.Tensor:
    """(O, ...) values -> (C, width) rows, zero beyond O: the segment-sum
    kernel's layout (channels as rows, observations padded to tiles)."""
    flat = vals.reshape(vals.shape[0], -1)
    rows = flat.new_zeros((flat.shape[1], width))
    rows[:, :flat.shape[0]] = flat.T
    return rows


def _make_seg_sums(idx: torch.Tensor, n: int,
                   impl: Optional[str] = None) -> Callable:
    """Segment-sum closure for a fixed index vector: (O, ...) -> (n, ...).

    * ``"onehot"`` (the card's default): kernel #6 over one plan of the ids
      (``fit_cuda.seg_plan`` of ids (1, O) int32, built here once), eight
      rows a launch, so a (O, 6, 6) block takes five launches; a fixed
      order, the same bits every run.  On the CPU its plain version.
    * ``"sort"`` (the CPU's default): sort once, then every sum is a gather,
      a prefix sum and two boundary gathers.  The global float32 prefix sum
      can cancel for large O with wide-magnitude values (kept for parity
      with the JAX package's CPU route, not for the card).
    * ``"scatter"``: ``index_add_`` (float atomics on the card, in no fixed
      order).
    """
    if impl is None:
        impl = "onehot" if idx.is_cuda else "sort"
    if impl == "scatter":
        lidx = idx.long()

        def seg_sum(vals):
            return vals.new_zeros((n,) + vals.shape[1:]).index_add_(0, lidx,
                                                                    vals)

        return seg_sum

    if impl == "onehot":
        ids = fit_cuda._pad_ids(idx.to(torch.int32)[None])   # (1, O padded)
        plan = fit_cuda.seg_plan(ids, n) if ids.is_cuda else None

        def seg_sum(vals):
            rows = _tile_rows(vals, ids.shape[1])
            out = torch.cat([
                fit_cuda.seg_sum(rows[c0:c0 + 8][None], ids, n, plan=plan)[0]
                for c0 in range(0, rows.shape[0], 8)])
            return out.T.reshape((n,) + vals.shape[1:]).contiguous()

        return seg_sum

    if impl != "sort":
        raise ValueError(f"unknown segment-sum impl {impl!r}")
    perm = torch.argsort(idx, stable=True)
    sorted_idx = idx[perm].contiguous()
    seg = torch.arange(n, dtype=idx.dtype, device=idx.device)
    starts = torch.searchsorted(sorted_idx, seg, side="left")
    ends = torch.searchsorted(sorted_idx, seg, side="right")

    def seg_sum(vals):
        v = vals[perm]
        c = torch.cat([v.new_zeros((1,) + v.shape[1:]), torch.cumsum(v, 0)])
        return c[ends] - c[starts]

    return seg_sum


class _Sums(NamedTuple):
    """The segment sums of one problem: over keyframes, over landmarks and,
    for the dense solver, over the distinct (keyframe, landmark) pairs
    (``kl_ids`` their flat ids k * L + l)."""
    k: Callable
    l: Callable
    kl: Optional[Callable] = None
    kl_ids: Optional[torch.Tensor] = None


def _ba_sums(prob: BAProblem, k: int, l: int, impl: Optional[str] = None,
             pairs: bool = False) -> _Sums:
    seg_k = _make_seg_sums(prob.obs_k, k, impl)
    seg_l = _make_seg_sums(prob.obs_l, l, impl)
    if not pairs:
        return _Sums(seg_k, seg_l)
    flat = prob.obs_k.long() * l + prob.obs_l.long()
    uniq, inv = torch.unique(flat, return_inverse=True)
    return _Sums(seg_k, seg_l,
                 _make_seg_sums(inv.to(torch.int32), uniq.numel(), impl),
                 uniq)


def _outer(a, b):
    """(O, 3, I), (O, 3, J) -> (O, I, J): sum over the residual's rows."""
    return torch.einsum("oai,oaj->oij", a, b)


def _partial_normal_eqs(poses, points, prob: BAProblem, k: int, l: int,
                        sums: Optional[_Sums] = None,
                        jacobian: str = "analytic"):
    """Assemble (A (K,6,6), B (K,6,L,3), C (L,3,3), ba (K,6), bx (L,3))."""
    if sums is None or sums.kl is None:
        sums = _ba_sums(prob, k, l, pairs=True)
    r, Jp, Jx = _obs_blocks(poses, points, prob, jacobian)
    A = sums.k(_outer(Jp, Jp))
    C = sums.l(_outer(Jx, Jx))
    B = torch.zeros((k * l, 6, 3), dtype=_F32, device=poses.device)
    B[sums.kl_ids] = sums.kl(_outer(Jp, Jx))
    B = B.reshape(k, l, 6, 3).permute(0, 2, 1, 3)
    ba = sums.k(torch.einsum("oai,oa->oi", Jp, r))
    bx = sums.l(torch.einsum("oai,oa->oi", Jx, r))
    return A, B, C, ba, bx


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det), branch-free."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * (1.0 / det)[..., None, None]


def _inv6x6(m: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 inverse by the 2x2-of-3x3 block Schur complement, each
    sub-inverse :func:`_inv3x3` (the PD pose blocks this solver inverts)."""
    P, Q = m[..., :3, :3], m[..., :3, 3:]
    R, S = m[..., 3:, :3], m[..., 3:, 3:]
    Pi = _inv3x3(P)
    RPi = R @ Pi
    Di = _inv3x3(S - RPi @ Q)
    PiQ = Pi @ Q
    top = torch.cat([Pi + PiQ @ Di @ RPi, -PiQ @ Di], dim=-1)
    bot = torch.cat([-Di @ RPi, Di], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _batched_inv(m: torch.Tensor, inv: str = "closed") -> torch.Tensor:
    """Batched small-matrix inverse of (..., 3, 3) or (..., 6, 6):
    "closed" (straight-line code) or "lapack" (``torch.linalg.inv_ex``)."""
    if inv == "lapack":
        return torch.linalg.inv_ex(m)[0]
    if inv != "closed":
        raise ValueError(f"unknown inverse {inv!r}")
    return _inv3x3(m) if m.shape[-1] == 3 else _inv6x6(m)


def _schur_solve(A, B, C, ba, bx, k, l, damping, anchor_weight,
                 inv: str = "closed"):
    """Eliminate landmarks, solve the reduced pose system, back-substitute."""
    dev = A.device
    C_inv = _batched_inv(C + damping * torch.eye(3, dtype=_F32, device=dev),
                         inv)
    BCi = torch.einsum("kilc,lcd->kild", B, C_inv)
    # S = A_dense - B C^-1 B^T over the pose-pair structure
    S = -(BCi.reshape(6 * k, 3 * l) @ B.reshape(6 * k, 3 * l).T)
    S = S.reshape(k, 6, k, 6)
    ar = torch.arange(k, device=dev)
    S[ar, :, ar, :] += A
    rhs = ba - torch.einsum("kild,ld->ki", BCi, bx)
    S = S.reshape(6 * k, 6 * k)
    diag = torch.full((6 * k,), damping, dtype=_F32, device=dev)
    diag[:6] += anchor_weight
    S = S + torch.diag(diag)
    dp = -torch.linalg.solve_ex(S, rhs.reshape(6 * k))[0].reshape(k, 6)
    # back-substitute landmarks: dx = -C^-1 (bx + B^T dp)
    bTdp = torch.einsum("kild,ki->ld", B, dp)
    dx = -torch.einsum("lcd,ld->lc", C_inv, bx + bTdp)
    return dp, dx


def _w_v(W: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W (O, 6, 3), v (O, 6) -> W^T v (O, 3)."""
    return (W * v[:, :, None]).sum(1)


def _w_z(W: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """W (O, 6, 3), z (O, 3) -> W z (O, 6)."""
    return (W * z[:, None, :]).sum(2)


def _pcg(hvp: Callable, prec: Callable, b: torch.Tensor, cg_iters: int,
         cg_tol: float) -> torch.Tensor:
    """Preconditioned CG for H x = b from x = 0, H applied by ``hvp``.

    Stops once |r|^2 <= cg_tol^2 |b|^2 or after ``cg_iters`` iterations.
    The rule is read on the host every ``_CG_CHECK_EVERY`` iterations, not
    every one: in between, each quantity is frozen by ``torch.where`` from
    the first iteration that meets it, so the result is the one of stopping
    there.  A solve of n iterations reads it 1 + ceil(n / 16) times.
    """
    tol2 = cg_tol ** 2 * torch.clamp((b * b).sum(), min=1e-30)
    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = (r * z).sum()
    live = (r * r).sum() > tol2
    for it in range(cg_iters):
        if it % _CG_CHECK_EVERY == 0 and not bool(live):
            break
        hp = hvp(p)
        alpha = rz / torch.clamp((p * hp).sum(), min=1e-30)
        r_n = r - alpha * hp
        z_n = prec(r_n)
        rz_n = (r_n * z_n).sum()
        p_n = z_n + (rz_n / torch.clamp(rz, min=1e-30)) * p
        x = torch.where(live, x + alpha * p, x)
        r = torch.where(live, r_n, r)
        z = torch.where(live, z_n, z)
        p = torch.where(live, p_n, p)
        rz = torch.where(live, rz_n, rz)
        live = live & ((r * r).sum() > tol2)
    return x


def _schur_pcg_step(poses, points, prob: BAProblem, k, l, damping,
                    anchor_weight, cg_iters, cg_tol,
                    sums: Optional[_Sums] = None, jacobian: str = "analytic",
                    inv: str = "closed"):
    """One Gauss-Newton step with the reduced pose system solved by
    matrix-free preconditioned CG (:func:`_pcg`): nothing of size O(K L) is
    formed; every product S v is two segment sums over the observations
    plus the block-diagonal terms."""
    if sums is None:
        sums = _ba_sums(prob, k, l)
    dev = poses.device
    r, Jp, Jx = _obs_blocks(poses, points, prob, jacobian)
    ok_, ol_ = prob.obs_k.long(), prob.obs_l.long()
    eye3 = torch.eye(3, dtype=_F32, device=dev)
    eye6 = torch.eye(6, dtype=_F32, device=dev)

    A = sums.k(_outer(Jp, Jp))
    C = sums.l(_outer(Jx, Jx))
    C_inv = _batched_inv(C + damping * eye3, inv)
    W = _outer(Jp, Jx)                                          # (O, 6, 3)
    ba = sums.k(torch.einsum("oai,oa->oi", Jp, r))
    bx = sums.l(torch.einsum("oai,oa->oi", Jx, r))
    cb = torch.einsum("lcd,ld->lc", C_inv, bx)
    rhs = ba - sums.k(_w_z(W, cb[ol_]))
    anchor = torch.zeros((k,), dtype=_F32, device=dev)
    anchor[0] = anchor_weight

    def hvp(v):  # v (K, 6) -> S v, never forming S
        av = (torch.einsum("kij,kj->ki", A, v) + damping * v
              + anchor[:, None] * v)
        z = torch.einsum("lcd,ld->lc", C_inv, sums.l(_w_v(W, v[ok_])))
        return av - sums.k(_w_z(W, z[ol_]))

    # block-Jacobi preconditioner from the (always PD) A + damping + anchor
    M_inv = _batched_inv(A + (damping + anchor[:, None, None]) * eye6, inv)

    def prec(res):
        return torch.einsum("kij,kj->ki", M_inv, res)

    dp = -_pcg(hvp, prec, rhs, cg_iters, cg_tol)
    y = sums.l(_w_v(W, dp[ok_]))
    dx = -torch.einsum("lcd,ld->lc", C_inv, bx + y)
    return dp, dx


# dense-B block budget: above this many (pose, landmark) cells -> PCG
_DENSE_KL_LIMIT = 1_000_000
# dense reduced-solve budget: the (6K, 6K) factorization is O((6K)^3)
_DENSE_K_LIMIT = 256


def _auto_solver(k: int, l: int) -> str:
    return ("dense" if k * l <= _DENSE_KL_LIMIT and k <= _DENSE_K_LIMIT
            else "pcg")


def bundle_adjust(
    prob: BAProblem,
    iters: int = 8,
    damping: float = 1e-4,
    anchor_weight: float = 1e6,
    solver: str | None = None,
    cg_iters: int | None = None,
    cg_tol: float = 1e-6,
    seg_impl: str | None = None,
    jacobian: str = "analytic",
    inv: str = "closed",
) -> BAProblem:
    """Single-device Schur-complement Gauss-Newton BA, on the device of
    ``prob``.

    solver: "dense" (explicit B and S, direct solve), "pcg" (matrix-free
    Schur products and block-Jacobi CG, O(observations) memory), or None to
    choose by the K*L block count and K.  ``seg_impl`` picks the segment
    sums (:func:`_make_seg_sums`; None: by device); their plans are built
    once here and serve every step.
    """
    k = prob.poses.shape[0]
    l = prob.points.shape[0]
    if solver is None:
        solver = _auto_solver(k, l)
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    if cg_iters is None:
        cg_iters = min(max(128, k), 2048)
    sums = _ba_sums(prob, k, l, seg_impl, pairs=solver == "dense")
    poses, points = prob.poses, prob.points
    for _ in range(iters):
        if solver == "dense":
            A, B, C, ba, bx = _partial_normal_eqs(poses, points, prob, k, l,
                                                  sums, jacobian)
            dp, dx = _schur_solve(A, B, C, ba, bx, k, l, damping,
                                  anchor_weight, inv)
        else:
            dp, dx = _schur_pcg_step(poses, points, prob, k, l, damping,
                                     anchor_weight, cg_iters, cg_tol, sums,
                                     jacobian, inv)
        poses = se3_compose(poses, se3_exp(dp))
        points = points + dx
    return prob._replace(poses=poses, points=points)


def _summed_over(seg_sum: Callable, group) -> Callable:
    """A rank's segment sum, then the ranks' sums added in rank order."""
    return lambda vals: ordered_sum(seg_sum(vals), group)


def bundle_adjust_sharded(
    prob: BAProblem,
    mesh,
    axis: str = "dp",
    iters: int = 8,
    damping: float = 1e-4,
    anchor_weight: float = 1e6,
    solver: str | None = None,
    cg_iters: int | None = None,
    cg_tol: float = 1e-6,
) -> BAProblem:
    """Distributed BA (ba.py:452-514 of the JAX package): ``prob``, the same
    on every rank, has its observations split over the ranks of ``axis``,
    each rank taking a contiguous block of O/W; every per-observation sum is
    the rank's sum over its block (kernel #6 over the rank's plans on the
    card), then :func:`..parallel.mesh.ordered_sum` over the axis; the
    reduced solve is replicated on every rank.  O must divide by the axis
    size (pad with obs_w = 0, as ``build_ba_problem`` does).

    solver follows :func:`bundle_adjust`: "dense" sums the explicit blocks
    (A, B, C, ba, bx), "pcg" every reduction inside the matrix-free CG (a
    (K, 6) and an (L, 3) block a product), None chooses.  Raises unless the
    poses and points come out with the same bits on every rank."""
    k = prob.poses.shape[0]
    l = prob.points.shape[0]
    if solver is None:
        solver = _auto_solver(k, l)
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    if cg_iters is None:
        cg_iters = min(max(128, k), 2048)
    w = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    o = prob.obs_k.shape[0]
    if o % w:
        raise ValueError(f"{o} observations do not divide over {w} ranks of "
                         f"{axis!r}: pad with obs_w = 0")
    lo = axis_index(mesh, axis) * (o // w)
    hi = lo + o // w
    block = prob._replace(obs_k=prob.obs_k[lo:hi], obs_l=prob.obs_l[lo:hi],
                          obs_p=prob.obs_p[lo:hi], obs_w=prob.obs_w[lo:hi])
    local = _ba_sums(block, k, l)
    sums = _Sums(_summed_over(local.k, group), _summed_over(local.l, group))
    if solver == "dense":
        # the pairs of the whole problem, so every rank's sums line up
        flat = prob.obs_k.long() * l + prob.obs_l.long()
        uniq, inv = torch.unique(flat, return_inverse=True)
        pairs = _make_seg_sums(inv[lo:hi].to(torch.int32), uniq.numel())
        sums = sums._replace(kl=_summed_over(pairs, group), kl_ids=uniq)
    poses, points = prob.poses, prob.points
    for _ in range(iters):
        if solver == "dense":
            A, B, C, ba, bx = _partial_normal_eqs(poses, points, block, k, l,
                                                  sums)
            dp, dx = _schur_solve(A, B, C, ba, bx, k, l, damping,
                                  anchor_weight)
        else:
            dp, dx = _schur_pcg_step(poses, points, block, k, l, damping,
                                     anchor_weight, cg_iters, cg_tol, sums)
        poses = se3_compose(poses, se3_exp(dp))
        points = points + dx
    for name, t in (("poses", poses), ("points", points)):
        diff = replicated_max_diff(t, group)
        if diff != 0.0:
            raise RuntimeError(f"bundle_adjust_sharded: the {name} differ "
                               f"between ranks by {diff}")
    return prob._replace(poses=poses, points=points)
