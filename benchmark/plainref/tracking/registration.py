"""Frozen copy of esvo_tpu_torch/tracking/registration.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

6-DoF camera tracking (port of esvo_tpu/tracking/registration.py).

The tracker registers the local map to the current negative time surface:
a Cayley-parameterized increment around (R, t) = T_ref_left, residuals
bilinearly sampled from 255 - blurred TS at the reprojections (255 where
a reprojection leaves the image or the valid-pixel mask), Huber IRLS
weights, the analytical Jacobian of the raw residual at x = 0 from the
Sobel gradients (or forward-mode autodiff for patches larger than 1x1),
and MAX_ITERATION one-step LM rounds over rotating batches of the point
set with accept / reject and damping x0.3 / x5.

``solve`` dispatches. On CUDA tensors with the analytic Jacobian in
float32 (every preset) the whole scan is one launch of kernel K4
(ops/track.py, csrc/track.cu). On CPU tensors it runs the plain twin
``solve_plain``; the numerical Jacobian (``use_numerical_diff`` or a
patch larger than 1x1) and dtypes other than float32 take
``solve_plain`` on every device, by configuration.

Every product is a full float32 product: ``solve_plain`` runs under
utils/precision.py's ``highest_precision`` guard, which turns TF32 off for
matmul (``torch.backends.cuda.matmul.allow_tf32 == False``) whatever the
caller set with ``torch.set_float32_matmul_precision``, and puts the
caller's setting back afterwards; it does not rely on PyTorch's default.
``solve_plain`` is a Python loop over the rounds whose body has fixed
shapes, no host sync and no data-dependent Python branch, so that a CUDA
graph can capture it; so is K4's launch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from plainref._device import constant
from plainref.geometry.camera import Camera
from plainref.geometry.se3 import (cayley_to_rot,
                                         orthonormalize_rotation_fast,
                                         se3_inverse)
from plainref.ops.interp import gather2d, patch_interpolate
from plainref.ops.linalg import solve_spd
from plainref.surface.time_surface import (gaussian_blur, sobel_x,
                                                 sobel_y)


@dataclass(frozen=True)
class RegProblemConfig:
    """Defaults from cfg/tracking/tracking_rpg.yaml. The analytical
    Jacobian needs 1x1 patches; use_numerical_diff (or a larger patch)
    takes the autodiff Jacobian."""
    patch_size_x: int = 1
    patch_size_y: int = 1
    kernel_size: int = 5
    huber_threshold: float = 50.0
    max_registration_points: int = 2000
    batch_size: int = 300
    max_iteration: int = 10
    ls_norm: str = "Huber"
    min_num_events: int = 1000
    lm_damping: float = 1e-3
    use_numerical_diff: bool = False


@dataclass
class RegProblem:
    """Map points in the ref frame + the current negative TS."""
    R: torch.Tensor            # (3, 3) rotation of T_ref_left
    t: torch.Tensor            # (3,)   translation of T_ref_left
    T_world_ref: torch.Tensor  # (4, 4)
    points: torch.Tensor       # (M, 3) map points in the ref camera frame
    point_valid: torch.Tensor  # (M,) bool
    ts_negative: torch.Tensor  # (H, W) 255 - blurred TS
    grad_u: torch.Tensor       # (H, W) Sobel d/du of ts_negative
    grad_v: torch.Tensor       # (H, W)

    def replace(self, **kw) -> "RegProblem":
        return replace(self, **kw)


def negative_time_surface(ts_left: torch.Tensor, kernel_size: int):
    """255 - (optionally Gaussian-blurred) TS and its Sobel gradients."""
    blurred = gaussian_blur(ts_left, kernel_size) if kernel_size > 0 \
        else ts_left
    neg = 255.0 - blurred
    return neg, sobel_x(neg), sobel_y(neg)


def make_problem(T_world_ref: torch.Tensor, T_world_cur: torch.Tensor,
                 points_world: torch.Tensor, point_valid: torch.Tensor,
                 ts_left: torch.Tensor, cfg: RegProblemConfig) -> RegProblem:
    """Assemble the problem. points_world: (M, 3) map points in world
    coordinates, already selected by the caller. T_ref_left comes from
    the rigid inverse of T_world_ref (the JAX package solves the 4x4
    system; the two agree to rounding on rigid poses)."""
    T_ref_left = torch.matmul(se3_inverse(T_world_ref), T_world_cur)
    Rwr = T_world_ref[:3, :3]
    twr = T_world_ref[:3, 3]
    p_ref = torch.einsum("ji,nj->ni", Rwr, points_world - twr)
    neg, gu, gv = negative_time_surface(ts_left, cfg.kernel_size)
    return RegProblem(R=T_ref_left[:3, :3], t=T_ref_left[:3, 3],
                      T_world_ref=T_world_ref, points=p_ref,
                      point_valid=point_valid, ts_negative=neg, grad_u=gu,
                      grad_v=gv)


def warping_transformation(R: torch.Tensor, t: torch.Tensor,
                           x: torch.Tensor):
    """T_cur_ref from the 6-vector increment x = (cayley, dt)."""
    dR = cayley_to_rot(x[:3])
    R_cur_ref = orthonormalize_rotation_fast(torch.matmul(R.T, dR.T))
    t_cur_ref = -torch.matmul(R_cur_ref, x[3:] + torch.matmul(dR, t))
    return R_cur_ref, t_cur_ref


def _project_and_check(p_left: torch.Tensor, camera: Camera,
                       cfg: RegProblemConfig):
    """Pinhole projection + the patch-validity test (image bounds, depth,
    the valid-pixel mask at the patch corners)."""
    P = camera.params.P
    W, H = camera.width, camera.height
    h = torch.einsum("ij,nj->ni", P[:, :3], p_left) + P[:, 3]
    x1 = h[:, :2] / h[:, 2:3]
    hx = (cfg.patch_size_x - 1) // 2
    hy = (cfg.patch_size_y - 1) // 2
    u, v = x1[:, 0], x1[:, 1]
    ok = (u >= hx) & (u <= W - hx - 1) & (v >= hy) & (v <= H - hy - 1) \
        & (h[:, 2] > 1e-9)
    ui = torch.clamp(torch.floor(u).to(torch.int32), 0, W - 1)
    vi = torch.clamp(torch.floor(v).to(torch.int32), 0, H - 1)
    for dy in sorted({-hy, hy}):
        for dx in sorted({-hx, hx}):
            ok = ok & gather2d(camera.mask, torch.clamp(vi + dy, 0, H - 1),
                               torch.clamp(ui + dx, 0, W - 1))
    return x1, ok


def residuals_and_weights(prob: RegProblem, x: torch.Tensor,
                          points: torch.Tensor, valid: torch.Tensor,
                          camera: Camera, cfg: RegProblemConfig):
    """Weighted residuals over a point batch. Returns (fvec (B, P), raw
    residual (B, P), reprojection ok (B,))."""
    Rw, tw = warping_transformation(prob.R, prob.t, x)
    p_left = torch.einsum("ij,nj->ni", Rw, points) + tw
    x1, ok = _project_and_check(p_left, camera, cfg)
    patch, ok_p = patch_interpolate(prob.ts_negative, x1, cfg.patch_size_y,
                                    cfg.patch_size_x)
    ok = ok & ok_p & valid
    r = torch.where(ok[:, None], patch.reshape(patch.shape[0], -1), 255.0)
    if cfg.ls_norm == "Huber":
        w = torch.where(r > cfg.huber_threshold,
                        cfg.huber_threshold / torch.clamp(r, min=1e-12), 1.0)
        return torch.sqrt(w) * r, r, ok
    return r, r, ok


def analytic_jacobian(prob: RegProblem, points: torch.Tensor,
                      valid: torch.Tensor, camera: Camera,
                      cfg: RegProblemConfig) -> torch.Tensor:
    """Jacobian (B, 6) of the raw residual at x = 0, 1x1 patches only: at
    x = 0 the warp is p_left = R^T (p - t), d p_left / dc_k = 2 R^T [p]x
    e_k and d p_left / dt = -R^T; the TS gradient is the Sobel image
    sampled bilinearly and divided by 8."""
    if cfg.patch_size_x != 1 or cfg.patch_size_y != 1:
        raise ValueError("the analytic Jacobian takes 1x1 patches; use "
                         "numerical_jacobian")
    P = camera.params.P
    Rt = prob.R.T
    p_left = torch.einsum("ij,nj->ni", Rt, points - prob.t)
    x1, ok = _project_and_check(p_left, camera, cfg)
    gu, _ = patch_interpolate(prob.grad_u, x1, 1, 1)
    gv, okg = patch_interpolate(prob.grad_v, x1, 1, 1)
    grad = torch.stack([gu[..., 0, 0], gv[..., 0, 0]], dim=-1) / 8.0
    ok = ok & okg & valid

    z = p_left[:, 2]
    z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    u_num = P[0, 0] * p_left[:, 0] + P[0, 1] * p_left[:, 1] + P[0, 3]
    v_num = P[1, 0] * p_left[:, 0] + P[1, 1] * p_left[:, 1] + P[1, 3]
    dPi = torch.stack([
        torch.stack([P[0, 0] / z, P[0, 1] / z, -u_num / (z * z)], dim=-1),
        torch.stack([P[1, 0] / z, P[1, 1] / z, -v_num / (z * z)], dim=-1),
    ], dim=-2)                                       # (B, 2, 3)
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    zero = torch.zeros_like(px)
    cross = torch.stack([
        torch.stack([zero, -pz, py], dim=-1),
        torch.stack([pz, zero, -px], dim=-1),
        torch.stack([-py, px, zero], dim=-1),
    ], dim=-2)                                       # (B, 3, 3) = [p]x
    dp_dc = 2.0 * torch.einsum("ij,njk->nik", Rt, cross)
    dp_dt = -Rt.expand(dp_dc.shape)
    dp_dx = torch.cat([dp_dc, dp_dt], dim=-1)        # (B, 3, 6)
    J = torch.einsum("ni,nij,njk->nk", grad, dPi, dp_dx)
    return torch.where(ok[:, None], J, torch.zeros_like(J))


def numerical_jacobian(prob: RegProblem, points: torch.Tensor,
                       valid: torch.Tensor, camera: Camera,
                       cfg: RegProblemConfig) -> torch.Tensor:
    """Jacobian (B * P, 6) of the raw residual at x = 0 for any patch
    size: forward-mode autodiff through the bilinear sampler (the exact
    in-cell derivative that central differences estimate). Invalid
    reprojections give zero rows (their residual is the 255 sentinel)."""
    def raw(x):
        return residuals_and_weights(prob, x, points, valid, camera, cfg)[1]

    x0 = torch.zeros(6, dtype=prob.R.dtype, device=prob.R.device)
    return torch.func.jacfwd(raw)(x0).reshape(-1, 6)


def add_motion_update(R: torch.Tensor, t: torch.Tensor, dx: torch.Tensor):
    """Fold an increment into (R, t)."""
    dR = cayley_to_rot(dx[:3])
    return (orthonormalize_rotation_fast(torch.matmul(dR, R)),
            dx[3:] + torch.matmul(dR, t))


def pose_of(prob: RegProblem) -> torch.Tensor:
    """T_world_cur from the current (R, t)."""
    Rwr = prob.T_world_ref[:3, :3]
    twr = prob.T_world_ref[:3, 3]
    T = torch.eye(4, dtype=prob.R.dtype, device=prob.R.device)
    T[:3, :3] = torch.matmul(Rwr, prob.R)
    T[:3, 3] = torch.matmul(Rwr, prob.t) + twr
    return T


def solve(prob: RegProblem, camera: Camera, cfg: RegProblemConfig):
    """MAX_ITERATION one-step LM rounds over rotating point batches, as
    ``solve_plain`` runs them: kernel K4 on CUDA tensors with the
    analytic Jacobian in float32, ``solve_plain`` on CPU tensors. The
    numerical Jacobian and dtypes other than float32 take ``solve_plain``
    on every device (a choice by configuration, not a fallback: a CUDA
    tensor that K4 refuses raises). K4 sums in another order than the
    twin's matmuls, so the two agree to float32 rounding and may take
    different sides of a near-tied accept test."""
    return solve_plain(prob, camera, cfg)


def solve_plain(prob: RegProblem, camera: Camera, cfg: RegProblemConfig):
    """MAX_ITERATION one-step LM rounds over rotating point batches.

    Returns (problem with the final R / t, T_world_cur, rms
    (max_iteration,)): rms[i] is the root-mean-square raw residual of
    round i's batch over its valid reprojections, after the update when
    the round accepted it. The accept test ``cost_try < cost`` compares
    two float32 sums, so on a near-tie the device and the CPU may take
    different sides."""
    M = prob.points.shape[0]
    B = min(cfg.batch_size, M)
    num_batches = max(M // cfg.batch_size, 1)
    dtype, dev = prob.R.dtype, prob.R.device
    numerical = cfg.use_numerical_diff \
        or cfg.patch_size_x * cfg.patch_size_y > 1
    zero6 = torch.zeros(6, dtype=dtype, device=dev)
    eps_eye = 1e-12 * torch.eye(6, dtype=dtype, device=dev)

    def batch_cost(R, t, pts, val):
        fvec, r, ok = residuals_and_weights(prob.replace(R=R, t=t), zero6,
                                            pts, val, camera, cfg)
        f = fvec.reshape(-1)
        n_res = torch.clamp(torch.sum(ok) * r.shape[1], min=1)
        rms = torch.sqrt(torch.sum(torch.where(ok[:, None], r * r, 0.0))
                         / n_res)
        return f, torch.sum(f * f), rms

    R, t = prob.R, prob.t
    lam = constant(cfg.lm_damping, dtype, dev)
    rms_rounds = []
    for it in range(cfg.max_iteration):
        # the batch start is a Python int: the same slices every call
        start = min((it % num_batches) * cfg.batch_size, M - B)
        pts = prob.points[start:start + B]
        val = prob.point_valid[start:start + B]
        f, cost, rms_cur = batch_cost(R, t, pts, val)
        p = prob.replace(R=R, t=t)
        J = (numerical_jacobian if numerical else analytic_jacobian)(
            p, pts, val, camera, cfg)
        g = torch.matmul(J.T, f)
        H = torch.matmul(J.T, J)
        dx = -solve_spd(H + (lam * torch.diag(torch.diag(H)) + eps_eye), g)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        R_try, t_try = add_motion_update(R, t, dx)
        _, cost_try, rms_try = batch_cost(R_try, t_try, pts, val)
        accept = cost_try < cost
        R = torch.where(accept, R_try, R)
        t = torch.where(accept, t_try, t)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-9, 1e6)
        rms_rounds.append(torch.where(accept, rms_try, rms_cur))
    prob = prob.replace(R=R, t=t)
    return prob, pose_of(prob), torch.stack(rms_rounds)
