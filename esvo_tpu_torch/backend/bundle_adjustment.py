"""Local bundle adjustment with Schur-complement reduction (port of
esvo_tpu/backend/bundle_adjustment.py).

  min over poses {T_k} and points {p_i} of
     sum_obs rho( pi(T_k^-1 p_i) - uv_obs )

- every observation's 2-vector residual and its (2x6) pose and (2x3)
  point Jacobians in one batched expression (analytic);
- the normal equations reduced by the Schur complement: point blocks C_i
  (3x3) inverted in closed form (batched adjugate), the reduced camera
  system S = B - E C^-1 E^T assembled with segment sums over
  observations (``ops.linalg.segment_sum``), and only the (6K x 6K) pose
  system solved densely;
- points back-substituted in parallel;
- Huber IRLS on the reprojection residual, a fixed trip count with
  per-iteration accept / reject damping (Levenberg-Marquardt), no host
  sync inside the loop.

With a process group (``group=``) the observation axis is sharded over
its ranks (parallel/sharding.py): every segment sum and cost sum is
all-reduced, JAX's psum sites; poses and points stay replicated.

Pose increments are Cayley + translation around the current estimate,
matching the tracker. Every solve runs under ``highest_precision``. The
segment sums add in another order on the card than on the CPU, so a card
run matches the CPU to rounding, not bit for bit (and repeats itself).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from esvo_tpu_torch.geometry.se3 import cayley_to_rot, orthonormalize_rotation
from esvo_tpu_torch.ops.linalg import psum, segment_sum, solve_or_nan
from esvo_tpu_torch.utils.precision import highest_precision


@dataclass(frozen=True)
class BAConfig:
    max_iterations: int = 10
    huber_threshold: float = 2.0
    damping: float = 1e-4
    # gauge fixing: keep the first `num_fixed_poses` keyframes constant
    num_fixed_poses: int = 1


@dataclass
class BAProblem:
    """K keyframes, P points, M observations (fixed capacity, masked)."""
    T_world_kf: torch.Tensor   # (K, 4, 4) keyframe poses
    points: torch.Tensor       # (P, 3) world-space points
    obs_kf: torch.Tensor       # (M,) int64 keyframe index per observation
    obs_point: torch.Tensor    # (M,) int64 point index per observation
    obs_uv: torch.Tensor       # (M, 2) measured pixel
    obs_valid: torch.Tensor    # (M,) bool
    fx: torch.Tensor           # 0-d intrinsics of the rectified camera
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    def replace(self, **kw) -> "BAProblem":
        return replace(self, **kw)


def _inv3_batched(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) closed-form inverses (the adjugate over the
    determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * co[..., 0, 0] + b * co[..., 0, 1] + c * co[..., 0, 2]
    # note: co as built is the adjugate already (transposed cofactors)
    return co / det[..., None, None]


@highest_precision()
def reprojection_residuals(prob: BAProblem):
    """(M, 2) residuals + per-observation Jacobians.

    Returns (r (M,2), Jc (M,2,6) wrt the obs's keyframe increment,
    Jp (M,2,3) wrt the obs's point, valid (M,)). The tracker's chain
    (p_cam = R^T (p - t); d p_cam/dc_k = -2 R^T [e_k]x p,
    d p_cam/dt = -R^T), with d p_cam / d p = R^T for the point."""
    T = prob.T_world_kf[prob.obs_kf]          # (M, 4, 4)
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    p = prob.points[prob.obs_point]           # (M, 3)
    pc = torch.einsum("nji,nj->ni", R, p - t)   # R^T (p - t)
    z = pc[:, 2]
    ok = prob.obs_valid & (z > 1e-6)
    zs = torch.where(torch.abs(z) > 1e-6, z, 1e-6)
    u = prob.fx * pc[:, 0] / zs + prob.cx
    v = prob.fy * pc[:, 1] / zs + prob.cy
    r = torch.stack([u, v], dim=1) - prob.obs_uv

    zero = torch.zeros_like(z)
    fx = prob.fx.expand_as(z)
    fy = prob.fy.expand_as(z)
    dPi = torch.stack([
        torch.stack([fx / zs, zero, -fx * pc[:, 0] / zs ** 2], -1),
        torch.stack([zero, fy / zs, -fy * pc[:, 1] / zs ** 2], -1),
    ], -2)                                     # (M, 2, 3)

    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    cross = torch.stack([
        torch.stack([zero, -pz, py], -1),
        torch.stack([pz, zero, -px], -1),
        torch.stack([-py, px, zero], -1),
    ], -2)                                     # (M, 3, 3) = [p]x
    Rt = R.transpose(1, 2)
    dpc_dc = 2.0 * torch.einsum("nij,njk->nik", Rt, cross)   # (M, 3, 3)
    dpc_dx = torch.cat([dpc_dc, -Rt], dim=-1)                # (M, 3, 6)

    Jc = torch.einsum("nij,njk->nik", dPi, dpc_dx)           # (M, 2, 6)
    Jp = torch.einsum("nij,njk->nik", dPi, Rt)               # (M, 2, 3)
    mask = ok[:, None]
    return torch.where(mask, r, 0.0), \
        torch.where(mask[..., None], Jc, 0.0), \
        torch.where(mask[..., None], Jp, 0.0), ok


def _huber_weights(r: torch.Tensor, ok: torch.Tensor, cfg: BAConfig):
    """(weights (M,), residual norms (M,)) of the Huber IRLS."""
    rn = torch.linalg.vector_norm(r, dim=1)
    w = torch.where(rn > cfg.huber_threshold,
                    cfg.huber_threshold / torch.clamp(rn, min=1e-12), 1.0)
    return torch.where(ok, w, 0.0), rn


@highest_precision()
def assemble_normal_equations(prob: BAProblem, cfg: BAConfig, group=None):
    """Weighted GN normal-equation blocks via segment sums.

    Returns (B (K,6,6), C (P,3,3), gc (K,6), gp (P,3), E_obs (M,6,3),
    cost): observation-indexed, the dense per-(point, keyframe) cross
    tensor (P, K, 6, 3) is never materialized. With `group` the
    observations are this rank's block and every sum is all-reduced
    (E_obs stays the rank's own)."""
    K = prob.T_world_kf.shape[0]
    P = prob.points.shape[0]
    r, Jc, Jp, ok = reprojection_residuals(prob)
    w, rn = _huber_weights(r, ok, cfg)
    cost = psum(torch.sum(w * rn * rn), group)

    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    B = psum(segment_sum(torch.einsum("nij,nik->njk", wJc, Jc),
                         prob.obs_kf, K), group)
    C = psum(segment_sum(torch.einsum("nij,nik->njk", wJp, Jp),
                         prob.obs_point, P), group)
    gc = psum(segment_sum(torch.einsum("nij,ni->nj", wJc, r), prob.obs_kf,
                          K), group)
    gp = psum(segment_sum(torch.einsum("nij,ni->nj", wJp, r),
                          prob.obs_point, P), group)
    E_obs = torch.einsum("nij,nik->njk", wJc, Jp)          # (M, 6, 3)
    return B, C, gc, gp, E_obs, cost


@highest_precision()
def _gn_step(prob: BAProblem, cfg: BAConfig, lam: torch.Tensor,
             group=None):
    """One damped Schur-complement GN step. Returns (dx_poses (K,6),
    dpoints (P,3), cost).

    The Schur cross-term S_{kl} = sum_p E_{p,k} C_p^-1 E_{p,l}^T is built
    one keyframe column at a time with segment sums over observations,
    so memory is O(M + P + K^2)."""
    K = prob.T_world_kf.shape[0]
    P = prob.points.shape[0]
    dtype, dev = prob.points.dtype, prob.points.device
    B, C, gc, gp, E_obs, cost = assemble_normal_equations(prob, cfg,
                                                          group)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    # LM damping on the diagonals
    B = B + lam * eye6[None] * B + 1e-8 * eye6
    C = C + lam * eye3[None] * C + 1e-8 * eye3
    Cinv = _inv3_batched(C)                              # (P, 3, 3)

    # F_n = E_obs_n C_{p(n)}^-1
    F = torch.einsum("nab,nbc->nac", E_obs, Cinv[prob.obs_point])

    # Schur cross-term, one keyframe column at a time:
    # S_{kl} = sum_n [kf(n)=k] F_n A_{p(n),l}^T with
    # A_{p,l} = sum_{m: point(m)=p, kf(m)=l} E_obs_m
    cols = []
    for l in range(K):
        sel = (prob.obs_kf == l)[:, None, None]
        A = psum(segment_sum(torch.where(sel, E_obs, 0.0), prob.obs_point,
                             P), group)
        contrib = torch.einsum("nab,ncb->nac", F, A[prob.obs_point])
        cols.append(psum(segment_sum(contrib, prob.obs_kf, K), group))
    S_blocks = -torch.stack(cols, dim=1)                 # (k, l, 6, 6)
    diag = torch.arange(K, device=dev)
    S_blocks[diag, diag] += B
    # reduced gradient: g_k = gc_k - sum_n [kf(n)=k] F_n gp_{p(n)}
    g_red = gc - psum(segment_sum(
        torch.einsum("nab,nb->na", F, gp[prob.obs_point]), prob.obs_kf, K),
        group)

    # gauge fixing: freeze the first num_fixed_poses keyframes
    fixed_rows = (torch.arange(K * 6, device=dev) // 6) < cfg.num_fixed_poses
    S_mat = S_blocks.transpose(1, 2).reshape(K * 6, K * 6)
    S_mat = torch.where(fixed_rows[:, None] | fixed_rows[None, :], 0.0,
                        S_mat)
    S_mat = S_mat + torch.diag(fixed_rows.to(dtype))
    g_vec = torch.where(fixed_rows, 0.0, g_red.reshape(-1))

    dx = -solve_or_nan(
        S_mat + 1e-9 * torch.eye(K * 6, dtype=dtype, device=dev), g_vec)
    dx_poses = dx.reshape(K, 6)

    # back-substitute: dp_p = -C_p^-1 (gp_p + sum_{n: p(n)=p}
    # E_obs_n^T dx_{kf(n)})
    Edx = psum(segment_sum(torch.einsum("nab,na->nb", E_obs,
                                         dx_poses[prob.obs_kf]),
                            prob.obs_point, P), group)
    dpoints = -torch.einsum("pij,pj->pi", Cinv, gp + Edx)
    return dx_poses, dpoints, cost


@highest_precision()
def _apply(prob: BAProblem, dx_poses: torch.Tensor, dpoints: torch.Tensor,
           cfg: BAConfig) -> BAProblem:
    K = prob.T_world_kf.shape[0]
    T = prob.T_world_kf
    dR = cayley_to_rot(dx_poses[:, :3])                  # (K, 3, 3)
    M = torch.matmul(dR, T[:, :3, :3])
    # a diverged step (a near-singular point block in float32) carries
    # non-finite values, on which torch's SVD raises where JAX's returns
    # NaN: project a finite stand-in and put the NaN back, so the trial's
    # cost is NaN and the accept test rejects it, as in JAX
    finite = torch.isfinite(M).all(dim=2).all(dim=1)[:, None, None]
    R = orthonormalize_rotation(torch.where(finite, M, torch.eye(
        3, dtype=M.dtype, device=M.device)))
    R = torch.where(finite, R, torch.nan)
    t = dx_poses[:, 3:] + torch.einsum("kij,kj->ki", dR, T[:, :3, 3])
    T_new = torch.cat([torch.cat([R, t[:, :, None]], dim=2), T[:, 3:]],
                      dim=1)
    fixed = torch.arange(K, device=T.device) < cfg.num_fixed_poses
    T_new = torch.where(fixed[:, None, None], T, T_new)
    return prob.replace(T_world_kf=T_new, points=prob.points + dpoints)


@highest_precision()
def _cost_only(prob: BAProblem, cfg: BAConfig, group=None) -> torch.Tensor:
    r, _, _, ok = reprojection_residuals(prob)
    w, rn = _huber_weights(r, ok, cfg)
    return psum(torch.sum(w * rn * rn), group)


@highest_precision()
def bundle_adjust(prob: BAProblem, cfg: BAConfig = BAConfig(), group=None):
    """Run LM-damped Schur GN for cfg.max_iterations trips. Returns
    (problem, cost history (iters,)), the cost entering each trip.

    `group`: a process group over which the observation axis is sharded
    (each rank passes its block of observations; every reduction is
    all-reduced, poses and points stay replicated)."""
    lam = torch.tensor(cfg.damping, dtype=prob.points.dtype,
                       device=prob.points.device)
    costs = []
    for _ in range(cfg.max_iterations):
        dxp, dpt, cost = _gn_step(prob, cfg, lam, group)
        trial = _apply(prob, dxp, dpt, cfg)
        accept = _cost_only(trial, cfg, group) < cost
        prob = prob.replace(
            T_world_kf=torch.where(accept, trial.T_world_kf, prob.T_world_kf),
            points=torch.where(accept, trial.points, prob.points))
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-9, 1e3)
        costs.append(cost)
    return prob, torch.stack(costs)
