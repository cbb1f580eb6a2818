"""Frozen copy of esvo_tpu_torch/geometry/se3.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

SE(3) / SO(3) utilities (port of esvo_tpu/geometry/se3.py).

Same functions, same conventions: poses are (..., 4, 4) homogeneous
matrices, quaternions are (x, y, z, w), every function broadcasts over
leading dimensions and keeps the dtype and device of its inputs.
"""
from __future__ import annotations

import torch


def cayley_to_rot(c: torch.Tensor) -> torch.Tensor:
    """Cayley parameters (..., 3) -> rotation matrices (..., 3, 3)."""
    # (..., 1) slices, not 0-d elements: under torch.func.jacfwd a Python
    # float meeting a 0-d float32 tensor promotes to float64
    c1, c2, c3 = c[..., 0:1], c[..., 1:2], c[..., 2:3]
    s = 1.0 + c1 * c1 + c2 * c2 + c3 * c3
    r = torch.cat([
        1.0 + c1 * c1 - c2 * c2 - c3 * c3,
        2.0 * (c1 * c2 - c3),
        2.0 * (c1 * c3 + c2),
        2.0 * (c1 * c2 + c3),
        1.0 - c1 * c1 + c2 * c2 - c3 * c3,
        2.0 * (c2 * c3 - c1),
        2.0 * (c1 * c3 - c2),
        2.0 * (c2 * c3 + c1),
        1.0 - c1 * c1 - c2 * c2 + c3 * c3,
    ], dim=-1).reshape(c.shape[:-1] + (3, 3))
    return r / s[..., None]


def rot_to_cayley(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> Cayley parameters (..., 3):
    C = (R - I)(R + I)^-1, cayley = (-C12, C02, -C01)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    C = torch.matmul(R - eye, torch.linalg.inv(R + eye))
    return torch.stack([-C[..., 1, 2], C[..., 0, 2], -C[..., 0, 1]], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) in (x, y, z, w) order -> (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    r = torch.stack([
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), (x, y, z, w),
    w >= 0. Branch-free: all four Shepperd candidates, pick the one with
    the largest pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-30))

    sw = safe_sqrt(1.0 + tr)
    q_w = torch.stack([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                       (m10 - m01) / (2 * sw), sw / 2], dim=-1)
    sx = safe_sqrt(1.0 + m00 - m11 - m22)
    q_x = torch.stack([sx / 2, (m01 + m10) / (2 * sx),
                       (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)],
                      dim=-1)
    sy = safe_sqrt(1.0 - m00 + m11 - m22)
    q_y = torch.stack([(m01 + m10) / (2 * sy), sy / 2,
                       (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)],
                      dim=-1)
    sz = safe_sqrt(1.0 - m00 - m11 + m22)
    q_z = torch.stack([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz),
                       sz / 2, (m10 - m01) / (2 * sz)], dim=-1)

    pivots = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([q_w, q_x, q_y, q_z], dim=-2)      # (..., 4, 4)
    sel = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, sel)[..., 0, :]
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Spherical linear interpolation between quaternions (x, y, z, w)."""
    alpha = torch.as_tensor(alpha, dtype=q0.dtype, device=q0.device)[..., None]
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - alpha,
                     torch.sin((1.0 - alpha) * theta) / safe)
    w1 = torch.where(small, alpha, torch.sin(alpha * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], -1),
        torch.stack([wz, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)


def _theta_coeffs(th2: torch.Tensor):
    """Taylor-safe (A, B, C) = (sin/th, (1-cos)/th^2, (th-sin)/th^3)."""
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - A) / th2s)
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential (..., 3) axis-angle -> (..., 3, 3)."""
    th2 = torch.sum(w * w, dim=-1)
    A, B, _ = _theta_coeffs(th2)
    K = so3_hat(w)
    K2 = torch.matmul(K, K)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A[..., None, None] * K + B[..., None, None] * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) axis-angle, |w| in [0, pi], via the
    branch-free quaternion extraction."""
    q = rot_to_quat(R)
    xyz = q[..., :3]
    qw = q[..., 3]
    n2 = torch.sum(xyz * xyz, dim=-1)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    angle = 2.0 * torch.arctan2(n, qw)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-12), angle / n)
    return xyz * scale[..., None]


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4) homogeneous transform."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    # fill_, not `= 1.0`: assigning a Python scalar copies it from host
    # memory, which a CUDA graph cannot capture
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) = (omega, v) -> (..., 4, 4) rigid transform."""
    w = xi[..., :3]
    v = xi[..., 3:]
    th2 = torch.sum(w * w, dim=-1)
    A, B, C = _theta_coeffs(th2)
    K = so3_hat(w)
    K2 = torch.matmul(K, K)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[..., None, None] * K + B[..., None, None] * K2
    V = eye + B[..., None, None] * K + C[..., None, None] * K2
    t = torch.einsum("...ij,...j->...i", V, v)
    return se3_matrix(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> twist (..., 6) = (omega, v); inverse of se3_exp."""
    w = so3_log(T[..., :3, :3])
    th2 = torch.sum(w * w, dim=-1)
    A, B, _ = _theta_coeffs(th2)
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    D = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - A / (2.0 * B)) / th2s)
    K = so3_hat(w)
    K2 = torch.matmul(K, K)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * K + D[..., None, None] * K2
    v = torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return torch.cat([w, v], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms (closed form, no solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_matrix(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, B)


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) or (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...j->...i", R, p) + t


def orthonormalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) via SVD (U V^T), fixing handedness.
    For callers far from SO(3); the tracker's LM rounds use the fast
    form."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(torch.matmul(U, Vt))
    sign = torch.where(det < 0, -1.0, 1.0).to(R.dtype)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * sign[..., None, None]],
                  dim=-1)
    return torch.matmul(U, Vt)


def orthonormalize_rotation_fast(R: torch.Tensor) -> torch.Tensor:
    """Project a NEARLY orthogonal (..., 3, 3) matrix onto SO(3) with two
    Newton-Schulz polar steps R <- R (3I - R^T R) / 2. Quadratic
    convergence: for the ~1e-6 drift of a product of rotations it matches
    the SVD projection to f32 precision. Not valid far from SO(3)."""
    eye3 = 3.0 * torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        R = 0.5 * torch.matmul(R, eye3 - torch.matmul(R.transpose(-1, -2),
                                                      R))
    return R


def interpolate_pose(t0, T0: torch.Tensor, t1, T1: torch.Tensor,
                     t) -> torch.Tensor:
    """Pose at time t between stamped poses (t0, T0), (t1, T1): lerp on
    translation, slerp on rotation."""
    kw = dict(dtype=T0.dtype, device=T0.device)
    t0 = torch.as_tensor(t0, **kw)
    t1 = torch.as_tensor(t1, **kw)
    t = torch.as_tensor(t, **kw)
    denom = torch.where(torch.abs(t1 - t0) < 1e-12, torch.ones_like(t1),
                        t1 - t0)
    alpha = torch.clamp((t - t0) / denom, 0.0, 1.0)
    q = slerp(rot_to_quat(T0[..., :3, :3]), rot_to_quat(T1[..., :3, :3]),
              alpha)
    trans = (1.0 - alpha)[..., None] * T0[..., :3, 3] \
        + alpha[..., None] * T1[..., :3, 3]
    return se3_matrix(quat_to_rot(q), trans)


def interpolate_pose_table(times: torch.Tensor, poses: torch.Tensor,
                           query_t: torch.Tensor) -> torch.Tensor:
    """Poses at query_t (Q,) from a sorted stamped table (times (S,),
    poses (S, 4, 4)); queries outside the table clamp to the end poses."""
    S = times.shape[0]
    hi = torch.clamp(torch.searchsorted(times, query_t, side="left"),
                     1, S - 1)
    lo = hi - 1
    return interpolate_pose(times[lo], poses[lo], times[hi], poses[hi],
                            query_t)


# SoA pose rows: rows[4*i + j] == T[i, j] for the top 3x4 of each
# transform, as (12, N) coefficient planes (the layout the LM kernel
# reads per event).

def rows_from_matrices(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (12, ...)."""
    flat = T[..., :3, :4].reshape(T.shape[:-2] + (12,))
    return torch.movedim(flat, -1, 0)


def matrices_from_rows(rows: torch.Tensor) -> torch.Tensor:
    """(12, ...) -> (..., 4, 4) with the affine bottom row appended."""
    batch = tuple(rows.shape[1:])
    T34 = torch.movedim(rows, 0, -1).reshape(batch + (3, 4))
    bottom = torch.zeros(batch + (1, 4), dtype=rows.dtype, device=rows.device)
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([T34, bottom], dim=-2)


def rows_apply(rows: torch.Tensor, px, py, pz):
    """Apply (12, N) transforms to per-lane points: returns (qx, qy, qz)."""
    qx = rows[0] * px + rows[1] * py + rows[2] * pz + rows[3]
    qy = rows[4] * px + rows[5] * py + rows[6] * pz + rows[7]
    qz = rows[8] * px + rows[9] * py + rows[10] * pz + rows[11]
    return qx, qy, qz
