"""Trajectory evaluation (ATE / RPE) and TUM-format export (port of
esvo_tpu/eval/trajectory.py). Host-side NumPy; the quaternion
conversions are this package's (geometry/se3.py), in float64."""
from __future__ import annotations

import numpy as np
import torch

from esvo_tpu_torch.geometry.se3 import quat_to_rot, rot_to_quat


def save_tum(path: str, times: np.ndarray, poses: np.ndarray) -> None:
    """Write `timestamp tx ty tz qx qy qz qw` lines."""
    poses = np.asarray(poses, np.float64)
    qs = rot_to_quat(torch.from_numpy(poses[:, :3, :3].copy())).numpy()
    with open(path, "w") as f:
        for t, T, q in zip(times, poses, qs):
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.9f} {tx:.9f} {ty:.9f} {tz:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def load_tum(path: str):
    """Returns (times (N,), poses (N, 4, 4))."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    times = data[:, 0]
    poses = np.tile(np.eye(4), (len(times), 1, 1))
    poses[:, :3, 3] = data[:, 1:4]
    poses[:, :3, :3] = quat_to_rot(torch.from_numpy(data[:, 4:8])).numpy()
    return times, poses


def interpolate_pose(times: np.ndarray, poses: np.ndarray,
                     t: float) -> np.ndarray:
    """Pose at time t from a stamped table: translation lerp + rotation
    lerp projected back to SO(3) (SVD). Queries outside the table clamp
    to the end segments."""
    i = int(np.clip(np.searchsorted(times, t), 1, len(times) - 1))
    t0, t1 = times[i - 1], times[i]
    a = 0.0 if t1 == t0 else float(np.clip((t - t0) / (t1 - t0), 0.0, 1.0))
    T0, T1 = poses[i - 1], poses[i]
    M = (1 - a) * T0[:3, :3] + a * T1[:3, :3]
    U, _, Vt = np.linalg.svd(M)
    R = U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = (1 - a) * T0[:3, 3] + a * T1[:3, 3]
    return T


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity / rigid alignment dst ~ s R src + t.
    Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / ((xs ** 2).sum() / len(src))) \
        if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def _associate(t_est, t_gt, max_dt=0.02):
    """Nearest-timestamp association; returns index pairs."""
    j = np.clip(np.searchsorted(t_gt, t_est), 1, len(t_gt) - 1)
    left = np.abs(t_gt[j - 1] - t_est) <= np.abs(t_gt[j] - t_est)
    j = np.where(left, j - 1, j)
    ok = np.abs(t_gt[j] - t_est) <= max_dt
    return np.nonzero(ok)[0], j[ok]


def rigid_mask(poses: np.ndarray, tol: float = 0.05) -> np.ndarray:
    """(K,) mask of finite, invertible, near-orthonormal poses (a diverged
    tracker step must not break the alignment)."""
    T = np.asarray(poses)
    ok = np.isfinite(T.reshape(len(T), -1)).all(axis=1)
    R = np.where(ok[:, None, None], T[:, :3, :3], np.eye(3))
    ok &= np.abs(np.linalg.det(R) - 1.0) < tol
    err = R @ np.transpose(R, (0, 2, 1)) - np.eye(3)
    ok &= np.sqrt((err ** 2).sum(axis=(1, 2))) < tol
    return ok


def ate_rmse(t_est, poses_est, t_gt, poses_gt, align: bool = True,
             with_scale: bool = False, max_dt: float = 0.02) -> float:
    """Absolute trajectory error RMSE (m) after SE(3) / Sim(3) alignment;
    degenerate estimated poses are left out (rigid_mask)."""
    keep = rigid_mask(poses_est)
    t_est = np.asarray(t_est)[keep]
    poses_est = np.asarray(poses_est)[keep]
    ie, ig = _associate(t_est, np.asarray(t_gt), max_dt)
    if len(ie) < 2:
        return float("inf")
    pe = poses_est[ie, :3, 3]
    pg = np.asarray(poses_gt)[ig, :3, 3]
    if align:
        s, R, t = umeyama_alignment(pe, pg, with_scale)
        pe = (s * (R @ pe.T)).T + t
    return float(np.sqrt(np.mean(np.sum((pe - pg) ** 2, axis=1))))


def rpe_stats(t_est, poses_est, t_gt, poses_gt, delta: int = 1,
              max_dt: float = 0.02):
    """Relative pose error over `delta`-step pairs. Returns (trans_rmse,
    rot_rmse_rad); degenerate estimated poses are left out."""
    keep = rigid_mask(poses_est)
    t_est = np.asarray(t_est)[keep]
    poses_est = np.asarray(poses_est)[keep]
    ie, ig = _associate(t_est, np.asarray(t_gt), max_dt)
    Te = poses_est[ie]
    Tg = np.asarray(poses_gt)[ig]
    if len(Te) <= delta:
        return float("inf"), float("inf")
    dts, drs = [], []
    for i in range(len(Te) - delta):
        E = np.linalg.inv(np.linalg.inv(Tg[i]) @ Tg[i + delta]) \
            @ (np.linalg.inv(Te[i]) @ Te[i + delta])
        dts.append(np.sum(E[:3, 3] ** 2))
        drs.append(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2,
                                     -1, 1)) ** 2)
    return float(np.sqrt(np.mean(dts))), float(np.sqrt(np.mean(drs)))
