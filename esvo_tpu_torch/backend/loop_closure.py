"""Appearance-based loop-closure detection over time-surface keyframes
(port of esvo_tpu/backend/loop_closure.py).

Keyframes carry a compact global descriptor of their left time surface;
revisits are detected by cosine similarity against the keyframe database
(one matrix-vector product), gated temporally, and verified
geometrically: the default aligns the candidate and current keyframes'
local 3D clouds with a fixed-trip masked ICP (icp_align /
verify_loop_icp); registering stale map points against the current time
surface (verify_loop) is also provided. An accepted loop yields a
relative-pose edge for backend.pose_graph.

The descriptor is an area-weighted (antialiased linear) thumbnail,
mean-removed and L2-normalized; the ICP's nearest-neighbour search is
one (N, M) distance matmul per round and its pose update a weighted
Kabsch fit (3x3 SVD). Every product runs under ``highest_precision``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from esvo_tpu_torch._device import resolve_device
from esvo_tpu_torch.tracking import registration as reg
from esvo_tpu_torch.utils.precision import highest_precision


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    desc_grid: tuple = (12, 16)         # thumbnail (rows, cols)
    min_similarity: float = 0.90        # cosine gate
    min_gap: int = 8                    # keyframes between query & match
    capacity: int = 512                 # keyframe database size
    verify_max_rms: float = 120.0       # TS-residual RMS gate (0..255)
    verify_min_points: int = 100
    # a point is an inlier when its negative-TS residual at the final
    # pose is below this (i.e. it lands on a bright edge)
    verify_inlier_threshold: float = 100.0
    verify_min_inlier_fraction: float = 0.6
    # 3D-3D (ICP) verification of candidate loops, the default path
    icp_max_corr_dist: float = 0.05     # m; correspondence/inlier radius
    icp_iters: int = 10
    # cap on the adaptive coarse-to-fine start radius (x max_corr_dist)
    icp_coarse_mult: float = 12.0
    # two keyframes of the same place cover partially disjoint edge
    # subsets, so the inlier gate tolerates partial overlap
    icp_min_inlier_fraction: float = 0.30
    icp_max_mean_dist: float = 0.02     # m; mean inlier residual gate
    # drift-plausibility gate on the accepted edge; with the elapsed time
    # between the two visits (gap_s) the translation cap is
    #     min(icp_max_correction_trans, icp_drift_floor
    #                                   + icp_drift_rate * gap_s)
    icp_max_correction_trans: float = 1.0   # m (absolute ceiling)
    icp_max_correction_rot: float = 0.5     # rad
    icp_drift_rate: float = 0.05            # m of drift per elapsed second
    icp_drift_floor: float = 0.3            # m minimum allowance
    # forward-backward (reciprocal) consistency: the swapped-cloud ICP
    # started from the inverse estimate must compose with the forward
    # estimate to near identity
    reciprocal: bool = True
    reciprocal_tol_trans: float = 0.10      # m
    reciprocal_tol_rot: float = 0.10        # rad
    # information weights of an accepted loop edge (scaled per edge by
    # verify_loop_icp's edge_quality)
    w_rot: float = 200.0
    w_trans: float = 200.0


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, device: torch.device):
    """(n_in, n_out) float32 weights of jax.image.resize(method="linear")
    along one axis: a triangle kernel widened by the shrink factor
    (antialiased), each output column normalized, columns whose sample
    lies outside the input zeroed (jax._src.image.scale.compute_weight_mat,
    in float64 as JAX computes it under jax_enable_x64)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


@highest_precision()
def ts_descriptor(ts: torch.Tensor, grid: tuple = (12, 16)) -> torch.Tensor:
    """Time surface (H, W) -> normalized thumbnail descriptor (gh*gw,).

    Average-pool to the grid (JAX's antialiased linear resize, as two
    weight matrices), remove the mean (decay-rate invariance),
    L2-normalize (event-rate invariance)."""
    gh, gw = grid
    H, W = ts.shape
    wy = _resize_weights(H, gh, ts.device)
    wx = _resize_weights(W, gw, ts.device)
    d = torch.matmul(wy.T, torch.matmul(ts.to(torch.float32), wx))
    d = d.reshape(-1)
    d = d - torch.mean(d)
    n = torch.linalg.vector_norm(d)
    return d / torch.where(n > 1e-6, n, 1.0)


class LoopClosureDetector:
    """Fixed-capacity keyframe descriptor database + query."""

    def __init__(self, cfg: LoopClosureConfig = LoopClosureConfig(),
                 device=None):
        self.cfg = cfg
        dim = cfg.desc_grid[0] * cfg.desc_grid[1]
        self._D = torch.zeros((cfg.capacity, dim), dtype=torch.float32,
                              device=resolve_device(device))
        self.count = 0

    def add_descriptor(self, d: torch.Tensor) -> int:
        """Register a precomputed descriptor; returns its index."""
        if self.count >= self.cfg.capacity:
            raise RuntimeError(
                "loop-closure database full — call drop_oldest() first")
        self._D[self.count] = d.to(self._D.device)
        self.count += 1
        return self.count - 1

    def add(self, ts: torch.Tensor) -> int:
        """Register a keyframe's time surface; returns its index."""
        return self.add_descriptor(ts_descriptor(ts, self.cfg.desc_grid))

    def drop_oldest(self, n: int) -> None:
        """Evict the n oldest keyframes (callers must remap their own
        keyframe indices by -n)."""
        n = min(n, self.count)
        self._D = torch.cat([self._D[n:], torch.zeros_like(self._D[:n])])
        self.count -= n

    @highest_precision()
    def query_descriptor(self, d: torch.Tensor) -> tuple[int, float]:
        """Best temporally-distant match for a precomputed descriptor.

        Returns (keyframe index, cosine similarity); index -1 when no
        keyframe clears the temporal gap. Call before add()ing the
        current keyframe."""
        hi = self.count - self.cfg.min_gap
        if hi <= 0:
            return -1, 0.0
        sims = torch.matmul(self._D, d.to(self._D.device))   # (capacity,)
        mask = torch.arange(self.cfg.capacity, device=sims.device) < hi
        sims = torch.where(mask, sims, -torch.inf)
        idx = int(torch.argmax(sims))
        return idx, float(sims[idx])

    def query(self, ts: torch.Tensor) -> tuple[int, float]:
        return self.query_descriptor(ts_descriptor(ts, self.cfg.desc_grid))


def verify_loop(points_world: torch.Tensor, point_valid: torch.Tensor,
                ts_cur: torch.Tensor, T_world_guess: np.ndarray,
                camera, reg_cfg: reg.RegProblemConfig,
                cfg: LoopClosureConfig):
    """Geometric verification: register the candidate keyframe's map
    points to the current time surface, starting from the candidate's
    own pose.

    Acceptance: final batch RMS below verify_max_rms AND a minimum
    fraction of ALL valid points landing on bright time-surface edges at
    the solved pose.

    Returns (accepted, T_world_cur_corrected (4, 4), final_rms), the
    corrected pose in the candidate's (old) world frame."""
    n_ok = int(torch.sum(point_valid))
    if n_ok < cfg.verify_min_points:
        return False, np.asarray(T_world_guess), float("inf")
    Tg = torch.as_tensor(np.asarray(T_world_guess), dtype=ts_cur.dtype,
                         device=ts_cur.device)
    prob = reg.make_problem(Tg, Tg, points_world.to(ts_cur.dtype),
                            point_valid, ts_cur, reg_cfg)
    prob, T_est, rms = reg.solve(prob, camera, reg_cfg)
    final_rms = float(rms[-1])

    # inlier fraction at the solved pose over ALL valid points
    with highest_precision():
        _, raw, proj_ok = reg.residuals_and_weights(
            prob, torch.zeros(6, dtype=prob.points.dtype,
                              device=prob.points.device),
            prob.points, prob.point_valid, camera, reg_cfg)
    on_edge = (raw[:, 0] < cfg.verify_inlier_threshold) & proj_ok \
        & prob.point_valid
    inlier_frac = float(torch.sum(on_edge)) / max(n_ok, 1)

    ok = (final_rms < cfg.verify_max_rms
          and inlier_frac >= cfg.verify_min_inlier_fraction)
    return ok, T_est.cpu().double().numpy(), final_rms


@highest_precision()
def icp_align(pts_a: torch.Tensor, valid_a: torch.Tensor,
              pts_b: torch.Tensor, valid_b: torch.Tensor,
              T_ab0: torch.Tensor, max_corr_dist: float, iters: int = 10,
              coarse_mult: float = 12.0, centroid_init: bool = False):
    """Point-to-point ICP: estimate T_ab with p_a ~ T_ab p_b.

    The nearest-neighbour search each round is one (N, M) distance
    matrix via a matmul, in float64 (ties take the first index); the
    pose update a
    weighted Kabsch fit (3x3 SVD with the determinant fix). Fixed trip
    count, masked correspondences, no host sync.

    The correspondence radius anneals coarse-to-fine from twice the
    median initial NN distance, clipped to [max_corr_dist,
    coarse_mult * max_corr_dist], halving each round down to
    max_corr_dist; the inlier gate at the end uses the tight radius.

    Returns (T_ab (4, 4), inlier_fraction, mean_inlier_dist) as tensors.
    """
    dt, dev = pts_a.dtype, pts_a.device
    T0 = torch.as_tensor(T_ab0, device=dev).to(dt)
    # the distance matrix in float64: |a|^2 + |b|^2 - 2 a.b cancels at
    # scene depths, and in float32 near-ties among neighbours resolve
    # differently on the card and the CPU; float64 makes the
    # nearest-neighbour choice a function of the points alone
    pa = pts_a.to(torch.float64)
    a2 = torch.sum(pa * pa, dim=1)
    big = torch.tensor(1e30, dtype=torch.float64, device=dev)
    eye4 = torch.eye(4, dtype=dt, device=dev)

    def nn(pb_t):
        """For each b point (transformed), the nearest valid a point."""
        pb = pb_t.to(torch.float64)
        b2 = torch.sum(pb * pb, dim=1)
        d2 = a2[:, None] + b2[None, :] - 2.0 * torch.matmul(pa, pb.T)
        d2 = torch.where(valid_a[:, None], d2, big)
        dmin, idx = torch.min(d2, dim=0)
        return idx, torch.sqrt(torch.clamp(dmin, min=0.0)).to(dt)

    def body(T, radius):
        pb_t = torch.matmul(pts_b, T[:3, :3].T) + T[:3, 3]
        idx, d = nn(pb_t)
        w = (valid_b & (d < radius)).to(dt)
        wsum = torch.clamp(torch.sum(w), min=1e-6)
        tgt = pts_a[idx]                                  # (M, 3)
        ca = torch.sum(w[:, None] * tgt, dim=0) / wsum
        cb = torch.sum(w[:, None] * pb_t, dim=0) / wsum
        Hm = torch.einsum("m,mi,mj->ij", w, pb_t - cb, tgt - ca) / wsum
        U, _, Vt = torch.linalg.svd(Hm)
        det = torch.linalg.det(torch.matmul(Vt.T, U.T))
        S = torch.diag(torch.cat([torch.ones(2, dtype=dt, device=dev),
                                  det[None]]))
        R = torch.matmul(torch.matmul(Vt.T, S), U.T)      # b->a increment
        t = ca - torch.matmul(R, cb)
        T_new = torch.cat([torch.cat([R, t[:, None]], dim=1), eye4[3:]])
        return torch.matmul(T_new, T)

    if centroid_init:
        # centroid pre-alignment: subtract the clouds' centroid gap (the
        # bulk of a large inter-visit translation drift);
        # verify_loop_icp runs both starts and keeps the better
        wa = valid_a.to(dt)
        wb = valid_b.to(dt)
        ca0 = torch.sum(wa[:, None] * pts_a, dim=0) / torch.clamp(
            torch.sum(wa), min=1e-6)
        pb_raw = torch.matmul(pts_b, T0[:3, :3].T) + T0[:3, 3]
        cb0 = torch.sum(wb[:, None] * pb_raw, dim=0) / torch.clamp(
            torch.sum(wb), min=1e-6)
        T0 = T0.clone()
        T0[:3, 3] += ca0 - cb0

    # adaptive coarse-to-fine radius schedule, capped so clouds of
    # genuinely different places stay uncapturable
    pb0 = torch.matmul(pts_b, T0[:3, :3].T) + T0[:3, 3]
    _, d0 = nn(pb0)
    med0 = torch.nanquantile(torch.where(valid_b, d0, torch.nan), 0.5,
                             interpolation="linear")
    med0 = torch.where(torch.isfinite(med0), med0, 0.0)
    r0 = torch.clamp(2.0 * med0, max_corr_dist, coarse_mult * max_corr_dist)
    radii = torch.clamp(
        r0 * 0.5 ** torch.arange(iters, dtype=dt, device=dev),
        min=max_corr_dist)
    T = T0
    for k in range(iters):
        T = body(T, radii[k])
    pb_t = torch.matmul(pts_b, T[:3, :3].T) + T[:3, 3]
    _, d = nn(pb_t)
    inl = valid_b & (d < max_corr_dist)
    n_b = torch.clamp(torch.sum(valid_b), min=1)
    frac = torch.sum(inl) / n_b.to(dt)
    mean_d = torch.sum(torch.where(inl, d, 0.0)) \
        / torch.clamp(torch.sum(inl), min=1).to(dt)
    return T, frac, mean_d


def edge_quality(frac: float, frac_rev: float, mean_d: float,
                 cfg: LoopClosureConfig) -> float:
    """Scale factor in (0, 1] for an accepted edge's information weight:
    the inlier share times the residual scale against its gate, so a
    just-barely-accepted edge weighs well below a tight one."""
    f = min(frac, frac_rev) if frac_rev >= 0 else frac
    q = f * min(1.0, cfg.icp_max_mean_dist / max(mean_d, 1e-9))
    return float(np.clip(q, 0.05, 1.0))


def _rot_angle(R: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def verify_loop_icp(p_cand: torch.Tensor, valid_cand: torch.Tensor,
                    p_cur: torch.Tensor, valid_cur: torch.Tensor,
                    T_world_cand, T_world_cur_est,
                    cfg: LoopClosureConfig, gap_s: float | None = None):
    """Geometric loop verification by aligning the candidate and current
    keyframes' local 3D clouds (see icp_align), from two starts (the
    odometry guess and its centroid pre-alignment), keeping the better.

    Gates, in order: inlier fraction, mean inlier residual,
    drift-proportional correction plausibility (`gap_s` is the elapsed
    time between the two keyframes), and forward-backward (reciprocal)
    consistency.

    p_cand/p_cur: (N, 3)/(M, 3) points in each keyframe's CAMERA frame.
    Returns (accepted, T_edge (4, 4), inlier_fraction, mean_dist, info)
    with T_edge = T_cand^-1 T_cur such that p_cand = T_edge p_cur; info
    holds the gate-by-gate values and the edge quality."""
    Ta = np.asarray(T_world_cand, np.float64)
    Tb = np.asarray(T_world_cur_est, np.float64)
    T0 = torch.as_tensor(np.linalg.inv(Ta) @ Tb, dtype=p_cand.dtype,
                         device=p_cand.device)
    args = (cfg.icp_max_corr_dist, cfg.icp_iters, cfg.icp_coarse_mult)
    T, frac, mean_d = icp_align(p_cand, valid_cand, p_cur, valid_cur, T0,
                                *args, centroid_init=False)
    T2, frac2, mean_d2 = icp_align(p_cand, valid_cand, p_cur, valid_cur,
                                   T0, *args, centroid_init=True)
    # one transfer for both starts
    host = torch.stack([frac, mean_d, frac2, mean_d2]).cpu().double()
    frac, mean_d, frac2, mean_d2 = host.tolist()
    if frac2 > frac or (frac2 == frac and mean_d2 < mean_d):
        T, frac, mean_d = T2, frac2, mean_d2
    T_np = T.cpu().double().numpy()
    # drift-plausibility gate, proportional to the inter-visit gap
    cap_t = cfg.icp_max_correction_trans
    if gap_s is not None:
        cap_t = min(cap_t,
                    cfg.icp_drift_floor + cfg.icp_drift_rate * abs(gap_s))
    dT = np.linalg.inv(T0.cpu().double().numpy()) @ T_np
    corr_t = float(np.linalg.norm(dT[:3, 3]))
    corr_r = _rot_angle(dT[:3, :3])
    ok = (frac >= cfg.icp_min_inlier_fraction
          and mean_d <= cfg.icp_max_mean_dist
          and corr_t <= cap_t
          and corr_r <= cfg.icp_max_correction_rot)
    # reciprocal consistency, only spent on edges that cleared every
    # cheap gate
    frac_rev, recip_t, recip_r = -1.0, -1.0, -1.0
    if ok and cfg.reciprocal:
        T_rev, frac_rev, _ = icp_align(
            p_cur, valid_cur, p_cand, valid_cand,
            torch.as_tensor(np.linalg.inv(T_np), dtype=p_cand.dtype,
                            device=p_cand.device),
            *args, centroid_init=False)
        frac_rev = float(frac_rev)
        comp = T_np @ T_rev.cpu().double().numpy()    # ~ identity
        recip_t = float(np.linalg.norm(comp[:3, 3]))
        recip_r = _rot_angle(comp[:3, :3])
        ok = (recip_t <= cfg.reciprocal_tol_trans
              and recip_r <= cfg.reciprocal_tol_rot
              and frac_rev >= cfg.icp_min_inlier_fraction)
    info = {"frac": frac, "mean_d": mean_d, "corr_t": corr_t,
            "corr_r": corr_r, "cap_t": cap_t, "frac_rev": frac_rev,
            "recip_t": recip_t, "recip_r": recip_r,
            "quality": edge_quality(frac, frac_rev, mean_d, cfg)}
    return ok, T_np, frac, mean_d, info
