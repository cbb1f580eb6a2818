"""Frozen copy of the steps of esvo_tpu_torch/runtime/system.py
(``MappingCycle``, the parts of ``EsvoSystem`` a tick runs) and
esvo_tpu_torch/runtime/resident.py (``ResidentLoop.roll``), on the plain
copies of this package. The benchmark's reference runs one step with
them from a state it was handed: a resident roll (``roll``), or a tick's
pose (``record_pose``, after ``tracked_pose`` where the tick tracks) and
its mapping cycle (``mapping_step``).
Every function is a plain function of its arguments; the caller sets
the matmul precision around a step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from plainref.geometry.camera import Camera, StereoRig
from plainref.geometry.se3 import interpolate_pose_table, se3_inverse
from plainref.mapping import block_matching as bm
from plainref.mapping import depth_refinement as dr
from plainref.mapping import fusion as fu
from plainref.mapping import initialization as init
from plainref.mapping.regularization import regularize
from plainref.ops.interp import gather2d
from plainref.runtime.config import SystemConfig
from plainref.surface import time_surface as tsf
from plainref.tracking import registration as reg


class Cycle:
    """MappingCycle's programs on one rig (buffers as plain attributes)."""

    def __init__(self, rig: StereoRig, cfg: SystemConfig):
        self.rig, self.cfg = rig, cfg
        self.H, self.W = rig.left.height, rig.left.width
        self.N = cfg.mapping.process_event_num
        self.F = cfg.history_frames
        self.dtype = rig.left.lut.dtype

    def render_left(self, st_l, t_sync):
        cfg = self.cfg.surface
        t = torch.as_tensor(t_sync, dtype=torch.float32,
                            device=st_l.last_t_pos.device)
        render = (tsf.render_backward if cfg.mode == "backward"
                  else tsf.render_forward)
        return render(st_l, t, self.rig.left, cfg)

    def render_pair(self, st_l, st_r, t_sync):
        cfg = self.cfg.surface
        t = torch.as_tensor(t_sync, dtype=torch.float32,
                            device=st_l.last_t_pos.device)
        if cfg.mode == "backward":
            return tsf.render_backward_pair(st_l, st_r, t, self.rig.left,
                                            self.rig.right, cfg)
        return (tsf.render_forward(st_l, t, self.rig.left, cfg),
                tsf.render_forward(st_r, t, self.rig.right, cfg))

    def compact(self, valid, *arrays):
        order = torch.argsort((~valid).to(torch.int8), stable=True)[:self.N]
        return (valid[order],) + tuple(a[order] for a in arrays)

    def lut_lookup(self, y, x):
        lut = self.rig.left.lut
        yi = torch.clamp(y, 0, self.H - 1)
        xi = torch.clamp(x, 0, self.W - 1)
        return torch.stack([gather2d(lut[..., 0], yi, xi),
                            gather2d(lut[..., 1], yi, xi)], dim=-1)

    def mapping_estimate(self, ts_l, ts_r, ev_x, ev_y, ev_t, ev_valid,
                         pose_times, pose_tab, T_world_frame):
        cfg, H, W, rig = self.cfg, self.H, self.W, self.rig
        if cfg.mapping.denoising:
            mask = init.denoising_mask(ev_x, ev_y, ev_valid, H, W)
            ev_valid = init.select_denoised(ev_x, ev_y, ev_valid, mask,
                                            cfg.mapping.process_event_num)
        ev_valid, ev_x, ev_y, ev_t = self.compact(ev_valid, ev_x, ev_y, ev_t)
        x_rect = self.lut_lookup(ev_y, ev_x)
        T_wv = interpolate_pose_table(pose_times, pose_tab,
                                      ev_t.to(pose_tab.dtype))
        matches, bm_stats = bm.match_events_stats(
            ts_l, ts_r, x_rect, x_rect, ev_t, ev_valid, rig.left.mask, rig,
            cfg.bm)
        T_lv = torch.matmul(se3_inverse(T_world_frame), T_wv)
        est = dr.solve(matches.x_left, T_wv, T_lv, matches.inv_depth,
                       matches.valid, ev_t, ts_l, ts_r, rig, cfg.depth)
        est = dr.point_culling(
            est, cfg.mapping.std_var_vis_threshold, cfg.cost_vis_threshold,
            cfg.mapping.inv_depth_min_range, cfg.mapping.inv_depth_max_range)
        return est, torch.sum(est.valid), bm_stats

    def rebuild_frame(self, history, T_world_frame, given=None):
        """rebuild_frame; `given`, a list, receives the grid the
        regularization is given."""
        cfg, H, W = self.cfg, self.H, self.W
        left = self.rig.left
        flat = history.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        grid = fu.empty_grid(H, W, self.dtype, T_world_frame.device)
        cand = fu.propagate_points(flat, se3_inverse(T_world_frame), left,
                                   cfg.fusion)
        grid, nfused, ndrop = fu.fuse_frame(grid, cand, left, cfg.fusion)
        grid = fu.clean_grid(
            grid, cfg.mapping.std_var_vis_threshold ** 2,
            cfg.mapping.age_vis_threshold, cfg.mapping.inv_depth_max_range,
            cfg.mapping.inv_depth_min_range)
        if given is not None:
            given.append(grid)
        if cfg.mapping.regularization:
            grid = regularize(grid, cfg.regularizer)
        pts_world, occ = fu.grid_points_world(grid, T_world_frame)
        return grid, pts_world, occ, nfused, ndrop

    @staticmethod
    def write_history(history, est, slot):
        idx = slot.reshape(1)
        return dr.DepthEstimates(**{
            name: h.index_copy(0, idx, getattr(est, name)[None].to(h.dtype))
            for name, h in vars(history).items()})


def select_from_scores(cfg: SystemConfig, pts_world, pt_valid, score):
    """EsvoSystem.select_from_scores."""
    M = cfg.tracker.max_registration_points
    flat_pts = pts_world.reshape(-1, 3)
    flat_ok = pt_valid.reshape(-1)
    score = score + torch.where(flat_ok, 0.0, 1e3)
    idx = torch.argsort(score, stable=True)[:M]
    return flat_pts[idx], flat_ok[idx]


def track_tick_body(cycle: Cycle, st_l, st_r, evl, evr, ts, T_world_ref,
                    T_ref_world, p_ref, ok, T_cur):
    """EsvoSystem._track_tick_body."""
    st_l = tsf.insert_events(st_l, evl)
    st_r = tsf.insert_events(st_r, evr)
    s_l = cycle.render_left(st_l, ts).to(cycle.dtype)
    T_ref_left = torch.matmul(T_ref_world, T_cur.to(cycle.dtype))
    neg, gu, gv = reg.negative_time_surface(s_l,
                                            cycle.cfg.tracker.kernel_size)
    prob = reg.RegProblem(
        R=T_ref_left[:3, :3], t=T_ref_left[:3, 3], T_world_ref=T_world_ref,
        points=p_ref, point_valid=ok, ts_negative=neg, grad_u=gu,
        grad_v=gv)
    _, T_est, rms = reg.solve(prob, cycle.rig.left, cycle.cfg.tracker)
    return st_l, st_r, s_l, T_est, rms


# ---------------------------------------------------------------------------
# the resident roll (ResidentLoop.roll)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RollState:
    """ResidentState's fields, on this package's classes."""
    ts_left: tsf.TimeSurfaceState
    ts_right: tsf.TimeSurfaceState
    pose_times: torch.Tensor
    pose_tab: torch.Tensor
    T_world_cur: torch.Tensor
    T_world_prev: torch.Tensor
    T_world_frame: torch.Tensor
    history: dr.DepthEstimates
    hist_slot: torch.Tensor
    grid: fu.DepthGrid
    ref_pts: torch.Tensor
    ref_ok: torch.Tensor
    rolls_since_good: torch.Tensor
    consec_rejects: torch.Tensor
    num_rejects: torch.Tensor


def _det3(R):
    return (R[0, 0] * (R[1, 1] * R[2, 2] - R[1, 2] * R[2, 1])
            - R[0, 1] * (R[1, 0] * R[2, 2] - R[1, 2] * R[2, 0])
            + R[0, 2] * (R[1, 0] * R[2, 1] - R[1, 1] * R[2, 0]))


def _guard_append(T_est, T_cur, t_k, ptimes, ptab, consec, nrej, tr_cfg):
    dt = T_est.dtype
    R = T_est[:3, :3]
    eye = torch.eye(3, dtype=dt, device=T_est.device)
    finite = torch.all(torch.isfinite(T_est))
    RRt = torch.matmul(R, R.T)
    rigid = (finite
             & (torch.abs(_det3(R) - 1.0) < 0.05)
             & (torch.sqrt(torch.sum((RRt - eye) ** 2)) < 0.05))
    dt_s = torch.clamp(t_k - ptimes[-1],
                       min=1.0 / tr_cfg.tracking_rate_hz).to(dt)
    dist = torch.linalg.vector_norm(T_est[:3, 3] - T_cur[:3, 3])
    dR = torch.matmul(T_cur[:3, :3].T, R)
    ang = torch.arccos(torch.clamp((torch.trace(dR) - 1.0) / 2.0, -1.0, 1.0))
    too_fast = ((dist > tr_cfg.max_speed_mps * dt_s + 0.01)
                | (ang > tr_cfg.max_ang_speed_rps * dt_s + 0.02))
    force = consec >= tr_cfg.max_consecutive_rejects
    accept = rigid & (~too_fast | force)
    consec = torch.where(accept, 0,
                         torch.where(rigid & too_fast, consec + 1, consec))
    nrej = nrej + (~accept).to(nrej.dtype)
    T_new = torch.where(accept, T_est, T_cur)
    ptimes = torch.where(
        accept, torch.cat([ptimes[1:], t_k[None].to(ptimes.dtype)]), ptimes)
    ptab = torch.where(
        accept, torch.cat([ptab[1:], T_new[None].to(ptab.dtype)]), ptab)
    return T_new, ptimes, ptab, consec, nrej, accept


def _tick(ev: tsf.EventBatch, k: int) -> tsf.EventBatch:
    return tsf.EventBatch(x=ev.x[k], y=ev.y[k], t=ev.t[k], p=ev.p[k],
                          valid=ev.valid[k])


def roll(cycle: Cycle, st: RollState, ev_left: tsf.EventBatch,
         ev_right: tsf.EventBatch, t_syncs: torch.Tensor,
         scores: torch.Tensor, follow=None):
    """One WORKING roll of K = len(t_syncs) ticks. Returns (the new
    state, poses (K, 4, 4), mapping estimates, number of map points).
    With `follow` = (poses (K, 4, 4), accepted (K,)) of another run of
    the same roll, each tick is solved from that run's pose at the tick
    before, and the pose table and the mapping cycle take that run's
    poses: every tick is then one solve from the same start (the poses
    returned are still this roll's own)."""
    cfg, dt = cycle.cfg, cycle.dtype
    tr_node = cfg.tracking
    K = t_syncs.shape[0]
    pts, ok = select_from_scores(cfg, st.ref_pts, st.ref_ok, scores)
    T_world_ref = st.T_world_frame
    p_ref = torch.einsum("ji,nj->ni", T_world_ref[:3, :3],
                         pts - T_world_ref[:3, 3])
    T_ref_world = se3_inverse(T_world_ref)
    ts_l, ts_r = st.ts_left, st.ts_right
    T_cur, T_prev = st.T_world_cur, st.T_world_prev
    ptimes, ptab = st.pose_times, st.pose_tab
    consec, nrej = st.consec_rejects, st.num_rejects
    poses = []
    for k in range(K):
        t_k = t_syncs[k]
        if tr_node.constant_velocity_prior:
            step = torch.matmul(T_cur, se3_inverse(T_prev))
            guess = torch.matmul(step, T_cur)
        else:
            guess = T_cur
        ts_l, ts_r, _, T_est, _ = track_tick_body(
            cycle, ts_l, ts_r, _tick(ev_left, k), _tick(ev_right, k), t_k,
            T_world_ref, T_ref_world, p_ref, ok, guess)
        T_new, ptimes_n, ptab_n, consec, nrej, acc = _guard_append(
            T_est.to(dt), T_cur, t_k, ptimes, ptab, consec, nrej, tr_node)
        poses.append(T_new)
        if follow is not None:
            T_new, acc = follow[0][k].to(dt), follow[1][k]
            ptimes_n = torch.where(acc, torch.cat(
                [ptimes[1:], t_k[None].to(ptimes.dtype)]), ptimes)
            ptab_n = torch.where(acc, torch.cat(
                [ptab[1:], T_new[None].to(ptab.dtype)]), ptab)
        ptimes, ptab = ptimes_n, ptab_n
        T_prev = torch.where(acc, T_cur, T_prev)
        T_cur = T_new

    s_l, s_r = cycle.render_pair(ts_l, ts_r, t_syncs[-1])
    last = _tick(ev_left, K - 1)
    est, _, _ = cycle.mapping_estimate(
        s_l.to(dt), s_r.to(dt), last.x, last.y, last.t.to(dt), last.valid,
        ptimes, ptab, T_cur)
    history = cycle.write_history(st.history, est, st.hist_slot)
    grid, pts_world, occ, _, _ = cycle.rebuild_frame(history, T_cur)
    n_pts = torch.sum(occ)
    good = n_pts >= cfg.tracker.batch_size
    new = RollState(
        ts_left=ts_l, ts_right=ts_r, pose_times=ptimes, pose_tab=ptab,
        T_world_cur=T_cur, T_world_prev=T_prev,
        T_world_frame=torch.where(good, T_cur, st.T_world_frame),
        history=history, hist_slot=(st.hist_slot + 1) % cycle.F, grid=grid,
        ref_pts=torch.where(good, pts_world, st.ref_pts),
        ref_ok=torch.where(good, occ, st.ref_ok),
        rolls_since_good=torch.where(good, 0, st.rolls_since_good + 1),
        consec_rejects=consec, num_rejects=nrej)
    return new, torch.stack(poses), est, int(n_pts)


# ---------------------------------------------------------------------------
# one tick of EsvoSystem.process_tick, WORKING
# ---------------------------------------------------------------------------

def pose_table(times: list, poses: list, S: int, dtype, device):
    """EsvoSystem._pose_table over host lists of stamped poses."""
    times = np.asarray(times[-S:], np.float64)
    poses = np.asarray(poses[-S:])
    n = len(times)
    if n < S:
        times = np.concatenate([times,
                                times[-1] + 1e-5 * np.arange(1, S - n + 1)])
        poses = np.concatenate([poses, np.repeat(poses[-1:], S - n, axis=0)])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return t(times), t(poses)


def _pose_is_rigid(T: np.ndarray, tol: float = 0.05) -> bool:
    if T.shape != (4, 4) or not np.isfinite(T).all():
        return False
    R = T[:3, :3]
    return (abs(float(np.linalg.det(R)) - 1.0) < tol
            and float(np.linalg.norm(R @ R.T - np.eye(3))) < tol)


def record_pose(cfg: SystemConfig, host: dict, t: float, T: np.ndarray):
    """EsvoSystem.record_pose on a dict of the host state (pose_times,
    pose_list, T_world_cur, consec_rejects), changed in place."""
    T = np.asarray(T)
    if not _pose_is_rigid(T):
        return
    if host["pose_times"]:
        tc = cfg.tracking
        dt_s = max(float(t) - host["pose_times"][-1],
                   1.0 / tc.tracking_rate_hz)
        dist = float(np.linalg.norm(T[:3, 3] - host["T_world_cur"][:3, 3]))
        dR = host["T_world_cur"][:3, :3].T @ T[:3, :3]
        ang = float(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0,
                                      1.0)))
        if (dist > tc.max_speed_mps * dt_s + 0.01
                or ang > tc.max_ang_speed_rps * dt_s + 0.02):
            host["consec_rejects"] += 1
            if host["consec_rejects"] < tc.max_consecutive_rejects:
                return
    host["consec_rejects"] = 0
    host["pose_times"].append(float(t))
    host["pose_list"].append(T)
    host["T_world_cur"] = T


def mapping_step(cycle: Cycle, host: dict, ts_l, ts_r, ev: tsf.EventBatch,
                 history, slot: int, pose_table_size: int, given=None):
    """EsvoSystem._dispatch_mapping after a tick's pose: the estimate at
    the tick's left events, the window with it at `slot`, the rebuilt
    frame. Returns (estimates, history, grid, points, occupied), or None
    where the pose table no longer covers the oldest event."""
    dev, dt = ts_l.device, cycle.dtype
    ev_t = ev.t.cpu().numpy()
    ev_ok = ev.valid.cpu().numpy()
    times = host["pose_times"]
    if ev_ok.any() and len(times) > 1:
        oldest = times[max(len(times) - pose_table_size, 0)]
        if float(ev_t[ev_ok].min()) < oldest - 1e-9:
            return None
    pt_t, pt_T = pose_table(times, host["pose_list"], pose_table_size, dt,
                            dev)
    T_wf = torch.as_tensor(host["T_world_cur"], dtype=dt, device=dev)
    est, _, _ = cycle.mapping_estimate(
        ts_l, ts_r, ev.x, ev.y, torch.as_tensor(ev_t, dtype=dt, device=dev),
        ev.valid, pt_t, pt_T, T_wf)
    history = cycle.write_history(
        history, est, torch.tensor(slot, dtype=torch.int64, device=dev))
    grid, pts, occ, _, _ = cycle.rebuild_frame(history, T_wf, given)
    return est, history, grid, pts, occ


def tracked_pose(cycle: Cycle, ts_l, T_world_frame: np.ndarray,
                 T_world_cur: np.ndarray, ref_pts, ref_ok, scores):
    """EsvoSystem.process_tick's tracking: select the registration points
    by `scores`, register them to the left surface. Returns the solved
    pose (float64, host)."""
    dev, dt = ts_l.device, cycle.dtype
    pts, ok = select_from_scores(cycle.cfg, ref_pts, ref_ok, scores)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    prob = reg.make_problem(t(T_world_frame), t(T_world_cur), pts, ok, ts_l,
                            cycle.cfg.tracker)
    _, T_est, _ = reg.solve(prob, cycle.rig.left, cycle.cfg.tracker)
    return T_est.double().cpu().numpy()
