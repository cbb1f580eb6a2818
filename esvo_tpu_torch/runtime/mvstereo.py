"""Multi-view stereo benchmark harness with known poses (port of
esvo_tpu/runtime/mvstereo.py).

The reference's ``esvo_MVStereo`` node (esvo_core/src/esvo_MVStereo.cpp),
the mapper's evaluation harness, with its five methods
(esvo_MVStereo.h:43-50):

  0 PURE_EVENT_MATCHING  - temporal matching + naive fusion
  1 PURE_BLOCK_MATCHING  - block matching + naive fusion
  2 EM_PLUS_ESTIMATION   - temporal matching + depth LM + fusion
  3 BM_PLUS_ESTIMATION   - block matching + depth LM + fusion (the ESVO
                           mapper: EsvoSystem's own WORKING cycle)
  4 PURE_SGM             - SGM + edge mask + naive fusion (EsvoSystem's
                           bootstrap, forced every mapping cycle)

Matches become depth points with the pseudo variance 0, bounded to 1e-6
(vEMP2vDP, esvo_MVStereo.cpp:1072-1094). Per-event virtual poses are
interpolated from the ground-truth pose table at each event's time.
Modes 0 and 2 send 8-row windows (15x15 patches) of the surfaces through
kernel K1; modes 2 and 3 run the depth LM (K1, K2); every tick renders
through K3.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from esvo_tpu_torch.geometry.camera import StereoRig, cam_to_world
from esvo_tpu_torch.geometry.se3 import interpolate_pose_table, se3_inverse
from esvo_tpu_torch.mapping import block_matching as bm
from esvo_tpu_torch.mapping import depth_refinement as dr
from esvo_tpu_torch.mapping.event_matcher import (EventMatcherConfig,
                                                  match_events_temporal)
from esvo_tpu_torch.runtime.config import SystemConfig
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from esvo_tpu_torch.utils.precision import highest_precision


class MVStereoMode(enum.IntEnum):
    """esvo_MVStereo.h:43-50."""
    PURE_EVENT_MATCHING = 0
    PURE_BLOCK_MATCHING = 1
    EM_PLUS_ESTIMATION = 2
    BM_PLUS_ESTIMATION = 3
    PURE_SGM = 4


def matches_to_estimates(matches: bm.EventMatches,
                         T_world_virtual: torch.Tensor, rig: StereoRig,
                         age: int) -> dr.DepthEstimates:
    """EventMatchPair -> DepthPoint with pseudo variance (vEMP2vDP,
    esvo_MVStereo.cpp:1072-1094)."""
    n = matches.x_left.shape[0]
    dt, dev = matches.x_left.dtype, matches.x_left.device
    inv_d = matches.inv_depth
    p_cam = cam_to_world(rig.left.params.P, matches.x_left,
                         torch.clamp(inv_d, min=1e-6))
    var = torch.full((n,), 1e-6, dtype=dt, device=dev)
    return dr.DepthEstimates(
        x=matches.x_left,
        inv_depth=torch.where(matches.valid, inv_d,
                              torch.full_like(inv_d, -1.0)),
        variance=var, scale2=var,
        nu=torch.full((n,), float("inf"), dtype=dt, device=dev),
        residual=matches.cost.to(dt),
        age=torch.full((n,), age, dtype=torch.int32, device=dev),
        p_cam=p_cam, T_world_cam=T_world_virtual, valid=matches.valid)


class MVStereoSystem(EsvoSystem):
    """EsvoSystem with given poses and a selectable mapping method.

    Call ``process_tick(..., gt_pose=...)`` as on EsvoSystem; the mapping
    path dispatches on ``mode``. The mode's stages read the system's
    MappingCycle and config when they run, so ``reconfigure`` (the base
    class's) takes effect in every mode."""

    def __init__(self, rig: StereoRig, mode: MVStereoMode,
                 config: SystemConfig | None = None,
                 em_config: EventMatcherConfig | None = None, **kw):
        self.mode = MVStereoMode(mode)
        self.em_cfg = em_config or EventMatcherConfig()
        super().__init__(rig, config, **kw)
        # the latest tick's right events, for temporal matching
        self._right_events = None

    # -- the mode stages ---------------------------------------------------
    def em_estimate(self, ts_l, ts_r, lx, ly, lt, lp, lvalid, rx, ry, rt, rp,
                    rvalid, pose_times, pose_tab, T_world_frame):
        """Temporal matching of the tick's first N valid left events
        against all its right events. Returns (matches, T_world_virtual)."""
        cycle = self.cycle
        lvalid, lx, ly, lt, lp = cycle.compact(lvalid, lx, ly, lt, lp)
        xl = cycle.lut_lookup(ly, lx)
        xr = cycle.lut_lookup(ry, rx, side="right")
        T_wv = interpolate_pose_table(pose_times, pose_tab,
                                      lt.to(pose_tab.dtype))
        T_lv = torch.matmul(se3_inverse(T_world_frame), T_wv)
        matches = match_events_temporal(ts_l, ts_r, xl, lt, lp, lvalid, T_lv,
                                        xr, rt, rp, rvalid, cycle.rig,
                                        self.em_cfg)
        return matches, T_wv

    def refine(self, matches, T_wv, ts_l, ts_r, T_world_frame):
        """Depth LM from the matches' inverse depths, then culling."""
        cfg = self.cfg
        T_lv = torch.matmul(se3_inverse(T_world_frame), T_wv)
        est = dr.solve(matches.x_left, T_wv, T_lv, matches.inv_depth,
                       matches.valid, matches.t, ts_l, ts_r, self.cycle.rig,
                       cfg.depth)
        return dr.point_culling(
            est, cfg.mapping.std_var_vis_threshold, cfg.cost_vis_threshold,
            cfg.mapping.inv_depth_min_range, cfg.mapping.inv_depth_max_range)

    def bm_match(self, ts_l, ts_r, ev_x, ev_y, ev_t, ev_valid, pose_times,
                 pose_tab):
        """Block matching of the tick's first N valid left events (no
        denoising). Returns (matches, T_world_virtual)."""
        cycle = self.cycle
        ev_valid, ev_x, ev_y, ev_t = cycle.compact(ev_valid, ev_x, ev_y, ev_t)
        x_rect = cycle.lut_lookup(ev_y, ev_x)
        T_wv = interpolate_pose_table(pose_times, pose_tab,
                                      ev_t.to(pose_tab.dtype))
        rig = cycle.rig
        matches = bm.match_events(ts_l, ts_r, x_rect, x_rect, ev_t, ev_valid,
                                  rig.left.mask, rig, self.cfg.bm)
        return matches, T_wv

    def to_estimates(self, matches, T_wv) -> dr.DepthEstimates:
        return matches_to_estimates(matches, T_wv, self.cycle.rig,
                                    self.cfg.mapping.age_vis_threshold)

    def remember_right_events(self, ev_right: dict) -> None:
        self._right_events = ev_right

    # -- the tick ----------------------------------------------------------
    @highest_precision()
    def process_tick(self, t_sync, ev_left, ev_right, gt_pose=None,
                     do_mapping=True):
        if gt_pose is None:
            raise ValueError("MVStereo runs with known poses: pass gt_pose")
        self.remember_right_events(ev_right)
        mode = self.mode
        if mode in (MVStereoMode.BM_PLUS_ESTIMATION, MVStereoMode.PURE_SGM):
            if mode == MVStereoMode.PURE_SGM:
                # the SGM path every mapping cycle
                self.status = SystemStatus.INITIALIZATION
            return super().process_tick(t_sync, ev_left, ev_right,
                                        gt_pose=gt_pose,
                                        do_mapping=do_mapping)

        # modes 0/1/2: do_mapping=None keeps the base class's rate
        # scheduling, as modes 3/4 do through super()
        if do_mapping is None:
            period = 1.0 / self.cfg.mapping.mapping_rate_hz
            do_mapping = (self.last_mapping_time is None
                          or t_sync - self.last_mapping_time
                          >= period - 1e-9)
        out = super().process_tick(t_sync, ev_left, ev_right,
                                   gt_pose=gt_pose, do_mapping=False)
        if not do_mapping:
            return out
        self.last_mapping_time = t_sync
        ts_l, ts_r = out["ts_left"], out["ts_right"]
        T_wf = np.asarray(gt_pose)
        T_wf_dev = self._tensor(T_wf)
        pt_t, pt_T = self._pose_table()
        dev = self.device
        ints = lambda ev, key: torch.as_tensor(np.asarray(ev[key]), device=dev)
        if mode == MVStereoMode.PURE_BLOCK_MATCHING:
            matches, T_wv = self.bm_match(
                ts_l, ts_r, ints(ev_left, "x"), ints(ev_left, "y"),
                self._tensor(ev_left["t"]), ints(ev_left, "valid"), pt_t,
                pt_T)
            est = self.to_estimates(matches, T_wv)
        else:
            r = self._right_events
            matches, T_wv = self.em_estimate(
                ts_l, ts_r, ints(ev_left, "x"), ints(ev_left, "y"),
                self._tensor(ev_left["t"]), ints(ev_left, "p"),
                ints(ev_left, "valid"), ints(r, "x"), ints(r, "y"),
                self._tensor(r["t"]), ints(r, "p"), ints(r, "valid"), pt_t,
                pt_T, T_wf_dev)
            if mode == MVStereoMode.EM_PLUS_ESTIMATION:
                est = self.refine(matches, T_wv, ts_l, ts_r, T_wf_dev)
            else:
                est = self.to_estimates(matches, T_wv)
        out["map_estimates"] = int(torch.sum(est.valid))
        self._push_history(est)
        self.T_world_frame = T_wf
        if mode == MVStereoMode.EM_PLUS_ESTIMATION:
            self.grid, self._map_pts, self._map_ok, _, _ = \
                self.cycle.rebuild_frame(self.history, T_wf_dev)
        else:
            self.grid, self._map_pts, self._map_ok = self.cycle.seed_frame(
                self.history, T_wf_dev)
        self.stats["map_points"] = int(torch.sum(self._map_ok))
        out["map_points"] = self.stats["map_points"]
        return out
