"""The WORKING mapping cycle (the part of esvo_tpu/runtime/system.py this
port has so far).

``MappingCycle`` holds the stereo rig as buffers and the fusion window as
state. One cycle is the JAX package's three programs:

- ``render_tick``: insert a tick's events and render both surfaces
  (kernel K3 rectifies both backward renders in one launch);
- ``mapping_estimate``: denoise -> compact -> LUT rectify -> pose-table
  interpolation -> ZNCC block matching -> windowed depth LM (kernels K1,
  K2) -> culling;
- ``rebuild_frame``: propagate the whole window -> Student-t fusion ->
  clean -> regularize -> export the map points.

Tracking, the SGM bootstrap and the system state machine come with later
slices of the port.
"""
from __future__ import annotations

import torch
from torch import nn

from esvo_tpu_torch._device import resolve_device
from esvo_tpu_torch.geometry.camera import Camera, PinholeParams, StereoRig
from esvo_tpu_torch.geometry.se3 import interpolate_pose_table, se3_inverse
from esvo_tpu_torch.mapping import block_matching as bm
from esvo_tpu_torch.mapping import depth_refinement as dr
from esvo_tpu_torch.mapping import fusion as fu
from esvo_tpu_torch.mapping import initialization as init
from esvo_tpu_torch.mapping.regularization import regularize
from esvo_tpu_torch.ops.interp import gather2d
from esvo_tpu_torch.runtime.config import MappingCycleConfig
from esvo_tpu_torch.surface import time_surface as tsf

_CAMERA_TENSORS = ("K", "D", "R", "P")
_CAMERA_MAPS = ("lut", "inv_map", "mask")


class MappingCycle(nn.Module):
    """One stereo rig's WORKING mapping cycle with its fusion window."""

    def __init__(self, rig: StereoRig, cfg: MappingCycleConfig | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg or MappingCycleConfig()
        dev = resolve_device(device)
        self._meta = {}
        for side in ("left", "right"):
            cam = getattr(rig, side)
            for name in _CAMERA_TENSORS:
                self.register_buffer(f"{side}_{name}",
                                     getattr(cam.params, name).to(dev))
            for name in _CAMERA_MAPS:
                self.register_buffer(f"{side}_{name}",
                                     getattr(cam, name).to(dev))
            self._meta[side] = (cam.params.width, cam.params.height,
                                cam.params.model)
        self.register_buffer("T_right_left", rig.T_right_left.to(dev))
        self.register_buffer("baseline", rig.baseline.to(dev))
        self.H = rig.left.height
        self.W = rig.left.width
        self.N = self.cfg.mapping.process_event_num
        self.F = self.cfg.history_frames
        self.reset()

    @property
    def device(self) -> torch.device:
        return self.left_lut.device

    @property
    def dtype(self) -> torch.dtype:
        return self.left_lut.dtype

    def _camera(self, side: str) -> Camera:
        width, height, model = self._meta[side]
        g = lambda name: getattr(self, f"{side}_{name}")
        params = PinholeParams(K=g("K"), D=g("D"), R=g("R"), P=g("P"),
                               width=width, height=height, model=model)
        return Camera(params=params, lut=g("lut"), inv_map=g("inv_map"),
                      mask=g("mask"))

    @property
    def rig(self) -> StereoRig:
        return StereoRig(left=self._camera("left"),
                         right=self._camera("right"),
                         T_right_left=self.T_right_left,
                         baseline=self.baseline)

    def reset(self) -> None:
        """Empty fusion window (every slot invalid)."""
        F, N, dt, dev = self.F, self.N, self.dtype, self.device
        z = lambda *s: torch.zeros(s, dtype=dt, device=dev)
        self.history = dr.DepthEstimates(
            x=z(F, N, 2), inv_depth=-torch.ones((F, N), dtype=dt, device=dev),
            variance=z(F, N), scale2=z(F, N), nu=z(F, N), residual=z(F, N),
            age=torch.zeros((F, N), dtype=torch.int32, device=dev),
            p_cam=z(F, N, 3),
            T_world_cam=torch.eye(4, dtype=dt, device=dev).expand(
                F, N, 4, 4).clone(),
            valid=torch.zeros((F, N), dtype=torch.bool, device=dev))
        self.hist_slot = 0

    # -- the three programs of one cycle -----------------------------------
    def render_tick(self, st_l: tsf.TimeSurfaceState,
                    st_r: tsf.TimeSurfaceState, ev_l: tsf.EventBatch,
                    ev_r: tsf.EventBatch, t_sync):
        """Insert one tick's events, render both surfaces. Returns
        (st_l, st_r, surface_left, surface_right)."""
        cfg = self.cfg.surface
        t = torch.as_tensor(t_sync, dtype=torch.float32, device=self.device)
        st_l = tsf.insert_events(st_l, ev_l)
        st_r = tsf.insert_events(st_r, ev_r)
        cam_l, cam_r = self._camera("left"), self._camera("right")
        if cfg.mode == "backward":
            s_l, s_r = tsf.render_backward_pair(st_l, st_r, t, cam_l, cam_r,
                                                cfg)
            return st_l, st_r, s_l, s_r
        return (st_l, st_r, tsf.render_forward(st_l, t, cam_l, cfg),
                tsf.render_forward(st_r, t, cam_r, cfg))

    def compact(self, valid: torch.Tensor, *arrays):
        """Move the first N valid lanes to the front (stable), so the
        batched stages run at the fixed width N."""
        order = torch.argsort((~valid).to(torch.int8), stable=True)[:self.N]
        return (valid[order],) + tuple(a[order] for a in arrays)

    def lut_lookup(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Rectified (x, y) of raw pixels through the left camera's LUT."""
        lut = self.left_lut
        yi = torch.clamp(y, 0, self.H - 1)
        xi = torch.clamp(x, 0, self.W - 1)
        return torch.stack([gather2d(lut[..., 0], yi, xi),
                            gather2d(lut[..., 1], yi, xi)], dim=-1)

    def mapping_estimate(self, ts_l, ts_r, ev_x, ev_y, ev_t, ev_valid,
                         pose_times, pose_tab, T_world_frame):
        """One WORKING cycle's estimate stage. Returns (estimates (N,),
        number valid, block-matching failure counters)."""
        cfg, H, W = self.cfg, self.H, self.W
        rig = self.rig
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
        # f32 batched product; TF32 stays off (PyTorch's default for
        # matmul, torch.backends.cuda.matmul.allow_tf32 == False)
        T_lv = torch.matmul(se3_inverse(T_world_frame), T_wv)
        est = dr.solve(matches.x_left, T_wv, T_lv, matches.inv_depth,
                       matches.valid, ev_t, ts_l, ts_r, rig, cfg.depth)
        est = dr.point_culling(
            est, cfg.mapping.std_var_vis_threshold, cfg.cost_vis_threshold,
            cfg.mapping.inv_depth_min_range, cfg.mapping.inv_depth_max_range)
        return est, torch.sum(est.valid), bm_stats

    def rebuild_frame(self, history: dr.DepthEstimates,
                      T_world_frame: torch.Tensor):
        """Propagate + fuse the whole window into a fresh depth frame,
        clean, regularize. Returns (grid, points_world, occupied,
        num_fused, num_dropped)."""
        cfg, H, W = self.cfg, self.H, self.W
        left = self._camera("left")
        flat = history.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        grid = fu.empty_grid(H, W, self.dtype, self.device)
        cand = fu.propagate_points(flat, se3_inverse(T_world_frame), left,
                                   cfg.fusion)
        grid, nfused, ndrop = fu.fuse_frame(grid, cand, left, cfg.fusion)
        grid = fu.clean_grid(
            grid, cfg.mapping.std_var_vis_threshold ** 2,
            cfg.mapping.age_vis_threshold, cfg.mapping.inv_depth_max_range,
            cfg.mapping.inv_depth_min_range)
        if cfg.mapping.regularization:
            grid = regularize(grid, cfg.regularizer)
        pts_world, occ = fu.grid_points_world(grid, T_world_frame)
        return grid, pts_world, occ, nfused, ndrop

    def push_history(self, est: dr.DepthEstimates) -> None:
        """Write one cycle's estimates into the next ring slot."""
        slot = self.hist_slot
        for name in vars(est):
            getattr(self.history, name)[slot] = getattr(est, name).to(
                getattr(self.history, name).dtype)
        self.hist_slot = (slot + 1) % self.F
