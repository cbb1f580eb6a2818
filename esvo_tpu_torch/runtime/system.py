"""The ESVO system loop (port of esvo_tpu/runtime/system.py).

``MappingCycle`` holds the stereo rig as buffers and the fusion window as
state. Its programs are the JAX package's:

- ``render_tick``: insert a tick's events and render both surfaces
  (kernel K3 rectifies both backward renders in one launch);
- ``mapping_estimate``: denoise -> compact -> LUT rectify -> pose-table
  interpolation -> ZNCC block matching -> windowed depth LM (kernels K1,
  K2) -> culling;
- ``rebuild_frame``: propagate the whole window -> Student-t fusion ->
  clean -> regularize -> export the map points;
- ``sgm_estimate`` and ``seed_frame``: the SGM bootstrap and its naive
  fusion;
- ``working_cycle``: ``mapping_estimate`` -> ``write_history`` ->
  ``rebuild_frame`` on static buffers, on the card one CUDA graph replay
  (the live path's WORKING cycle; runtime/resident.py graphs whole rolls).

``EsvoSystem`` is the host-side scheduler around one ``MappingCycle``:
per sync tick it renders the surfaces and, while WORKING, registers the
map to the new left surface (the tracker), on the card without a mesh as
one CUDA graph replay on static buffers (``_tick_static``); every 1 /
mapping_rate it runs a mapping cycle (or, in INITIALIZATION, the SGM
bootstrap). It keeps the state machine, the pose table with its
rigidity and velocity guard, the REF_HISTORY ring of map exports, the
global cloud and the trajectory.
``process_ticks`` is the fused roll: K inserts and K chained tracking
solves (one left render a tick), one point selection, both surfaces
rendered once at the end, and the mapping cycle's hand-off one roll late.

Each entry point runs on ``cuda`` unless the caller passes ``device=``.
The tracker's stochastic point selection draws from a ``torch.Generator``
on the system's device, seeded from ``seed`` (the JAX package's
``jax.random`` stream cannot be reproduced); ``select_ref_points`` is
separate from the track bodies, so a caller can hand them any selection,
and is itself one draw (``draw_ref_scores``) and a selection that draws
nothing (``select_from_scores``), which runtime/resident.py replays in a
CUDA graph. The entry points (``MappingCycle``'s stages, ``track``,
``process_tick[s]``, ``flush``) run under utils/precision.py's
``highest_precision``: full float32 matmuls whatever the caller set.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import os
import warnings

import numpy as np
import torch
from torch import nn

from esvo_tpu_torch._device import resolve_device
from esvo_tpu_torch.geometry.camera import Camera, PinholeParams, StereoRig
from esvo_tpu_torch.geometry.se3 import (interpolate_pose_table, se3_inverse,
                                         transform_points)
from esvo_tpu_torch.mapping import block_matching as bm
from esvo_tpu_torch.mapping import depth_refinement as dr
from esvo_tpu_torch.mapping import fusion as fu
from esvo_tpu_torch.mapping import initialization as init
from esvo_tpu_torch.mapping.regularization import regularize
from esvo_tpu_torch.ops import _build
from esvo_tpu_torch.ops.interp import gather2d
from esvo_tpu_torch.parallel import sharding as ps
from esvo_tpu_torch.runtime.config import SystemConfig
from esvo_tpu_torch.surface import time_surface as tsf
from esvo_tpu_torch.tracking import registration as reg
from esvo_tpu_torch.utils.precision import highest_precision
from esvo_tpu_torch.utils.profiling import count, device_span, span

_CAMERA_TENSORS = ("K", "D", "R", "P")
_CAMERA_MAPS = ("lut", "inv_map", "mask")


class MappingCycle(nn.Module):
    """One stereo rig's mapping programs with its fusion window."""

    def __init__(self, rig: StereoRig, cfg: SystemConfig | None = None,
                 device=None, mesh=None):
        super().__init__()
        self.cfg = cfg or SystemConfig()
        # a DeviceMesh shards the inserts and the depth solve over its
        # ranks (parallel/sharding.py)
        self.mesh = mesh
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
        self._static: dict = {}       # working_cycle's buffers by signature
        self.reset()

    @property
    def device(self) -> torch.device:
        return self.left_lut.device

    @property
    def dtype(self) -> torch.dtype:
        return self.left_lut.dtype

    def camera(self, side: str) -> Camera:
        width, height, model = self._meta[side]
        g = lambda name: getattr(self, f"{side}_{name}")
        params = PinholeParams(K=g("K"), D=g("D"), R=g("R"), P=g("P"),
                               width=width, height=height, model=model)
        return Camera(params=params, lut=g("lut"), inv_map=g("inv_map"),
                      mask=g("mask"))

    @property
    def rig(self) -> StereoRig:
        return StereoRig(left=self.camera("left"),
                         right=self.camera("right"),
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

    # -- surfaces ------------------------------------------------------------
    @highest_precision()
    def render_left(self, st_l: tsf.TimeSurfaceState, t_sync):
        """The left surface alone (the tracker's per-tick input)."""
        cfg = self.cfg.surface
        t = torch.as_tensor(t_sync, dtype=torch.float32, device=self.device)
        render = (tsf.render_backward if cfg.mode == "backward"
                  else tsf.render_forward)
        return render(st_l, t, self.camera("left"), cfg)

    @highest_precision()
    def render_pair(self, st_l: tsf.TimeSurfaceState,
                    st_r: tsf.TimeSurfaceState, t_sync):
        """Both surfaces at t_sync; backward renders share one K3
        launch."""
        cfg = self.cfg.surface
        t = torch.as_tensor(t_sync, dtype=torch.float32, device=self.device)
        cam_l, cam_r = self.camera("left"), self.camera("right")
        if cfg.mode == "backward":
            return tsf.render_backward_pair(st_l, st_r, t, cam_l, cam_r, cfg)
        return (tsf.render_forward(st_l, t, cam_l, cfg),
                tsf.render_forward(st_r, t, cam_r, cfg))

    @highest_precision()
    def render_tick(self, st_l: tsf.TimeSurfaceState,
                    st_r: tsf.TimeSurfaceState, ev_l: tsf.EventBatch,
                    ev_r: tsf.EventBatch, t_sync):
        """Insert one tick's events, render both surfaces. Returns
        (st_l, st_r, surface_left, surface_right)."""
        st_l = self.insert(st_l, ev_l)
        st_r = self.insert(st_r, ev_r)
        return (st_l, st_r) + tuple(self.render_pair(st_l, st_r, t_sync))

    def insert(self, st: tsf.TimeSurfaceState,
               ev: tsf.EventBatch) -> tsf.TimeSurfaceState:
        """insert_events; with a mesh the frame is padded to a mesh
        multiple (valid=False lanes) and each rank scatters its block
        (sharded_surface_update: the same grids bit for bit)."""
        if self.mesh is None:
            return tsf.insert_events(st, ev)
        return ps.sharded_surface_update(self.mesh, st,
                                         ps.pad_events(self.mesh, ev))

    # -- the mapping programs ------------------------------------------------
    def compact(self, valid: torch.Tensor, *arrays):
        """Move the first N valid lanes to the front (stable), so the
        batched stages run at the fixed width N."""
        order = torch.argsort((~valid).to(torch.int8), stable=True)[:self.N]
        return (valid[order],) + tuple(a[order] for a in arrays)

    def lut_lookup(self, y: torch.Tensor, x: torch.Tensor,
                   side: str = "left") -> torch.Tensor:
        """Rectified (x, y) of raw pixels through one camera's LUT (the
        left one unless `side` is "right")."""
        lut = getattr(self, f"{side}_lut")
        yi = torch.clamp(y, 0, self.H - 1)
        xi = torch.clamp(x, 0, self.W - 1)
        return torch.stack([gather2d(lut[..., 0], yi, xi),
                            gather2d(lut[..., 1], yi, xi)], dim=-1)

    @highest_precision()
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
        T_lv = torch.matmul(se3_inverse(T_world_frame), T_wv)
        # with a mesh each rank refines its block of events; block
        # matching stays replicated (its cost volume is image-bound)
        solve = (ps.sharded_depth_solve(self.mesh, rig, cfg.depth)
                 if self.mesh is not None
                 else lambda *a: dr.solve(*a, rig, cfg.depth))
        est = solve(matches.x_left, T_wv, T_lv, matches.inv_depth,
                    matches.valid, ev_t, ts_l, ts_r)
        est = dr.point_culling(
            est, cfg.mapping.std_var_vis_threshold, cfg.cost_vis_threshold,
            cfg.mapping.inv_depth_min_range, cfg.mapping.inv_depth_max_range)
        return est, torch.sum(est.valid), bm_stats

    @highest_precision()
    def rebuild_frame(self, history: dr.DepthEstimates,
                      T_world_frame: torch.Tensor):
        """Propagate + fuse the whole window into a fresh depth frame,
        clean, regularize. Returns (grid, points_world, occupied,
        num_fused, num_dropped)."""
        cfg, H, W = self.cfg, self.H, self.W
        left = self.camera("left")
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

    @highest_precision()
    def sgm_estimate(self, ts_l, ts_r, ev_x, ev_y, ev_valid,
                     T_world_frame):
        """The SGM bootstrap's estimates at the tick's first N valid
        events. Returns (estimates (N,), number valid)."""
        cfg = self.cfg
        ev_valid, ev_x, ev_y = self.compact(ev_valid, ev_x, ev_y)
        est = init.sgm_depth_points(
            ts_l, ts_r, self.lut_lookup(ev_y, ev_x), ev_valid,
            T_world_frame, self.rig, cfg.sgm,
            cfg.mapping.inv_depth_min_range, cfg.mapping.inv_depth_max_range,
            init_age=cfg.mapping.age_vis_threshold)
        return est, torch.sum(est.valid)

    @highest_precision()
    def seed_frame(self, history: dr.DepthEstimates,
                   T_world_frame: torch.Tensor):
        """Naive fusion of the window for the SGM bootstrap. Returns
        (grid, points_world, occupied)."""
        left = self.camera("left")
        flat = history.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        cand = fu.propagate_points(flat, se3_inverse(T_world_frame), left,
                                   self.cfg.fusion)
        grid = fu.naive_fuse_frame(
            fu.empty_grid(self.H, self.W, self.dtype, self.device), cand,
            left, self.cfg.fusion)
        pts_world, occ = fu.grid_points_world(grid, T_world_frame)
        return grid, pts_world, occ

    def push_history(self, est: dr.DepthEstimates) -> None:
        """Write one cycle's estimates into the next ring slot."""
        slot = torch.tensor(self.hist_slot, dtype=torch.int64,
                            device=self.history.valid.device)
        self.history = self.write_history(self.history, est, slot)
        self.hist_slot = (self.hist_slot + 1) % self.F

    @staticmethod
    def write_history(history: dr.DepthEstimates, est: dr.DepthEstimates,
                      slot: torch.Tensor) -> dr.DepthEstimates:
        """A new window with one cycle's estimates at `slot`, a 0-d int64
        tensor (the JAX package's ``_tree_stack_slot``): the slot stays on
        the device, so a CUDA graph does not bake it in."""
        idx = slot.reshape(1)
        return dr.DepthEstimates(**{
            name: h.index_copy(0, idx, getattr(est, name)[None].to(h.dtype))
            for name, h in vars(history).items()})

    # -- the WORKING cycle on static buffers ---------------------------------
    @highest_precision()
    def working_cycle(self, ts_l, ts_r, ev: dict, pose_times, pose_tab,
                      T_world_frame):
        """One WORKING cycle, advancing the window: mapping_estimate ->
        write_history at hist_slot -> rebuild_frame. ev: the left frame's
        x, y, t, valid; pose_times (S,), pose_tab (S, 4, 4),
        T_world_frame (4, 4): host arrays.

        The cycle reads static buffers that the host fills first (on the
        card the host arrays go through one pinned buffer and one
        non-blocking copy). On the card without a mesh it is one replay of
        a CUDA graph, captured at the first cycle of each input signature
        (event capacity and dtypes); on the CPU, or with a mesh (a sharded
        cycle is not captured, as ``ResidentLoop`` refuses a mesh), the
        same body runs eagerly. The graphs live on the cycle, so
        ``EsvoSystem.reconfigure`` drops them with it.

        Returns (grid, points_world, occupied, counters, bm_keys):
        counters is one int64 row (estimates, the block-matching counters
        in bm_keys' order, fusions, dropped candidates, map points). Every
        tensor returned, and the new ``history``, lies in storage made for
        this cycle, never in a buffer that a later cycle writes: callers
        keep them by reference (the REF_HISTORY ring; a copy of the state
        taken before a tick) and must read the same values after any later
        cycle."""
        host = ([torch.as_tensor(np.asarray(ev[k])) for k in ("x", "y")]
                + [torch.as_tensor(np.asarray(ev["t"]), dtype=self.dtype),
                   torch.as_tensor(np.asarray(ev["valid"]))]
                + [torch.as_tensor(np.asarray(a), dtype=self.dtype)
                   for a in (pose_times, pose_tab, T_world_frame)])
        graphed = self.device.type == "cuda" and self.mesh is None
        with span("tick.map.stage"):
            st = self._static_cycle([ts_l, ts_r], host)
            st.ts[0].copy_(ts_l)
            st.ts[1].copy_(ts_r)
            if st.pinned is not None:
                # refill the pinned buffer only once its last copy has
                # finished
                st.ready.synchronize()
                for p, h in zip(st.pinned.views, host):
                    p.copy_(h)
                st.inputs.data.copy_(st.pinned.data, non_blocking=True)
                st.ready.record(torch.cuda.current_stream(self.device))
            else:
                for d, h in zip(st.inputs.views, host):
                    d.copy_(h)
            # the static window holds what this signature's last cycle
            # published; a window rebound since (a world correction, a
            # degrade, a bootstrap, another signature's cycle) is copied in.
            # The published window is never changed in place.
            if self.history is not st.published:
                for d, h in zip(st.window.views, vars(self.history).values()):
                    d.copy_(h)
            st.slot.fill_(self.hist_slot)
        if graphed:
            if st.graph is None:
                self._capture(st)
            with device_span("tick.map.replay"):
                st.graph.replay()
            for kernel, n in st.launches.items():
                kernel.replayed += n
            count("cycle.replays")
        else:
            self._cycle_into_buffers(st)
            count("cycle.eager")
        with span("tick.map.publish"):
            st.published = self.history = dr.DepthEstimates(
                *st.window.fresh())
            *grid, counters = st.out.fresh()
            pts, occ = st.map.fresh()
        self.hist_slot = (self.hist_slot + 1) % self.F
        return fu.DepthGrid(*grid), pts, occ, counters, st.bm_keys

    def _static_cycle(self, ts: list, host: list) -> "_StaticCycle":
        """The static buffers for inputs of this signature, allocated at
        its first cycle."""
        key = tuple((tuple(a.shape), a.dtype) for a in ts + host)
        st = self._static.get(key)
        if st is None:
            dev = self.device
            specs = [(a.shape, a.dtype) for a in host]
            on_card = dev.type == "cuda"
            st = self._static[key] = _StaticCycle(
                ts=[torch.empty_like(a, device=dev) for a in ts],
                inputs=_Packed(specs, dev),
                window=_Packed([(h.shape, h.dtype) for h in
                                vars(self.history).values()], dev),
                slot=torch.zeros((), dtype=torch.int64, device=dev),
                pinned=_Packed(specs, "cpu", pin=True) if on_card else None,
                ready=torch.cuda.Event() if on_card else None)
        return st

    def _cycle_body(self, ts: list, inputs: list, window: list,
                    slot: torch.Tensor) -> tuple:
        """The cycle on the given inputs, which it leaves as they are.
        Returns (the new window's fields, the grid's fields and the
        counters, [points, occupancy], the block-matching counters'
        keys): the groups that ``_StaticCycle`` packs apart."""
        est, n, bm_stats = self.mapping_estimate(*ts, *inputs)
        history = self.write_history(dr.DepthEstimates(*window), est, slot)
        grid, pts, occ, nf, nd = self.rebuild_frame(history, inputs[-1])
        counters = torch.stack([c.to(torch.int64) for c in (
            n, *bm_stats.values(), nf, nd, torch.sum(occ))])
        return (list(vars(history).values()),
                [*vars(grid).values(), counters], [pts, occ], tuple(bm_stats))

    def _cycle_into_buffers(self, st: "_StaticCycle") -> None:
        """What a graph captures: the cycle on the static inputs, its new
        window and outputs written into the static buffers."""
        window, out, ref_map, st.bm_keys = self._cycle_body(
            st.ts, st.inputs.views, st.window.views, st.slot)
        if st.out is None:
            st.out = _Packed.like(out, self.device)
            st.map = _Packed.like(ref_map, self.device)
        for buf, got in ((st.window, window), (st.out, out),
                         (st.map, ref_map)):
            for d, o in zip(buf.views, got):
                d.copy_(o)

    def _capture(self, st: "_StaticCycle") -> None:
        """Warm up on copies of the static inputs (``_warm_up``; the
        outputs' buffers sized from it), then capture one cycle
        (``_capture_graph``). Errors propagate and keep no graph: nothing
        runs eagerly in the graph's place."""
        with span("tick.map.capture"):
            _, out, ref_map, _ = _warm_up(
                self.device, lambda: self._cycle_body(
                    _copies(st.ts), _copies(st.inputs.views),
                    _copies(st.window.views), st.slot.clone()))
            if st.out is None:
                st.out = _Packed.like(out, self.device)
                st.map = _Packed.like(ref_map, self.device)
            st.graph, st.launches = _capture_graph(
                lambda: self._cycle_into_buffers(st))


def _copies(tensors) -> list:
    return [t.clone() for t in tensors]


def _state_tensors(st_l: tsf.TimeSurfaceState,
                   st_r: tsf.TimeSurfaceState) -> list:
    """Both surface states' tensors, left's fields first."""
    return [*vars(st_l).values(), *vars(st_r).values()]


def _warm_up(device, body):
    """``body()`` on a side stream ordered after the current one, which
    then waits for it: a graph's warm-up, filling every lazy cache
    (kernel builds, cached constants, library handles) before the
    capture. Returns what the body returns."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = body()
    torch.cuda.current_stream().wait_stream(side)
    return got


def _capture_graph(body) -> tuple:
    """Capture ``body()`` as a CUDA graph. Returns (graph, launches): the
    capture's kernel calls launched nothing, so they move from each
    wrapper's ``launches`` to the replay's count, which the caller adds
    to ``replayed`` at each replay."""
    graph = torch.cuda.CUDAGraph()
    before = _build.launch_counts()
    with torch.cuda.graph(graph):
        body()
    launches = {k: k.launches - n for k, n in before.items()
                if k.launches != n}
    for kernel, n in launches.items():
        kernel.launches -= n
    count("graph.captures")
    return graph, launches


class _Packed:
    """Tensors of fixed shapes and dtypes laid out in one byte buffer, so
    that the set moves in one copy. Each starts at a 256-byte boundary,
    as a fresh allocation does."""

    def __init__(self, specs: list, device, pin: bool = False):
        self.specs = []       # (shape, contiguous strides, dtype, offset)
        end = 0
        for shape, dtype in specs:
            strides = tuple(math.prod(shape[i + 1:])
                            for i in range(len(shape)))
            # the offset in elements of the dtype
            self.specs.append((tuple(shape), strides, dtype,
                               end // dtype.itemsize))
            end += -(-math.prod(shape) * dtype.itemsize // 256) * 256
        self.data = torch.empty(end, dtype=torch.uint8, device=device,
                                pin_memory=pin)
        self.views = self.unpack(self.data)

    @classmethod
    def like(cls, tensors: list, device) -> "_Packed":
        return cls([(t.shape, t.dtype) for t in tensors], device)

    def unpack(self, data: torch.Tensor) -> list:
        """The tensors as views of `data`, a whole buffer of this
        layout."""
        typed = {dtype: data.view(dtype) for _, _, dtype, _ in self.specs}
        return [typed[dtype].as_strided(shape, strides, offset)
                for shape, strides, dtype, offset in self.specs]

    def fresh(self) -> list:
        """The tensors as views of a copy of the buffer: storage that no
        later write to the buffer reaches."""
        return self.unpack(self.data.clone())


@dataclasses.dataclass
class _StaticCycle:
    """One input signature's buffers of ``MappingCycle.working_cycle``:
    the inputs that the host fills before each cycle, the window and the
    outputs that the cycle writes and, on the card, its graph."""
    ts: list                      # the two surfaces
    inputs: _Packed               # x, y, t, valid, the pose table and
    #                               T_world_frame (mapping_estimate's order)
    window: _Packed               # the window's fields: read, then written
    slot: torch.Tensor            # 0-d int64 ring slot
    pinned: _Packed | None        # host staging of `inputs` (card only)
    ready: object                 # CUDA event after the last staging copy
    # sized at the first cycle: the grid's fields and the counters; the
    # map export (points, occupancy), apart since the REF_HISTORY ring
    # keeps it for several cycles
    out: _Packed | None = None
    map: _Packed | None = None
    published: object = None      # the window this signature published
    graph: object = None
    launches: dict = dataclasses.field(default_factory=dict)  # a replay's,
    #                               by kernel wrapper
    bm_keys: tuple = ()


# a live tick's host inputs: each camera's event arrays in EventBatch's
# fields and dtypes, then the tick time and the two poses
_EVENT_FIELDS = (("x", torch.int32), ("y", torch.int32),
                 ("t", torch.float32), ("p", torch.bool),
                 ("valid", torch.bool))


@dataclasses.dataclass
class _StaticTick:
    """One body's buffers of a live tick (``EsvoSystem._tick_static``)
    for one input signature."""
    inputs: _Packed               # 2 x 5 event arrays, t_sync, T_world_frame,
    #                               T_world_cur
    host: list                    # numpy views the host fills: of `pinned`
    #                               on the card, else of `inputs`
    pinned: _Packed | None        # host staging of `inputs` (card only)
    ready: object                 # CUDA event after the last staging copy
    state: _Packed                # both surfaces' states: read, then written
    sel: _Packed | None           # the tracker's points and flags; None in
    #                               the render-only body
    # sized at the first tick: the two surfaces and, tracked, the row of
    # the pose, the per-round rms and the point count
    out: _Packed | None = None
    published: tuple = (None, None)  # the states this body last published
    graph: object = None
    launches: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

def _pose_is_rigid(T: np.ndarray, tol: float = 0.05) -> bool:
    """Finite, near-orthonormal rotation with det ~ 1."""
    if T.shape != (4, 4) or not np.isfinite(T).all():
        return False
    R = T[:3, :3]
    return (abs(float(np.linalg.det(R)) - 1.0) < tol
            and float(np.linalg.norm(R @ R.T - np.eye(3))) < tol)


class SystemStatus(enum.Enum):
    INITIALIZATION = "INITIALIZATION"
    WORKING = "WORKING"
    TERMINATE = "TERMINATE"


class EsvoSystem:
    """Host-side orchestrator of the mapping programs and the tracker.

    mesh: a 1-D DeviceMesh (parallel/sharding.py make_mesh) of SPMD
    ranks, each running this system on the same inputs. The time-surface
    inserts and the mapping cycle's depth solve then shard the event axis
    over the ranks (the reference's NUM_THREAD_MAPPING event striping);
    block matching (image-bound) and tracking (the reference's one
    tracking thread) stay replicated. Every rank seeds its generator
    alike, so all ranks draw the same points and hold the same state."""

    def __init__(self, rig: StereoRig, config: SystemConfig | None = None,
                 pose_table_size: int = 1024, seed: int = 0,
                 emit_debug_maps: bool = False, mesh=None, device=None):
        self.cfg = config or SystemConfig()
        self.mesh = None if mesh is None else ps.check_mesh(mesh)
        self._check_mesh_divides(self.cfg)
        self._rig = rig
        self.cycle = MappingCycle(rig, self.cfg, device=device,
                                  mesh=self.mesh)
        self.device = self.cycle.device
        self.H, self.W = self.cycle.H, self.cycle.W
        self.dtype = self.cycle.dtype
        self.status = SystemStatus.INITIALIZATION
        self.emit_debug_maps = emit_debug_maps
        self.pose_table_size = pose_table_size
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._pending_mapping = None
        # callbacks of apply_world_correction (a live ResidentLoop mirrors
        # each correction into its device state)
        self._world_correction_observers: list = []
        self._ticks: dict = {}        # _tick_static's buffers by signature
        self.reset()

    @property
    def N(self) -> int:
        return self.cycle.N

    @property
    def F(self) -> int:
        return self.cycle.F

    @property
    def rig(self) -> StereoRig:
        return self.cycle.rig

    @property
    def history(self) -> dr.DepthEstimates:
        return self.cycle.history

    @history.setter
    def history(self, value: dr.DepthEstimates) -> None:
        self.cycle.history = value

    def reconfigure(self, config: SystemConfig, reset: bool = True):
        """Runtime parameter update (the reference's dynamic_reconfigure,
        whose change callback resets the system). Rebuilds the
        MappingCycle; ``reset=False`` keeps the live state when the event
        budget and the fusion window keep their shapes."""
        self._check_mesh_divides(config)
        old = self.cycle
        self.cfg = config
        self.cycle = MappingCycle(self._rig, config, device=self.device,
                                  mesh=self.mesh)
        self._ticks = {}              # their graphs hold the old config
        if reset or self.N != old.N or self.F != old.F:
            self.reset()
        else:
            self.cycle.history, self.cycle.hist_slot = (old.history,
                                                        old.hist_slot)

    def _check_mesh_divides(self, config: SystemConfig) -> None:
        n = config.mapping.process_event_num
        if self.mesh is not None and n % self.mesh.size():
            raise ValueError(
                f"process_event_num {n} must be divisible by the mesh size "
                f"{self.mesh.size()} for event-axis sharding")

    # -- state -----------------------------------------------------------------
    def reset(self):
        """Full state reset."""
        H, W, dev = self.H, self.W, self.device
        self.ts_state_left = tsf.init_state(H, W, dev)
        self.ts_state_right = tsf.init_state(H, W, dev)
        self.grid = fu.empty_grid(H, W, self.dtype, dev)
        self.T_world_frame = np.eye(4)
        self.cycle.reset()
        self._frames_filled = 0
        self.pose_times = [0.0]
        self.pose_list = [np.eye(4)]
        self.T_world_cur = np.eye(4)
        self.traj_times: list[float] = []
        self.traj_poses: list[np.ndarray] = []
        self.status = SystemStatus.INITIALIZATION
        self.last_tick_time: float | None = None
        self.last_mapping_time: float | None = None
        self.events_since_last_obs = 0
        self.stats = {"fusions": 0, "dropped": 0, "map_points": 0,
                      "low_event_ticks": 0, "pose_miss_skips": 0,
                      "tracking_rejects": 0, "bm": {}}
        self._consec_rejects = 0
        self._ref_maps: list[tuple] = []   # (pts, ok, n_points)
        self._map_pts = None
        self._map_ok = None
        self._global_voxels: dict = {}
        self._pending_mapping = None
        self.reset_count = getattr(self, "reset_count", 0) + 1

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def apply_world_correction(self, corr: np.ndarray) -> None:
        """Left-multiply every world-frame quantity of the live state by
        the 4x4 `corr`: poses, ref maps, the window's per-point poses,
        the pending map and the global cloud. Frame-local state (the
        grid's p_cam, the surfaces) is untouched."""
        corr = np.asarray(corr, np.float64)
        R, tr = corr[:3, :3], corr[:3, 3]
        self.T_world_cur = corr @ self.T_world_cur
        self.T_world_frame = corr @ self.T_world_frame
        self.pose_list = [corr @ T for T in self.pose_list]
        self.traj_poses = [corr @ T for T in self.traj_poses]
        cj = self._tensor(corr)
        move_pts = lambda pts: transform_points(cj, pts)

        self._ref_maps = [(move_pts(p), ok, n)
                          for (p, ok, n) in self._ref_maps]
        if self._map_pts is not None:
            self._map_pts = move_pts(self._map_pts)
        self.history = self.history.replace(T_world_cam=torch.einsum(
            "ij,fnjk->fnik", cj, self.history.T_world_cam))
        if self._pending_mapping is not None:
            self._pending_mapping["pts"] = move_pts(
                self._pending_mapping["pts"])
        if self._global_voxels:
            pts = np.stack(list(self._global_voxels.values())) @ R.T + tr
            self._global_voxels = dict(zip(self._global_voxels.keys(), pts))
        for callback in self._world_correction_observers:
            callback(corr)

    # -- tracking --------------------------------------------------------------
    def draw_ref_scores(self) -> torch.Tensor:
        """One roll's (H*W,) uniform draws from the system's generator:
        the random part of the registration-point selection."""
        return torch.rand(self.H * self.W, generator=self._gen,
                          device=self.device)

    def select_ref_points(self, pts_world: torch.Tensor,
                          pt_valid: torch.Tensor):
        """Stochastic selection of <= M registration points from a map
        export (valid points first, in random order): one draw, then
        select_from_scores. Returns (pts (M, 3), ok (M,))."""
        return self.select_from_scores(pts_world, pt_valid,
                                       self.draw_ref_scores())

    def select_from_scores(self, pts_world: torch.Tensor,
                           pt_valid: torch.Tensor, score: torch.Tensor):
        """The <= M registration points of a map export (H, W) ordered by
        `score` (H*W,), valid points first. Draws nothing."""
        M = self.cfg.tracker.max_registration_points
        flat_pts = pts_world.reshape(-1, 3)
        flat_ok = pt_valid.reshape(-1)
        score = score + torch.where(flat_ok, 0.0, 1e3)
        idx = torch.argsort(score, stable=True)[:M]
        return flat_pts[idx], flat_ok[idx]

    @highest_precision()
    def track(self, ts_l: torch.Tensor, T_world_ref: torch.Tensor,
              T_world_cur: torch.Tensor, pts: torch.Tensor, ok: torch.Tensor):
        """Register selected world points to the left surface ts_l from
        the guess T_world_cur. Returns (T_est (4, 4), rms
        (max_iteration,))."""
        prob = reg.make_problem(T_world_ref.to(self.dtype),
                                T_world_cur.to(self.dtype), pts, ok, ts_l,
                                self.cfg.tracker)
        _, T_est, rms = reg.solve(prob, self.cycle.camera("left"),
                                  self.cfg.tracker)
        return T_est, rms

    def _track_tick_body(self, st_l, st_r, evl, evr, ts, T_world_ref,
                         T_ref_world, p_ref, ok, T_cur):
        """One sync tick of a tracked roll: insert events, render the left
        surface, register the (pre-selected, ref-frame) map points to it.
        Returns (st_l, st_r, s_l, T_est, rms)."""
        st_l = self.cycle.insert(st_l, evl)
        st_r = self.cycle.insert(st_r, evr)
        s_l = self.cycle.render_left(st_l, ts).to(self.dtype)
        T_ref_left = torch.matmul(T_ref_world, T_cur.to(self.dtype))
        neg, gu, gv = reg.negative_time_surface(
            s_l, self.cfg.tracker.kernel_size)
        prob = reg.RegProblem(
            R=T_ref_left[:3, :3], t=T_ref_left[:3, 3],
            T_world_ref=T_world_ref, points=p_ref, point_valid=ok,
            ts_negative=neg, grad_u=gu, grad_v=gv)
        _, T_est, rms = reg.solve(prob, self.cycle.camera("left"),
                                  self.cfg.tracker)
        return st_l, st_r, s_l, T_est, rms

    # -- helpers ---------------------------------------------------------------
    def _event_batch(self, ev: dict) -> tsf.EventBatch:
        return tsf.EventBatch.from_arrays(ev["x"], ev["y"], ev["t"], ev["p"],
                                          ev["valid"], device=self.device)

    def _pose_arrays(self):
        """Fixed-size (pose_table_size,) stamped-pose table as host arrays:
        the newest poses, padded by repeating the last one at strictly
        increasing times (queries past the end clamp to the latest pose)."""
        S = self.pose_table_size
        times = np.asarray(self.pose_times[-S:], np.float64)
        poses = np.asarray(self.pose_list[-S:])
        n = len(times)
        if n < S:
            times = np.concatenate([times,
                                    times[-1] + 1e-5 * np.arange(1, S - n + 1)])
            poses = np.concatenate(
                [poses, np.repeat(poses[-1:], S - n, axis=0)])
        return times, poses

    def _pose_table(self):
        """``_pose_arrays`` on the device."""
        return tuple(map(self._tensor, self._pose_arrays()))

    def record_pose(self, t: float, T_world_cam: np.ndarray):
        """Feed a pose into the pose table (ground truth in MVStereo mode,
        the tracker's in the closed loop). A non-finite or non-rigid pose
        is rejected (the previous one kept, counted); so is a rigid one
        that implies motion above the tracking section's speed bounds,
        until max_consecutive_rejects rejections in a row re-anchor the
        guard to the incoming pose."""
        T = np.asarray(T_world_cam)
        if not _pose_is_rigid(T):
            self.stats["tracking_rejects"] += 1
            return
        if self.pose_times:
            tc = self.cfg.tracking
            dt_s = max(float(t) - self.pose_times[-1],
                       1.0 / tc.tracking_rate_hz)
            dist = float(np.linalg.norm(T[:3, 3] - self.T_world_cur[:3, 3]))
            dR = self.T_world_cur[:3, :3].T @ T[:3, :3]
            ang = float(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0,
                                          -1.0, 1.0)))
            if (dist > tc.max_speed_mps * dt_s + 0.01
                    or ang > tc.max_ang_speed_rps * dt_s + 0.02):
                self.stats["tracking_rejects"] += 1
                self._consec_rejects += 1
                if self._consec_rejects < tc.max_consecutive_rejects:
                    return
                warnings.warn(
                    f"velocity guard re-anchoring after "
                    f"{self._consec_rejects} consecutive rejections "
                    f"(sustained motion above {tc.max_speed_mps} m/s?)")
        self._consec_rejects = 0
        self.pose_times.append(float(t))
        self.pose_list.append(T)
        self.T_world_cur = T

    def _push_history(self, est: dr.DepthEstimates):
        self.cycle.push_history(est)
        self._frames_filled = min(self._frames_filled + 1, self.F)

    def _push_ref_map(self, pts, ok, n_points: int):
        """Append a map export to the REF_HISTORY ring."""
        self._ref_maps.append((pts, ok, n_points))
        R = self.cfg.tracking.ref_history_length
        if len(self._ref_maps) > R:
            self._ref_maps = self._ref_maps[-R:]

    def _current_ref_map(self):
        """Newest ring map with enough points for registration, or None:
        a collapsed newest cycle falls back to an older map."""
        need = self.cfg.tracker.batch_size
        for pts, ok, n in reversed(self._ref_maps):
            if n >= need:
                return pts, ok, n
        return None

    def _accumulate_global_map(self, pts_world, occ, leaf: float = 0.01):
        """Voxel-downsampled global cloud: one point per occupied voxel,
        newest wins (host side)."""
        with span("tick.global_map"):
            p = pts_world.detach().cpu().numpy().reshape(-1, 3)
            p = p[occ.detach().cpu().numpy().reshape(-1)]
            count("host_reads", 2)
            if len(p) == 0:
                return
            keys = np.floor(p / leaf).astype(np.int64)
            k = ((keys[:, 0] + (1 << 20)) << 42) \
                + ((keys[:, 1] + (1 << 20)) << 21) + (keys[:, 2] + (1 << 20))
            self._global_voxels.update(zip(k.tolist(), p))

    def global_map(self) -> np.ndarray:
        """(M, 3) accumulated voxel-downsampled world point cloud."""
        if not self._global_voxels:
            return np.zeros((0, 3))
        return np.stack(list(self._global_voxels.values()))

    # -- pipeline stages -------------------------------------------------------
    @highest_precision()
    def process_tick(self, t_sync: float, ev_left: dict, ev_right: dict,
                     gt_pose: np.ndarray | None = None,
                     do_mapping: bool | None = None):
        """One sync tick. ev_*: dicts from io.events.frame_events for one
        frame (arrays shaped (cap,)). gt_pose: if given, MVStereo mode
        (known poses; tracking bypassed). do_mapping: force a mapping
        cycle on / off; None schedules it from mapping_rate_hz. Returns a
        dict of per-tick outputs."""
        with span("tick", t=t_sync, mapped=False) as root:
            # timestamp-inconsistency watchdog
            if self.last_tick_time is not None:
                dt = t_sync - self.last_tick_time
                if dt < 0 or dt >= 0.5:
                    self.reset()
            self.last_tick_time = t_sync
            if do_mapping is None:
                period = 1.0 / self.cfg.mapping.mapping_rate_hz
                do_mapping = (self.last_mapping_time is None
                              or t_sync - self.last_mapping_time
                              >= period - 1e-9)

            out = {"t": t_sync, "status": self.status.value}
            # a cycle parked by a roll is published before this tick uses
            # it
            fin = self._finalize_pending_mapping()
            if fin:
                out.update(fin)
            # the tick's body: render both surfaces and, WORKING with a
            # usable map and no given pose, track; one graph replay on the
            # card without a mesh
            ref = self._current_ref_map()
            if not (gt_pose is None and self.status == SystemStatus.WORKING):
                ref = None
            body = (self._tick_static
                    if self.device.type == "cuda" and self.mesh is None
                    else self._tick_plain)
            ts_l, ts_r, host = body(t_sync, ev_left, ev_right, ref)
            out["ts_left"] = ts_l
            out["ts_right"] = ts_r
            self.events_since_last_obs = int(np.sum(ev_left["valid"]))
            if self.events_since_last_obs < self.cfg.tracker.min_num_events:
                self.stats["low_event_ticks"] += 1
                out["low_events"] = True

            if gt_pose is not None:
                self.record_pose(t_sync, gt_pose)
            elif host is not None:
                self.record_pose(t_sync, host[:16].reshape(4, 4))
                out["tracking_rms"] = host[16:-1]
                out["lm_stats"] = {"n_points": int(host[-1]),
                                   "n_iter": self.cfg.tracker.max_iteration,
                                   "rms": float(host[-2])}

            self.traj_times.append(t_sync)
            self.traj_poses.append(self.T_world_cur.copy())
            if not do_mapping:
                return out

            T_wf = self.T_world_cur.copy()
            if self.status == SystemStatus.INITIALIZATION:
                self._sgm_bootstrap(t_sync, ts_l, ts_r, ev_left, T_wf, out)
            elif self._dispatch_mapping(t_sync, ts_l, ts_r, ev_left, T_wf,
                                        gt_mode=gt_pose is not None,
                                        out=out):
                root.set(mapped=True)
                fin = self._finalize_pending_mapping()
                if fin:
                    out.update(fin)
            out["map_points"] = self.stats["map_points"]
            if self.emit_debug_maps:
                out["maps"] = self.render_debug_maps()
            return out

    # -- a live tick's body ----------------------------------------------------
    def _tick_plain(self, t_sync, ev_left: dict, ev_right: dict, ref):
        """The tick's body, eager (the CPU, a mesh): insert both frames,
        render both surfaces and, given a ref map `ref`, select its points
        and track. Advances the surface states. Returns (surface left,
        surface right, the host row of the pose, the per-round rms and the
        point count as float64, or None untracked)."""
        with span("tick.render"):
            self.ts_state_left, self.ts_state_right, ts_l, ts_r = \
                self.cycle.render_tick(
                    self.ts_state_left, self.ts_state_right,
                    self._event_batch(ev_left),
                    self._event_batch(ev_right), t_sync)
            ts_l = ts_l.to(self.dtype)
            ts_r = ts_r.to(self.dtype)
        count("tick.eager")
        if ref is None:
            return ts_l, ts_r, None
        with span("tick.track"):
            pts, ok = self.select_ref_points(ref[0], ref[1])
            T_est, rms = self.track(
                ts_l, self._tensor(self.T_world_frame),
                self._tensor(self.T_world_cur), pts, ok)
            # one transfer: the pose, the per-round rms, the points used
            with span("tick.track.read"):
                host = torch.cat([T_est.reshape(-1), rms,
                                  torch.sum(ok).to(rms.dtype)[None]]).cpu()
            count("host_reads")
        return ts_l, ts_r, host.double().numpy()

    def _tick_static(self, t_sync, ev_left: dict, ev_right: dict, ref):
        """``_tick_plain``'s operations on static buffers: the same
        results, bit for bit. The selection runs first, eagerly (through
        the instance's ``select_ref_points``); the host arrays go through
        one pinned buffer and one non-blocking copy; the surface states
        are copied in only when they are not what this body last
        published (a reset, a roll of ``process_ticks``, the other body).
        On the card one replay of a CUDA graph, captured at the first tick
        of each body and input signature (event capacities); elsewhere
        the body runs eagerly into the buffers. The surfaces and the
        states it publishes lie in storage made for this tick, which no
        later tick writes."""
        sel = None if ref is None else self.select_ref_points(ref[0],
                                                              ref[1])
        host = [np.asarray(ev[k]) for ev in (ev_left, ev_right)
                for k, _ in _EVENT_FIELDS] + [
            t_sync, self.T_world_frame, self.T_world_cur]
        with span("tick.stage"):
            st = self._static_tick(host, sel)
            if st.pinned is not None:
                # refill the pinned buffer only once its last copy has
                # finished
                st.ready.synchronize()
            for d, h in zip(st.host, host):
                np.copyto(d, h, casting="unsafe")
            if st.pinned is not None:
                st.inputs.data.copy_(st.pinned.data, non_blocking=True)
                st.ready.record(torch.cuda.current_stream(self.device))
            states = (self.ts_state_left, self.ts_state_right)
            if any(a is not b for a, b in zip(states, st.published)):
                for d, s in zip(st.state.views, _state_tensors(*states)):
                    d.copy_(s)
            if sel is not None:
                for d, s in zip(st.sel.views, sel):
                    d.copy_(s)
        if self.device.type == "cuda":
            if st.graph is None:
                self._capture_tick(st)
            with device_span("tick.replay"):
                st.graph.replay()
            for kernel, n in st.launches.items():
                kernel.replayed += n
            count("tick.replays")
        else:
            self._tick_into_buffers(st)
            count("tick.eager")
        with span("tick.publish"):
            state = st.state.fresh()
            half = len(state) // 2
            self.ts_state_left = tsf.TimeSurfaceState(*state[:half])
            self.ts_state_right = tsf.TimeSurfaceState(*state[half:])
            st.published = (self.ts_state_left, self.ts_state_right)
            ts_l, ts_r, *row = st.out.fresh()
        if not row:
            return ts_l, ts_r, None
        with span("tick.track.read"):
            row = row[0].cpu()
        count("host_reads")
        return ts_l, ts_r, row.double().numpy()

    def _static_tick(self, host: list, sel) -> _StaticTick:
        """The static buffers of this body and input signature, allocated
        at its first tick."""
        key = (tuple(np.shape(h) for h in host[:-3]),
               None if sel is None
               else tuple((tuple(t.shape), t.dtype) for t in sel))
        st = self._ticks.get(key)
        if st is None:
            dev = self.device
            specs = [(np.shape(h), dtype) for h, (_, dtype) in zip(
                host, _EVENT_FIELDS * 2)]
            specs += [((), torch.float32), ((4, 4), self.dtype),
                      ((4, 4), self.dtype)]
            inputs = _Packed(specs, dev)
            on_card = dev.type == "cuda"
            pinned = _Packed(specs, "cpu", pin=True) if on_card else None
            st = self._ticks[key] = _StaticTick(
                inputs=inputs, host=[v.numpy() for v in (
                    pinned or inputs).views], pinned=pinned,
                ready=torch.cuda.Event() if on_card else None,
                state=_Packed.like(_state_tensors(
                    self.ts_state_left, self.ts_state_right), dev),
                sel=None if sel is None else _Packed.like(sel, dev))
        return st

    def _tick_body(self, state: list, inputs: list, sel):
        """The tick on the given inputs, which it leaves as they are: the
        calls of ``_tick_plain`` in its order, on device tensors. Returns
        (the new states' tensors, [surface left, surface right] and,
        given `sel` (pts, ok), the host row)."""
        half = len(state) // 2
        ev_l = tsf.EventBatch(*inputs[:5])
        ev_r = tsf.EventBatch(*inputs[5:10])
        t_sync, T_world_frame, T_world_cur = inputs[10:]
        st_l, st_r, ts_l, ts_r = self.cycle.render_tick(
            tsf.TimeSurfaceState(*state[:half]),
            tsf.TimeSurfaceState(*state[half:]), ev_l, ev_r, t_sync)
        out = [ts_l.to(self.dtype), ts_r.to(self.dtype)]
        if sel is not None:
            pts, ok = sel
            T_est, rms = self.track(out[0], T_world_frame, T_world_cur, pts,
                                    ok)
            out.append(torch.cat([T_est.reshape(-1), rms,
                                  torch.sum(ok).to(rms.dtype)[None]]))
        return _state_tensors(st_l, st_r), out

    def _tick_into_buffers(self, st: _StaticTick) -> None:
        """What a graph captures: the tick on the static inputs, its new
        states and outputs written into the static buffers."""
        state, out = self._tick_body(
            st.state.views, st.inputs.views,
            None if st.sel is None else st.sel.views)
        if st.out is None:
            st.out = _Packed.like(out, self.device)
        for buf, got in ((st.state, state), (st.out, out)):
            for d, o in zip(buf.views, got):
                d.copy_(o)

    def _capture_tick(self, st: _StaticTick) -> None:
        """Warm up on copies of the static inputs, then capture one tick
        (as ``MappingCycle._capture``). Errors propagate and keep no
        graph."""
        with span("tick.capture"):
            _, out = _warm_up(self.device, lambda: self._tick_body(
                _copies(st.state.views), _copies(st.inputs.views),
                None if st.sel is None else _copies(st.sel.views)))
            if st.out is None:
                st.out = _Packed.like(out, self.device)
            st.graph, st.launches = _capture_graph(
                lambda: self._tick_into_buffers(st))

    def _sgm_bootstrap(self, t_sync, ts_l, ts_r, ev_left, T_wf, out):
        """SGM bootstrap cycle, synchronous: its point count decides the
        state machine."""
        with span("tick.bootstrap"):
            dev = self.device
            est, n = self.cycle.sgm_estimate(
                ts_l, ts_r, torch.as_tensor(ev_left["x"], device=dev),
                torch.as_tensor(ev_left["y"], device=dev),
                torch.as_tensor(ev_left["valid"], device=dev),
                self._tensor(T_wf))
            n = int(n)
            count("host_reads")
            out["sgm_points"] = n
            if n >= self.cfg.mapping.init_sgm_num_threshold:
                self._push_history(est)
                self.T_world_frame = T_wf
                self.grid, self._map_pts, self._map_ok = self.cycle.seed_frame(
                    self.history, self._tensor(T_wf))
                self.stats["map_points"] = int(torch.sum(self._map_ok))
                count("host_reads")
                self._push_ref_map(self._map_pts, self._map_ok,
                                   self.stats["map_points"])
                self.status = SystemStatus.WORKING
                self.last_mapping_time = t_sync

    def _dispatch_mapping(self, t_sync, ts_l, ts_r, ev_left, T_wf,
                          gt_mode: bool, out: dict) -> bool:
        """Queue one WORKING mapping cycle on the device
        (``MappingCycle.working_cycle``: one graph replay on the card)
        without waiting for it: its outputs are parked in
        `_pending_mapping` for `_finalize_pending_mapping`. Returns False
        when the pose table no longer covers the frame's oldest event (the
        cycle is skipped)."""
        with span("tick.map"):
            ev_t = np.asarray(ev_left["t"])
            ev_ok = np.asarray(ev_left["valid"])
            if ev_ok.any() and len(self.pose_times) > 1:
                oldest_needed = float(ev_t[ev_ok].min())
                oldest_avail = self.pose_times[
                    max(len(self.pose_times) - self.pose_table_size, 0)]
                if oldest_needed < oldest_avail - 1e-9:
                    self.stats["pose_miss_skips"] += 1
                    out["pose_miss_skip"] = True
                    return False
            self.grid, self._map_pts, self._map_ok, counters, bm_keys = \
                self.cycle.working_cycle(ts_l, ts_r, ev_left,
                                         *self._pose_arrays(), T_wf)
            self._frames_filled = min(self._frames_filled + 1, self.F)
            self.T_world_frame = T_wf
            self.last_mapping_time = t_sync
            self._pending_mapping = {
                "counters": counters, "bm_keys": bm_keys,
                "pts": self._map_pts, "ok": self._map_ok, "gt_mode": gt_mode}
            return True

    def _finalize_pending_mapping(self) -> dict | None:
        """Bring the parked cycle's counters to the host, publish its map
        to the REF_HISTORY ring and run the degrade check."""
        p = self._pending_mapping
        if p is None:
            return None
        self._pending_mapping = None
        with span("tick.finalize"):
            # the cycle's counters in one transfer (working_cycle's row)
            n, *bm_vals, nf, nd, n_pts = p["counters"].tolist()
            count("host_reads")
            out = {"map_estimates": n}
            bm_stats = dict(zip(p["bm_keys"], bm_vals))
            out["bm_stats"] = bm_stats
            self.stats["bm"] = {k: self.stats["bm"].get(k, 0) + v
                                for k, v in bm_stats.items()}
            self.stats["fusions"] += nf
            self.stats["dropped"] += nd
            self.stats["map_points"] = n_pts
            self._push_ref_map(p["pts"], p["ok"], self.stats["map_points"])
            self._accumulate_global_map(p["pts"], p["ok"])
            # degrade only when no ring map can support registration
            if not p["gt_mode"] and self._current_ref_map() is None:
                self._degrade()
            out["map_points"] = self.stats["map_points"]
        return out

    def _degrade(self):
        """Drop to INITIALIZATION and invalidate the fusion window: its
        frames were built under untrusted poses, and the next bootstrap's
        seed_frame reads every slot."""
        self.status = SystemStatus.INITIALIZATION
        self._frames_filled = 0
        self.cycle.hist_slot = 0
        self.history = self.history.replace(
            valid=torch.zeros_like(self.history.valid))

    @highest_precision()
    def process_ticks(self, t_syncs, ev_left: dict, ev_right: dict,
                      gt_poses=None, do_mapping: bool | None = None):
        """K consecutive sync ticks as one roll: K inserts and (while
        WORKING) K chained tracking solves against the previous cycle's
        map, then a scheduled mapping cycle on the last tick, whose
        hand-off is consumed at the start of the next call (or by
        flush()).

        t_syncs: (K,) tick times; ev_left / ev_right: dicts of (K, cap)
        framed event arrays; gt_poses: optional (K, 4, 4) (MVStereo
        mode). Returns a dict: final surfaces, (K, 4, 4) poses, tracking
        rms, plus the previous roll's finalized mapping stats."""
        t_syncs = np.asarray(t_syncs, float)
        K = len(t_syncs)
        prev = ([self.last_tick_time] if self.last_tick_time is not None
                else [])
        dts = np.diff(np.concatenate([prev, t_syncs]))
        if len(dts) and ((dts < 0).any() or (dts >= 0.5).any()):
            # the watchdog fires on a tick: run the ticks one by one so the
            # reset lands on it; a forced cycle stays on the final tick
            per_tick = [
                self.process_tick(
                    float(t), {k: v[i] for k, v in ev_left.items()},
                    {k: v[i] for k, v in ev_right.items()},
                    gt_pose=None if gt_poses is None else gt_poses[i],
                    do_mapping=(do_mapping if i == K - 1
                                else (None if do_mapping is None
                                      else False)))
                for i, t in enumerate(t_syncs)]
            out = dict(per_tick[-1])
            out["per_tick"] = per_tick
            out["status"] = self.status.value
            return out

        out = {"t": float(t_syncs[-1]), "status": self.status.value}
        fin = self._finalize_pending_mapping()
        if fin:
            out.update(fin)
        if do_mapping is None:
            period = 1.0 / self.cfg.mapping.mapping_rate_hz
            do_mapping = (self.last_mapping_time is None
                          or t_syncs[-1] - self.last_mapping_time
                          >= period - 1e-9)

        evb_l = self._event_batch(ev_left)
        evb_r = self._event_batch(ev_right)
        t_dev = torch.as_tensor(t_syncs, dtype=torch.float32,
                                device=self.device)
        tick = lambda b, k: tsf.EventBatch(x=b.x[k], y=b.y[k], t=b.t[k],
                                           p=b.p[k], valid=b.valid[k])
        ref = self._current_ref_map()
        n_valid = np.sum(np.asarray(ev_left["valid"]), axis=1)
        self.stats["low_event_ticks"] += int(
            (n_valid < self.cfg.tracker.min_num_events).sum())
        self.events_since_last_obs = int(n_valid[-1])

        st_l, st_r = self.ts_state_left, self.ts_state_right
        if gt_poses is None and self.status == SystemStatus.WORKING \
                and ref is not None:
            # the map is fixed across the roll: select once, move the
            # points to the ref frame once
            T_world_ref = self._tensor(self.T_world_frame)
            pts, ok = self.select_ref_points(ref[0], ref[1])
            p_ref = torch.einsum("ji,nj->ni", T_world_ref[:3, :3],
                                 pts - T_world_ref[:3, 3])
            T_ref_world = se3_inverse(T_world_ref)
            T_cur = self._tensor(self.T_world_cur)
            poses, rms_last = [], []
            for k in range(K):
                st_l, st_r, _, T_cur, rms = self._track_tick_body(
                    st_l, st_r, tick(evb_l, k), tick(evb_r, k), t_dev[k],
                    T_world_ref, T_ref_world, p_ref, ok, T_cur)
                poses.append(T_cur)
                rms_last.append(rms[-1])
            s_l, s_r = self.cycle.render_pair(st_l, st_r, t_dev[-1])
            rms = torch.stack(rms_last)
            host = torch.cat([torch.stack(poses).reshape(-1), rms,
                              torch.sum(ok).to(rms.dtype)[None]]).cpu()
            count("host_reads")
            host = host.double().numpy()
            poses_np = host[:16 * K].reshape(K, 4, 4)
            for i, t in enumerate(t_syncs):
                self.record_pose(float(t), poses_np[i])
                self.traj_times.append(float(t))
                # the guarded pose: a rejected step repeats the last one
                self.traj_poses.append(self.T_world_cur.copy())
            out["tracking_rms"] = host[16 * K:-1]
            out["lm_stats"] = {"n_points": int(host[-1]),
                               "n_iter": self.cfg.tracker.max_iteration,
                               "rms": float(host[-2])}
            out["poses"] = poses_np
        else:
            for k in range(K):
                st_l = self.cycle.insert(st_l, tick(evb_l, k))
                st_r = self.cycle.insert(st_r, tick(evb_r, k))
            s_l, s_r = self.cycle.render_pair(st_l, st_r, t_dev[-1])
            for i, t in enumerate(t_syncs):
                if gt_poses is not None:
                    self.record_pose(float(t), np.asarray(gt_poses[i]))
                self.traj_times.append(float(t))
                self.traj_poses.append(self.T_world_cur.copy())
        self.ts_state_left, self.ts_state_right = st_l, st_r
        s_l, s_r = s_l.to(self.dtype), s_r.to(self.dtype)
        self.last_tick_time = float(t_syncs[-1])
        out["ts_left"] = s_l
        out["ts_right"] = s_r

        if do_mapping:
            ev_last = {k: np.asarray(v)[-1] for k, v in ev_left.items()}
            T_wf = self.T_world_cur.copy()
            if self.status == SystemStatus.INITIALIZATION:
                self._sgm_bootstrap(float(t_syncs[-1]), s_l, s_r, ev_last,
                                    T_wf, out)
            else:
                self._dispatch_mapping(float(t_syncs[-1]), s_l, s_r,
                                       ev_last, T_wf,
                                       gt_mode=gt_poses is not None,
                                       out=out)
            if self.emit_debug_maps:
                out["maps"] = self.render_debug_maps()
        out["map_points"] = self.stats["map_points"]
        return out

    @highest_precision()
    def flush(self):
        """Finalize a pending mapping cycle (call once after the last
        process_ticks of a run)."""
        return self._finalize_pending_mapping()

    # -- outputs ---------------------------------------------------------------
    def trajectory(self):
        return np.asarray(self.traj_times), np.asarray(self.traj_poses)

    def save_trajectory(self, path: str):
        """TUM export."""
        from esvo_tpu_torch.eval.trajectory import save_tum
        save_tum(path, *self.trajectory())

    def depth_map(self):
        """(inv_depth (H, W), valid (H, W)) of the current frame, numpy."""
        return (self.grid.inv_depth.cpu().numpy(),
                self.grid.occupied.cpu().numpy())

    def save_depth_map(self, save_dir: str, t: float | None = None) -> str:
        """Per-cycle depth-map txt dump: one ``x y z`` line per valid
        point (sub-pixel rectified coordinate, depth in the frame's
        camera), in a file named by the timestamp in nanoseconds. Returns
        the path."""
        os.makedirs(save_dir, exist_ok=True)
        if t is None:
            t = self.last_tick_time or 0.0
        path = os.path.join(save_dir, f"{int(round(t * 1e9))}.txt")
        occ = self.grid.occupied.cpu().numpy()
        x = self.grid.x.cpu().numpy()[occ]
        z = self.grid.p_cam.cpu().numpy()[occ][:, 2]
        np.savetxt(path, np.column_stack([x, z]), fmt="%.9g")
        return path

    def render_debug_maps(self) -> dict:
        """Per-cycle debug images: inverse depth, std, age and cost
        false-colour maps, and the tracker's reprojection overlay, as
        (H, W, 3) uint8 arrays."""
        from esvo_tpu_torch.utils import visualization as vis
        m = self.cfg.mapping
        g = {k: getattr(self.grid, k).cpu().numpy()
             for k in ("inv_depth", "variance", "age", "residual")}
        occ = self.grid.occupied.cpu().numpy()
        maps = {
            "inv_depth": vis.plot_inv_depth_map(
                g["inv_depth"], occ, m.inv_depth_min_range,
                m.inv_depth_max_range),
            "std_var": vis.plot_std_var_map(g["variance"], occ,
                                            m.std_var_vis_threshold),
            "age": vis.plot_age_map(g["age"], occ, m.age_max_range),
            "cost": vis.plot_cost_map(g["residual"], occ,
                                      self.cfg.cost_vis_threshold),
        }
        ref = self._current_ref_map()
        if ref is not None:
            maps["reprojection"] = vis.plot_reprojection_map(
                ref[0].cpu().numpy().reshape(-1, 3),
                ref[1].cpu().numpy().reshape(-1),
                np.linalg.inv(self.T_world_cur),
                self.cycle.left_P.cpu().numpy(), self.H, self.W)
        return maps
