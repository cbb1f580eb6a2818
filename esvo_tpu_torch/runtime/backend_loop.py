"""Sliding-window bundle-adjustment layer over the runtime system (port
of esvo_tpu/runtime/backend_loop.py).

Keyframes are sampled from the mapper's depth frames, associated across
views by voxel-hashed world proximity (backend.keyframes), and a sliding
window of recent keyframes is refined with the Schur-complement BA
(backend.bundle_adjustment). The pose correction of the newest keyframe
is folded back into the system's live state through
``apply_world_correction``, bounding tracker drift. Works over
``EsvoSystem`` and over a running ``ResidentLoop`` alike (the loop mirrors
a correction into its device state).

Usage:
    backend = BackendLoop(system, keyframe_every=5, window=6)
    ...
    out = system.process_tick(...)
    backend.maybe_update(out)     # after each mapping tick
"""
from __future__ import annotations

import os

import numpy as np

from esvo_tpu_torch.backend.bundle_adjustment import BAConfig, bundle_adjust
from esvo_tpu_torch.backend.keyframes import KeyframeGraph, build_ba_problem
from esvo_tpu_torch.parallel import sharding as ps
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus


class BackendLoop:
    def __init__(self, system: EsvoSystem, keyframe_every: int = 5,
                 window: int = 6, max_points_per_kf: int = 400,
                 ba_config: BAConfig | None = None,
                 voxel_size: float = 0.05, mesh=None):
        """mesh: a 1-D DeviceMesh of SPMD ranks (parallel/sharding.py):
        BA then runs through sharded_bundle_adjust with the observation
        axis sharded (all-reduced Schur assembly)."""
        self.mesh = None if mesh is None else ps.check_mesh(mesh)
        self.system = system
        self.keyframe_every = keyframe_every
        self.window = window
        self.max_points_per_kf = max_points_per_kf
        # two fixed poses pin the SE(3) + scale gauge of the window
        self.ba_cfg = ba_config or BAConfig(max_iterations=8,
                                            num_fixed_poses=2)
        P = system.rig.left.params.P.cpu().double().numpy()
        self._intr = (float(P[0, 0]), float(P[1, 1]), float(P[0, 2]),
                      float(P[1, 2]))
        self.voxel_size = voxel_size
        self._mapping_cycles = 0
        self._last_kf_cycle = 0
        # sliding window of (time, T_world_kf, p_cam (frame-local), uv,
        # valid): points kept in keyframe-camera coordinates, so a refined
        # pose moves its points
        self._kfs: list[tuple] = []
        self.num_ba_runs = 0
        self.num_rejected_corrections = 0
        self.last_correction = np.eye(4)
        self._seen_reset = getattr(system, "reset_count", 0)
        # plausibility gate on the fold-back correction: between two BA
        # updates genuine drift is millimetres / milliradians, so a large
        # correction means the solve diverged — rejected, not clamped
        self.max_correction_trans = 0.05   # m
        self.max_correction_rot = 0.05     # rad

    def _sample_keyframe(self):
        """The current depth frame's best points + their pixels, padded
        to max_points_per_kf (valid=False lanes): fixed shapes, as the
        JAX package keeps them for its compiled programs."""
        sys = self.system
        grid = sys.grid
        occ = grid.occupied.cpu().numpy()
        ys, xs = np.nonzero(occ)
        if len(ys) == 0:
            return None
        var = grid.variance.cpu().numpy()[ys, xs]
        order = np.argsort(var)[:self.max_points_per_kf]
        ys, xs = ys[order], xs[order]
        uv = grid.x.cpu().numpy()[ys, xs]               # sub-pixel coords
        p_cam = grid.p_cam.cpu().numpy()[ys, xs]
        T = np.asarray(sys.T_world_frame)
        cap = self.max_points_per_kf
        n = len(ys)
        ok = np.zeros(cap, bool)
        ok[:n] = True
        p_pad = np.zeros((cap, 3))
        p_pad[:n] = p_cam
        uv_pad = np.zeros((cap, 2))
        uv_pad[:n] = uv
        return (sys.last_tick_time, T, p_pad, uv_pad, ok)

    def maybe_update(self, tick_out: dict) -> dict | None:
        """Call after a mapping tick; runs BA when the window advances.
        Returns a BA stats dict or None."""
        sys = self.system
        # a system reset re-zeroes the world frame: keyframes built in
        # the previous frame must not mix into the next BA window
        if getattr(sys, "reset_count", 0) != self._seen_reset:
            self._seen_reset = sys.reset_count
            self._last_kf_cycle = 0
            self._kfs = []
            self._mapping_cycles = 0
        # only a tick whose mapping cycle published counts
        if sys.status != SystemStatus.WORKING \
                or not ("bm_stats" in tick_out or "sgm_points" in tick_out):
            return None
        # a resident dispatch covers several mapping cycles (n_cycles):
        # cadence is counted in cycles, sampled at call granularity
        self._mapping_cycles += int(tick_out.get("n_cycles", 1))
        if self._mapping_cycles - self._last_kf_cycle < self.keyframe_every:
            return None
        self._last_kf_cycle = self._mapping_cycles
        kf = self._sample_keyframe()
        if kf is None:
            return None
        self._kfs.append(kf)
        if len(self._kfs) < 3:
            return None
        self._kfs = self._kfs[-self.window:]

        fx, fy, cx, cy = self._intr
        graph = KeyframeGraph(fx=fx, fy=fy, cx=cx, cy=cy,
                              voxel_size=self.voxel_size)
        for (t, T, p_cam, uv, ok) in self._kfs:
            pts_world = p_cam @ T[:3, :3].T + T[:3, 3]
            graph.add_keyframe(T, pts_world, uv, ok)
        if graph.multiview_fraction() < 0.1:
            return None
        prob = build_ba_problem(graph, max_points=2000, dtype=sys.dtype,
                                device=sys.device)
        if self.mesh is not None:
            prob, costs = ps.sharded_bundle_adjust(self.mesh, self.ba_cfg)(
                ps.pad_observations(self.mesh, prob))
        else:
            prob, costs = bundle_adjust(prob, self.ba_cfg)
        self.num_ba_runs += 1

        # fold the newest keyframe's correction into the live state (all
        # of it: pose table, ref maps, history poses, global map)
        T_old = self._kfs[-1][1]
        T_all = prob.T_world_kf.cpu().double().numpy()
        corr = T_all[-1] @ np.linalg.inv(T_old)
        c = costs.cpu().double().numpy()
        stats = {"ba_cost_initial": float(c[0]),
                 "ba_cost_final": float(c[-1]),
                 "num_keyframes": graph.num_keyframes,
                 "num_points": graph.num_points,
                 "multiview_fraction": graph.multiview_fraction()}
        if not self._accept_correction(corr, c):
            self.num_rejected_corrections += 1
            stats["ba_correction_rejected"] = True
            # drop the window: its associations produced a diverged
            # solve, and re-optimizing the same data would re-diverge
            self._kfs = self._kfs[-1:]
            return stats
        self.last_correction = corr
        sys.apply_world_correction(corr)
        # refresh stored keyframe poses with the refined ones (their
        # frame-local points follow)
        self._kfs = [(t, Tk, p_cam, uv, ok)
                     for (t, _, p_cam, uv, ok), Tk in zip(self._kfs, T_all)]
        return stats

    def _accept_correction(self, corr: np.ndarray, costs: np.ndarray) \
            -> bool:
        """Plausibility gate: finite, cost non-increasing, and within the
        drift bound a fraction-of-a-second window can accumulate."""
        if not np.isfinite(corr).all() or not np.isfinite(costs).all():
            return False
        if costs[-1] > costs[0]:
            return False
        dt = float(np.linalg.norm(corr[:3, 3]))
        ang = float(np.arccos(np.clip(
            (np.trace(corr[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
        return dt <= self.max_correction_trans \
            and ang <= self.max_correction_rot

    # -- checkpoint / resume (keyframes are ragged: concatenated + offsets),
    # the JAX package's file and fields
    _CKPT_FILE = "backend_ba.npz"

    def save(self, path: str) -> None:
        """Write the BA-window state next to a system checkpoint."""
        K = len(self._kfs)
        pts = [k[2] for k in self._kfs] if K else [np.zeros((0, 3))]
        uvs = [k[3] for k in self._kfs] if K else [np.zeros((0, 2))]
        oks = [k[4] for k in self._kfs] if K else [np.zeros(0, bool)]
        np.savez_compressed(
            os.path.join(path, self._CKPT_FILE),
            times=np.asarray([k[0] for k in self._kfs]),
            poses=(np.stack([k[1] for k in self._kfs]) if K
                   else np.zeros((0, 4, 4))),
            pts=np.concatenate(pts), uvs=np.concatenate(uvs),
            oks=np.concatenate(oks),
            counts=np.asarray([len(p) for p in pts], np.int64)[:K],
            mapping_cycles=self._mapping_cycles,
            num_ba_runs=self.num_ba_runs,
            last_correction=self.last_correction)

    def load(self, path: str) -> bool:
        """Restore from a checkpoint dir (the port's or the JAX
        package's); returns False if absent."""
        f = os.path.join(path, self._CKPT_FILE)
        if not os.path.exists(f):
            return False
        d = np.load(f)
        offs = np.concatenate([[0], np.cumsum(d["counts"])]).astype(int)
        self._kfs = [
            (float(d["times"][k]), d["poses"][k],
             d["pts"][offs[k]:offs[k + 1]],
             d["uvs"][offs[k]:offs[k + 1]],
             d["oks"][offs[k]:offs[k + 1]])
            for k in range(len(d["counts"]))]
        self._mapping_cycles = int(d["mapping_cycles"])
        self._last_kf_cycle = self._mapping_cycles
        self.num_ba_runs = int(d["num_ba_runs"])
        self.last_correction = d["last_correction"]
        self._seen_reset = getattr(self.system, "reset_count", 0)
        return True
