"""Loop-closure + pose-graph layer over the runtime system (port of
esvo_tpu/runtime/pose_graph_loop.py).

Keyframes sampled from the mapper carry a time-surface descriptor
(backend.loop_closure); on a detected and geometrically verified revisit
the keyframe chain plus every accepted loop edge is optimized as an
SE(3) pose graph (backend.pose_graph) and the newest keyframe's
correction is folded back into the live system. Works over
``EsvoSystem`` and over a running ``ResidentLoop`` alike.

Usage:
    pgl = PoseGraphLoop(system, keyframe_every=5)
    ...
    out = system.process_tick(...)
    pgl.maybe_update(out)        # after each tick

Shapes are bucketed as in the JAX package (poses to multiples of 32,
edges of 64): the padding enters the dense solve through the damping, so
both packages solve the same systems.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from esvo_tpu_torch.backend import loop_closure as lc
from esvo_tpu_torch.backend import pose_graph as pg
from esvo_tpu_torch.parallel import sharding as ps
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from esvo_tpu_torch.tracking import registration as reg


def _bucket(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class PoseGraphLoop:
    def __init__(self, system: EsvoSystem, keyframe_every: int = 5,
                 max_points_per_kf: int = 600,
                 lc_config: lc.LoopClosureConfig | None = None,
                 pg_config: pg.PoseGraphConfig | None = None,
                 reg_config: reg.RegProblemConfig | None = None,
                 odom_w_rot: float = 100.0, odom_w_trans: float = 100.0,
                 mesh=None):
        """mesh: a 1-D DeviceMesh of SPMD ranks (parallel/sharding.py):
        the pose-graph LM then runs through sharded_pose_graph with the
        edge axis sharded; edge buckets are multiples of 64, so the mesh
        size must divide 64."""
        self.mesh = None if mesh is None else ps.check_mesh(mesh)
        if self.mesh is not None and 64 % self.mesh.size():
            raise ValueError(f"mesh size {self.mesh.size()} must divide the "
                             "64-edge bucket")
        self.system = system
        self.device = getattr(system, "device", None)
        self.keyframe_every = keyframe_every
        self.max_points_per_kf = max_points_per_kf
        self.lc_cfg = lc_config or lc.LoopClosureConfig()
        self.pg_cfg = pg_config or pg.PoseGraphConfig(
            max_iterations=15, huber_threshold=10.0)
        # verification solver for verify_loop: more LM rounds than the
        # per-tick tracker
        self.reg_cfg = reg_config or reg.RegProblemConfig(
            batch_size=500, max_iteration=20, huber_threshold=50.0)
        self.odom_w = (odom_w_rot, odom_w_trans)
        self.detector = lc.LoopClosureDetector(self.lc_cfg, self.device)
        # keyframes: (time, T_world (4,4) np, p_cam (N,3), valid (N,)),
        # points kf-local so optimized poses move them
        self._kfs: list[tuple] = []
        self._loop_edges: list[tuple] = []   # (i, j, T_ij, w_rot, w_trans)
        self._mapping_cycles = 0
        self._last_kf_cycle = 0
        self._seen_reset = getattr(system, "reset_count", 0)
        self.num_loop_closures = 0
        self.num_optimizations = 0

    # ------------------------------------------------------------------
    def _sample_keyframe(self):
        """The current frame's best points, padded to max_points_per_kf
        (valid=False lanes)."""
        sys = self.system
        grid = sys.grid
        occ = grid.occupied.cpu().numpy()
        ys, xs = np.nonzero(occ)
        if len(ys) == 0:
            return None
        var = grid.variance.cpu().numpy()[ys, xs]
        order = np.argsort(var)[:self.max_points_per_kf]
        p_cam = grid.p_cam.cpu().numpy()[ys[order], xs[order]]
        T = np.asarray(sys.T_world_frame, np.float64)
        cap = self.max_points_per_kf
        n = len(order)
        ok = np.zeros(cap, bool)
        ok[:n] = True
        p_pad = np.zeros((cap, 3))
        p_pad[:n] = p_cam
        return (sys.last_tick_time, T, p_pad, ok)

    def _compact(self):
        """The descriptor database is full: evict the oldest half of the
        keyframes (loop edges remap; edges into the evicted prefix are
        dropped — their corrections are already folded into the
        poses)."""
        shift = len(self._kfs) // 2
        if shift == 0:
            return
        self._kfs = self._kfs[shift:]
        self.detector.drop_oldest(shift)
        self._loop_edges = [(i - shift, j - shift, T, wr, wt)
                            for (i, j, T, wr, wt) in self._loop_edges
                            if i >= shift and j >= shift]

    def _optimize(self):
        """Pose-graph optimization over the keyframe chain + loop edges;
        fold the newest keyframe's correction into the live system."""
        K = len(self._kfs)
        Kp = _bucket(K, 32)
        Ep = _bucket(K - 1 + len(self._loop_edges), 64)
        dtype = torch.float64 if self.system.dtype == torch.float64 \
            else torch.float32
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        T = np.stack([np.eye(4)] * Kp)
        for k, (t, Tk, *_rest) in enumerate(self._kfs):
            T[k] = Tk
        ei = np.zeros(Ep, np.int64)
        ej = np.zeros(Ep, np.int64)
        T_ij = np.stack([np.eye(4)] * Ep)
        w_rot = np.zeros(Ep)
        w_trans = np.zeros(Ep)
        valid = np.zeros(Ep, bool)
        # the odometry edges measure the chain in the graph's dtype, as
        # the JAX package computes them from its cast poses
        Tc = T.astype(np_dtype)
        for k in range(K - 1):
            ei[k], ej[k] = k, k + 1
            T_ij[k] = np.linalg.inv(Tc[k]) @ Tc[k + 1]
            w_rot[k], w_trans[k] = self.odom_w
            valid[k] = True
        for n, (i, j, Tij, wr, wt) in enumerate(self._loop_edges):
            s = K - 1 + n
            ei[s], ej[s] = i, j
            T_ij[s] = Tij
            w_rot[s] = wr
            w_trans[s] = wt
            valid[s] = True

        dev = self.device
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        graph = pg.PoseGraph(
            T_world=f(Tc), edge_i=torch.as_tensor(ei, device=dev),
            edge_j=torch.as_tensor(ej, device=dev), T_ij=f(T_ij),
            w_rot=f(w_rot), w_trans=f(w_trans),
            edge_valid=torch.as_tensor(valid, device=dev))
        if self.mesh is not None:
            graph, costs = ps.sharded_pose_graph(self.mesh, self.pg_cfg)(
                graph)
        else:
            graph, costs = pg.optimize_pose_graph(graph, self.pg_cfg)
        self.num_optimizations += 1

        T_opt = graph.T_world.cpu().double().numpy()
        T_old_last = self._kfs[-1][1]
        corr = T_opt[K - 1] @ np.linalg.inv(T_old_last)
        self.system.apply_world_correction(corr)
        self._kfs = [(t, T_opt[k], p, ok)
                     for k, (t, _, p, ok) in enumerate(self._kfs)]
        c = costs.cpu().double().numpy()
        return {"pg_cost_initial": float(c[0]),
                "pg_cost_final": float(c[-1]),
                "pg_num_poses": K,
                "pg_num_loop_edges": len(self._loop_edges)}

    # ------------------------------------------------------------------
    def maybe_update(self, tick_out: dict) -> dict | None:
        """Call after each tick; on keyframe cadence queries the
        loop-closure database and optimizes when a loop verifies.
        Returns a stats dict when anything happened."""
        sys = self.system
        if getattr(sys, "reset_count", 0) != self._seen_reset:
            self._seen_reset = sys.reset_count
            self._kfs = []
            self._loop_edges = []
            self._mapping_cycles = 0
            self._last_kf_cycle = 0
            self.detector = lc.LoopClosureDetector(self.lc_cfg, self.device)
        if sys.status != SystemStatus.WORKING \
                or not ("bm_stats" in tick_out or "sgm_points" in tick_out):
            return None
        # a resident dispatch covers several mapping cycles (n_cycles)
        self._mapping_cycles += int(tick_out.get("n_cycles", 1))
        if self._mapping_cycles - self._last_kf_cycle < self.keyframe_every:
            return None
        self._last_kf_cycle = self._mapping_cycles
        ts_l = tick_out.get("ts_left")
        if ts_l is None:
            return None
        kf = self._sample_keyframe()
        if kf is None:
            return None
        if self.detector.count >= self.lc_cfg.capacity:
            self._compact()

        # query BEFORE adding the current surface (one descriptor shared
        # by query and add)
        desc = lc.ts_descriptor(ts_l, self.lc_cfg.desc_grid)
        cand, sim = self.detector.query_descriptor(desc)
        stats = {"lc_candidate": cand, "lc_similarity": sim}
        accepted = False
        if cand >= 0 and sim >= self.lc_cfg.min_similarity \
                and cand < len(self._kfs):
            # 3D-3D verification: align the candidate and current
            # keyframes' local clouds
            t_c, T_c, p_cam_c, ok_c = self._kfs[cand]
            t_n, T_n, p_cam_n, ok_n = kf
            # the clouds in the system's float (the JAX package's default
            # float: float32, float64 under jax_enable_x64)
            f = lambda a: torch.as_tensor(np.asarray(a), dtype=sys.dtype,
                                          device=ts_l.device)
            b = lambda a: torch.as_tensor(np.asarray(a, bool),
                                          device=ts_l.device)
            accepted, T_edge, frac, mean_d, icp_info = lc.verify_loop_icp(
                f(p_cam_c), b(ok_c), f(p_cam_n), b(ok_n),
                T_c, T_n, self.lc_cfg, gap_s=float(t_n) - float(t_c))
            stats["lc_inlier_fraction"] = frac
            stats["lc_mean_dist"] = mean_d
            stats.update({f"lc_{k}": v for k, v in icp_info.items()
                          if k.startswith("corr")})
        self.detector.add_descriptor(desc)
        self._kfs.append(kf)

        if accepted:
            # information weight scaled by the ICP inlier statistics
            q = icp_info["quality"]
            self._loop_edges.append(
                (cand, len(self._kfs) - 1, T_edge,
                 self.lc_cfg.w_rot * q, self.lc_cfg.w_trans * q))
            self.num_loop_closures += 1
            stats["lc_edge_quality"] = q
            stats.update(self._optimize())
        return stats

    def loop_edges(self):
        """[(t_i, t_j, T_ij (4, 4))] of the accepted loop edges, stamped
        with their keyframes' tick times."""
        return [(float(self._kfs[i][0]), float(self._kfs[j][0]),
                 np.asarray(T, np.float64))
                for (i, j, T, _wr, _wt) in self._loop_edges]

    def optimized_trajectory(self):
        """(times (K,), T_world (K, 4, 4)) of the keyframe chain."""
        if not self._kfs:
            return np.zeros(0), np.zeros((0, 4, 4))
        return (np.asarray([k[0] for k in self._kfs]),
                np.stack([k[1] for k in self._kfs]))

    # -- checkpoint / resume: the JAX package's file and fields
    _CKPT_FILE = "pose_graph.npz"

    def save(self, path: str) -> None:
        """Write the loop-closure state next to a system checkpoint."""
        K = len(self._kfs)
        pts = ([k[2] for k in self._kfs] if K else
               [np.zeros((0, 3))])
        oks = ([k[3] for k in self._kfs] if K else [np.zeros(0, bool)])
        counts = np.asarray([len(p) for p in pts], np.int64)[:K]
        E = len(self._loop_edges)
        np.savez_compressed(
            os.path.join(path, self._CKPT_FILE),
            times=np.asarray([k[0] for k in self._kfs]),
            poses=(np.stack([k[1] for k in self._kfs]) if K
                   else np.zeros((0, 4, 4))),
            pts=np.concatenate(pts), oks=np.concatenate(oks),
            counts=counts,
            edge_i=np.asarray([e[0] for e in self._loop_edges], np.int64),
            edge_j=np.asarray([e[1] for e in self._loop_edges], np.int64),
            edge_T=(np.stack([e[2] for e in self._loop_edges]) if E
                    else np.zeros((0, 4, 4))),
            edge_wr=np.asarray([e[3] for e in self._loop_edges]),
            edge_wt=np.asarray([e[4] for e in self._loop_edges]),
            desc=self.detector._D.cpu().numpy(),
            desc_count=self.detector.count,
            mapping_cycles=self._mapping_cycles,
            num_loop_closures=self.num_loop_closures,
            num_optimizations=self.num_optimizations)

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
             d["pts"][offs[k]:offs[k + 1]], d["oks"][offs[k]:offs[k + 1]])
            for k in range(len(d["counts"]))]
        E = len(d["edge_i"])
        # checkpoints without per-edge weights: the config's full weight
        wr = d["edge_wr"] if "edge_wr" in d \
            else np.full(E, self.lc_cfg.w_rot)
        wt = d["edge_wt"] if "edge_wt" in d \
            else np.full(E, self.lc_cfg.w_trans)
        self._loop_edges = [
            (int(i), int(j), T, float(wr[n]), float(wt[n]))
            for n, (i, j, T) in enumerate(zip(d["edge_i"], d["edge_j"],
                                              d["edge_T"]))]
        self.detector._D = torch.as_tensor(d["desc"], dtype=torch.float32,
                                           device=self.detector._D.device)
        self.detector.count = int(d["desc_count"])
        self._mapping_cycles = int(d["mapping_cycles"])
        self._last_kf_cycle = self._mapping_cycles
        self.num_loop_closures = int(d["num_loop_closures"])
        self.num_optimizations = int(d["num_optimizations"])
        self._seen_reset = getattr(self.system, "reset_count", 0)
        return True
