"""Rank bodies and serial references of tests/test_torch_parallel*.py.

The rank bodies run in processes that esvo_tpu_torch.parallel.spawn_ranks
starts, which import this module by name: it imports torch, numpy and
the port only (no JAX), so a rank starts in a few seconds.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from esvo_tpu_torch.backend import bundle_adjustment as ba
from esvo_tpu_torch.backend import pose_graph as pg
from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.mapping import block_matching as bm
from esvo_tpu_torch.mapping import depth_refinement as dr
from esvo_tpu_torch.ops.linalg import solve_spd
from esvo_tpu_torch.parallel import sharding as ps
from esvo_tpu_torch.surface import time_surface as tsf
from esvo_tpu_torch.tracking import registration as reg

# tests/test_parallel.py's configurations
BM_CFG = dict(patch_size_x=5, patch_size_y=5, max_disparity=8)
DP_CFG = dict(patch_size_x=5, patch_size_y=5, max_iteration=3,
              td_fixed_point_iters=5)
REG_CFG = dict(kernel_size=0, lm_damping=1e-3)
BA_ITERS = 4
PG_ITERS = 10
LM_KERNELS = ("auto", "xla")


@contextlib.contextmanager
def one_rank_mesh(tmp_dir):
    """A 1-rank gloo mesh in this process (a file:// rendezvous in
    tmp_dir), its process group torn down on exit."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_dir}/rdzv",
                            world_size=1, rank=0)
    try:
        yield ps.make_mesh(1)
    finally:
        dist.destroy_process_group()


def _t(a, device, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def rig_of(w: dict, device):
    W, H = w["W"], w["H"]
    return make_ideal_rig(W, H, 50.0, 50.0, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                          device=device)


def ba_problem(w: dict, device) -> ba.BAProblem:
    f = lambda k: _t(w[k], device, torch.float64)
    return ba.BAProblem(
        T_world_kf=f("T_kf"), points=f("points"),
        obs_kf=_t(w["obs_kf"], device, torch.int64),
        obs_point=_t(w["obs_point"], device, torch.int64),
        obs_uv=f("obs_uv"), obs_valid=_t(w["obs_valid"], device, torch.bool),
        fx=f("fx"), fy=f("fy"), cx=f("cx"), cy=f("cy"))


def pose_graph(w: dict, device) -> pg.PoseGraph:
    f = lambda k: _t(w[k], device, torch.float64)
    return pg.PoseGraph(
        T_world=f("T_world"), edge_i=_t(w["edge_i"], device, torch.int64),
        edge_j=_t(w["edge_j"], device, torch.int64), T_ij=f("T_ij"),
        w_rot=f("w_rot"), w_trans=f("w_trans"),
        edge_valid=_t(w["edge_valid"], device, torch.bool))


def _run(worlds: dict, device, mesh=None) -> dict:
    """Every case of tests/test_parallel.py through the sharded functions
    (with a mesh) or their serial counterparts (without)."""
    out = {}
    w = worlds["surface"]
    ev = tsf.EventBatch.from_arrays(w["x"], w["y"], w["t"], w["p"],
                                    device=device)
    state = tsf.init_state(w["H"], w["W"], device)
    st = (ps.sharded_surface_update(mesh, state, ev) if mesh is not None
          else tsf.insert_events(state, ev))
    out["surface"] = (st.last_t_pos, st.last_t_neg)

    w = worlds["map"]
    rig = rig_of(w, device)
    args = [_t(w[k], device) for k in ("ts_l", "ts_r", "x_rect", "t")]
    args += [_t(w["valid"], device, torch.bool), _t(w["T"], device),
             _t(w["T"], device)]
    bm_cfg = bm.BlockMatchConfig(**BM_CFG)
    for kernel in LM_KERNELS:
        dp_cfg = dr.DepthProblemConfig(lm_kernel=kernel, **DP_CFG)
        if mesh is not None:
            est = ps.sharded_map_estimate(mesh, rig, bm_cfg, dp_cfg)(*args)
        else:
            ts_l, ts_r, x, t, v, T, _ = args
            m = bm.match_events(ts_l, ts_r, x, x, t, v, rig.left.mask, rig,
                                bm_cfg)
            est = dr.solve(m.x_left, T, T, m.inv_depth, m.valid, t, ts_l,
                           ts_r, rig, dp_cfg)
        out[f"map_{kernel}"] = est

    w = worlds["tracking"]
    cam = rig_of(w, device).left
    cfg = reg.RegProblemConfig(**REG_CFG)
    neg, gu, gv = reg.negative_time_surface(_t(w["img"], device), 0)
    R = torch.eye(3, device=device)
    t = torch.zeros(3, device=device)
    Twr = torch.eye(4, device=device)
    pts = _t(w["pts"], device)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    if mesh is not None:
        out["tracking"] = ps.sharded_tracking_step(mesh, cam, cfg)(
            R, t, Twr, neg, gu, gv, pts, ok)
    else:
        prob = reg.RegProblem(R=R, t=t, T_world_ref=Twr, points=pts,
                              point_valid=ok, ts_negative=neg, grad_u=gu,
                              grad_v=gv)
        fvec, _, _ = reg.residuals_and_weights(
            prob, torch.zeros(6, device=device), pts, ok, cam, cfg)
        J = reg.analytic_jacobian(prob, pts, ok, cam, cfg)
        f = fvec.reshape(-1)
        Hm = torch.matmul(J.T, J)
        damp = cfg.lm_damping * torch.diag(torch.diag(Hm)) \
            + 1e-12 * torch.eye(6, device=device)
        out["tracking"] = (-solve_spd(Hm + damp, torch.matmul(J.T, f)),
                           torch.sum(f * f))

    prob = ba_problem(worlds["ba_blocks"], device)
    if mesh is not None:
        fn = ps.sharded_ba_normal_equations(mesh, ba.BAConfig())
        out["ba_blocks"] = fn(prob.T_world_kf, prob.points, prob.obs_kf,
                              prob.obs_point, prob.obs_uv, prob.obs_valid,
                              prob.fx, prob.fy, prob.cx, prob.cy)
    else:
        out["ba_blocks"] = ba.assemble_normal_equations(prob,
                                                        ba.BAConfig())[:4]

    prob = ba_problem(worlds["ba"], device)
    cfg = ba.BAConfig(max_iterations=BA_ITERS)
    res, costs = (ps.sharded_bundle_adjust(mesh, cfg)(prob)
                  if mesh is not None else ba.bundle_adjust(prob, cfg))
    out["ba"] = (res.T_world_kf, res.points, costs)

    graph = pose_graph(worlds["pose_graph"], device)
    cfg = pg.PoseGraphConfig(max_iterations=PG_ITERS)
    res, costs = (ps.sharded_pose_graph(mesh, cfg)(graph)
                  if mesh is not None else pg.optimize_pose_graph(graph, cfg))
    out["pose_graph"] = (res.T_world, costs)
    return out


def sharded(worlds: dict, device) -> dict:
    """Rank body: every case with the mesh of all ranks."""
    return _run(worlds, device, ps.make_mesh())


def serial(worlds: dict, device="cpu") -> dict:
    """The same cases through the unsharded functions."""
    return _run(worlds, device)


# ---------------------------------------------------------------------------
# the runtime layers: EsvoSystem(mesh), BackendLoop(mesh), PoseGraphLoop(mesh)
# ---------------------------------------------------------------------------

def loop_config():
    """tests/test_system.py's make_config."""
    from esvo_tpu_torch.mapping.initialization import SGMConfig
    from esvo_tpu_torch.runtime.config import MappingConfig, SystemConfig
    return SystemConfig(
        depth=dr.DepthProblemConfig(max_iteration=8),
        bm=bm.BlockMatchConfig(zncc_threshold=0.25),
        sgm=SGMConfig(num_disparities=48),
        mapping=MappingConfig(process_event_num=800,
                              init_sgm_num_threshold=300,
                              std_var_vis_threshold=0.05,
                              age_vis_threshold=0, denoising=False,
                              regularization=False))


def closed_loop(w: dict, device, mesh=None) -> dict:
    """tests/test_parallel.py::test_sharded_system_closed_loop's run: 25
    ticks, a mapping cycle every 5, with a BackendLoop (a keyframe every
    cycle) attached. With a mesh also tries a ResidentLoop on the
    system."""
    from esvo_tpu_torch.runtime.backend_loop import BackendLoop
    from esvo_tpu_torch.runtime.resident import ResidentLoop
    from esvo_tpu_torch.runtime.system import EsvoSystem
    W, H, fx = w["W"], w["H"], w["fx"]
    rig = make_ideal_rig(W, H, fx, fx, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                         device=device)
    system = EsvoSystem(rig, loop_config(), mesh=mesh, device=device)
    backend = BackendLoop(system, keyframe_every=1, window=5,
                          voxel_size=0.08, mesh=mesh)
    frame = lambda f, k: {key: v[k] for key, v in f.items()}
    for k in range(w["n_ticks"]):
        out = system.process_tick(float(w["ticks"][k]), frame(w["left"], k),
                                  frame(w["right"], k),
                                  do_mapping=(k % 5 == 4))
        backend.maybe_update(out)
    t, T = system.trajectory()
    res = dict(status=system.status.value, t=np.asarray(t),
               T=np.asarray(T), map_points=system.stats["map_points"],
               ba_runs=backend.num_ba_runs)
    if mesh is not None:
        try:
            ResidentLoop(system, ticks_per_roll=5, rolls_per_dispatch=2)
        except NotImplementedError as e:
            res["resident_refused"] = str(e)
    return res


class FakeSystem:
    """tests/test_torch_loop_closure.py's stand-in for EsvoSystem
    (drifting keyframe poses, rendered views)."""

    def __init__(self, device):
        from esvo_tpu_torch.runtime.system import SystemStatus
        self.status = SystemStatus.WORKING
        self.dtype = torch.float64
        self.device = device
        self.reset_count = 0
        self.T_world_frame = np.eye(4)
        self.last_tick_time = 0.0

    def apply_world_correction(self, corr):
        self.T_world_frame = corr @ self.T_world_frame


def drift_loop(w: dict, device, mesh=None) -> dict:
    """tests/test_parallel.py::test_sharded_pose_graph_loop_corrects_drift:
    a drifting keyframe chain that revisits its start, through a
    PoseGraphLoop (the surfaces rendered by the caller)."""
    from esvo_tpu_torch.backend import loop_closure as lc
    from esvo_tpu_torch.runtime.pose_graph_loop import PoseGraphLoop
    sysf = FakeSystem(device)
    pgl = PoseGraphLoop(sysf, keyframe_every=1, mesh=mesh,
                        lc_config=lc.LoopClosureConfig(**w["lc"]))
    pts, gt, est = w["pts"], w["gt"], w["est"]
    K = len(gt) - 1

    def sample():
        Tinv = np.linalg.inv(sysf.gt_pose)
        return (sysf.last_tick_time, np.asarray(sysf.T_world_frame),
                pts @ Tinv[:3, :3].T + Tinv[:3, 3], np.ones(len(pts), bool))
    pgl._sample_keyframe = sample
    for k in range(K + 1):
        sysf.last_tick_time = float(k)
        if k > 0:
            sysf.T_world_frame = sysf.T_world_frame @ (
                np.linalg.inv(est[k - 1]) @ est[k])
        sysf.gt_pose = gt[k]
        pgl.maybe_update({"ts_left": _t(w["surfaces"][k], device,
                                        torch.float64), "bm_stats": {}})
    return dict(closures=pgl.num_loop_closures,
                T_frame=np.asarray(sysf.T_world_frame),
                T_opt=np.asarray(pgl.optimized_trajectory()[1]))


def sharded_system(loop_world: dict, drift_world: dict, device) -> dict:
    """Rank body: the closed loop and the drift loop on the mesh of all
    ranks."""
    mesh = ps.make_mesh()
    return dict(loop=closed_loop(loop_world, device, mesh),
                drift=drift_loop(drift_world, device, mesh))
