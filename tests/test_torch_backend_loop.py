"""The port's BA layer over the runtime (runtime/backend_loop.py), on
tests/test_backend_loop.py's five cases, plus checkpoints the JAX
package wrote and a BA correction folded into a running ResidentLoop.

The closed loops are the port's alone (its point-selection stream
differs from JAX's, ROADMAP Queue 3), held to that file's bars. The BA
window of test_ba_reduces_drift_ate runs on both packages in float64:
poses within 1e-9 m / rad. A JAX-written backend_ba.npz / pose_graph.npz
loads into the port field for field (and the port's into JAX's).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.backend import bundle_adjustment as jba
from esvo_tpu.backend import keyframes as jkf
from esvo_tpu.geometry.camera import make_ideal_rig as jrig
from esvo_tpu.geometry.se3 import cayley_to_rot
from esvo_tpu.runtime import backend_loop as jbl
from esvo_tpu.runtime import pose_graph_loop as jpgl
from esvo_tpu.runtime import system as jsys
from esvo_tpu.runtime.config import SystemConfig as JSC
from esvo_tpu_torch.backend import bundle_adjustment as tba
from esvo_tpu_torch.backend import keyframes as tkf
from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.io import synthetic as tsyn
from esvo_tpu_torch.io.events import frame_events
from esvo_tpu_torch.runtime import resident as tres
from esvo_tpu_torch.runtime.backend_loop import BackendLoop
from esvo_tpu_torch.runtime.config import MappingConfig, SystemConfig
from esvo_tpu_torch.runtime.pose_graph_loop import PoseGraphLoop
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from test_torch_loop_closure_e2e import make_config
from test_torch_resident import bootstrap, pick, world  # noqa: F401
from test_torch_system import _loop_config

W, H, FX, TICK = 240, 180, 150.0, 0.01


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small_system():
    rig = make_ideal_rig(64, 48, 50.0, 50.0, 31.5, 23.5, 0.1, device="cpu")
    cfg = SystemConfig(mapping=MappingConfig(process_event_num=64,
                                             max_fusion_points=128))
    return EsvoSystem(rig, cfg, device="cpu")


def test_backend_loop_runs_and_reduces_cost():
    rng = np.random.default_rng(9)
    rig = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                         device="cpu")
    scene = tsyn.make_scene(rng, num_points=4000, duration=0.6, steps=61,
                            motion_scale=0.6)
    ev_l, ev_r = tsyn.simulate_stereo_events(
        scene, rig.left.params.P.double().numpy(),
        rig.right.params.P.double().numpy(), W, H, pixel_threshold=0.75,
        rng=rng)
    ticks = np.arange(TICK, 0.6, TICK)
    fl = frame_events(ev_l, ticks, 3000)
    fr = frame_events(ev_r, ticks, 3000)
    system = EsvoSystem(rig, make_config(), device="cpu")
    backend = BackendLoop(system, keyframe_every=1, window=5,
                          voxel_size=0.08)
    stats = []
    for k in range(50):
        t = float(ticks[k])
        out = system.process_tick(t, pick(fl, k), pick(fr, k),
                                  gt_pose=tsyn.interpolate_gt_pose(scene, t),
                                  do_mapping=(k % 5 == 4))
        s = backend.maybe_update(out)
        if s:
            stats.append(s)
    assert system.status == SystemStatus.WORKING
    assert backend.num_ba_runs >= 2, f"only {backend.num_ba_runs} BA runs"
    for s in stats:
        assert s["ba_cost_final"] <= s["ba_cost_initial"] * 1.001
        assert s["num_keyframes"] >= 3
    corr = backend.last_correction
    assert np.linalg.norm(corr[:3, 3]) < 0.2
    assert np.arccos(np.clip((np.trace(corr[:3, :3]) - 1) / 2, -1, 1)) < 0.1


def test_apply_world_correction_consistency():
    sys_ = _small_system()
    rng = np.random.default_rng(0)
    sys_.pose_times = [0.0, 0.01]
    T1 = np.eye(4)
    T1[:3, 3] = [0.1, 0, 0]
    sys_.pose_list = [np.eye(4), T1]
    sys_.T_world_cur = T1.copy()
    sys_.T_world_frame = T1.copy()
    pts = torch.as_tensor(rng.normal(size=(10, 3)), dtype=torch.float32)
    ok = torch.ones(10, dtype=torch.bool)
    sys_._ref_maps = [(pts, ok, 10)]
    sys_._map_pts = pts
    sys_._global_voxels = {(0, 0, 0): np.array([1.0, 2.0, 3.0])}
    corr = np.eye(4)
    th = 0.1
    corr[:3, :3] = [[np.cos(th), -np.sin(th), 0],
                    [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    corr[:3, 3] = [0.05, -0.02, 0.01]
    sys_.apply_world_correction(corr)
    np.testing.assert_allclose(sys_.T_world_cur, corr @ T1, atol=1e-12)
    np.testing.assert_allclose(sys_.pose_list[0], corr, atol=1e-12)
    want = pts.numpy() @ corr[:3, :3].T + corr[:3, 3]
    np.testing.assert_allclose(sys_._ref_maps[0][0].numpy(), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sys_._map_pts.numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        sys_.global_map()[0],
        corr[:3, :3] @ np.array([1.0, 2.0, 3.0]) + corr[:3, 3], rtol=1e-6)
    np.testing.assert_allclose(sys_.history.T_world_cam[0, 0].numpy(),
                               corr, atol=1e-5)


def test_backend_reset_awareness():
    sys_ = _small_system()
    backend = BackendLoop(sys_)
    backend._kfs = [("fake",)] * 4
    backend._mapping_cycles = 7
    sys_.reset()
    assert backend.maybe_update({"map_points": 0}) is None
    assert backend._kfs == [] and backend._mapping_cycles == 0


def test_ba_reduces_drift_ate():
    rng = np.random.default_rng(11)
    P, K = 400, 6
    gt_points = np.stack([rng.uniform(-0.8, 0.8, P),
                          rng.uniform(-0.6, 0.6, P),
                          rng.uniform(1.5, 3.0, P)], axis=1)
    gt_poses, drift_poses = [], []
    for k in range(K):
        T = np.eye(4)
        T[:3, 3] = [0.06 * k, 0.01 * k, 0.0]
        gt_poses.append(T)
        D = np.eye(4)
        if k >= 2:
            c = 0.004 * (k - 1) * np.array([0.5, -1.0, 0.7])
            D[:3, :3] = np.asarray(cayley_to_rot(jnp.asarray(c)))
            D[:3, 3] = 0.02 * (k - 1) * np.array([1.0, -0.5, 0.3])
        drift_poses.append(D @ T)
    graphs = [mod.KeyframeGraph(fx=FX, fy=FX, cx=120.0, cy=90.0,
                                voxel_size=0.05) for mod in (jkf, tkf)]
    for k in range(K):
        Tinv = np.linalg.inv(gt_poses[k])
        pc = gt_points @ Tinv[:3, :3].T + Tinv[:3, 3]
        u = FX * pc[:, 0] / pc[:, 2] + 120.0
        v = FX * pc[:, 1] / pc[:, 2] + 90.0
        ok = (pc[:, 2] > 0.1) & (u > 0) & (u < 240) & (v > 0) & (v < 180)
        for g in graphs:
            g.add_keyframe(drift_poses[k], gt_points, np.stack([u, v], 1),
                           ok)
    assert graphs[1].multiview_fraction() > 0.9
    out, _ = tba.bundle_adjust(
        tkf.build_ba_problem(graphs[1], dtype=torch.float64, device="cpu"),
        tba.BAConfig(max_iterations=12, num_fixed_poses=2))
    jout, _ = jba.bundle_adjust(jkf.build_ba_problem(graphs[0]),
                                jba.BAConfig(max_iterations=12,
                                             num_fixed_poses=2))
    np.testing.assert_allclose(out.T_world_kf.numpy(),
                               np.asarray(jout.T_world_kf), atol=1e-9)

    def pose_ate(T_est):
        e = [np.linalg.norm(T_est[k][:3, 3] - gt_poses[k][:3, 3])
             for k in range(K)]
        return float(np.sqrt(np.mean(np.square(e))))
    before = pose_ate(np.stack(drift_poses))
    assert pose_ate(out.T_world_kf.numpy()) < 0.3 * before


def test_ba_correction_gate():
    loop = BackendLoop(_small_system())
    good = np.eye(4)
    good[:3, 3] = [0.01, 0.0, -0.02]
    down = np.array([5.0, 1.0])
    assert loop._accept_correction(good, down)
    far = np.eye(4)
    far[:3, 3] = [3.0, 0.0, 0.0]
    assert not loop._accept_correction(far, down)
    th = 0.2
    rot = np.eye(4)
    rot[:3, :3] = [[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    assert not loop._accept_correction(rot, down)
    assert not loop._accept_correction(good, np.array([1.0, 5.0]))
    bad = good.copy()
    bad[0, 3] = np.nan
    assert not loop._accept_correction(bad, down)


def _drift_keyframes(n_kf, W=64, H=48, fx=50.0, cx=31.5, cy=23.5):
    """BackendLoop keyframes (time, drifting pose, frame-local points,
    pixels, valid) of test_ba_reduces_drift_ate's kind of scene."""
    rng = np.random.default_rng(11)
    P = 400
    pts = np.stack([rng.uniform(-0.8, 0.8, P), rng.uniform(-0.6, 0.6, P),
                    rng.uniform(1.5, 3.0, P)], axis=1)
    kfs = []
    for k in range(n_kf):
        T = np.eye(4)
        T[:3, 3] = [0.06 * k, 0.01 * k, 0.0]
        D = np.eye(4)
        D[:3, 3] = 0.01 * k * np.array([1.0, -0.5, 0.3])
        Tinv = np.linalg.inv(T)
        pc = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fx * pc[:, 1] / pc[:, 2] + cy], 1)
        ok = (uv[:, 0] > 0) & (uv[:, 0] < W) & (uv[:, 1] > 0) \
            & (uv[:, 1] < H)
        kfs.append((float(k), D @ T, pc, uv, ok))
    return kfs


def test_mesh_raises_not_implemented(tmp_path):
    """A mesh that is no DeviceMesh raises TypeError; a 1-rank mesh runs
    the sharded BA and pose graph, equal bit for bit to the plain loops
    (collectives over one rank are identities)."""
    import torch_parallel_ranks as ranks
    sys_ = _small_system()
    with pytest.raises(TypeError, match="DeviceMesh"):
        BackendLoop(sys_, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        PoseGraphLoop(sys_, mesh=object())
    kfs = _drift_keyframes(3)
    with ranks.one_rank_mesh(tmp_path) as mesh:
        loops = []
        for m in (mesh, None):
            system = _small_system()
            system.status = SystemStatus.WORKING
            loop = BackendLoop(system, keyframe_every=1, voxel_size=0.08,
                               mesh=m)
            feed = iter(kfs)
            loop._sample_keyframe = lambda: next(feed)
            for _ in kfs:
                loop.maybe_update({"bm_stats": {}})
            loops.append(loop)
        assert loops[0].num_ba_runs == loops[1].num_ba_runs == 1
        np.testing.assert_array_equal(loops[0].last_correction,
                                      loops[1].last_correction)
        poses = []
        for m in (mesh, None):
            pgl = PoseGraphLoop(_small_system(), mesh=m)
            pgl._kfs = [(t, T, None, None) for (t, T, *_) in
                        _drift_keyframes(5)]
            # the revisit measures the ground-truth motion 0 -> 4
            rel = np.eye(4)
            rel[:3, 3] = [0.24, 0.04, 0.0]
            pgl._loop_edges = [(0, 4, rel, 400.0, 400.0)]
            pgl._optimize()
            poses.append(np.stack([T for (_, T, _, _) in pgl._kfs]))
        np.testing.assert_array_equal(poses[0], poses[1])


def _jax_checkpoint(tmp_path):
    """A JAX BackendLoop's and PoseGraphLoop's files, from states set by
    hand (as a resumed JAX run would have them)."""
    rig = jrig(64, 48, 50.0, 50.0, 31.5, 23.5, 0.1, dtype=jnp.float32)
    jcfg = JSC()
    jcfg.mapping = dataclasses.replace(jcfg.mapping, process_event_num=64,
                                       max_fusion_points=128)
    jcfg.__post_init__()
    system = jsys.EsvoSystem(rig, jcfg)
    rng = np.random.default_rng(3)
    ba = jbl.BackendLoop(system)
    ba._kfs = [(0.1 * k, np.eye(4) + 0.01 * k, rng.normal(size=(400, 3)),
                rng.uniform(0, 60, (400, 2)), rng.random(400) < 0.7)
               for k in range(3)]
    ba._mapping_cycles, ba.num_ba_runs = 12, 4
    ba.last_correction = np.eye(4) * 1.001
    ba.save(str(tmp_path))
    pg = jpgl.PoseGraphLoop(system)
    pg._kfs = [(0.25 * k, np.eye(4) + 0.02 * k, rng.normal(size=(600, 3)),
                rng.random(600) < 0.5) for k in range(10)]
    pg._loop_edges = [(1, 9, np.eye(4) * 0.5, 150.0, 120.0)]
    for k in range(10):
        pg.detector.add_descriptor(jnp.asarray(
            rng.normal(size=192), jnp.float32))
    pg._mapping_cycles, pg.num_loop_closures = 50, 1
    pg.num_optimizations = 1
    pg.save(str(tmp_path))
    return ba, pg


def test_resume_from_jax_checkpoint(tmp_path):
    jba_loop, jpg_loop = _jax_checkpoint(tmp_path)
    system = _small_system()
    ba = BackendLoop(system)
    pg = PoseGraphLoop(system)
    assert ba.load(str(tmp_path)) and pg.load(str(tmp_path))
    assert len(ba._kfs) == 3 and ba._mapping_cycles == ba._last_kf_cycle \
        == 12 and ba.num_ba_runs == 4
    for ours, theirs in zip(ba._kfs, jba_loop._kfs):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ba.last_correction,
                                  jba_loop.last_correction)
    assert len(pg._kfs) == 10 and pg.detector.count == 10
    np.testing.assert_array_equal(pg.detector._D.numpy(),
                                  np.asarray(jpg_loop.detector._D))
    assert pg._loop_edges[0][:2] == (1, 9)
    assert pg._loop_edges[0][3:] == (150.0, 120.0)
    assert pg.loop_edges()[0][:2] == jpg_loop.loop_edges()[0][:2]
    assert (pg.num_loop_closures, pg.num_optimizations,
            pg._mapping_cycles) == (1, 1, 50)
    # and back: the port's files load into the JAX package
    out = tmp_path / "port"
    out.mkdir()
    ba.save(str(out))
    pg.save(str(out))
    jb, jp = jbl.BackendLoop(jba_loop.system), \
        jpgl.PoseGraphLoop(jpg_loop.system)
    assert jb.load(str(out)) and jp.load(str(out))
    assert jb.num_ba_runs == 4 and jp.detector.count == 10
    assert not BackendLoop(system).load(str(tmp_path / "missing"))


def test_ba_correction_survives_resident_sync(world):  # noqa: F811
    """BackendLoop over a running ResidentLoop: an accepted BA correction,
    applied between dispatches, lands in the device state (the loop's
    observer) and survives the next sync."""
    rig, scene, ticks, (fl, fr) = world
    system = EsvoSystem(rig, _loop_config(), device="cpu", seed=5)
    k0 = bootstrap(system, ticks, fl, fr)
    backend = BackendLoop(system, keyframe_every=1, window=5,
                          voxel_size=0.08)
    loop = tres.ResidentLoop(system, ticks_per_roll=5, rolls_per_dispatch=1)
    loop.start()
    applied = 0
    while k0 + 5 <= len(ticks):
        sl = slice(k0, k0 + 5)
        loop.run(ticks[sl], pick(fl, sl), pick(fr, sl))
        out = loop.sync()
        before = system.T_world_cur.copy()
        stats = backend.maybe_update(out)
        if stats and not stats.get("ba_correction_rejected"):
            applied += 1
            corr = backend.last_correction
            np.testing.assert_allclose(system.T_world_cur, corr @ before,
                                       atol=1e-12)
            np.testing.assert_allclose(
                loop.state.T_world_cur.double().numpy(),
                system.T_world_cur, atol=1e-5)
        k0 += 5
    assert backend.num_ba_runs >= 1 and applied >= 1, \
        (backend.num_ba_runs, backend.num_rejected_corrections)
    summary = loop.finish()
    assert summary == {} and system.status == SystemStatus.WORKING
    np.testing.assert_allclose(system.T_world_cur,
                               loop.state.T_world_cur.double().numpy(),
                               atol=1e-6)
    assert np.isfinite(system.trajectory()[1]).all()
