"""The port's loop closure (backend/loop_closure.py) and pose-graph loop
(runtime/pose_graph_loop.py) against the JAX package, on
tests/test_loop_closure.py's cases.

The worlds are tests/test_loop_closure.py's (float64 under
``jax_enable_x64``; the descriptor is float32 on both sides).
Tolerances: descriptors within 1e-6 of JAX's antialiased
``jax.image.resize`` (the 180x240 -> 12x16 case) and similarities within
1e-6; ICP poses within 1e-6 m / rad and inlier statistics within 1e-9,
accept flags equal; the time-surface verification within 1e-5 m; the
pose-graph loop's optimized keyframe trajectory within 1e-5 m of JAX's
on the same inputs; plus each JAX test's own bars on the port.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.backend import loop_closure as jlc
from esvo_tpu.geometry import se3 as jse3
from esvo_tpu.tracking import registration as jreg
from esvo_tpu_torch.backend import loop_closure as lc
from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.runtime.system import SystemStatus
from esvo_tpu_torch.tracking import registration as reg
from test_loop_closure import (W, H, FX, edge_surface, rig as jrig,
                               scene_points, volume_points)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: these are thousands of small ops, and
    several test workers each running a full pool slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def trig():
    return make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                          dtype=torch.float64, device="cpu")


def surf(pts, T=np.eye(4)):
    return edge_surface(pts, T, jrig().left)


def t64(a):
    return torch.as_tensor(np.array(a, np.float64))


def tb(a):
    return torch.as_tensor(np.array(a, bool))


def test_descriptor_matches_jax_and_similarity():
    rng = np.random.default_rng(0)
    ts_a = surf(scene_points(0))
    ts_b = ts_a + rng.normal(0, 4.0, ts_a.shape)
    ts_c = surf(scene_points(105))
    d = {}
    for name, ts in (("a", ts_a), ("b", ts_b), ("c", ts_c),
                     ("s", 0.4 * ts_a + 20.0)):
        d[name] = lc.ts_descriptor(t64(ts))
        want = np.asarray(jlc.ts_descriptor(jnp.asarray(ts)))
        np.testing.assert_allclose(d[name].numpy(), want, atol=1e-6)
        assert d[name].shape == (12 * 16,)
    assert float(d["a"] @ d["b"]) > 0.97
    assert float(d["a"] @ d["c"]) < 0.8
    assert float(torch.linalg.vector_norm(d["a"])) == pytest.approx(
        1.0, rel=1e-5)
    np.testing.assert_allclose(d["s"].numpy(), d["a"].numpy(), atol=1e-5)


@pytest.mark.parametrize("grid", [(6, 8), (24, 32), (90, 120)])
def test_descriptor_other_grids_match_jax(grid):
    ts = surf(scene_points(3)) + 7.0
    np.testing.assert_allclose(
        lc.ts_descriptor(t64(ts), grid).numpy(),
        np.asarray(jlc.ts_descriptor(jnp.asarray(ts), grid)), atol=1e-6)


def test_detector_finds_revisit_with_temporal_gate():
    rng = np.random.default_rng(1)
    jcfg = jlc.LoopClosureConfig(min_gap=4, min_similarity=0.9)
    cfg = lc.LoopClosureConfig(min_gap=4, min_similarity=0.9)
    jdet, det = jlc.LoopClosureDetector(jcfg), lc.LoopClosureDetector(
        cfg, device="cpu")
    scenes = [scene_points(s) for s in range(10)]
    for s in range(10):
        ts = surf(scenes[s])
        jdet.add(jnp.asarray(ts))
        det.add(t64(ts))
    ts_q = surf(scenes[2]) + rng.normal(0, 3.0, (H, W))
    idx, sim = det.query(t64(ts_q))
    jidx, jsim = jdet.query(jnp.asarray(ts_q))
    assert idx == jidx == 2 and sim > 0.9
    assert sim == pytest.approx(jsim, abs=1e-6)
    idx2, _ = det.query(t64(surf(scenes[9])))
    assert idx2 <= 10 - cfg.min_gap - 1 and idx2 != 9
    assert idx2 == jdet.query(jnp.asarray(surf(scenes[9])))[0]


def test_verify_loop_recovers_relative_pose():
    cam = trig().left
    pts = volume_points(2)
    xi = np.array([0.004, -0.003, 0.002, 0.015, -0.01, 0.02])
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(xi)), np.float64)
    ts_cur = surf(pts, T_true)
    kw = dict(kernel_size=0, batch_size=500, max_iteration=25,
              huber_threshold=50.0, lm_damping=1e-3)
    cfg = lc.LoopClosureConfig(verify_max_rms=120.0, verify_min_points=100)
    ok, T_est, rms = lc.verify_loop(
        t64(pts), torch.ones(len(pts), dtype=torch.bool), t64(ts_cur),
        np.eye(4), cam, reg.RegProblemConfig(**kw), cfg)
    assert ok, f"verification rejected, rms={rms}"
    assert np.linalg.norm(T_est[:3, 3] - T_true[:3, 3]) < 0.01
    j_ok, j_T, j_rms = jlc.verify_loop(
        jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.asarray(ts_cur),
        np.eye(4), jrig().left, jreg.RegProblemConfig(**kw),
        jlc.LoopClosureConfig(verify_max_rms=120.0, verify_min_points=100))
    assert j_ok
    np.testing.assert_allclose(T_est, j_T, atol=1e-5)
    assert rms == pytest.approx(j_rms, rel=1e-4)
    ts_bad = surf(scene_points(9))
    ok_bad, _, rms_bad = lc.verify_loop(
        t64(pts), torch.ones(len(pts), dtype=torch.bool), t64(ts_bad),
        np.eye(4), cam, reg.RegProblemConfig(**kw), cfg)
    assert not ok_bad, f"bogus loop accepted, rms={rms_bad}"


def _icp_world():
    rng = np.random.default_rng(4)
    pts_w = volume_points(4, n=800)
    xi = jnp.asarray([0.01, -0.008, 0.012, 0.03, -0.02, 0.025])
    T_b = np.asarray(jse3.se3_exp(xi), np.float64)
    Tinv = np.linalg.inv(T_b)
    keep_a = rng.random(len(pts_w)) < 0.7
    keep_b = rng.random(len(pts_w)) < 0.7
    p_a = pts_w + rng.normal(0, 0.002, pts_w.shape)
    p_b = pts_w @ Tinv[:3, :3].T + Tinv[:3, 3] \
        + rng.normal(0, 0.002, pts_w.shape)
    T0 = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.0, 0.0, 0.004, 0.015, -0.012, 0.008])), np.float64) @ T_b
    return p_a, keep_a, p_b, keep_b, T0, T_b


@pytest.mark.parametrize("centroid_init", [False, True])
def test_icp_align_matches_jax(centroid_init):
    p_a, keep_a, p_b, keep_b, T0, T_b = _icp_world()
    T, frac, mean_d = lc.icp_align(t64(p_a), tb(keep_a), t64(p_b),
                                   tb(keep_b), t64(T0), 0.05, 15,
                                   centroid_init=centroid_init)
    jT, jfrac, jmean = jlc.icp_align(
        jnp.asarray(p_a), jnp.asarray(keep_a), jnp.asarray(p_b),
        jnp.asarray(keep_b), jnp.asarray(T0), 0.05, 15,
        centroid_init=centroid_init)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-6)
    assert float(frac) == pytest.approx(float(jfrac), abs=1e-9)
    assert float(mean_d) == pytest.approx(float(jmean), abs=1e-9)
    if centroid_init:   # tests/test_loop_closure.py's bars are for the
        return          # odometry start
    T = T.numpy()
    assert float(frac) > 0.6
    assert np.linalg.norm(T[:3, 3] - T_b[:3, 3]) < 0.005
    R_err = np.arccos(np.clip(
        (np.trace(T[:3, :3] @ T_b[:3, :3].T) - 1) / 2, -1, 1))
    assert R_err < 0.01


def test_icp_disjoint_clouds_rejected():
    p_a, keep_a, *_ = _icp_world()
    other = volume_points(99, n=800) + np.array([5.0, 0.0, 0.0])
    args = (np.eye(4), np.eye(4))
    ok, T_bad, frac_bad, _, info = lc.verify_loop_icp(
        t64(p_a), tb(keep_a), t64(other),
        torch.ones(len(other), dtype=torch.bool), *args,
        lc.LoopClosureConfig())
    j_ok, jT, jfrac, _, jinfo = jlc.verify_loop_icp(
        jnp.asarray(p_a), jnp.asarray(keep_a), jnp.asarray(other),
        jnp.ones(len(other), bool), *args, jlc.LoopClosureConfig())
    assert not ok and not j_ok
    assert np.linalg.norm(T_bad[:3, 3]) > \
        lc.LoopClosureConfig().icp_max_correction_trans
    np.testing.assert_allclose(T_bad, jT, atol=1e-6)
    assert frac_bad == pytest.approx(jfrac, abs=1e-9)


@pytest.mark.parametrize("gap_s, accepted", [(2.0, False), (20.0, True),
                                             (None, True)],
                         ids=["short_gap", "long_gap", "no_gap"])
def test_drift_proportional_correction_cap(gap_s, accepted):
    rng = np.random.default_rng(9)
    pts = volume_points(9, n=800)
    keep = rng.random(len(pts)) < 0.8
    p = pts + rng.normal(0, 0.002, pts.shape)
    T_est = np.eye(4)
    T_est[:3, 3] = [0.6, 0.0, 0.0]
    kw = dict(icp_max_corr_dist=0.05, icp_max_mean_dist=0.05,
              icp_max_correction_trans=1.0, icp_drift_rate=0.05,
              icp_drift_floor=0.2)
    cfg = lc.LoopClosureConfig(**kw)
    ok, T_edge, frac, _, info = lc.verify_loop_icp(
        t64(p), tb(keep), t64(p), tb(keep), np.eye(4), T_est, cfg,
        gap_s=gap_s)
    j_ok, jT, jfrac, _, jinfo = jlc.verify_loop_icp(
        jnp.asarray(p), jnp.asarray(keep), jnp.asarray(p),
        jnp.asarray(keep), np.eye(4), T_est, jlc.LoopClosureConfig(**kw),
        gap_s=gap_s)
    assert ok == j_ok == accepted
    np.testing.assert_allclose(T_edge, jT, atol=1e-6)
    for k in info:
        assert info[k] == pytest.approx(jinfo[k], abs=1e-6), k
    if not accepted:
        assert info["corr_t"] > info["cap_t"] and frac > 0.5
    else:
        assert np.linalg.norm(T_edge[:3, 3]) < 0.02
        assert info["frac_rev"] > 0.5
        assert info["recip_t"] < cfg.reciprocal_tol_trans
        assert 0.05 <= info["quality"] <= 1.0
    if gap_s is None:
        assert info["cap_t"] == cfg.icp_max_correction_trans


def test_edge_quality_scales_with_inlier_stats():
    cfg = lc.LoopClosureConfig(icp_max_mean_dist=0.02)
    jcfg = jlc.LoopClosureConfig(icp_max_mean_dist=0.02)
    for args in ((0.9, 0.9, 0.005), (0.32, 0.30, 0.019), (0.31, -1.0, 0.02)):
        assert lc.edge_quality(*args, cfg) == jlc.edge_quality(*args, jcfg)
    assert lc.edge_quality(0.9, 0.9, 0.005, cfg) == pytest.approx(0.9)
    weak = lc.edge_quality(0.32, 0.30, 0.019, cfg)
    assert 0.05 <= weak < 0.4


class _FakeSystem:
    """tests/test_loop_closure.py's stand-in for EsvoSystem (drifting
    keyframe poses, rendered views), for either package."""

    def __init__(self, status, dtype, device=None):
        self.status = status
        self.dtype = dtype
        self.device = device
        self.reset_count = 0
        self.T_world_frame = np.eye(4)
        self.last_tick_time = 0.0
        self.corrections = []

    def apply_world_correction(self, corr):
        self.corrections.append(np.asarray(corr))
        self.T_world_frame = corr @ self.T_world_frame


def _drive_pose_graph_loop(pgl, sysf, pts, gt, est, to_ts):
    K = len(gt) - 1

    def sample():
        Tinv = np.linalg.inv(sysf.gt_pose)
        p_cam = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
        return (sysf.last_tick_time,
                np.asarray(sysf.T_world_frame, np.float64),
                p_cam, np.ones(len(pts), bool))
    pgl._sample_keyframe = sample
    rels = [np.linalg.inv(est[k]) @ est[k + 1] for k in range(K)]
    for k in range(K + 1):
        sysf.last_tick_time = float(k)
        if k > 0:
            sysf.T_world_frame = sysf.T_world_frame @ rels[k - 1]
        sysf.gt_pose = gt[k]
        pgl.maybe_update({"ts_left": to_ts(surf(pts, gt[k])),
                          "bm_stats": {}})


def test_pose_graph_loop_corrects_drift():
    from esvo_tpu.runtime.pose_graph_loop import PoseGraphLoop as JPGL
    from esvo_tpu.runtime.system import SystemStatus as JStatus
    from esvo_tpu_torch.runtime.pose_graph_loop import PoseGraphLoop
    pts = volume_points(3)
    K = 12
    gt = [np.asarray(jse3.se3_exp(jnp.asarray(
        [0.0, 0.0, 0.0, 0.03 * np.cos(2 * np.pi * k / K) - 0.03,
         0.03 * np.sin(2 * np.pi * k / K), 0.0])), np.float64)
        for k in range(K + 1)]
    drift = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.0, 0.0, 0.001, 0.004, 0.002, 0.0])), np.float64)
    est = [gt[0]]
    for k in range(K):
        est.append(est[-1] @ np.linalg.inv(gt[k]) @ gt[k + 1] @ drift)
    kw = dict(min_gap=6, min_similarity=0.9, verify_min_points=100,
              verify_max_rms=120.0)

    sysf = _FakeSystem(SystemStatus.WORKING, torch.float64, "cpu")
    pgl = PoseGraphLoop(sysf, keyframe_every=1,
                        lc_config=lc.LoopClosureConfig(**kw))
    _drive_pose_graph_loop(pgl, sysf, pts, gt, est, t64)
    jsys = _FakeSystem(JStatus.WORKING, jnp.float64)
    jpgl = JPGL(jsys, keyframe_every=1,
                lc_config=jlc.LoopClosureConfig(**kw))
    _drive_pose_graph_loop(jpgl, jsys, pts, gt, est, jnp.asarray)

    err_uncorrected = np.linalg.norm(est[K][:3, 3] - gt[K][:3, 3])
    assert pgl.num_loop_closures >= 1, "revisit not detected"
    assert pgl.num_loop_closures == jpgl.num_loop_closures
    assert sysf.corrections, "no correction applied"
    err_after = np.linalg.norm(sysf.T_world_frame[:3, 3] - gt[K][:3, 3])
    assert err_after < 0.5 * err_uncorrected
    times, T_opt = pgl.optimized_trajectory()
    assert len(times) == K + 1
    assert np.linalg.norm(T_opt[-1][:3, 3] - gt[K][:3, 3]) \
        < 0.5 * err_uncorrected
    np.testing.assert_allclose(T_opt, jpgl.optimized_trajectory()[1],
                               atol=1e-5)
    for (ti, tj, T), (jti, jtj, jT) in zip(pgl.loop_edges(),
                                           jpgl.loop_edges()):
        assert (ti, tj) == (jti, jtj)
        np.testing.assert_allclose(T, jT, atol=1e-6)


def test_detector_compaction():
    from esvo_tpu_torch.runtime.pose_graph_loop import PoseGraphLoop
    cfg = lc.LoopClosureConfig(min_gap=2, capacity=8)
    det = lc.LoopClosureDetector(cfg, device="cpu")
    surfaces = [surf(scene_points(s)) for s in range(8)]
    for ts in surfaces:
        det.add(t64(ts))
    assert det.count == 8
    with pytest.raises(RuntimeError, match="database full"):
        det.add(t64(surfaces[0]))
    det.drop_oldest(4)
    assert det.count == 4
    idx, sim = det.query(t64(surfaces[5]))
    assert idx == 1 and sim > 0.99
    det.add(t64(surfaces[0]))
    assert det.count == 5

    sysf = _FakeSystem(SystemStatus.WORKING, torch.float32, "cpu")
    pgl = PoseGraphLoop(sysf, lc_config=cfg)
    pgl._kfs = [(float(k), np.eye(4), None, None) for k in range(8)]
    pgl.detector = det
    pgl._loop_edges = [(0, 6, np.eye(4), 200.0, 200.0),
                       (5, 7, np.eye(4), 200.0, 200.0)]
    pgl._compact()
    assert len(pgl._kfs) == 4
    assert len(pgl._loop_edges) == 1
    assert pgl._loop_edges[0][:2] == (1, 3)


def test_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(
        lc.LoopClosureConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(
        jlc.LoopClosureConfig)}
    assert ours == theirs
