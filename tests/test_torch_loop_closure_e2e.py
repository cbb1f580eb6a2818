"""End-to-end loop closure on the port's real system
(tests/test_loop_closure_e2e.py's case): EsvoSystem tracks a synthetic
stream whose trajectory returns to its start, and PoseGraphLoop detects
the revisit from the live mapper's time surfaces and depth maps,
verifies it by aligning the two keyframes' clouds, and optimizes the
keyframe chain. The point-selection streams of the two packages differ
(ROADMAP Queue 3), so the port is held to that test's own assertions,
not to JAX's trajectory: WORKING, at least one loop accepted, every
accepted edge within 0.1 m of the ground-truth relative pose, and the
pose-graph keyframe ATE under 1.2x the odometry's.
"""
import json

import numpy as np
import pytest
import torch

from esvo_tpu_torch.backend import loop_closure as lc
from esvo_tpu_torch.eval.trajectory import ate_rmse
from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.io.events import frame_events
from esvo_tpu_torch.io.synthetic import (interpolate_gt_pose, make_scene,
                                         simulate_stereo_events)
from esvo_tpu_torch.runtime.pose_graph_loop import PoseGraphLoop
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from esvo_tpu_torch.mapping.block_matching import BlockMatchConfig
from esvo_tpu_torch.mapping.depth_refinement import DepthProblemConfig
from esvo_tpu_torch.mapping.initialization import SGMConfig
from esvo_tpu_torch.runtime.config import MappingConfig, SystemConfig
from test_system import W, H, FX, BASELINE, TICK


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_config() -> SystemConfig:
    """tests/test_system.py's make_config, on the port."""
    return SystemConfig(
        depth=DepthProblemConfig(max_iteration=8),
        bm=BlockMatchConfig(zncc_threshold=0.25),
        sgm=SGMConfig(num_disparities=48),
        mapping=MappingConfig(process_event_num=800,
                              init_sgm_num_threshold=300,
                              std_var_vis_threshold=0.05,
                              age_vis_threshold=0, denoising=False,
                              regularization=False))


def test_loop_closure_on_real_system():
    rng = np.random.default_rng(7)
    rig = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, BASELINE,
                         device="cpu")
    scene = make_scene(rng, num_points=4000, duration=0.5, steps=51,
                       motion_scale=0.6)
    ev_l, ev_r = simulate_stereo_events(
        scene, rig.left.params.P.double().numpy(),
        rig.right.params.P.double().numpy(), W, H, pixel_threshold=0.75,
        rng=rng)
    ticks = np.arange(TICK, 0.5, TICK)
    fl = frame_events(ev_l, ticks, 3000)
    fr = frame_events(ev_r, ticks, 3000)

    system = EsvoSystem(rig, make_config(), device="cpu")
    pgl = PoseGraphLoop(
        system, keyframe_every=1,
        lc_config=lc.LoopClosureConfig(min_gap=4, min_similarity=0.88))
    frame = lambda f, k: {key: v[k] for key, v in f.items()
                          if key != "dropped"}
    for k in range(len(ticks)):
        out = system.process_tick(
            float(ticks[k]), frame(fl, k), frame(fr, k),
            do_mapping=(k % 5 == 4 or k == len(ticks) - 1))
        pgl.maybe_update(out)

    assert system.status == SystemStatus.WORKING
    assert pgl.num_loop_closures >= 1, "no loop accepted on the revisit"
    times = [kf[0] for kf in pgl._kfs]
    for (i, j, T_edge, _wr, _wt) in pgl._loop_edges:
        rel_gt = np.linalg.inv(interpolate_gt_pose(scene, times[i])) \
            @ interpolate_gt_pose(scene, times[j])
        err = np.linalg.norm(T_edge[:3, 3] - rel_gt[:3, 3])
        assert err < 0.1, (i, j, T_edge[:3, 3], rel_gt[:3, 3])

    t_est, T_est = system.trajectory()
    assert np.isfinite(T_est).all()
    gt = np.stack([interpolate_gt_pose(scene, t) for t in t_est])
    ate_odo = ate_rmse(t_est, T_est, t_est, gt, align=True)
    pt, pT = pgl.optimized_trajectory()
    gt_kf = np.stack([interpolate_gt_pose(scene, t) for t in pt])
    ate_pg = ate_rmse(pt, pT, pt, gt_kf, align=True)
    assert ate_pg < 1.2 * ate_odo, (ate_odo, ate_pg)


def _sensitivity_script():
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
            / "torch_loop_closure_sensitivity.py")
    spec = importlib.util.spec_from_file_location("sensitivity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("magnitude", [1e-6, 1e-4, 0.03])
def test_sensitivity_correction_is_rigid_and_sized(magnitude):
    """scripts/torch_loop_closure_sensitivity.py's perturbation: a proper
    rotation of `magnitude` rad, a translation of normal draws times
    `magnitude` (within 1e-12)."""
    corr = _sensitivity_script().world_correction(magnitude, seed=3)
    R = corr[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert abs(np.linalg.det(R) - 1) < 1e-12
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    angle = np.arctan2(np.linalg.norm(w), (np.trace(R) - 1) / 2)
    assert abs(angle - magnitude) < 1e-12 + 1e-6 * magnitude
    assert 0 < np.linalg.norm(corr[:3, 3]) < 5 * magnitude
    np.testing.assert_array_equal(corr[3], [0, 0, 0, 1])


def test_sensitivity_script_unperturbed_run_closes(capsys):
    """The script's unperturbed run is the e2e drive: it closes the loop
    (the assertion of test_loop_closure_on_real_system) and prints one
    line a run and the summary."""
    mod = _sensitivity_script()
    assert mod.main(["--device", "cpu", "--magnitudes", "0"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    assert lines[0]["status"] == "WORKING" and lines[0]["seed"] is None
    assert lines[0]["loop_closures"] >= 1
    assert all("corr_t" in v for v in lines[0]["verified"])
    assert lines[1]["closed_runs"] == {"0.0": "1 of 1"}
