"""The port's runtime layers with the event axis sharded, on 2 gloo ranks
on the CPU (tests/torch_parallel_ranks.py holds the rank bodies):

- EsvoSystem(mesh=...) on tests/test_parallel.py::
  test_sharded_system_closed_loop's scene (25 ticks, a mapping cycle
  every 5), with a BackendLoop(mesh=...) attached: WORKING, ATE under
  that test's 0.08 m, and a ResidentLoop refusing the sharded system;
- PoseGraphLoop(mesh=...) on test_sharded_pose_graph_loop_corrects_drift's
  scenario: at least one closure, the error under half the uncorrected
  drift;
(scripts/torch_run_dataset.py --devices 2 runs in
tests/test_torch_run_dataset.py, beside its fixture.)

Both ranks' trajectories and poses are equal bit for bit. Against the
port's serial closed loop on the same inputs (one thread, like each
rank): the inserts and the depth solve shard exactly, and only the BA's
all-reduced sums round differently, so poses agree to 1e-4. (The sharded
pose graph is held to its serial call in tests/test_torch_parallel.py.) JAX's sharded
closed loop is not re-run here (~4 s a tick on its CPU mesh); JAX's own
test holds it to its serial loop.
"""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from esvo_tpu_torch.eval.trajectory import ate_rmse
from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.geometry.se3 import se3_exp
from esvo_tpu_torch.io import synthetic as tsyn
from esvo_tpu_torch.io.events import frame_events
from esvo_tpu_torch.parallel import sharding as ps
from test_loop_closure import volume_points
from test_torch_loop_closure import surf

WORLD = 2
W, H, FX, TICK = 240, 180, 150.0, 0.01
# test_sharded_pose_graph_loop_corrects_drift's gates: with min_gap 10
# only the final revisits reach the verification
LC = dict(min_gap=10, min_similarity=0.9)


@pytest.fixture(scope="module")
def loop_world():
    rng = np.random.default_rng(7)
    rig = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                         device="cpu")
    scene = tsyn.make_scene(rng, num_points=4000, duration=0.5, steps=51,
                            motion_scale=0.6)
    ev_l, ev_r = tsyn.simulate_stereo_events(
        scene, rig.left.params.P.double().numpy(),
        rig.right.params.P.double().numpy(), W, H, pixel_threshold=0.75,
        rng=rng)
    ticks = np.arange(TICK, 0.42, TICK)
    drop = lambda f: {k: v for k, v in f.items() if k != "dropped"}
    return scene, dict(W=W, H=H, fx=FX, ticks=ticks, n_ticks=25,
                       left=drop(frame_events(ev_l, ticks, 3000)),
                       right=drop(frame_events(ev_r, ticks, 3000)))


@pytest.fixture(scope="module")
def drift_world():
    pts = volume_points(3)
    K = 12
    twist = lambda xi: se3_exp(torch.tensor(xi, dtype=torch.float64)).numpy()
    gt = [twist([0.0, 0.0, 0.0, 0.03 * np.cos(2 * np.pi * k / K) - 0.03,
                 0.03 * np.sin(2 * np.pi * k / K), 0.0])
          for k in range(K + 1)]
    drift = twist([0.0, 0.0, 0.001, 0.004, 0.002, 0.0])
    est = [gt[0]]
    for k in range(K):
        est.append(est[-1] @ np.linalg.inv(gt[k]) @ gt[k + 1] @ drift)
    return dict(pts=pts, gt=np.stack(gt), est=np.stack(est), lc=LC,
                surfaces=np.stack([surf(pts, T) for T in gt]))


@pytest.fixture(scope="module")
def sharded(loop_world, drift_world):
    return ps.spawn_ranks(ranks.sharded_system, WORLD, loop_world[1],
                          drift_world, device="cpu")


@pytest.fixture(scope="module")
def serial(loop_world):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ranks.closed_loop(loop_world[1], "cpu")
    finally:
        torch.set_num_threads(n)


def _ate(scene, t, T):
    gt = np.stack([tsyn.interpolate_gt_pose(scene, ti) for ti in t])
    return ate_rmse(t, T, t, gt, align=True)


def test_sharded_closed_loop(loop_world, sharded, serial):
    scene = loop_world[0]
    out = sharded[0]["loop"]
    assert out["status"] == "WORKING"
    assert out["map_points"] > 150
    ate = _ate(scene, out["t"], out["T"])
    assert ate < 0.08, f"ATE {ate}"
    np.testing.assert_array_equal(sharded[1]["loop"]["T"], out["T"])
    ref = serial
    assert ref["status"] == "WORKING"
    np.testing.assert_array_equal(out["t"], ref["t"])
    np.testing.assert_allclose(out["T"], ref["T"], atol=1e-4)


def test_sharded_backend_loop_runs(sharded, serial):
    assert sharded[0]["loop"]["ba_runs"] >= 1
    assert sharded[0]["loop"]["ba_runs"] == serial["ba_runs"]


def test_resident_loop_refuses_a_sharded_system(sharded):
    for r in range(WORLD):
        assert "single chip" in sharded[r]["loop"]["resident_refused"]


def test_sharded_pose_graph_loop_corrects_drift(drift_world, sharded):
    gt, est = drift_world["gt"], drift_world["est"]
    out = sharded[0]["drift"]
    assert out["closures"] >= 1
    err_uncorrected = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    err_after = np.linalg.norm(out["T_frame"][:3, 3] - gt[-1][:3, 3])
    assert err_after < 0.5 * err_uncorrected, (err_uncorrected, err_after)
    np.testing.assert_array_equal(sharded[1]["drift"]["T_opt"],
                                  out["T_opt"])
