"""scripts/torch_run_dataset.py from other sources, on the CPU: a rosbag
that carries its own camera_info and ground-truth topics (no --calib),
the bag's event cache, and --mode mvstereo (ground-truth poses) against
scripts/run_dataset.py on the same fixture, whose map points it matches
within max(2%, 5) (the mode has no random draw).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import run_dataset  # noqa: E402
import torch_run_dataset  # noqa: E402
from esvo_tpu.geometry.se3 import rot_to_quat  # noqa: E402
from esvo_tpu_torch.eval.trajectory import load_tum  # noqa: E402
from esvo_tpu_torch.io.datasets import load_rpg_dataset  # noqa: E402
from test_rosbag import (_camera_info_msg, _connection,  # noqa: E402
                         _event_array_msg, _message, _pose_msg, _write_bag)
from test_run_dataset import BASELINE, FX, H, W, dataset_dir  # noqa: E402,F401
from test_torch_run_dataset import base_args, few_threads  # noqa: E402,F401


def _camera_infos():
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    K = [[FX, 0, cx], [0, FX, cy], [0, 0, 1]]
    msgs = []
    for conn, tx in ((3, 0.0), (4, -FX * BASELINE)):
        P = [[FX, 0, cx, tx], [0, FX, cy, 0], [0, 0, 1, 0]]
        msgs.append(_message(conn, _camera_info_msg(
            W, H, "plumb_bob", [0.0] * 5, K, np.eye(3), P)))
    return msgs


def test_rosbag_with_camera_info(dataset_dir, tmp_path):  # noqa: F811
    """The fixture's events and ground truth packed into a bz2 bag at
    epoch-scale stamps, with camera_info topics: no --calib."""
    import jax.numpy as jnp
    ev_l, ev_r, gt_t, gt_T = load_rpg_dataset(str(dataset_dir))
    t0_abs = 1468941032.0
    qs = np.asarray(rot_to_quat(jnp.asarray(gt_T[:, :3, :3])))

    def ev_chunks(ev, conn, per=2000):
        return [_message(conn, _event_array_msg(
            ev.t[s:s + per] + t0_abs, ev.x[s:s + per], ev.y[s:s + per],
            ev.p[s:s + per])) for s in range(0, len(ev.t), per)]

    inner = [_connection(0, "/davis/left/events", "dvs_msgs/EventArray")
             + _connection(1, "/davis/right/events", "dvs_msgs/EventArray")
             + _connection(2, "/gt/pose", "geometry_msgs/PoseStamped")
             + _connection(3, "/davis/left/camera_info",
                           "sensor_msgs/CameraInfo")
             + _connection(4, "/davis/right/camera_info",
                           "sensor_msgs/CameraInfo")]
    inner += _camera_infos() + ev_chunks(ev_l, 0) + ev_chunks(ev_r, 1)
    inner += [_message(2, _pose_msg(float(gt_t[i]) + t0_abs,
                                    tuple(gt_T[i][:3, 3]), tuple(qs[i])))
              for i in range(len(gt_t))]
    bag = str(tmp_path / "fixture.bag")
    _write_bag(bag, inner, "bz2")
    out = str(tmp_path / "traj_bag.txt")
    args = [a for a in base_args(dataset_dir)]
    i = args.index("--dataset")
    args[i:i + 4] = ["--bag", bag, "--bag-gt-topic", "/gt/pose"]
    result = torch_run_dataset.main(args + ["--duration", "0.45", "--out",
                                            out], device="cpu")
    t_est, _ = load_tum(out)
    assert len(t_est) >= 40
    assert result["stats"]["map_points"] > 150
    assert result["ate_rmse_m"] < 0.15, result


def test_bag_event_cache(tmp_path):
    rng = np.random.default_rng(1)
    n = 300
    t = np.sort(1e9 + rng.uniform(0, 1, n))
    inner = (_connection(0, "/davis/left/events", "dvs_msgs/EventArray")
             + _connection(1, "/davis/right/events", "dvs_msgs/EventArray")
             + _connection(2, "/gt", "geometry_msgs/PoseStamped")
             + _message(0, _event_array_msg(
                 t, rng.integers(0, 240, n), rng.integers(0, 180, n),
                 rng.random(n) > 0.5))
             + _message(1, _event_array_msg(
                 t + 0.001, rng.integers(0, 240, n),
                 rng.integers(0, 180, n), rng.random(n) > 0.5))
             + _message(2, _pose_msg(1e9 + 0.5, (1, 2, 3), (0, 0, 0, 1))))
    bag = str(tmp_path / "c.bag")
    _write_bag(bag, [inner], "bz2")
    args = argparse.Namespace(
        dataset=None, mvsec=None, dsec=None, bag=bag, cache=True,
        bag_left_topic="/davis/left/events",
        bag_right_topic="/davis/right/events", bag_gt_topic="/gt",
        max_events=None)
    first = torch_run_dataset.load_events(args)
    assert os.path.exists(bag + ".left.npz")
    again = torch_run_dataset.load_events(args)
    jax_side = run_dataset.load_events(args)
    for a, b, c in zip(first, again, jax_side):
        for x, y in ((a, b), (a, c)):
            if hasattr(x, "t"):
                for name in ("t", "x", "y", "p"):
                    np.testing.assert_array_equal(getattr(x, name),
                                                  getattr(y, name))
            else:
                np.testing.assert_array_equal(x, y)
    args.max_events = 50
    assert len(torch_run_dataset.load_events(args)[0]) == 50


def test_mvstereo_mode_matches_jax_runner(dataset_dir, tmp_path):  # noqa: F811
    argv = base_args(dataset_dir) + ["--mode", "mvstereo", "--duration",
                                     "0.4"]
    got = torch_run_dataset.main(argv + ["--out", str(tmp_path / "t.txt")],
                                 device="cpu")
    want = run_dataset.main(argv + ["--out", str(tmp_path / "j.txt")])
    n_t, n_j = got["stats"]["map_points"], want["stats"]["map_points"]
    assert n_j > 200
    assert abs(n_t - n_j) <= max(0.02 * n_j, 5), (n_t, n_j)
    assert "ate_rmse_m" not in got
    np.testing.assert_array_equal(load_tum(str(tmp_path / "t.txt"))[1],
                                  load_tum(str(tmp_path / "j.txt"))[1])
