"""scripts/torch_sim_campaign.py (the port's accuracy campaign) on
tests/test_sim_campaign.py's cases: loop-edge classification against
ground truth and the depth scoring against the analytic scene, each
equal to the JAX script's on the same inputs (depth figures within
1e-5: the two renderers agree within 1e-5 relative in depth), and the
cached generation path. The whole campaign runs on the CPU at a tiny
size, with the same keys in its result as the JAX script's plus the
simulation's seconds and events and the replay's ticks/s."""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "scripts"))
import sim_campaign  # noqa: E402
import torch_sim_campaign  # noqa: E402
from esvo_tpu_torch.eval.trajectory import interpolate_pose, save_tum  # noqa: E402,E501
from esvo_tpu_torch.io import esim  # noqa: E402
from test_sim_campaign import _gt  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_classify_loop_edges_matches_jax():
    gt_t, gt_T = _gt()
    Ti = interpolate_pose(gt_t, gt_T, 2.0)
    Tj = interpolate_pose(gt_t, gt_T, 8.0)
    bad = np.linalg.inv(Ti) @ Tj
    bad[:3, 3] += [0.8, 0.0, 0.0]
    edges = [(2.0, 8.0, np.linalg.inv(Ti) @ Tj), (2.0, 8.0, bad)]
    tp, fp, det = torch_sim_campaign.classify_loop_edges(edges, gt_t, gt_T)
    assert (tp, fp) == (1, 1)
    assert det[0]["true"] and not det[1]["true"]
    assert det[1]["trans_err_m"] == pytest.approx(0.8, abs=1e-3)
    assert (tp, fp, det) == sim_campaign.classify_loop_edges(edges, gt_t,
                                                             gt_T)


def test_eval_depth_maps_scores_analytic_depth(tmp_path):
    argv = ["--out", str(tmp_path), "--width", "64", "--height", "48",
            "--fx", "50", "--duration", "2.0", "--depth-eval-every", "1"]
    args = torch_sim_campaign.parse_args(argv)
    scene = esim.make_room_scene(np.random.default_rng(3))
    scene.save(str(tmp_path / "scene.npz"))
    K = torch_sim_campaign.make_K(args)
    pose = lambda t: esim.loop_trajectory_pose(t, args.duration,
                                               laps=args.laps)
    gt_t = np.linspace(0.0, 2.0, 21)
    save_tum(str(tmp_path / "groundtruth.txt"), gt_t,
             np.stack([pose(t) for t in gt_t]))
    depth_dir = tmp_path / "depth_maps"
    depth_dir.mkdir()
    rng = np.random.default_rng(0)
    for t in (0.5, 1.0):
        depth = esim.render_log_intensity(
            scene, torch.as_tensor(pose(t), dtype=torch.float32), K,
            args.width, args.height)[1].numpy()
        xs = rng.uniform(1, args.width - 2, 300)
        ys = rng.uniform(1, args.height - 2, 300)
        np.savetxt(str(depth_dir / f"{int(t * 1e9)}.txt"),
                   np.stack([xs.astype(int) + 0.0, ys.astype(int) + 0.0,
                             depth[ys.astype(int), xs.astype(int)]], 1))
    res = torch_sim_campaign.eval_depth_maps(args, str(depth_dir), "cpu")
    jres = sim_campaign.eval_depth_maps(sim_campaign.parse_args(argv),
                                        str(depth_dir))
    assert res["frames"] == jres["frames"] == 2
    assert res["inv_depth_rel_err_median"] < 0.02
    assert res["frac_within_10pct"] > 0.9
    for k in res:
        assert res[k] == pytest.approx(jres[k], abs=1e-5), k
    for name in os.listdir(depth_dir):
        pts = np.loadtxt(str(depth_dir / name), ndmin=2)
        pts[:, 2] *= 0.5
        np.savetxt(str(depth_dir / name), pts)
    res2 = torch_sim_campaign.eval_depth_maps(args, str(depth_dir), "cpu")
    assert res2["inv_depth_rel_err_median"] > 0.5


def test_generate_caches(tmp_path):
    args = torch_sim_campaign.parse_args(
        ["--out", str(tmp_path), "--width", "40", "--height", "30",
         "--fx", "30", "--duration", "0.4", "--quick"])
    assert torch_sim_campaign.generate(args, "cpu") > 0.0
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta["contrast"] == args.contrast and meta["laps"] == args.laps
    mtime = os.path.getmtime(tmp_path / "events_left.npz")
    assert torch_sim_campaign.generate(args, "cpu") == 0.0  # a cache hit
    assert os.path.getmtime(tmp_path / "events_left.npz") == mtime
    assert os.path.exists(tmp_path / "raw_left.npz")
    assert os.path.exists(tmp_path / "raw_right.npz")
    # the JAX script finds the port's dataset current (same meta keys)
    jargs = sim_campaign.parse_args(
        ["--out", str(tmp_path), "--width", "40", "--height", "30",
         "--fx", "30", "--duration", "0.4", "--quick"])
    sim_campaign.generate(jargs)
    assert os.path.getmtime(tmp_path / "events_left.npz") == mtime


def test_campaign_end_to_end(tmp_path):
    """The whole campaign at a tiny size: simulation, the closed loop
    with BA and the pose graph through the resident loop, the scoring."""
    res = torch_sim_campaign.main(
        ["--out", str(tmp_path), "--duration", "0.5", "--width", "120",
         "--height", "90", "--fx", "100", "--laps", "1", "--quick",
         "--resident", "2", "--ba"], device="cpu")
    for key in ("ate_rmse_m", "ticks", "status", "ba_runs", "loop_closures",
                "sim_s", "sim_events", "ticks_per_s", "depth"):
        assert key in res, key
    assert res["ticks"] == 49 and res["sim_s"] > 0
    assert res["sim_events"]["left"] > 0 and res["ticks_per_s"] > 0
    assert np.isfinite(res["ate_rmse_m"])
    saved = json.load(open(tmp_path / "campaign_result.json"))
    assert saved["ticks"] == res["ticks"]
