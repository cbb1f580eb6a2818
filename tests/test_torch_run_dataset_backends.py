"""scripts/torch_run_dataset.py's --ba, --loop-closure (with --lc-set and
--lc-min-similarity) and --live-view on tests/test_run_dataset.py's
fixture, run on the CPU through ``main(argv, device="cpu")``: the closed
loop with both backends on the host path, the same through the resident
loop with checkpoints and a resume that restores the backends' state,
and the live dashboard. The bars are those of tests/test_run_dataset.py's
cases (ATE 0.15 m, resumed 0.2 m); the short fixture does not revisit,
so, as there, the loop-closure layer must run, not close.
"""
import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import torch_run_dataset  # noqa: E402
from esvo_tpu_torch.eval.trajectory import load_tum  # noqa: E402
from test_run_dataset import dataset_dir  # noqa: E402,F401
from test_torch_run_dataset import base_args, run  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_ba_and_loop_closure_host_path(dataset_dir, tmp_path):  # noqa: F811
    out = str(tmp_path / "traj.txt")
    result = run(base_args(dataset_dir) + [
        "--duration", "0.6", "--out", out, "--ba", "--ba-every", "1",
        "--loop-closure", "--loop-every", "2", "--lc-min-similarity",
        "0.95", "--lc-set", "capacity=64", "--lc-set", "min_gap=3"])
    assert result["status"] == "WORKING"
    assert result["ba_runs"] >= 1
    assert result["ba_rejected_corrections"] <= result["ba_runs"]
    assert "loop_closures" in result and "loop_edges" in result
    assert result["ate_rmse_m"] < 0.15, result
    assert result["stats"]["map_points"] > 200
    t, T = load_tum(out)
    assert len(t) >= 50 and np.isfinite(T).all()
    if result["loop_closures"]:
        assert os.path.exists(result["pose_graph_trajectory"])


def test_backends_resident_checkpoint_resume(dataset_dir, tmp_path):  # noqa: F811,E501
    """--resident 2 with both backends fed from the dispatch summaries;
    each checkpoint also writes backend_ba.npz and pose_graph.npz, and
    --resume restores them."""
    ckpt = str(tmp_path / "ckpt")
    args = base_args(dataset_dir) + ["--roll", "5", "--resident", "2",
                                     "--ba", "--ba-every", "1",
                                     "--loop-closure", "--loop-every", "1"]
    first = run(args + ["--duration", "0.3", "--checkpoint-every", "0.1",
                        "--checkpoint-dir", ckpt,
                        "--out", str(tmp_path / "a.txt")])
    for f in ("state.npz", "backend_ba.npz", "pose_graph.npz"):
        assert os.path.exists(os.path.join(ckpt, f)), f
    saved = np.load(os.path.join(ckpt, "pose_graph.npz"))
    assert int(saved["mapping_cycles"]) > 0
    out2 = str(tmp_path / "b.txt")
    result = run(args + ["--duration", "0.6", "--resume", ckpt,
                         "--out", out2])
    t, _ = load_tum(out2)
    assert t[-1] > 0.5
    assert result["ate_rmse_m"] < 0.2, result
    assert result["ba_runs"] >= first["ba_runs"]


def test_lc_set_rejects_unknown_field(dataset_dir):  # noqa: F811
    with pytest.raises(SystemExit, match="unknown field"):
        run(base_args(dataset_dir) + ["--duration", "0.1", "--loop-closure",
                                      "--lc-set", "no_such_field=1"])
    args = torch_run_dataset.parse_args(
        ["--dataset", "d", "--lc-set", "icp_max_mean_dist=0.1",
         "--lc-min-similarity", "0.8"])
    cfg = torch_run_dataset.lc_config(args)
    assert cfg.icp_max_mean_dist == 0.1 and cfg.min_similarity == 0.8
    assert torch_run_dataset.lc_config(
        torch_run_dataset.parse_args(["--dataset", "d"])) is None


def test_live_view_serves_the_run(dataset_dir, tmp_path, monkeypatch):  # noqa: F811,E501
    """--live-view: the dashboard gets the debug maps and the status
    while the replay runs, and a queued parameter applies between
    chunks (with a reset)."""
    from esvo_tpu_torch.utils import live_view
    seen = {}
    real = live_view.LiveViewer

    class Probe(real):
        def update(self, name, rgb):
            super().update(name, rgb)
            if "state" not in seen:
                base = f"http://127.0.0.1:{self.port}"
                seen["state"] = json.loads(urllib.request.urlopen(
                    base + "/state.json").read())
                req = urllib.request.Request(
                    f"{base}/param", data=b"bm.zncc_threshold=0.3",
                    method="POST")
                seen["param"] = urllib.request.urlopen(req).read().decode()
    monkeypatch.setattr(torch_run_dataset, "LiveViewer", Probe)
    result = run(base_args(dataset_dir) + [
        "--duration", "0.3", "--live-view", "0", "--roll", "5",
        "--out", str(tmp_path / "t.txt")])
    assert result["ticks"] >= 25
    assert "inv_depth" in seen["state"]["frames"]
    assert "queued" in seen["param"]
    assert threading.active_count() < 50
