"""scripts/torch_run_dataset.py on tests/test_run_dataset.py's fixture (an
rpg text directory with calibration and reference-format YAMLs), run on
the CPU through ``main(argv, device="cpu")``: the closed loop on the host
path and through the resident loop, --trace, checkpoint and resume,
--devices 2 (two gloo ranks; rank 0 writes the trajectory), and --devices
beyond the visible CUDA cards, which stops at argument time. The
backend and dashboard flags run in tests/test_torch_run_dataset_backends.py.
The bars are those of tests/test_run_dataset.py's cases.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import torch_run_dataset  # noqa: E402
from esvo_tpu_torch.eval.trajectory import load_tum  # noqa: E402
from esvo_tpu_torch.utils import profiling  # noqa: E402
from test_run_dataset import dataset_dir  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def base_args(root):
    return ["--dataset", str(root), "--calib", str(root / "calib"),
            "--mapping-yaml", str(root / "cfg" / "mapping.yaml"),
            "--tracking-yaml", str(root / "cfg" / "tracking.yaml"),
            "--ts-yaml", str(root / "cfg" / "ts.yaml"), "--quiet"]


def run(argv):
    return torch_run_dataset.main(argv, device="cpu")


def test_closed_loop(dataset_dir, tmp_path):  # noqa: F811
    out = str(tmp_path / "traj.txt")
    gm = str(tmp_path / "global_map.xyz")
    dm_dir = str(tmp_path / "depth_maps")
    result = run(base_args(dataset_dir) + [
        "--duration", "0.6", "--out", out, "--global-map-out", gm,
        "--save-depth-maps", dm_dir])
    dumps = sorted(os.listdir(dm_dir))
    assert len(dumps) >= 5 and all(f.endswith(".txt") for f in dumps)
    rows = np.loadtxt(os.path.join(dm_dir, dumps[-1]))
    assert rows.ndim == 2 and rows.shape[1] == 3 and rows.shape[0] > 100
    assert (rows[:, 2] > 0).all()
    t, _ = load_tum(out)
    assert len(t) >= 50
    assert result["ate_rmse_m"] < 0.15, result
    assert result["rpe_trans_rmse_m"] < 0.05, result
    assert result["stats"]["map_points"] > 200
    gm_pts = np.loadtxt(gm)
    assert gm_pts.shape[0] > 200 and gm_pts.shape[1] == 3


def test_resident_loop(dataset_dir, tmp_path):  # noqa: F811
    out = str(tmp_path / "traj_res.txt")
    dm_dir = str(tmp_path / "depth_maps_res")
    result = run(base_args(dataset_dir) + [
        "--duration", "0.6", "--roll", "5", "--resident", "2",
        "--save-depth-maps", dm_dir, "--out", out])
    assert result["ate_rmse_m"] < 0.15, result
    assert result["stats"]["map_points"] > 200
    t, _ = load_tum(out)
    assert len(t) >= 50
    dumps = sorted(os.listdir(dm_dir))
    assert len(dumps) >= 3
    rows = np.loadtxt(os.path.join(dm_dir, dumps[-1]))
    assert rows.ndim == 2 and rows.shape[0] > 100


def test_trace_writes_spans(dataset_dir, tmp_path):  # noqa: F811
    """--trace DIR: the host path's ticks (bootstrap included) and the
    resident dispatches as spans in DIR/spans.json, the summary beside
    it, and the tracer off again after the run."""
    trace = tmp_path / "trace"
    run(base_args(dataset_dir) + [
        "--duration", "0.3", "--roll", "5", "--resident", "2",
        "--trace", str(trace), "--out", str(tmp_path / "traj.txt")])
    assert not profiling.enabled()
    with open(trace / "spans.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    assert {"tick.bootstrap", "tick.map", "tick.finalize", "resident.run",
            "resident.stage", "resident.step", "resident.sync",
            "resident.sync.read"} <= names
    runs = [e for e in events if e["name"] == "resident.run"]
    assert runs and all(e["args"]["counts"]["resident.ticks"] == 10
                        for e in runs)
    summary = (trace / "summary.txt").read_text()
    assert "resident.run:" in summary and "host_reads:" in summary


def test_checkpoint_resume(dataset_dir, tmp_path):  # noqa: F811
    """--checkpoint-every + --resume, through the resident loop: each
    checkpoint hands the device state back (finish()), the loop re-enters
    at the next chunk, and the resumed run continues past the
    checkpointed tick."""
    ckpt = str(tmp_path / "ckpt")
    args = base_args(dataset_dir) + ["--roll", "5", "--resident", "2"]
    run(args + ["--duration", "0.3", "--checkpoint-every", "0.1",
                "--checkpoint-dir", ckpt, "--out",
                str(tmp_path / "a.txt")])
    assert os.path.exists(os.path.join(ckpt, "state.npz"))
    out2 = str(tmp_path / "b.txt")
    result = run(args + ["--duration", "0.6", "--resume", ckpt,
                         "--out", out2])
    t, _ = load_tum(out2)
    assert t[-1] > 0.5
    assert result["ate_rmse_m"] < 0.2, result


@pytest.mark.parametrize("flags, missing", [
    (["--devices", "64"], "CUDA card(s) visible")])
def test_unported_flags_stop_at_argument_time(flags, missing, capsys):
    """More devices than visible cards stops at argument time (the
    default device is cuda), naming the count."""
    with pytest.raises(SystemExit) as exc:
        torch_run_dataset.parse_args(["--dataset", "d", "--calib", "c"]
                                     + flags)
    assert exc.value.code == 2
    assert missing in capsys.readouterr().err


def test_devices_runs_ranks(dataset_dir, tmp_path):  # noqa: F811
    """--devices 2 --roll 5 --loop-closure, as
    tests/test_run_dataset.py::test_run_dataset_sharded_rolls runs it
    (its bars): two gloo ranks, rank 0's trajectory file; with
    --live-view, rank 0 serves the dashboard and every chunk broadcasts
    its (here empty) live control to the other rank."""
    out = str(tmp_path / "traj_sh.txt")
    result = torch_run_dataset.main(
        base_args(dataset_dir) + [
            "--duration", "0.35", "--devices", "2", "--roll", "5",
            "--loop-closure", "--loop-every", "2", "--live-view", "0",
            "--out", out, "--quiet"], device="cpu")
    assert result["stats"]["map_points"] > 150
    assert result["ate_rmse_m"] < 0.15, result
    assert "loop_closures" in result
    t, T = load_tum(out)
    assert len(t) == result["ticks"] and np.isfinite(T).all()
    with pytest.raises(SystemExit, match="single device"):
        torch_run_dataset.main(base_args(dataset_dir) + [
            "--devices", "2", "--roll", "5", "--resident", "2"],
            device="cpu")
