"""The port's measurement scripts on the CPU at tiny sizes:

- scripts/torch_measure_em_overflow.py: its statistics equal the JAX
  script's (scripts/measure_em_overflow.py) on a dataset this test
  writes, in both layouts (packed npz and rpg text);
- scripts/torch_bench_solve.py, torch_bench_ticks.py and
  torch_profile_system.py run with --device cpu;
- scripts/torch_bench_scaling.py at worlds 1 and 2 on gloo ranks: each
  stage's collective bytes (parallel/sharding.py's COLLECTIVE_BYTES)
  equal its analytic payload, the bytes of every collective's result.
"""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_bench_scaling as tbs  # noqa: E402
import torch_bench_solve  # noqa: E402
import torch_bench_ticks  # noqa: E402
import torch_measure_em_overflow  # noqa: E402
import torch_profile_system  # noqa: E402

from esvo_tpu_torch.io.events import EventArray, save_events_npz  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: these are thousands of small ops, and
    several test workers each running a full pool slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_measure_em_overflow", ROOT / "scripts" / "measure_em_overflow.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events(rng, n):
    return EventArray(t=np.sort(rng.uniform(0.0, 0.05, n)),
                      x=rng.integers(0, 240, n).astype(np.int32),
                      y=rng.integers(0, 180, n).astype(np.int32),
                      p=rng.random(n) > 0.5)


@pytest.mark.parametrize("layout", ["npz", "txt"])
def test_em_overflow_equals_jax(tmp_path, layout):
    rng = np.random.default_rng(5)
    evs = [_events(rng, 20000), _events(rng, 18000)]
    for side, ev in zip(("left", "right"), evs):
        if layout == "npz":
            save_events_npz(str(tmp_path / f"events_{side}.npz"), ev)
        else:
            np.savetxt(tmp_path / f"events_{side}.txt",
                       np.stack([ev.t, ev.x, ev.y, ev.p], 1),
                       fmt=["%.9f", "%d", "%d", "%d"])
    argv = ["--dataset", str(tmp_path), "--ks", "4,8,16"]
    if layout == "txt":
        argv += ["--max-events", "15000"]
    got = torch_measure_em_overflow.main(argv)
    want = _jax_script().main(argv)
    assert got == want
    assert got["candidates_max"] > 4 and got["overflow_frac_K4"] > 0


@pytest.mark.parametrize("dsec", [False, True])
def test_bench_solve_cpu(dsec, capsys):
    argv = ["--device", "cpu", "--n", "64", "--iters", "0,2", "--reps", "1"]
    rows = torch_bench_solve.main(argv + (["--dsec"] if dsec else []))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    assert [r["iters"] for r in rows] == [0, 2]
    assert all(r["ms"] > 0 and 0 < r["valid"] <= 64 for r in rows)


def test_bench_ticks_cpu(capsys):
    rates = torch_bench_ticks.main(["--device", "cpu", "--ticks", "10"])
    assert set(rates) == {"sequential", "rolled"}
    assert all(r > 0 for r in rates.values())
    assert "speedup" in capsys.readouterr().out


def test_profile_system_cpu(capsys):
    timer = torch_profile_system.main(["6", "--device", "cpu"])
    assert sum(timer.counts.values()) == 6
    assert set(timer.counts) == {"tick_first", "tick_map_first", "tick"}
    assert "tick_map_first" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# scaling: collective bytes against each stage's payload
# ---------------------------------------------------------------------------

PER_DEVICE = dict(events=64, points=64, obs=64, edges=8)


def payload(stage: str, n: int) -> dict:
    """The bytes of the results of one step's collectives (float32 = 4
    bytes a value), from the shapes and the code's collective sites."""
    if stage == "solve":
        # all-gather of the estimates: x 2, inv_depth, variance, scale2,
        # nu, residual, age (int32), p_cam 3, T_world_cam 16 values of 4
        # bytes, valid 1 byte (bool as uint8)
        return {"all-gather": PER_DEVICE["events"] * n * ((2 + 6 + 3 + 16)
                                                          * 4 + 1)}
    if stage == "surface":
        # MAX all-reduce of both (H, W) timestamp grids
        return {"all-reduce": 2 * tbs.H * tbs.W * 4}
    if stage == "tracking":
        # J^T J (6, 6), J^T f (6), cost
        return {"all-reduce": (36 + 6 + 1) * 4}
    if stage == "ba":
        K, P = tbs.BA_KEYFRAMES, tbs.BA_POINTS
        # an iteration: cost, B (K,6,6), C (P,3,3), gc (K,6), gp (P,3);
        # per keyframe column A (P,6,3) and S's column (K,6,6); g_red
        # (K,6); E dx (P,3); the trial's cost
        per_iter = (1 + 36 * K + 9 * P + 6 * K + 3 * P
                    + K * (18 * P + 36 * K) + 6 * K + 3 * P + 1)
        return {"all-reduce": tbs.BA_ITERS * per_iter * 4}
    if stage == "pose_graph":
        K6 = 6 * tbs.PG_POSES
        # an iteration: cost, H (6K, 6K), g (6K), the trial's cost; then
        # the returned graph's cost
        return {"all-reduce": (tbs.PG_ITERS * (1 + K6 * K6 + K6 + 1) + 1)
                * 4}
    raise KeyError(stage)


@pytest.fixture(scope="module")
def scaling():
    return tbs.main(["--device", "cpu", "--devices", "1,2", "--reps", "1",
                     "--events-per-device", str(PER_DEVICE["events"]),
                     "--points-per-device", str(PER_DEVICE["points"]),
                     "--obs-per-device", str(PER_DEVICE["obs"]),
                     "--edges-per-device", str(PER_DEVICE["edges"])])


@pytest.mark.parametrize("stage", ["solve", "surface", "tracking", "ba",
                                   "pose_graph"])
def test_scaling_collective_bytes(scaling, stage):
    rows = scaling[stage]
    assert [r[0] for r in rows] == [1, 2]
    for n, items, ms, _, cpu_ms, _, total, by_op in rows:
        assert by_op == payload(stage, n), (stage, n)
        assert total == sum(by_op.values())
        assert ms > 0 and cpu_ms > 0 and items > 0
