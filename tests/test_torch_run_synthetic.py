"""examples/torch_run_synthetic.py, the port of examples/run_synthetic.py
(the README's demo), on the CPU at 10 ticks: the SGM bootstrap at tick
4 takes it to WORKING and five tracked ticks follow; the trajectory
stays under its 0.1 m ATE bar and the map holds points. Without a card,
the default device raises (no CPU fallback). The JAX demo's flags
(n_ticks, --ba, --loop-closure) parse as they do there."""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def demo():
    spec = importlib.util.spec_from_file_location(
        "torch_run_synthetic", ROOT / "examples" / "torch_run_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", [[], ["--ba", "--loop-closure"]],
                         ids=["closed-loop", "backends"])
def test_demo_reaches_working_on_the_cpu(demo, few_threads, flags):
    res = demo.main(["10", "--device", "cpu", *flags])
    assert res["status"] == "WORKING" and res["ticks"] == 10
    assert res["map_points"] > 0 and res["ate_m"] < demo.ATE_BAR
    assert ("ba_runs" in res) == ("--ba" in flags)
    assert ("loop_closures" in res) == ("--loop-closure" in flags)


def test_demo_without_a_card_raises(demo):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["5"])
