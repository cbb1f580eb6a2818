"""The float32 matmul-precision guard (utils/precision.py) and the port's
entry points under it: a caller's ``torch.set_float32_matmul_precision``
("high" or "medium") is restored after a guarded call and after one that
raises, and spies inside ``registration.solve``,
``MappingCycle.mapping_estimate`` and ``ResidentLoop.roll`` read
``torch.backends.cuda.matmul.allow_tf32 == False`` while the caller has
set "high".
"""
import numpy as np
import pytest
import torch

from esvo_tpu_torch.geometry.camera import make_ideal_rig
from esvo_tpu_torch.mapping import depth_refinement as dr
from esvo_tpu_torch.runtime.config import MappingConfig, SystemConfig
from esvo_tpu_torch.runtime.resident import ResidentLoop
from esvo_tpu_torch.runtime.system import EsvoSystem, MappingCycle
from esvo_tpu_torch.tracking import registration as reg
from esvo_tpu_torch.utils.precision import highest_precision

W, H = 64, 48


class Stop(Exception):
    pass


@pytest.fixture
def caller_high():
    """The caller's process-wide setting is "high" (TF32 allowed); put
    back afterwards."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(saved)


def tf32() -> bool:
    return torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("setting", ["high", "medium", "highest"])
def test_guard_restores_the_callers_setting(setting):
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(setting)
    try:
        @highest_precision()
        def inside():
            return tf32(), torch.get_float32_matmul_precision()

        assert inside() == (False, "highest")
        assert torch.get_float32_matmul_precision() == setting
        with pytest.raises(Stop):
            with highest_precision():
                assert not tf32()
                raise Stop
        assert torch.get_float32_matmul_precision() == setting
        with highest_precision():          # nested: the outer one restores
            with highest_precision():
                pass
            assert not tf32()
        assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision(saved)


def _spy(seen, fn=None):
    def spy(*args, **kw):
        seen.append(tf32())
        if fn is None:
            raise Stop
        return fn(*args, **kw)
    return spy


def test_tracking_solve_runs_in_full_float32(caller_high, monkeypatch):
    rig = make_ideal_rig(W, H, 60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                         device="cpu")
    rng = np.random.default_rng(0)
    pts = torch.tensor(np.c_[rng.uniform(-0.3, 0.3, (200, 2)),
                             rng.uniform(0.8, 1.5, 200)], dtype=torch.float32)
    ts = torch.tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32)
    cfg = reg.RegProblemConfig(batch_size=100, max_iteration=3)
    prob = reg.make_problem(torch.eye(4), torch.eye(4), pts,
                            torch.ones(200, dtype=torch.bool), ts, cfg)
    seen = []
    monkeypatch.setattr(reg, "solve_spd", _spy(seen, reg.solve_spd))
    _, T, rms = reg.solve(prob, rig.left, cfg)
    assert seen == [False] * 3
    assert torch.isfinite(T).all() and rms.shape == (3,)
    assert torch.get_float32_matmul_precision() == "high" and tf32()


def test_mapping_estimate_runs_in_full_float32(caller_high, monkeypatch):
    cfg = SystemConfig(mapping=MappingConfig(process_event_num=64,
                                             denoising=False))
    cycle = MappingCycle(make_ideal_rig(W, H, 60.0, 60.0, W / 2 - 0.5,
                                        H / 2 - 0.5, 0.1, device="cpu"),
                         cfg, device="cpu")
    rng = np.random.default_rng(1)
    ts_l, ts_r = (torch.tensor(rng.uniform(0, 255, (H, W)),
                               dtype=torch.float32) for _ in range(2))
    n = 100
    x = torch.tensor(rng.integers(0, W, n), dtype=torch.int32)
    y = torch.tensor(rng.integers(0, H, n), dtype=torch.int32)
    t = torch.tensor(np.sort(rng.uniform(0, 0.01, n)), dtype=torch.float32)
    times = torch.tensor([0.0, 0.02])
    poses = torch.eye(4).expand(2, 4, 4).contiguous()
    args = (ts_l, ts_r, x, y, t, torch.ones(n, dtype=torch.bool), times,
            poses, torch.eye(4))
    seen = []
    monkeypatch.setattr(dr, "solve", _spy(seen, dr.solve))
    est, n_valid, _ = cycle.mapping_estimate(*args)
    assert seen == [False] and est.inv_depth.shape == (64,)
    assert tf32()
    monkeypatch.setattr(dr, "solve", _spy(seen))     # raises inside
    with pytest.raises(Stop):
        cycle.mapping_estimate(*args)
    assert seen == [False, False]
    assert torch.get_float32_matmul_precision() == "high" and tf32()


def test_resident_roll_runs_in_full_float32(caller_high, monkeypatch):
    rig = make_ideal_rig(W, H, 60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                         device="cpu")
    system = EsvoSystem(rig, SystemConfig(mapping=MappingConfig(
        process_event_num=64)), device="cpu")
    loop = ResidentLoop(system, ticks_per_roll=2, rolls_per_dispatch=1)
    seen = []
    monkeypatch.setattr(system, "select_from_scores", _spy(seen))

    class Inputs:
        scores = torch.zeros(H * W)

    with pytest.raises(Stop):
        loop.roll(loop.state, Inputs())
    assert seen == [False]
    assert torch.get_float32_matmul_precision() == "high" and tf32()
