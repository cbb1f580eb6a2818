"""Parity of the port's block matching (the "slice" and "matmul" cost
volumes) with the JAX package, on the world of
tests/test_block_matching.py in float32.

Disparity and inverse depth must be equal on at least 99% of the events
matched on both sides, and the validity decisions must agree on at least
99% of all events (a cost at the ZNCC threshold may flip at float32
rounding). The failure counters must be equal.

"matmul" against "slice" in the port: valid and disparity exactly equal,
cost atol 2e-4 (tests/test_block_matching.py's own tolerances: the
product adds the horizontal box in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry.camera import make_ideal_rig
from esvo_tpu.mapping import block_matching as jbm
from esvo_tpu_torch import convert
from esvo_tpu_torch.mapping import block_matching as tbm

W, H = 240, 180
FX = 200.0
BASELINE = 0.1


def _rigs():
    rj = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, BASELINE,
                        dtype=jnp.float32)
    return rj, convert.rig_from_numpy(convert.rig_to_numpy(rj), device="cpu")


def _shifted_pair(rng, disp, vertical=False):
    n = (H + 64, W) if vertical else (H, W + 64)
    base = rng.uniform(0, 255, size=n)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"),
                               0 if vertical else 1, base)
    if vertical:
        return base[32:32 + H], base[32 + disp:32 + disp + H]
    return base[:, 32:32 + W], base[:, 32 + disp:32 + disp + W]


def _run_both(ts_l, ts_r, x, valid, jcfg, tcfg):
    rj, rt = _rigs()
    N = x.shape[0]
    f = np.float32
    a, sa = jbm.match_events_stats(
        jnp.asarray(ts_l, f), jnp.asarray(ts_r, f), jnp.asarray(x, f),
        jnp.asarray(x, f), jnp.zeros(N, f), jnp.asarray(valid), rj.left.mask,
        rj, jcfg)
    b, sb = tbm.match_events_stats(
        torch.tensor(ts_l, dtype=torch.float32),
        torch.tensor(ts_r, dtype=torch.float32),
        torch.tensor(x, dtype=torch.float32),
        torch.tensor(x, dtype=torch.float32), torch.zeros(N),
        torch.tensor(valid), rt.left.mask, rt, tcfg)
    return a, sa, b, sb


def _assert_agree(a, sa, b, sb, min_matched=0.5):
    va, vb = np.asarray(a.valid), b.valid.numpy()
    assert (va == vb).mean() >= 0.99
    both = va & vb
    assert both.mean() >= min_matched
    for name in ("disparity", "inv_depth"):
        eq = (np.asarray(getattr(a, name))[both]
              == getattr(b, name).numpy()[both])
        assert eq.size == 0 or eq.mean() >= 0.99, name
    np.testing.assert_allclose(b.cost.numpy()[both], np.asarray(a.cost)[both],
                               atol=1e-5)
    np.testing.assert_array_equal(b.x_right.numpy()[both],
                                  np.asarray(a.x_right)[both])
    assert {k: int(v) for k, v in sb.items()} == \
        {k: int(v) for k, v in sa.items()}


@pytest.mark.parametrize("disp,noise", [(9, 0.0), (5, 10.0), (1, 0.0)])
def test_matches_jax(disp, noise):
    rng = np.random.default_rng(disp)
    ts_l, ts_r = _shifted_pair(rng, disp)
    ts_r = ts_r + rng.normal(0, noise, ts_r.shape) if noise else ts_r
    N = 300
    x = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], axis=1)
    valid = rng.random(N) > 0.05
    cfg = dict(zncc_threshold=0.1 if noise == 0 else 0.3)
    a, sa, b, sb = _run_both(ts_l, ts_r, x, valid,
                             jbm.BlockMatchConfig(cost_strategy="slice",
                                                  **cfg),
                             tbm.BlockMatchConfig(**cfg))
    _assert_agree(a, sa, b, sb)


def test_up_down_and_smoothing():
    rng = np.random.default_rng(2)
    ts_l, ts_r = _shifted_pair(rng, 6, vertical=True)
    N = 100
    x = np.stack([rng.uniform(20, W - 20, N), rng.uniform(40, H - 20, N)],
                 axis=1)
    cfg = dict(up_down=True, smooth_time_surface=True)
    a, sa, b, sb = _run_both(ts_l, ts_r, x, np.ones(N, bool),
                             jbm.BlockMatchConfig(cost_strategy="slice",
                                                  **cfg),
                             tbm.BlockMatchConfig(**cfg))
    _assert_agree(a, sa, b, sb)


def test_local_minimum_check_and_bounds():
    rng = np.random.default_rng(4)
    ts_l, ts_r = _shifted_pair(rng, 1)
    N = 200
    x = np.stack([rng.uniform(60, W - 20, N), rng.uniform(10, H - 10, N)],
                 axis=1)
    a, sa, b, sb = _run_both(ts_l, ts_r, x, np.ones(N, bool),
                             jbm.BlockMatchConfig(cost_strategy="slice",
                                                  step=2),
                             tbm.BlockMatchConfig(step=2))
    _assert_agree(a, sa, b, sb, min_matched=0.0)
    assert int(sb["fine_fail"]) > 0.5 * N
    rj, rt = _rigs()
    for lo, hi in ((0.2, 2.0), (0.5, 9.0), (0.0, 0.01)):
        got = tbm.derive_disparity_bounds(rt, lo, hi, tbm.BlockMatchConfig())
        assert got == jbm.derive_disparity_bounds(rj, lo, hi,
                                                  jbm.BlockMatchConfig())
    # an unknown strategy raises the JAX package's ValueError
    args = (torch.zeros(H, W), torch.zeros(H, W), torch.zeros(1, 2),
            torch.zeros(1, 2), torch.zeros(1),
            torch.ones(1, dtype=torch.bool), rt.left.mask, rt)
    with pytest.raises(ValueError, match="unknown cost_strategy"):
        tbm.match_events(*args, tbm.BlockMatchConfig(cost_strategy="mxu"))
    with pytest.raises(ValueError, match="unknown cost_strategy"):
        jbm.match_events(*(jnp.asarray(a.numpy()) for a in args[:6]),
                         rj.left.mask, rj,
                         jbm.BlockMatchConfig(cost_strategy="mxu"))


def _matmul_world():
    """tests/test_block_matching.py::test_matmul_strategy_matches_slice's
    inputs: a 7-pixel shift with noise on the right surface."""
    rng = np.random.default_rng(3)
    ts_l, ts_r = _shifted_pair(rng, 7)
    ts_r = ts_r + rng.normal(0, 10, ts_r.shape)
    N = 256
    x = np.stack([rng.uniform(60, W - 20, N), rng.uniform(10, H - 10, N)],
                 axis=1)
    return ts_l, ts_r, x


def test_matmul_strategy_matches_slice():
    ts_l, ts_r, x = _matmul_world()
    _, rt = _rigs()
    N = x.shape[0]
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    args = (t(ts_l), t(ts_r), t(x), t(x), torch.zeros(N),
            torch.ones(N, dtype=torch.bool), rt.left.mask, rt)
    a, sa = tbm.match_events_stats(*args, tbm.BlockMatchConfig(
        cost_strategy="slice", zncc_threshold=1.0))
    b, sb = tbm.match_events_stats(*args, tbm.BlockMatchConfig(
        cost_strategy="matmul", zncc_threshold=1.0))
    assert a.valid.sum() > 0.5 * N
    torch.testing.assert_close(b.valid, a.valid, rtol=0, atol=0)
    torch.testing.assert_close(b.disparity, a.disparity, rtol=0, atol=0)
    torch.testing.assert_close(b.cost, a.cost, rtol=0, atol=2e-4)
    assert {k: int(v) for k, v in sb.items()} == \
        {k: int(v) for k, v in sa.items()}


@pytest.mark.parametrize("max_disparity", [40, 13])
def test_matmul_strategy_matches_jax(max_disparity):
    """The port's "matmul" against JAX's "matmul" (a full chunk count at
    40 disparities, a ragged last chunk at 13)."""
    ts_l, ts_r, x = _matmul_world()
    cfg = dict(cost_strategy="matmul", zncc_threshold=1.0,
               max_disparity=max_disparity)
    a, sa, b, sb = _run_both(ts_l, ts_r, x, np.ones(x.shape[0], bool),
                             jbm.BlockMatchConfig(**cfg),
                             tbm.BlockMatchConfig(**cfg))
    _assert_agree(a, sa, b, sb)
