"""The port's depth-LM scan (depth_refinement._lm_scan: the zncc norm,
lm_kernel="xla", float64 surfaces and the unwindowed fallback) against
the JAX package's XLA scan, in float64.

Worlds: tests/test_depth_refinement.py's smooth random surfaces (the
three norms, windowed and unwindowed) and tests/test_windowed_solve.py's
exact 8-pixel shift (windowed against unwindowed). In float64 validity
must be equal and inverse depth agree to rtol 1e-7: the two packages
round differently in the last bits, and on a few converged events one
side takes a last step below the LM's own stopping test (a relative step
of 1e-6) that the other freezes before, ~1e-8 apart (measured). The
variance is compared where the residual cost is at least 1e-3 (under
Tdist an all-zero residual takes the degenerate branch of the scale
fixed point, where J^T J jumps between paths an ulp apart), to rtol
1e-6.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.geometry.camera import make_ideal_rig
from esvo_tpu.mapping import depth_refinement as jdr
from esvo_tpu_torch import convert
from esvo_tpu_torch.mapping import depth_refinement as tdr

W, H, FX, BASELINE = 240, 180, 200.0, 0.1
F64 = torch.float64


def _rigs():
    rj = make_ideal_rig(W, H, FX, FX, W / 2 - 0.5, H / 2 - 0.5, BASELINE,
                        dtype=jnp.float64)
    return rj, convert.rig_from_numpy(convert.rig_to_numpy(rj), dtype=F64,
                                      device="cpu")


def _smooth(rng, h, w, k):
    img = rng.uniform(0, 255, size=(h, w))
    kern = np.ones(k) / k
    for axis in (1, 0):
        img = np.apply_along_axis(lambda r: np.convolve(r, kern, "same"),
                                  axis, img)
    return img


def refinement_world(seed=0, n=64):
    """tests/test_depth_refinement.py: independent smooth surfaces and a
    small random virtual-to-left pose, events away from the border."""
    rng = np.random.default_rng(seed)
    ts_l = _smooth(rng, H + 16, W + 16, 9)[8:8 + H, 8:8 + W]
    ts_r = _smooth(rng, H + 16, W + 16, 9)[8:8 + H, 8:8 + W]
    coords = np.stack([rng.uniform(20, W - 20, n),
                       rng.uniform(15, H - 15, n)], 1)
    d_init = rng.uniform(0.3, 2.0, n)
    T = np.broadcast_to(np.eye(4), (n, 4, 4)).copy()
    T[:, :3, 3] = 0.01 * rng.standard_normal((n, 3))
    return ts_l, ts_r, coords, d_init, T


def windowed_world(seed=0, n=64, disp=8):
    """tests/test_windowed_solve.py: an exact `disp`-pixel shift, inverse
    depth started within 10% of the truth."""
    rng = np.random.default_rng(seed)
    base = _smooth(rng, H, W + 64, 9)
    ts_l = base[:, 32:32 + W]
    ts_r = base[:, 32 + disp:32 + disp + W]
    coords = np.stack([rng.uniform(40, W - 40, n),
                       rng.uniform(20, H - 20, n)], 1)
    d_init = disp / (FX * BASELINE) * rng.uniform(0.9, 1.1, n)
    return ts_l, ts_r, coords, d_init, np.broadcast_to(
        np.eye(4), (n, 4, 4)).copy()


def solve_both(world, **cfg):
    ts_l, ts_r, coords, d_init, T = world
    rj, rt = _rigs()
    n = coords.shape[0]
    a = jax.jit(jdr.solve)(
        jnp.asarray(coords), jnp.asarray(T), jnp.asarray(T),
        jnp.asarray(d_init), jnp.ones(n, bool), jnp.zeros(n),
        jnp.asarray(ts_l), jnp.asarray(ts_r), rj,
        jdr.DepthProblemConfig(**cfg))
    t = lambda x: torch.tensor(np.asarray(x), dtype=F64)
    b = tdr.solve(t(coords), t(T), t(T), t(d_init),
                  torch.ones(n, dtype=torch.bool), torch.zeros(n), t(ts_l),
                  t(ts_r), rt, tdr.DepthProblemConfig(**cfg))
    return a, b


def assert_same(a, b):
    assert b.inv_depth.dtype == F64
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    np.testing.assert_allclose(b.inv_depth.numpy(), np.asarray(a.inv_depth),
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(b.residual.numpy(), np.asarray(a.residual),
                               rtol=1e-6, atol=1e-6)
    live = (np.asarray(a.residual) >= 1e-3) & (b.residual.numpy() >= 1e-3)
    np.testing.assert_allclose(b.variance.numpy()[live],
                               np.asarray(a.variance)[live], rtol=1e-6)
    np.testing.assert_allclose(b.p_cam.numpy(), np.asarray(a.p_cam),
                               rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("window_margin", [8, -1])
@pytest.mark.parametrize("ls_norm", ["l2", "zncc", "Tdist"])
def test_scan_matches_jax(ls_norm, window_margin):
    a, b = solve_both(refinement_world(), ls_norm=ls_norm,
                      window_margin=window_margin, max_iteration=10,
                      td_fixed_point_iters=50)
    assert np.asarray(a.valid).mean() > 0.5
    assert_same(a, b)


@pytest.mark.parametrize("ls_norm", ["l2", "zncc", "Tdist"])
def test_windowed_world_matches_jax(ls_norm):
    a, b = solve_both(windowed_world(), ls_norm=ls_norm, max_iteration=10)
    assert np.asarray(a.valid).mean() > 0.9
    assert_same(a, b)


def test_windowed_solve_matches_direct_sampling():
    """The port's windowed scan agrees with its unwindowed one wherever
    both are valid (tests/test_windowed_solve.py's bounds)."""
    world = windowed_world()
    _, win = solve_both(world, max_iteration=10, window_margin=8)
    _, direct = solve_both(world, max_iteration=10, window_margin=-1)
    both = win.valid & direct.valid
    assert both.double().mean() > 0.9
    np.testing.assert_allclose(win.inv_depth[both].numpy(),
                               direct.inv_depth[both].numpy(), rtol=1e-6,
                               atol=1e-9)
    ratio = (win.variance[both] / direct.variance[both]).numpy()
    assert np.median(np.abs(np.log(ratio))) < 0.05
    assert (np.abs(np.log(ratio)) < np.log(3)).mean() > 0.9


def test_small_image_falls_back_to_direct_sampling():
    """An image smaller than the window takes the unwindowed scan whatever
    lm_kernel says, as in JAX (here float32, where "auto" would otherwise
    run K2's twin)."""
    rng = np.random.default_rng(5)
    w, h = 30, 20
    rj = make_ideal_rig(w, h, 50.0, 50.0, w / 2 - 0.5, h / 2 - 0.5, 0.1,
                        dtype=jnp.float32)
    rt = convert.rig_from_numpy(convert.rig_to_numpy(rj), device="cpu")
    base = _smooth(rng, h, w + 16, 3).astype(np.float32)
    ts_l, ts_r = base[:, 4:4 + w].copy(), base[:, 6:6 + w].copy()
    n = 16
    coords = np.stack([rng.uniform(10, w - 10, n),
                       rng.uniform(6, h - 6, n)], 1).astype(np.float32)
    d_init = (2 / 5.0 * rng.uniform(0.9, 1.1, n)).astype(np.float32)
    T = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    a = jax.jit(jdr.solve)(
        jnp.asarray(coords), jnp.asarray(T), jnp.asarray(T),
        jnp.asarray(d_init), jnp.ones(n, bool), jnp.zeros(n, jnp.float32),
        jnp.asarray(ts_l), jnp.asarray(ts_r), rj,
        jdr.DepthProblemConfig(lm_kernel="pallas"))
    t = torch.tensor
    b = tdr.solve(t(coords), t(T), t(T), t(d_init),
                  torch.ones(n, dtype=torch.bool), torch.zeros(n), t(ts_l),
                  t(ts_r), rt, tdr.DepthProblemConfig())
    va, vb = np.asarray(a.valid), b.valid.numpy()
    np.testing.assert_array_equal(vb, va)
    np.testing.assert_allclose(b.inv_depth.numpy()[va],
                               np.asarray(a.inv_depth)[va], rtol=2e-4,
                               atol=2e-5)


def test_unknown_lm_kernel_and_norm_raise():
    ts_l, ts_r, coords, d_init, T = windowed_world(n=4)
    _, rt = _rigs()
    t = lambda x: torch.tensor(np.asarray(x), dtype=F64)
    args = (t(coords), t(T), t(T), t(d_init), torch.ones(4, dtype=torch.bool),
            torch.zeros(4), t(ts_l), t(ts_r), rt)
    for cfg, match in ((dict(lm_kernel="cuda"), "lm_kernel"),
                       (dict(ls_norm="huber"), "LSnorm")):
        with pytest.raises(ValueError, match=match):
            tdr.solve(*args, tdr.DepthProblemConfig(**cfg))
