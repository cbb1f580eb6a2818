"""Kernel K5's dispatch and its plain twin (mapping/regularization.py).

- ``regularize`` on CPU tensors is ``regularize_plain`` bit for bit and
  never reaches the kernel's wrapper.
- The wrapper's argument checks (``ops/regularize.py``) raise on wrong
  dtypes, shapes, devices and a radius whose halo does not fit a block's
  shared memory, and a CPU tensor never launches.
- The twin against JAX's ``regularize`` at the DSEC radius of 20 and its
  gates (32 neighbours, 32 close) on a 60x80 grid whose occupancy and
  noise vary across it, so that both gates pass and fail: Tdist with
  finite nu, Tdist with a third of the points at nu = inf (the Gaussian
  limit) and l2. The cells each package invalidates (EMPTY) are the
  same; the smoothed inverse depths agree within the fusion tests'
  rtol 1e-5, atol 1e-7 (tests/test_torch_fusion.py). The r = 2 case is
  tests/test_torch_fusion.py's.
The kernel itself runs on the card only (tests/test_torch_cuda.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.mapping import fusion as jfu
from esvo_tpu.mapping import regularization as jreg
from esvo_tpu_torch.mapping import fusion as tfu
from esvo_tpu_torch.mapping import regularization as treg
from esvo_tpu_torch.ops import regularize as regularize_op

H, W = 60, 80
f32 = np.float32


def _planes(seed, nu_inf_share):
    """A slanted inverse-depth plane with noise whose spread grows to the
    right, occupancy from 0.2% (top) to 30% (bottom), per-cell variances
    around the noise, Student-t scales and nu (a share of them inf)."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:H, 0:W].astype(f32)
    noise = (0.002 + 0.02 * gx / W) * rng.standard_normal((H, W))
    invD = (0.3 + 0.2 * gx / W + 0.1 * gy / H + noise).astype(f32)
    occ = rng.random((H, W)) < 0.002 + 0.3 * (gy / H) ** 2
    var = ((0.004 + 0.01 * rng.random((H, W))) ** 2).astype(f32)
    scale2 = (var * (0.5 + rng.random((H, W)))).astype(f32)
    nu = (2.0 + 4.0 * rng.random((H, W))).astype(f32)
    nu[rng.random((H, W)) < nu_inf_share] = np.inf
    invD = np.where(occ, invD, f32(-1.0)).astype(f32)
    return dict(inv_depth=invD, variance=var, scale2=scale2, nu=nu)


def _grids(planes):
    zeros = np.zeros((H, W), f32)
    rest = dict(residual=zeros, age=np.zeros((H, W), np.int32),
                x=np.zeros((H, W, 2), f32), p_cam=np.zeros((H, W, 3), f32))
    full = dict(planes, **rest)
    gj = jfu.DepthGrid(**{k: jnp.asarray(v) for k, v in full.items()})
    gt = tfu.DepthGrid(**{k: torch.from_numpy(np.array(v))
                          for k, v in full.items()})
    return gj, gt


DSEC_GATES = dict(radius=20, min_neighbours=32, min_close_neighbours=32)


@pytest.mark.parametrize("ls_norm, nu_inf_share", [
    ("Tdist", 0.0), ("Tdist", 0.33), ("l2", 0.0)],
    ids=["tdist", "tdist-nu-inf", "l2"])
def test_twin_matches_jax_at_dsec_radius(ls_norm, nu_inf_share):
    gj, gt = _grids(_planes(1, nu_inf_share))
    rj = jreg.regularize(gj, jreg.RegularizationConfig(ls_norm=ls_norm,
                                                       **DSEC_GATES))
    rt = treg.regularize(gt, treg.RegularizationConfig(ls_norm=ls_norm,
                                                       **DSEC_GATES))
    dj = np.asarray(rj.inv_depth)
    dt = rt.inv_depth.numpy()
    valid = gt.occupied.numpy()
    kept_t, kept_j = valid & (dt != -1.0), valid & (dj != -1.0)
    np.testing.assert_array_equal(kept_t, kept_j)
    # both gates pass somewhere and fail somewhere
    assert 0.1 < kept_t.sum() / valid.sum() < 0.95
    np.testing.assert_array_equal(dt[~valid], gt.inv_depth.numpy()[~valid])
    np.testing.assert_allclose(dt[kept_t], dj[kept_t], rtol=1e-5, atol=1e-7)
    moved = np.abs(dt[kept_t] - gt.inv_depth.numpy()[kept_t])
    assert np.median(moved) > 1e-4          # it smoothed


@pytest.mark.parametrize("ls_norm", ["Tdist", "l2"])
def test_cpu_regularize_is_the_twin(ls_norm, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached K5's wrapper")

    monkeypatch.setattr(regularize_op, "regularize", refuse)
    _, gt = _grids(_planes(2, 0.2))
    cfg = treg.RegularizationConfig(ls_norm=ls_norm, radius=3,
                                    min_neighbours=4, min_close_neighbours=3)
    got = treg.regularize(gt, cfg).inv_depth
    want = treg.regularize_plain(gt, cfg).inv_depth
    assert torch.equal(got, want)


def _wrapper_args():
    return dict(valid=torch.ones(6, 7, dtype=torch.bool),
                invD=torch.zeros(6, 7), var=torch.ones(6, 7),
                scale2=torch.ones(6, 7), nu=torch.ones(6, 7))


@pytest.mark.parametrize("name, bad, exc", [
    ("valid", torch.ones(6, 7), TypeError),
    ("invD", torch.zeros(6, 7, dtype=torch.float64), TypeError),
    ("var", torch.ones(6, 8), ValueError),
    ("nu", torch.ones(6, 7, device="meta"), ValueError),
], ids=["valid-dtype", "invD-f64", "var-shape", "device"])
def test_wrapper_checks_raise(name, bad, exc):
    args = _wrapper_args()
    regularize_op.check_inputs(**args, radius=20)
    args[name] = bad
    with pytest.raises(exc):
        regularize_op.check_inputs(**args, radius=20)


def test_wrapper_checks_the_halo_and_refuses_cpu_tensors():
    assert regularize_op.shared_bytes(20) == 72 * 48 * 17
    with pytest.raises(ValueError, match="halo"):
        regularize_op.check_inputs(**_wrapper_args(), radius=60)
    before = regularize_op.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        regularize_op.regularize(**_wrapper_args(), radius=5, tdist=True,
                                 min_neighbours=8, min_close_neighbours=8)
    assert regularize_op.KERNEL.launches == before


def test_kernel_takes_float32_and_a_halo_that_fits(monkeypatch):
    """K5's dispatch rule: a float32 inverse depth and a radius whose
    halo fits a block (48 does, 49 does not) take K5; float64 takes the
    twin on every device (here through ``regularize``, which never
    reaches the wrapper); a float32 grid whose other planes are float64
    is taken by the rule and refused by the wrapper's checks."""
    _, gt = _grids(_planes(3, 0.2))
    cfg = treg.RegularizationConfig(radius=20, min_neighbours=32,
                                    min_close_neighbours=32)
    assert treg.kernel_takes(gt, cfg)
    assert treg.kernel_takes(gt, treg.RegularizationConfig(radius=48))
    assert not treg.kernel_takes(gt, treg.RegularizationConfig(radius=49))
    g64 = gt.replace(**{k: getattr(gt, k).double() for k in (
        "inv_depth", "variance", "scale2", "nu")})
    assert not treg.kernel_takes(g64, cfg)

    def refuse(*a, **kw):
        raise AssertionError("a float64 grid reached K5's wrapper")

    monkeypatch.setattr(regularize_op, "regularize", refuse)
    small = treg.RegularizationConfig(radius=3, min_neighbours=4,
                                      min_close_neighbours=3)
    got = treg.regularize(g64, small).inv_depth
    assert got.dtype == torch.float64
    assert torch.equal(got, treg.regularize_plain(g64, small).inv_depth)
    mixed = gt.replace(variance=gt.variance.double())
    assert treg.kernel_takes(mixed, cfg)
    with pytest.raises(TypeError):
        regularize_op.check_inputs(mixed.occupied, mixed.inv_depth,
                                   mixed.variance, mixed.scale2, mixed.nu,
                                   cfg.radius)
