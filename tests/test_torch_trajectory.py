"""The port's trajectory evaluation (eval/trajectory.py) against the JAX
package's on the same arrays, to 1e-9: ATE (rigid and Sim(3)), RPE, the
rigid mask with degenerate poses, host-side pose interpolation, and the
TUM round trip (written by each package, read by the other)."""
import numpy as np
import jax.numpy as jnp
import pytest

from esvo_tpu.eval import trajectory as jtr
from esvo_tpu.geometry.se3 import se3_exp
from esvo_tpu_torch.eval import trajectory as ttr


def _trajectories(seed=0, n=60):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.01
    xi = np.cumsum(rng.normal(0, 0.02, (n, 6)), axis=0)
    gt = np.asarray(se3_exp(jnp.asarray(xi, jnp.float64)))
    noise = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 3e-3, (n, 6)),
                                           jnp.float64)))
    A = np.asarray(se3_exp(jnp.asarray([0.1, -0.2, 0.3, 1.0, 2.0, -0.5],
                                       jnp.float64)))
    est = A @ gt @ noise
    est[7] = np.zeros((4, 4))                  # a diverged step
    est[13, 0, 3] = np.nan
    return t, est, t + 1e-3, gt


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_and_rpe(with_scale):
    t_est, est, t_gt, gt = _trajectories()
    for args in ((t_est, est, t_gt, gt), (t_est[::2], est[::2], t_gt, gt)):
        assert ttr.ate_rmse(*args, with_scale=with_scale) == pytest.approx(
            jtr.ate_rmse(*args, with_scale=with_scale), rel=1e-9, abs=1e-12)
        assert ttr.ate_rmse(*args, align=False) == pytest.approx(
            jtr.ate_rmse(*args, align=False), rel=1e-9)
        for delta in (1, 5):
            np.testing.assert_allclose(ttr.rpe_stats(*args, delta=delta),
                                       jtr.rpe_stats(*args, delta=delta),
                                       rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(ttr.rigid_mask(est), jtr.rigid_mask(est))
    assert ttr.ate_rmse(t_est[:1], est[:1], t_gt, gt) == float("inf")


def test_umeyama_and_interpolation():
    t_est, est, _, gt = _trajectories(1)
    keep = ttr.rigid_mask(est)
    src, dst = est[keep, :3, 3], gt[keep, :3, 3]
    for ws in (False, True):
        for a, b in zip(ttr.umeyama_alignment(src, dst, ws),
                        jtr.umeyama_alignment(src, dst, ws)):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    for t in (-1.0, 0.0, 0.123, 0.3051, 5.0):
        np.testing.assert_allclose(ttr.interpolate_pose(t_est, gt, t),
                                   jtr.interpolate_pose(t_est, gt, t),
                                   rtol=1e-9, atol=1e-12)


def test_tum_round_trip(tmp_path):
    t, _, _, gt = _trajectories(2, 20)
    ttr.save_tum(str(tmp_path / "port.txt"), t, gt)
    jtr.save_tum(str(tmp_path / "jax.txt"), t, gt)
    assert (tmp_path / "port.txt").read_text() \
        == (tmp_path / "jax.txt").read_text()
    for name in ("port.txt", "jax.txt"):
        tp, Tp = ttr.load_tum(str(tmp_path / name))
        tj, Tj = jtr.load_tum(str(tmp_path / name))
        np.testing.assert_allclose(tp, tj, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(Tp, Tj, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(Tp, gt, atol=1e-8)
