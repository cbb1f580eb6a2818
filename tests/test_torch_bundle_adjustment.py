"""The port's bundle adjustment and keyframe graph
(backend/{bundle_adjustment,keyframes}.py) against the JAX package, on
tests/test_backend.py's cases.

Under the tests' ``jax_enable_x64`` the JAX BA runs in float64 (its
damping scalar is a float64 array, which promotes a float32 problem), so
both packages solve the same float64 problems here. Tolerances:
residuals and Jacobians within 1e-9 (absolute, float64 pixels); the
costs and the poses after the LM trips within 1e-8 relative / 1e-9 m;
plus each JAX test's own bars on the port.
"""
import numpy as np
import jax
import pytest
import torch

from esvo_tpu.backend import bundle_adjustment as jba
from esvo_tpu.backend import keyframes as jkf
from esvo_tpu_torch.backend import bundle_adjustment as tba
from esvo_tpu_torch.backend import keyframes as tkf
from test_backend import synthetic_problem, FX, FY, CX, CY


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: these are thousands of small ops, and
    several test workers each running a full pool slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_port(prob) -> tba.BAProblem:
    f = lambda a: torch.as_tensor(np.array(a, np.float64))
    return tba.BAProblem(
        T_world_kf=f(prob.T_world_kf), points=f(prob.points),
        obs_kf=torch.as_tensor(np.array(prob.obs_kf, np.int64)),
        obs_point=torch.as_tensor(np.array(prob.obs_point, np.int64)),
        obs_uv=f(prob.obs_uv),
        obs_valid=torch.as_tensor(np.array(prob.obs_valid)),
        fx=f(prob.fx), fy=f(prob.fy), cx=f(prob.cx), cy=f(prob.cy))


def test_residuals_and_jacobians_match_jax():
    prob, *_ = synthetic_problem(np.random.default_rng(1), K=3, P=40)
    want = jba.reprojection_residuals(prob)
    got = tba.reprojection_residuals(to_port(prob))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9)


def test_residuals_zero_at_ground_truth():
    prob, *_ = synthetic_problem(np.random.default_rng(0), pose_noise=0.0,
                                 point_noise=0.0)
    r, Jc, Jp, ok = tba.reprojection_residuals(to_port(prob))
    assert ok.all()
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-9)


def test_jacobians_match_finite_differences():
    prob = to_port(synthetic_problem(np.random.default_rng(1), K=2,
                                     P=10)[0])
    r0, Jc, Jp, ok = tba.reprojection_residuals(prob)
    eps = 1e-7
    for axis in range(3):
        dp = torch.zeros_like(prob.points)
        dp[:, axis] = eps
        r1 = tba.reprojection_residuals(prob.replace(points=prob.points
                                                     + dp))[0]
        np.testing.assert_allclose(Jp[:, :, axis].numpy(),
                                   ((r1 - r0) / eps).numpy(),
                                   rtol=1e-4, atol=1e-5)
        T2 = prob.T_world_kf.clone()
        T2[:, axis, 3] += eps
        r1 = tba.reprojection_residuals(prob.replace(T_world_kf=T2))[0]
        np.testing.assert_allclose(Jc[:, :, 3 + axis].numpy(),
                                   ((r1 - r0) / eps).numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed, noise, iters", [
    (2, dict(pose_noise=0.01, point_noise=0.02), 15),
    (3, dict(pose_noise=0.02, point_noise=0.05, pix_noise=0.3), 15)],
    ids=["recovers_ground_truth", "pixel_noise"])
def test_bundle_adjust_matches_jax(seed, noise, iters):
    prob, gt_poses, gt_points = synthetic_problem(
        np.random.default_rng(seed), **noise)
    cfg = dict(max_iterations=iters, num_fixed_poses=2)
    j_out, j_costs = jax.jit(lambda p: jba.bundle_adjust(
        p, jba.BAConfig(**cfg)))(prob)
    t_out, t_costs = tba.bundle_adjust(to_port(prob), tba.BAConfig(**cfg))
    np.testing.assert_allclose(t_costs.numpy(), np.asarray(j_costs),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(t_out.T_world_kf.numpy(),
                               np.asarray(j_out.T_world_kf), atol=1e-9)
    # the JAX tests' own bars, on the port
    T_est = t_out.T_world_kf.numpy()
    t_err = np.linalg.norm(T_est[:, :3, 3] - gt_poses[:, :3, 3], axis=1)
    if "pix_noise" in noise:
        assert t_err.max() < 0.01, t_err
    else:
        c = t_costs.numpy()
        assert c[-1] < 1e-4 * c[0]
        assert t_err.max() < 1e-4, t_err
        p_err = np.linalg.norm(t_out.points.numpy() - gt_points, axis=1)
        assert np.median(p_err) < 1e-4


def test_bundle_adjust_float32():
    """The port's production dtype: float32 reaches the float64 answer's
    accuracy bar (JAX cannot run this under x64, see the docstring)."""
    prob, gt_poses, _ = synthetic_problem(np.random.default_rng(2),
                                          pose_noise=0.01, point_noise=0.02)
    p = to_port(prob)
    p32 = p.replace(**{k: getattr(p, k).float() for k in (
        "T_world_kf", "points", "obs_uv", "fx", "fy", "cx", "cy")})
    out, costs = tba.bundle_adjust(p32, tba.BAConfig(max_iterations=15,
                                                     num_fixed_poses=2))
    assert out.T_world_kf.dtype == torch.float32
    assert (np.diff(costs.numpy()) <= 0).all()
    t_err = np.linalg.norm(out.T_world_kf.numpy()[:, :3, 3]
                           - gt_poses[:, :3, 3], axis=1)
    assert t_err.max() < 1e-3, t_err


def test_keyframe_graph_association_matches_jax():
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(-0.5, 0.5, 50),
                    rng.uniform(-0.4, 0.4, 50),
                    rng.uniform(1.5, 2.5, 50)], axis=1)
    uv = rng.uniform(0, 100, (50, 2))
    graphs = []
    for mod in (jkf, tkf):
        g = mod.KeyframeGraph(fx=FX, fy=FY, cx=CX, cy=CY, voxel_size=0.05)
        g.add_keyframe(np.eye(4), pts, uv, np.ones(50, bool))
        g.add_keyframe(np.eye(4), pts + 0.001, uv, np.ones(50, bool))
        graphs.append(g)
    jg, tg = graphs
    assert tg.num_keyframes == 2 and 50 <= tg.num_points <= 55
    assert tg.num_points == jg.num_points and tg.obs == jg.obs
    assert tg.multiview_fraction() == jg.multiview_fraction() > 0.85
    for max_points in (None, 40, 80):
        jp = jkf.build_ba_problem(jg, max_points=max_points)
        tp = tkf.build_ba_problem(tg, max_points=max_points,
                                  dtype=torch.float64, device="cpu")
        for name in ("T_world_kf", "points", "obs_kf", "obs_point",
                     "obs_uv", "obs_valid", "fx", "cy"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)))
    prob = tkf.build_ba_problem(tg, device="cpu")
    assert prob.obs_uv.shape == (1024, 2) and prob.points.dtype == \
        torch.float32
    assert int(prob.obs_valid.sum()) == 100
    assert bool(prob.obs_valid[:100].all())
