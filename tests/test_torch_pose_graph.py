"""The port's SE(3) pose graph (backend/pose_graph.py) against the JAX
package, on tests/test_pose_graph.py's cases.

The graphs are float64 on both sides (the JAX tests' worlds under
``jax_enable_x64``), plus one float32 graph, the port's production
dtype. Tolerances: residuals within 1e-10 and Jacobians within 1e-8
(absolute) of JAX's ``vmap(jacfwd)``; optimized poses within 1e-6 m /
rad and costs within 1e-8 relative of JAX's after the same LM trips;
float32 within 1e-4; plus each JAX test's own bars on the port.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from esvo_tpu.backend import pose_graph as jpg
from esvo_tpu.geometry import se3 as jse3
from esvo_tpu_torch.backend import pose_graph as tpg
from esvo_tpu_torch.geometry import se3 as tse3
from test_pose_graph import noisy_circle_graph, rand_twists


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: these are thousands of small ops, and
    several test workers each running a full pool slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_port(graph, dtype=torch.float64) -> tpg.PoseGraph:
    f = lambda a: torch.as_tensor(np.array(a, np.float64), dtype=dtype)
    i = lambda a: torch.as_tensor(np.array(a, np.int64))
    return tpg.PoseGraph(
        T_world=f(graph.T_world), edge_i=i(graph.edge_i),
        edge_j=i(graph.edge_j), T_ij=f(graph.T_ij), w_rot=f(graph.w_rot),
        w_trans=f(graph.w_trans),
        edge_valid=torch.as_tensor(np.array(graph.edge_valid)))


def test_edge_jacobians_match_jax_and_are_finite_at_zero():
    """jacfwd through exp/log at xi = 0 (the Taylor branch of se3_log):
    finite, and equal to JAX's."""
    graph, *_ = noisy_circle_graph(np.random.default_rng(7), K=10,
                                   loop_slots=0)
    jac = jax.jit(jpg.edge_residuals_and_jacobians)
    rj, Jj = jac(graph)
    rt, Jt = tpg.edge_residuals_and_jacobians(to_port(graph))
    assert torch.isfinite(Jt).all()
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-10)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-8)
    # an exactly consistent edge (zero residual, se3_log at theta = 0)
    T_i = jse3.se3_exp(rand_twists(np.random.default_rng(2), 1)[0])
    T_j = jse3.se3_exp(rand_twists(np.random.default_rng(3), 1)[0])
    T_ij = np.asarray(jse3.se3_inverse(T_i) @ T_j)
    jg = jpg.odometry_graph(jnp.stack([T_i, T_j]))
    rj, Jj = jac(jg)
    rt, Jt = tpg.edge_residuals_and_jacobians(to_port(jg))
    np.testing.assert_allclose(rt.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-8)
    assert np.allclose(to_port(jg).T_ij[0].numpy(), T_ij, atol=1e-12)


def test_normal_equations_match_jax():
    graph, gt, _ = noisy_circle_graph(np.random.default_rng(7), K=12,
                                      loop_slots=1)
    graph = jpg.add_edge(graph, graph.edge_i.shape[0] - 1, 11, 0,
                         np.linalg.inv(gt[-1]) @ gt[0], 400.0, 400.0)
    cfg = dict(huber_threshold=1.0)
    Hj, gj, cj = jax.jit(lambda g: jpg._normal_equations(
        g, jpg.PoseGraphConfig(**cfg)))(graph)
    Ht, gt_, ct = tpg._normal_equations(to_port(graph),
                                        tpg.PoseGraphConfig(**cfg))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-7)
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj), atol=1e-8)
    assert float(ct) == pytest.approx(float(cj), rel=1e-10)


def test_loop_closure_reduces_error():
    rng = np.random.default_rng(7)
    graph, gt, est = noisy_circle_graph(rng, K=24, loop_slots=1)
    rel = np.linalg.inv(gt[-1]) @ gt[0]
    graph = jpg.add_edge(graph, graph.edge_i.shape[0] - 1,
                         graph.T_world.shape[0] - 1, 0, rel,
                         w_rot=400.0, w_trans=400.0)
    tg = tpg.add_edge(to_port(jpg.odometry_graph(jnp.asarray(est),
                                                 extra_capacity=1)),
                      23, 23, 0, rel, w_rot=400.0, w_trans=400.0)
    for name in ("edge_i", "edge_j", "T_ij", "w_rot", "edge_valid"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(graph, name)))
    opt_j, costs_j = jpg.optimize_pose_graph(
        graph, jpg.PoseGraphConfig(max_iterations=25))
    opt, costs = tpg.optimize_pose_graph(
        tg, tpg.PoseGraphConfig(max_iterations=25))
    assert costs.shape == (26,)
    np.testing.assert_allclose(costs.numpy(), np.asarray(costs_j),
                               rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(opt.T_world.numpy(),
                               np.asarray(opt_j.T_world), atol=1e-6)
    # tests/test_pose_graph.py's bars, on the port
    err0 = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    err1 = np.linalg.norm(opt.T_world.numpy()[:, :3, 3] - gt[:, :3, 3],
                          axis=1)
    assert float(costs[-1]) < float(costs[0])
    assert err1.max() < 0.6 * err0.max()
    assert err1[-1] < 0.1 * err0[-1]
    np.testing.assert_array_equal(opt.T_world[0].numpy(), gt[0])


def test_consistent_graph_stays_put():
    graph, gt, est = noisy_circle_graph(np.random.default_rng(8), K=12,
                                        loop_slots=0)
    opt, costs = tpg.optimize_pose_graph(
        to_port(graph), tpg.PoseGraphConfig(max_iterations=5))
    assert float(costs[0]) < 1e-12
    np.testing.assert_allclose(opt.T_world.numpy(), est, atol=1e-6)


def test_huber_downweights_false_loop():
    def run(huber):
        graph, gt, est = noisy_circle_graph(
            np.random.default_rng(9), K=16, loop_slots=1, drift=0.005)
        bogus = np.linalg.inv(gt[8]) @ gt[0]
        graph = jpg.add_edge(graph, graph.edge_i.shape[0] - 1,
                             15, 0, bogus, w_rot=50.0, w_trans=50.0)
        opt_j, _ = jpg.optimize_pose_graph(graph, jpg.PoseGraphConfig(
            max_iterations=20, huber_threshold=huber))
        opt, _ = tpg.optimize_pose_graph(to_port(graph), tpg.PoseGraphConfig(
            max_iterations=20, huber_threshold=huber))
        np.testing.assert_allclose(opt.T_world.numpy(),
                                   np.asarray(opt_j.T_world), atol=1e-6)
        return np.linalg.norm(opt.T_world.numpy()[:, :3, 3]
                              - gt[:, :3, 3], axis=1).max()

    assert run(1.0) < run(np.inf)


def test_float32_graph():
    """The port's production dtype, against the float64 answer."""
    graph, gt, est = noisy_circle_graph(np.random.default_rng(7), K=24,
                                        loop_slots=1)
    rel = np.linalg.inv(gt[-1]) @ gt[0]
    g64 = tpg.add_edge(to_port(graph), 23, 23, 0, rel, 400.0, 400.0)
    g32 = tpg.add_edge(to_port(graph, torch.float32), 23, 23, 0, rel, 400.0,
                       400.0)
    cfg = tpg.PoseGraphConfig(max_iterations=15, huber_threshold=10.0)
    o64, _ = tpg.optimize_pose_graph(g64, cfg)
    o32, c32 = tpg.optimize_pose_graph(g32, cfg)
    assert o32.T_world.dtype == torch.float32
    assert float(c32[-1]) < float(c32[0])
    np.testing.assert_allclose(o32.T_world.double().numpy(),
                               o64.T_world.numpy(), atol=1e-4)


def test_se3_roundtrip_near_zero_and_pi():
    """The port's se3 exp/log, which the Jacobians differentiate, on
    tests/test_pose_graph.py's twists (tiny and near-pi rotations)."""
    rng = np.random.default_rng(0)
    xi = np.concatenate([np.asarray(rand_twists(rng, 16)),
                         np.asarray(rand_twists(rng, 8, 1e-8, 1e-8)),
                         np.asarray(rand_twists(rng, 8, rot_scale=0.0))])
    axes = rng.normal(size=(8, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    xi = np.concatenate([xi, np.concatenate(
        [axes * (np.pi - 1e-4), rng.normal(size=(8, 3))], 1)])
    T = tse3.se3_exp(torch.as_tensor(xi))
    np.testing.assert_allclose(T.numpy(), np.asarray(jse3.se3_exp(
        jnp.asarray(xi))), atol=1e-12)
    np.testing.assert_allclose(tse3.se3_log(T).numpy(), xi, atol=1e-8)
