"""The port's event-axis sharding (esvo_tpu_torch/parallel/sharding.py) on
4 gloo ranks on the CPU, against its own serial calls and against the
JAX package's sharded functions on a 4-device mesh (the conftest's
virtual CPU devices), on tests/test_parallel.py's inputs made with numpy
from the same seeds.

All cases run inside one spawn of the ranks (tests/torch_parallel_ranks.py
holds the rank body). Tolerances are tests/test_parallel.py's:

- surfaces exact (scatter-max is associative);
- map estimate: validity exact, inverse depth rtol 1e-5 / atol 1e-7
  against the serial call; across the packages both sides run the LM
  scan (lm_kernel="xla"), and >= 99% of events agree to inverse depth
  rtol 2e-4 (float32 accept / reject races of the LM, as in
  tests/test_torch_lm.py);
- tracking step: cost rtol 1e-5, dx rtol 0.1 / atol 1e-3 (the 6x6 solve
  amplifies float32 summation-order noise);
- BA normal-equation blocks rtol 1e-6 / atol 1e-8 (float64);
- BA and pose-graph costs rtol 1e-5, poses rtol 1e-4 / atol 1e-6,
  points atol 1e-5 (float64).

The outputs a sharded function replicates must be equal on every rank,
bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_ranks as ranks
from esvo_tpu.backend import bundle_adjustment as jba
from esvo_tpu.backend import pose_graph as jpg
from esvo_tpu.geometry.camera import make_ideal_rig
from esvo_tpu.mapping import block_matching as jbm
from esvo_tpu.mapping import depth_refinement as jdr
from esvo_tpu.parallel import sharding as jps
from esvo_tpu.surface import time_surface as jtsf
from esvo_tpu.tracking import registration as jreg
from esvo_tpu_torch.parallel import sharding as ps
from tests.test_backend import synthetic_problem
from tests.test_pose_graph import noisy_circle_graph

WORLD = 4
W, H = 64, 48
N_PAD = 8     # test_parallel.py pads to its 8 devices: a multiple of 4


def _pad_obs(prob):
    pad = (-prob.obs_kf.shape[0]) % N_PAD
    return prob.replace(
        obs_kf=jnp.pad(prob.obs_kf, (0, pad)),
        obs_point=jnp.pad(prob.obs_point, (0, pad)),
        obs_uv=jnp.pad(prob.obs_uv, ((0, pad), (0, 0))),
        obs_valid=jnp.pad(prob.obs_valid, (0, pad)))


def _ba_arrays(prob) -> dict:
    return dict(T_kf=np.asarray(prob.T_world_kf),
                points=np.asarray(prob.points),
                obs_kf=np.asarray(prob.obs_kf),
                obs_point=np.asarray(prob.obs_point),
                obs_uv=np.asarray(prob.obs_uv),
                obs_valid=np.asarray(prob.obs_valid),
                fx=np.asarray(prob.fx), fy=np.asarray(prob.fy),
                cx=np.asarray(prob.cx), cy=np.asarray(prob.cy))


def make_worlds():
    """tests/test_parallel.py's inputs (same seeds and sizes), as numpy,
    plus the JAX objects they came from."""
    worlds, jax_in = {}, {}
    rng = np.random.default_rng(0)
    n = 64 * 8
    worlds["surface"] = dict(
        W=W, H=H, x=rng.integers(0, W, n), y=rng.integers(0, H, n),
        t=np.sort(rng.uniform(0, 0.01, n)).astype(np.float32),
        p=rng.random(n) > 0.5)

    rng = np.random.default_rng(1)
    n = 32 * 8
    base = rng.uniform(0, 255, size=(H, W + 16)).astype(np.float32)
    worlds["map"] = dict(
        W=W, H=H, ts_l=base[:, 8:8 + W].copy(), ts_r=base[:, 12:12 + W].copy(),
        x_rect=np.stack([rng.uniform(10, W - 10, n),
                         rng.uniform(10, H - 10, n)], 1).astype(np.float32),
        t=np.sort(rng.uniform(0, 0.01, n)).astype(np.float32),
        valid=np.ones(n, bool),
        T=np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy())

    rng = np.random.default_rng(2)
    m = 16 * 8
    img = (0.7 * np.arange(W)[None, :] - 0.3 * np.arange(H)[:, None]
           + 100.0).astype(np.float32)
    worlds["tracking"] = dict(
        W=W, H=H, img=img,
        pts=np.stack([rng.uniform(-0.2, 0.2, m), rng.uniform(-0.15, 0.15, m),
                      rng.uniform(0.8, 1.5, m)], 1).astype(np.float32))

    rng = np.random.default_rng(5)
    jax_in["ba_blocks"] = _pad_obs(synthetic_problem(rng, K=4, P=64)[0])
    worlds["ba_blocks"] = _ba_arrays(jax_in["ba_blocks"])
    rng = np.random.default_rng(6)
    jax_in["ba"] = _pad_obs(synthetic_problem(rng, K=4, P=64)[0])
    worlds["ba"] = _ba_arrays(jax_in["ba"])

    rng = np.random.default_rng(12)
    graph, gt, _ = noisy_circle_graph(rng, K=24, loop_slots=1)
    E = graph.edge_i.shape[0]
    pad = (-E) % N_PAD
    z4 = jnp.broadcast_to(jnp.eye(4, dtype=graph.T_ij.dtype), (pad, 4, 4))
    graph = graph.replace(
        edge_i=jnp.pad(graph.edge_i, (0, pad)),
        edge_j=jnp.pad(graph.edge_j, (0, pad)),
        T_ij=jnp.concatenate([graph.T_ij, z4]),
        w_rot=jnp.pad(graph.w_rot, (0, pad)),
        w_trans=jnp.pad(graph.w_trans, (0, pad)),
        edge_valid=jnp.pad(graph.edge_valid, (0, pad)))
    rel = np.linalg.inv(gt[-1]) @ gt[0]
    graph = jpg.add_edge(graph, E - 1, graph.T_world.shape[0] - 1, 0, rel,
                         w_rot=400.0, w_trans=400.0)
    jax_in["pose_graph"] = graph
    worlds["pose_graph"] = {k: np.asarray(getattr(graph, k)) for k in (
        "T_world", "edge_i", "edge_j", "T_ij", "w_rot", "w_trans",
        "edge_valid")}
    return worlds, jax_in


@pytest.fixture(scope="module")
def worlds():
    return make_worlds()


@pytest.fixture(scope="module")
def rank_results(worlds):
    """Every case on 4 gloo ranks, in one spawn: a list of 4 dicts."""
    return ps.spawn_ranks(ranks.sharded, WORLD, worlds[0], device="cpu")


@pytest.fixture(scope="module")
def port(rank_results):
    return rank_results[0]


@pytest.fixture(scope="module")
def port_serial(worlds):
    return ranks.serial(worlds[0])


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= WORLD
    return jps.make_mesh(WORLD)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(x):
    """The tensors of one case's output, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _flat(item)]
    return [t for v in vars(x).values() for t in _flat(v)]


CASES = ("surface", "map_auto", "map_xla", "tracking", "ba_blocks", "ba",
         "pose_graph")


@pytest.mark.parametrize("case", CASES)
def test_replicated_outputs_equal_across_ranks(rank_results, case):
    first = _flat(rank_results[0][case])
    for r in range(1, WORLD):
        for a, b in zip(first, _flat(rank_results[r][case])):
            torch.testing.assert_close(b, a, rtol=0, atol=0,
                                       equal_nan=True)


def test_surface_update(worlds, port, port_serial, jax_mesh):
    w = worlds[0]["surface"]
    for got, want in zip(port["surface"], port_serial["surface"]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    ev = jtsf.EventBatch.from_arrays(w["x"], w["y"], w["t"], w["p"])
    jst = jps.sharded_surface_update(jax_mesh,
                                     jtsf.init_state(H, W), ev)
    np.testing.assert_array_equal(_np(port["surface"][0]),
                                  np.asarray(jst.last_t_pos))
    np.testing.assert_array_equal(_np(port["surface"][1]),
                                  np.asarray(jst.last_t_neg))


@pytest.mark.parametrize("kernel", ranks.LM_KERNELS)
def test_map_estimate_matches_serial(port, port_serial, kernel):
    got, want = port[f"map_{kernel}"], port_serial[f"map_{kernel}"]
    assert want.valid.sum() > 0.3 * want.valid.numel()
    torch.testing.assert_close(got.valid, want.valid, rtol=0, atol=0)
    np.testing.assert_allclose(_np(got.inv_depth), _np(want.inv_depth),
                               rtol=1e-5, atol=1e-7)


def test_map_estimate_matches_jax(worlds, port, jax_mesh):
    w = worlds[0]["map"]
    r = make_ideal_rig(W, H, 50.0, 50.0, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                       dtype=jnp.float32)
    fn = jps.sharded_map_estimate(
        jax_mesh, r, jbm.BlockMatchConfig(**ranks.BM_CFG),
        jdr.DepthProblemConfig(lm_kernel="xla", **ranks.DP_CFG))
    T = jnp.asarray(w["T"])
    est = fn(jnp.asarray(w["ts_l"]), jnp.asarray(w["ts_r"]),
             jnp.asarray(w["x_rect"]), jnp.asarray(w["t"]),
             jnp.asarray(w["valid"]), T, T)
    got = port["map_xla"]
    va, vb = np.asarray(est.valid), _np(got.valid)
    assert va.sum() > 0.3 * va.size
    assert (va == vb).mean() >= 0.99
    both = va & vb
    close = np.isclose(_np(got.inv_depth)[both],
                       np.asarray(est.inv_depth)[both], rtol=2e-4, atol=0)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} apart"


def test_tracking_step(worlds, port, port_serial, jax_mesh):
    (dx, cost), (dx_s, cost_s) = port["tracking"], port_serial["tracking"]
    np.testing.assert_allclose(float(cost), float(cost_s), rtol=1e-5)
    np.testing.assert_allclose(_np(dx), _np(dx_s), rtol=0.1, atol=1e-3)
    w = worlds[0]["tracking"]
    r = make_ideal_rig(W, H, 50.0, 50.0, W / 2 - 0.5, H / 2 - 0.5, 0.1,
                       dtype=jnp.float32)
    neg, gu, gv = jreg.negative_time_surface(jnp.asarray(w["img"]), 0)
    pts = jnp.asarray(w["pts"])
    fn = jps.sharded_tracking_step(jax_mesh, r.left,
                                   jreg.RegProblemConfig(**ranks.REG_CFG))
    jdx, jcost = fn(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
                    jnp.eye(4, dtype=jnp.float32), neg, gu, gv, pts,
                    jnp.ones(pts.shape[0], bool))
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), rtol=0.1, atol=1e-3)


def test_ba_normal_equations(worlds, port, port_serial, jax_mesh):
    for got, want in zip(port["ba_blocks"], port_serial["ba_blocks"]):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-8)
    p = worlds[1]["ba_blocks"]
    jout = jps.sharded_ba_normal_equations(jax_mesh, jba.BAConfig())(
        p.T_world_kf, p.points, p.obs_kf, p.obs_point, p.obs_uv,
        p.obs_valid, p.fx, p.fy, p.cx, p.cy)
    for got, want in zip(port["ba_blocks"], jout):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-8)


def _assert_ba(got, want_T, want_pts, want_costs):
    T, pts, costs = got
    np.testing.assert_allclose(_np(costs), _np(want_costs), rtol=1e-5)
    np.testing.assert_allclose(_np(T), _np(want_T), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(pts), _np(want_pts), rtol=1e-4,
                               atol=1e-5)


def test_bundle_adjust(worlds, port, port_serial, jax_mesh):
    _assert_ba(port["ba"], *port_serial["ba"])
    jprob, jcosts = jps.sharded_bundle_adjust(
        jax_mesh, jba.BAConfig(max_iterations=ranks.BA_ITERS))(
            worlds[1]["ba"])
    _assert_ba(port["ba"], jprob.T_world_kf, jprob.points, jcosts)
    costs = _np(port["ba"][2])
    assert costs[-1] < 0.5 * costs[0]


def test_pose_graph(worlds, port, port_serial, jax_mesh):
    (T, costs), (T_s, costs_s) = port["pose_graph"], port_serial["pose_graph"]
    np.testing.assert_allclose(_np(costs), _np(costs_s), rtol=1e-5)
    np.testing.assert_allclose(_np(T), _np(T_s), rtol=1e-4, atol=1e-6)
    jgraph, jcosts = jps.sharded_pose_graph(
        jax_mesh, jpg.PoseGraphConfig(max_iterations=ranks.PG_ITERS))(
            worlds[1]["pose_graph"])
    np.testing.assert_allclose(_np(costs), np.asarray(jcosts), rtol=1e-5)
    np.testing.assert_allclose(_np(T), np.asarray(jgraph.T_world),
                               rtol=1e-4, atol=1e-6)


def test_mesh_needs_a_group_and_a_mesh():
    with pytest.raises(RuntimeError, match="process group"):
        ps.make_mesh(2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ps.sharded_pose_graph(object(), None)


def test_launcher_checks_backend_and_cards():
    with pytest.raises(ValueError, match="gloo"):
        ps.spawn_ranks(ranks.sharded, 2, {}, device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ps.spawn_ranks(ranks.sharded, 2, {}, device="cuda")
