"""SE(3) pose-graph optimization (port of esvo_tpu/backend/pose_graph.py).

Given keyframe poses and relative-pose measurements (the odometry chain
and loop-closure edges from backend.loop_closure), minimize

    sum_e  || log( T_e^-1 · T_i^-1 · T_j ) ||^2_{W_e}

over the absolute poses {T_k}:

- every edge's 6-vector residual and its (6, 12) Jacobian w.r.t. the two
  incident local twists in one batched ``torch.func.jacfwd`` under
  ``torch.func.vmap`` (JAX's ``vmap(jacfwd)``);
- the (6K, 6K) normal equations assembled with one flat scatter-add of
  the per-edge 12x12 outer products (int64 flat indices);
- Levenberg-Marquardt with fixed trips and accept / reject damping, no
  host sync inside the loop.

With a process group (``group=``) the edge axis is sharded over its
ranks (parallel/sharding.py): H, g and every cost sum are all-reduced,
JAX's psum sites; the poses stay replicated.

Pose increments are left-multiplicative twists T_k <- exp(xi_k) T_k.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from esvo_tpu_torch.geometry.se3 import (
    orthonormalize_rotation_fast, se3_exp, se3_inverse, se3_log)
from esvo_tpu_torch.ops.linalg import psum, segment_sum, solve_or_nan
from esvo_tpu_torch.utils.precision import highest_precision


@dataclass(frozen=True)
class PoseGraphConfig:
    max_iterations: int = 20
    damping: float = 1e-6
    # gauge fixing: keep the first `num_fixed_poses` poses constant
    num_fixed_poses: int = 1
    # Huber threshold on the weighted residual norm (robustifies against
    # a false loop closure); inf = plain least squares
    huber_threshold: float = math.inf


@dataclass
class PoseGraph:
    """K poses, E edges (fixed capacity, masked by edge_valid)."""
    T_world: torch.Tensor      # (K, 4, 4) absolute poses
    edge_i: torch.Tensor       # (E,) int64 source pose index
    edge_j: torch.Tensor       # (E,) int64 target pose index
    T_ij: torch.Tensor         # (E, 4, 4) measured T_i^-1 T_j
    w_rot: torch.Tensor        # (E,) rotation information weight
    w_trans: torch.Tensor      # (E,) translation information weight
    edge_valid: torch.Tensor   # (E,) bool

    def replace(self, **kw) -> "PoseGraph":
        return replace(self, **kw)


def _edge_residual(xi2, T_i, T_j, T_ij_inv, sqw):
    """Weighted 6-residual of one edge at local twists xi2 = (xi_i, xi_j):
    r = sqrt(W) * log( T_ij^-1 · (exp(xi_i) T_i)^-1 · exp(xi_j) T_j ).
    Broadcasts over leading dimensions."""
    Ti = torch.matmul(se3_exp(xi2[..., :6]), T_i)
    Tj = torch.matmul(se3_exp(xi2[..., 6:]), T_j)
    return sqw * se3_log(torch.matmul(torch.matmul(T_ij_inv, se3_inverse(Ti)),
                                      Tj))


def _edge_residual_1(xi2, T_i, T_j, T_ij_inv, sqw):
    """_edge_residual of one edge with a unit leading dimension inside:
    under torch.func a Python float meeting a 0-d float32 tensor promotes
    to float64, and se3's Taylor coefficients are per-edge scalars."""
    return _edge_residual(xi2[None], T_i[None], T_j[None], T_ij_inv[None],
                          sqw[None])[0]


def _edge_sqw(graph: PoseGraph) -> torch.Tensor:
    """(E, 6) per-component sqrt information weights, zero for invalid
    edges (the one source of residual weighting for both costs of the
    accept test)."""
    sqw = torch.stack([graph.w_rot] * 3 + [graph.w_trans] * 3, dim=-1)
    return torch.sqrt(torch.where(graph.edge_valid[:, None], sqw, 0.0))


@highest_precision()
def edge_residuals_and_jacobians(graph: PoseGraph):
    """(E, 6) weighted residuals + (E, 6, 12) Jacobians w.r.t. the two
    incident twists, evaluated at xi = 0 (batched jacfwd)."""
    T_ij_inv = se3_inverse(graph.T_ij)
    sqw = _edge_sqw(graph)
    T_i = graph.T_world[graph.edge_i]
    T_j = graph.T_world[graph.edge_j]
    zero = torch.zeros((graph.edge_i.shape[0], 12),
                       dtype=graph.T_world.dtype, device=graph.T_world.device)
    r = _edge_residual(zero, T_i, T_j, T_ij_inv, sqw)
    J = torch.func.vmap(torch.func.jacfwd(_edge_residual_1))(
        zero, T_i, T_j, T_ij_inv, sqw)
    return r, J


def _robust_weights_and_cost(r: torch.Tensor, graph: PoseGraph,
                             cfg: PoseGraphConfig, group=None):
    """Huber IRLS weights on the weighted residual norm + total cost
    (summed over the ranks of `group`)."""
    rn = torch.linalg.vector_norm(r, dim=1)
    w = torch.where(rn > cfg.huber_threshold,
                    cfg.huber_threshold / torch.clamp(rn, min=1e-12), 1.0)
    w = torch.where(graph.edge_valid, w, 0.0)
    return w, psum(torch.sum(w * rn * rn), group)


@highest_precision()
def _normal_equations(graph: PoseGraph, cfg: PoseGraphConfig, group=None):
    """Dense (6K, 6K) H, (6K,) g and the robust cost, assembled with one
    flat scatter-add over edges (all-reduced over `group`)."""
    K = graph.T_world.shape[0]
    dev = graph.T_world.device
    r, J = edge_residuals_and_jacobians(graph)
    w, cost = _robust_weights_and_cost(r, graph, cfg, group)

    wJ = J * w[:, None, None]
    JtJ = torch.einsum("eri,erj->eij", wJ, J)      # (E, 12, 12)
    Jtr = torch.einsum("eri,er->ei", wJ, r)        # (E, 12)

    # flat scatter: block rows/cols of edge e are (6i..6i+5, 6j..6j+5)
    six = torch.arange(6, device=dev)[None, :]
    base = torch.cat([graph.edge_i[:, None] * 6 + six,
                      graph.edge_j[:, None] * 6 + six], dim=1)   # int64
    n6 = 6 * K
    flat_idx = base[:, :, None] * n6 + base[:, None, :]   # (E, 12, 12)
    H = psum(segment_sum(JtJ.reshape(-1), flat_idx.reshape(-1), n6 * n6),
             group).reshape(n6, n6)
    g = psum(segment_sum(Jtr.reshape(-1), base.reshape(-1), n6), group)
    return H, g, cost


@highest_precision()
def _cost_only(graph: PoseGraph, cfg: PoseGraphConfig,
               group=None) -> torch.Tensor:
    T_i = graph.T_world[graph.edge_i]
    T_j = graph.T_world[graph.edge_j]
    r = _edge_sqw(graph) * se3_log(
        torch.matmul(se3_inverse(graph.T_ij),
                     torch.matmul(se3_inverse(T_i), T_j)))
    _, cost = _robust_weights_and_cost(r, graph, cfg, group)
    return cost


@highest_precision()
def _apply(graph: PoseGraph, dx: torch.Tensor,
           cfg: PoseGraphConfig) -> PoseGraph:
    K = graph.T_world.shape[0]
    fixed = torch.arange(K, device=dx.device) < cfg.num_fixed_poses
    T_new = torch.matmul(se3_exp(dx.reshape(K, 6)), graph.T_world)
    # the product of two near-exact rotations drifts only by rounding:
    # two Newton-Schulz steps re-project it
    R = orthonormalize_rotation_fast(T_new[:, :3, :3])
    T_new = torch.cat([torch.cat([R, T_new[:, :3, 3:]], dim=2),
                       T_new[:, 3:]], dim=1)
    T_new = torch.where(fixed[:, None, None], graph.T_world, T_new)
    return graph.replace(T_world=T_new)


@highest_precision()
def optimize_pose_graph(graph: PoseGraph,
                        cfg: PoseGraphConfig = PoseGraphConfig(),
                        group=None):
    """LM-damped Gauss-Newton over the pose graph. Returns (graph, cost
    history (iters + 1,)): the cost entering each trip, then the cost of
    the returned graph.

    `group`: a process group over which the edge axis is sharded (each
    rank passes its block of edges; H, g and the costs are all-reduced,
    the poses stay replicated)."""
    K = graph.T_world.shape[0]
    dt, dev = graph.T_world.dtype, graph.T_world.device
    fixed_rows = (torch.arange(6 * K, device=dev) // 6) < cfg.num_fixed_poses
    lam = torch.tensor(cfg.damping, dtype=dt, device=dev)
    eye = torch.eye(6 * K, dtype=dt, device=dev)
    costs = []
    for _ in range(cfg.max_iterations):
        H, g, cost = _normal_equations(graph, cfg, group)
        # LM damping + gauge prior on the fixed poses
        H = H + lam * torch.diag(torch.diag(H)) + 1e-10 * eye
        H = torch.where(fixed_rows[:, None] | fixed_rows[None, :], 0.0, H)
        H = H + torch.diag(fixed_rows.to(dt))
        g = torch.where(fixed_rows, 0.0, g)
        dx = -solve_or_nan(H, g)
        trial = _apply(graph, dx, cfg)
        accept = _cost_only(trial, cfg, group) < cost
        graph = graph.replace(T_world=torch.where(accept, trial.T_world,
                                                  graph.T_world))
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-12, 1e3)
        costs.append(cost)
    costs.append(_cost_only(graph, cfg, group))
    return graph, torch.stack(costs)


def odometry_graph(T_world: torch.Tensor, w_rot: float = 100.0,
                   w_trans: float = 100.0,
                   extra_capacity: int = 0) -> PoseGraph:
    """A chain pose graph from a trajectory: edge (k, k+1) measures the
    current relative pose. `extra_capacity` reserves masked edge slots
    for loop closures."""
    K = T_world.shape[0]
    dev = T_world.device
    Ec = K - 1 + extra_capacity
    zeros = torch.zeros(extra_capacity, dtype=torch.int64, device=dev)
    ei = torch.cat([torch.arange(K - 1, device=dev), zeros])
    ej = torch.cat([torch.arange(1, K, device=dev), zeros])
    T_ij = torch.matmul(se3_inverse(T_world[ei]), T_world[ej])
    return PoseGraph(
        T_world=T_world, edge_i=ei, edge_j=ej, T_ij=T_ij,
        w_rot=torch.full((Ec,), w_rot, dtype=T_world.dtype, device=dev),
        w_trans=torch.full((Ec,), w_trans, dtype=T_world.dtype, device=dev),
        edge_valid=torch.cat([
            torch.ones(K - 1, dtype=torch.bool, device=dev),
            torch.zeros(extra_capacity, dtype=torch.bool, device=dev)]))


def add_edge(graph: PoseGraph, slot: int, i: int, j: int, T_ij,
             w_rot: float, w_trans: float) -> PoseGraph:
    """Fill a reserved edge slot (returns a new graph; the input is not
    modified)."""
    g = graph.replace(**{k: getattr(graph, k).clone() for k in (
        "edge_i", "edge_j", "T_ij", "w_rot", "w_trans", "edge_valid")})
    g.edge_i[slot] = i
    g.edge_j[slot] = j
    g.T_ij[slot] = torch.as_tensor(T_ij, dtype=g.T_ij.dtype,
                                   device=g.T_ij.device)
    g.w_rot[slot] = w_rot
    g.w_trans[slot] = w_trans
    g.edge_valid[slot] = True
    return g
