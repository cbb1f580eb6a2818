"""Per-event inverse-depth refinement — batched 1-DoF Levenberg-Marquardt
(port of esvo_tpu/mapping/depth_refinement.py, its windowed path).

Each event gets one (patch + 2*margin) window per surface, cut at its
initial warp positions (kernel K1 on the card); the whole LM solve then
runs on those windows (kernel K2 on the card, its plain twin on the CPU).
The JAX package's unwindowed fallback and its ``zncc`` norm are not
ported: no preset uses them, and they raise NotImplementedError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace

import torch

from esvo_tpu_torch.geometry.camera import StereoRig, cam_to_world, inv3
from esvo_tpu_torch.geometry.se3 import rows_apply, rows_from_matrices
from esvo_tpu_torch.ops.interp import slice_patches_pair
from esvo_tpu_torch.ops.lm import lm_solve


@dataclass(frozen=True)
class DepthProblemConfig:
    """Defaults from the reference's cfg/mapping/mapping_rpg.yaml."""
    patch_size_x: int = 15
    patch_size_y: int = 7
    ls_norm: str = "Tdist"
    td_nu: float = 2.1897
    td_scale: float = 16.6397
    max_iteration: int = 10
    regularization_radius: int = 5
    regularization_min_neighbours: int = 8
    regularization_min_close_neighbours: int = 8
    td_fixed_point_iters: int = 10
    window_margin: int = 8
    # kept for field parity with the JAX config; the port has one LM
    # path (kernel K2 on CUDA tensors, its twin on CPU tensors)
    lm_kernel: str = "auto"

    @property
    def td_scale_squared(self) -> float:
        return self.td_scale * self.td_scale

    @property
    def td_stdvar(self) -> float:
        return math.sqrt(self.td_nu / (self.td_nu - 2.0)) * self.td_scale

    @property
    def patch_area(self) -> int:
        return self.patch_size_x * self.patch_size_y


@dataclass
class DepthEstimates:
    """Batched DepthPoint fields (leading axes: (N,) or (F, N))."""
    x: torch.Tensor            # (N, 2) sub-pixel rectified left coordinate
    inv_depth: torch.Tensor    # (N,)
    variance: torch.Tensor     # (N,)
    scale2: torch.Tensor       # (N,) Student-t scale^2
    nu: torch.Tensor           # (N,)
    residual: torch.Tensor     # (N,) |r|^2 at the solution
    age: torch.Tensor          # (N,) int32 fusion count
    p_cam: torch.Tensor        # (N, 3) point in its own (virtual) camera
    T_world_cam: torch.Tensor  # (N, 4, 4) pose of that camera
    valid: torch.Tensor        # (N,) bool

    def replace(self, **kw) -> "DepthEstimates":
        return replace(self, **kw)

    def map(self, fn) -> "DepthEstimates":
        """Apply fn to every field (the pytree map of the JAX package)."""
        return DepthEstimates(**{f.name: fn(getattr(self, f.name))
                                 for f in fields(self)})


def _warp_positions_rows(d, u, v, rows_lv, P_left, P_right, Ainv):
    """Warp of each event into both surfaces at inverse depth d, in the
    SoA pose-rows layout. Returns (u1, v1, u2, v2), each (N,)."""
    z = 1.0 / d
    r0 = z * u - P_left[0, 3]
    r1 = z * v - P_left[1, 3]
    r2 = z - P_left[2, 3]
    px = Ainv[0, 0] * r0 + Ainv[0, 1] * r1 + Ainv[0, 2] * r2
    py = Ainv[1, 0] * r0 + Ainv[1, 1] * r1 + Ainv[1, 2] * r2
    pz = Ainv[2, 0] * r0 + Ainv[2, 1] * r1 + Ainv[2, 2] * r2
    qx, qy, qz = rows_apply(rows_lv, px, py, pz)

    def proj(P):
        hx = P[0, 0] * qx + P[0, 1] * qy + P[0, 2] * qz + P[0, 3]
        hy = P[1, 0] * qx + P[1, 1] * qy + P[1, 2] * qz + P[1, 3]
        hz = P[2, 0] * qx + P[2, 1] * qy + P[2, 2] * qz + P[2, 3]
        return hx / hz, hy / hz

    u1, v1 = proj(P_left)
    u2, v2 = proj(P_right)
    return u1, v1, u2, v2


def window_problem(matches_x, T_left_virtual, d_init, ts_left, ts_right,
                   rig: StereoRig, cfg: DepthProblemConfig):
    """The arguments of ops.lm.lm_solve for N events: one (patch +
    2*margin) window per surface per event, cut at the initial warp
    positions (kernel K1 on the card, both surfaces in one launch).
    Returns (args, kwargs)."""
    H, W = ts_left.shape
    P_left = rig.left.params.P
    P_right = rig.right.params.P
    wy, wx = cfg.patch_size_y, cfg.patch_size_x
    mg = cfg.window_margin
    Wy, Wx = wy + 1 + 2 * mg, wx + 1 + 2 * mg
    if cfg.ls_norm not in ("Tdist", "l2"):
        raise NotImplementedError(f"ls_norm {cfg.ls_norm!r} is not ported")
    if not (mg >= 0 and H >= Wy and W >= Wx):
        raise NotImplementedError(
            "the unwindowed depth solve (window_margin < 0 or an image "
            "smaller than the window) is not ported")
    rows_lv = rows_from_matrices(T_left_virtual).contiguous()   # (12, N)
    Ainv = inv3(P_left[:, :3])
    u_ev = matches_x[:, 0].contiguous()
    v_ev = matches_x[:, 1].contiguous()
    d_init = d_init.to(ts_left.dtype).contiguous()
    u1, v1, u2, v2 = _warp_positions_rows(d_init, u_ev, v_ev, rows_lv,
                                          P_left, P_right, Ainv)

    def origin(u, v):
        oy = torch.floor(v).to(torch.int32) - (wy - 1) // 2 - mg
        ox = torch.floor(u).to(torch.int32) - (wx - 1) // 2 - mg
        return (torch.clamp(oy, 0, H - Wy).contiguous(),
                torch.clamp(ox, 0, W - Wx).contiguous())

    oy1, ox1 = origin(u1, v1)
    oy2, ox2 = origin(u2, v2)
    win1, win2 = slice_patches_pair(ts_left, oy1, ox1, ts_right, oy2, ox2,
                                    Wy, Wx)
    args = (P_left, P_right, Ainv, u_ev, v_ev, d_init, oy1, ox1, oy2, ox2,
            rows_lv, win1, win2)
    kwargs = dict(wy=wy, wx=wx, Wy=Wy, Wx=Wx, H=H, W=W, ls_norm=cfg.ls_norm,
                  nu=float(cfg.td_nu),
                  scale2_init=float(cfg.td_scale_squared),
                  td_iters=cfg.td_fixed_point_iters,
                  max_iteration=cfg.max_iteration)
    return args, kwargs


def solve(matches_x, T_world_virtual, T_left_virtual, d_init, valid,
          t_event, ts_left, ts_right, rig: StereoRig,
          cfg: DepthProblemConfig) -> DepthEstimates:
    """Refine inverse depth for N events in parallel.

    matches_x (N, 2) rectified left coordinates; T_world_virtual and
    T_left_virtual (N, 4, 4); d_init (N,) inverse depth from block
    matching; valid (N,); ts_left/ts_right (H, W) surfaces. The LM
    starts from max(d_init, 1e-6), as the TPU kernel does."""
    del t_event
    args, kwargs = window_problem(matches_x, T_left_virtual, d_init,
                                  ts_left, ts_right, rig, cfg)
    d, cost, jtj = lm_solve(*args, **kwargs)
    return _finalize(d, cost, jtj, matches_x, T_world_virtual, valid,
                     rig.left.params.P, cfg)


def _finalize(d, cost, jtj, matches_x, T_world_virtual, valid, P_left,
              cfg: DepthProblemConfig) -> DepthEstimates:
    """Variance from the final Jacobian and the DepthPoint conversion."""
    m = cfg.patch_area
    inv_jtj = torch.where(jtj > 1e-20, 1.0 / torch.clamp(jtj, min=1e-20),
                          torch.full_like(jtj, 1e20))
    if cfg.ls_norm == "Tdist":
        variance = cfg.td_stdvar ** 2 * inv_jtj
    else:
        variance = cost / max(m - 1, 1) * inv_jtj
    variance = torch.clamp(variance, min=1e-6)
    ok = valid & (d > 0.001)
    p_cam = cam_to_world(P_left, matches_x, d)
    if cfg.ls_norm == "Tdist":
        scale2 = variance * (cfg.td_nu - 2.0) / cfg.td_nu
        nu = torch.full_like(d, cfg.td_nu)
    else:
        scale2 = variance
        nu = torch.full_like(d, math.inf)
    return DepthEstimates(
        x=matches_x, inv_depth=torch.where(ok, d, torch.full_like(d, -1.0)),
        variance=variance, scale2=scale2, nu=nu, residual=cost,
        age=torch.zeros(d.shape, dtype=torch.int32, device=d.device),
        p_cam=p_cam, T_world_cam=T_world_virtual, valid=ok)


def point_culling(est: DepthEstimates, std_variance_threshold: float,
                  cost_threshold: float, inv_depth_min: float,
                  inv_depth_max: float) -> DepthEstimates:
    """Masked DepthProblemSolver::pointCulling."""
    keep = (est.valid
            & (est.variance <= std_variance_threshold ** 2)
            & (est.residual <= cost_threshold)
            & (est.inv_depth >= inv_depth_min)
            & (est.inv_depth <= inv_depth_max))
    return est.replace(valid=keep)
