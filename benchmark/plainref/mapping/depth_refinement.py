"""Frozen copy of esvo_tpu_torch/mapping/depth_refinement.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Per-event inverse-depth refinement — batched 1-DoF Levenberg-Marquardt
(port of esvo_tpu/mapping/depth_refinement.py).

Each event gets one (patch + 2*margin) window per surface, cut at its
initial warp positions (kernel K1 on the card). Two LM paths run on those
windows, dispatched as the JAX package dispatches them:

- float32 Tdist / l2 with ``lm_kernel`` "auto" or "pallas": the fused
  solve, kernel K2 on the card and its plain twin on the CPU;
- ``lm_kernel="xla"``, the ``zncc`` norm or any other dtype: the JAX
  package's masked LM scan in plain PyTorch, each trial's residuals and
  their depth derivative from one ``torch.func.jvp``.

Where the window does not fit the image (or ``window_margin < 0``) the
scan samples every patch from the full surfaces instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace

import torch

from plainref.geometry.camera import StereoRig, cam_to_world, inv3
from plainref.geometry.se3 import rows_apply, rows_from_matrices
from plainref.ops.interp import slice_patches, slice_patches_pair
from plainref.ops.lm import lm_solve, tdist_weights

LS_NORMS = ("l2", "zncc", "Tdist")
LM_KERNELS = ("auto", "pallas", "xla")


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
    # < 0 samples every LM patch from the full surfaces (no windows)
    window_margin: int = 8
    # "auto" / "pallas": kernel K2 (its twin on the CPU) for float32
    # Tdist / l2, the scan otherwise; "xla": always the scan
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


def _window_shape(cfg: DepthProblemConfig) -> tuple[int, int]:
    mg = cfg.window_margin
    return (cfg.patch_size_y + 1 + 2 * mg, cfg.patch_size_x + 1 + 2 * mg)


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
    Wy, Wx = _window_shape(cfg)
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
    matching; valid (N,); ts_left/ts_right (H, W) surfaces. Kernel K2
    (or its twin) starts from max(d_init, 1e-6), as the TPU kernel does;
    the scan starts from d_init, as the JAX package's scan does."""
    del t_event
    if cfg.ls_norm not in LS_NORMS:
        raise ValueError(f"unsupported LSnorm: {cfg.ls_norm}")
    if cfg.lm_kernel not in LM_KERNELS:
        raise ValueError(f"unknown lm_kernel {cfg.lm_kernel!r} (expected "
                         f"one of {LM_KERNELS})")
    H, W = ts_left.shape
    Wy, Wx = _window_shape(cfg)
    if cfg.window_margin >= 0 and H >= Wy and W >= Wx:
        args, kwargs = window_problem(matches_x, T_left_virtual, d_init,
                                      ts_left, ts_right, rig, cfg)
        if (cfg.lm_kernel != "xla" and cfg.ls_norm in ("Tdist", "l2")
                and ts_left.dtype == torch.float32):
            d, cost, jtj = lm_solve(*args, **kwargs)
        else:
            d, cost, jtj = _lm_scan(
                args[5], *_window_sampler(*args, H, W, cfg), cfg)
    else:
        d, cost, jtj = _lm_scan(
            d_init.to(ts_left.dtype),
            *_direct_sampler(matches_x, T_left_virtual, ts_left, ts_right,
                             rig, cfg), cfg)
    return _finalize(d, cost, jtj, matches_x, T_world_virtual, valid,
                     rig.left.params.P, cfg)


# ---------------------------------------------------------------------------
# the LM scan (the JAX package's XLA path: zncc, lm_kernel="xla", float64,
# and the unwindowed fallback)
# ---------------------------------------------------------------------------

def _apply_norm(tau1, tau2, ok, cfg: DepthProblemConfig):
    """fvec (N, P) from the two sampled patches (N, wy, wx) under
    cfg.ls_norm, with the out-of-bounds sentinel residual 255
    (DepthProblem.cpp:44-59, 126-158)."""
    P = cfg.patch_area
    n = tau1.shape[0]
    r_raw = (tau1 - tau2).reshape(n, P)
    okx = ok[:, None]
    r = torch.where(okx, r_raw, 255.0)
    if cfg.ls_norm == "l2":
        return r
    if cfg.ls_norm == "zncc":
        mu1 = tau1.mean(dim=(-2, -1), keepdim=True)
        mu2 = tau2.mean(dim=(-2, -1), keepdim=True)
        s1 = torch.sqrt(((tau1 - mu1) ** 2).mean(dim=(-2, -1),
                                                 keepdim=True)) + 1e-6
        s2 = torch.sqrt(((tau2 - mu2) ** 2).mean(dim=(-2, -1),
                                                 keepdim=True)) + 1e-6
        z = ((tau1 - mu1) / s1 - (tau2 - mu2) / s2).reshape(n, P) \
            / math.sqrt(P)
        return torch.where(okx, z, 2.0 / math.sqrt(P))
    nu = cfg.td_nu
    w_oob = (nu + 1.0) / (nu + (255.0 / cfg.td_scale) ** 2)
    # detached: the LM differentiates sqrt(w) * r with the weights frozen,
    # as JAX's stop_gradient does
    w_valid = tdist_weights(r_raw.detach(), nu, cfg.td_scale_squared,
                            cfg.td_fixed_point_iters)
    return torch.sqrt(torch.where(okx, w_valid, w_oob)) * r


def _blend(src, u, v, wy: int, wx: int):
    """The bilinear (wy, wx) patch at fractions (u - floor u, v - floor v)
    of each event's integer-aligned (wy+1, wx+1) source block."""
    fx = (u - torch.floor(u))[:, None, None]
    fy = (v - torch.floor(v))[:, None, None]
    r = (1.0 - fx) * src[:, :, :wx] + fx * src[:, :, 1:]
    return (1.0 - fy) * r[:, :wy] + fy * r[:, 1:]


def _warp_in_bounds(u1, v1, u2, v2, W: int, H: int,
                    cfg: DepthProblemConfig):
    """Both warped centres leave room for the patch."""
    bx = (cfg.patch_size_x - 1) // 2
    by = (cfg.patch_size_y - 1) // 2
    return ((u1 >= bx) & (u1 <= W - bx) & (v1 >= by) & (v1 <= H - by)
            & (u2 >= bx) & (u2 <= W - bx) & (v2 >= by) & (v2 <= H - by))


def _window_sampler(P_left, P_right, Ainv, u_ev, v_ev, d_init, oy1, ox1,
                    oy2, ox2, rows_lv, win1, win2, H: int, W: int,
                    cfg: DepthProblemConfig):
    """(warp, sources) of the windowed scan: the warp in the pose-rows
    layout, and each event's source blocks gathered from its windows
    (JAX's ``_window_patch``; a source block past the window is out of
    bounds). sources(u1, v1, u2, v2) -> (src1, src2, ok)."""
    wy, wx = cfg.patch_size_y, cfg.patch_size_x
    N, Wy, Wx = win1.shape
    dev = win1.device
    jy = torch.arange(wy + 1, device=dev)[None, :, None]
    jx = torch.arange(wx + 1, device=dev)[None, None, :]
    n = torch.arange(N, device=dev)[:, None, None]

    def warp(d):
        return _warp_positions_rows(d, u_ev, v_ev, rows_lv, P_left,
                                    P_right, Ainv)

    def source(win, oy, ox, u, v):
        ry = torch.floor(v).long() - (wy - 1) // 2 - oy.long()
        rx = torch.floor(u).long() - (wx - 1) // 2 - ox.long()
        ok = (ry >= 0) & (rx >= 0) & (ry + wy + 1 <= Wy) \
            & (rx + wx + 1 <= Wx)
        ry = torch.clamp(ry, 0, Wy - wy - 1)[:, None, None]
        rx = torch.clamp(rx, 0, Wx - wx - 1)[:, None, None]
        return win[n, ry + jy, rx + jx], ok

    def sources(u1, v1, u2, v2):
        src1, ok1 = source(win1, oy1, ox1, u1, v1)
        src2, ok2 = source(win2, oy2, ox2, u2, v2)
        return src1, src2, (_warp_in_bounds(u1, v1, u2, v2, W, H, cfg)
                            & ok1 & ok2)

    return warp, sources


def _direct_sampler(matches_x, T_left_virtual, ts_left, ts_right,
                    rig: StereoRig, cfg: DepthProblemConfig):
    """(warp, sources) of the unwindowed scan: the warp through the
    per-event matrices, and each event's source blocks cut from the full
    surfaces (kernel K1 on the card where it takes the block) with the
    reference's patchInterpolation bounds."""
    wy, wx = cfg.patch_size_y, cfg.patch_size_x
    H, W = ts_left.shape
    P_left, P_right = rig.left.params.P, rig.right.params.P
    R = T_left_virtual[:, :3, :3]
    t = T_left_virtual[:, :3, 3]

    def warp(d):
        p_rv = cam_to_world(P_left, matches_x.to(d.dtype), d)
        p_left = torch.einsum("nij,nj->ni", R, p_rv) + t
        x1 = torch.einsum("ij,nj->ni", P_left[:, :3], p_left) + P_left[:, 3]
        x2 = torch.einsum("ij,nj->ni", P_right[:, :3], p_left) \
            + P_right[:, 3]
        return (x1[:, 0] / x1[:, 2], x1[:, 1] / x1[:, 2],
                x2[:, 0] / x2[:, 2], x2[:, 1] / x2[:, 2])

    def source(img, u, v):
        ul_x = torch.floor(u).to(torch.int32) - (wx - 1) // 2
        ul_y = torch.floor(v).to(torch.int32) - (wy - 1) // 2
        ok = (ul_x >= 0) & (ul_y >= 0) & (ul_x + wx < W) & (ul_y + wy < H)
        return slice_patches(img, ul_y, ul_x, wy + 1, wx + 1), ok

    def sources(u1, v1, u2, v2):
        src1, ok1 = source(ts_left, u1, v1)
        src2, ok2 = source(ts_right, u2, v2)
        return src1, src2, (_warp_in_bounds(u1, v1, u2, v2, W, H, cfg)
                            & ok1 & ok2)

    return warp, sources


def _lm_scan(d_init, warp, sources, cfg: DepthProblemConfig):
    """The JAX package's masked LM scan (cfg.max_iteration damped steps
    with per-event accept / reject and the two-strike freeze). Returns
    (d, cost, jtj), each (N,).

    Each evaluation cuts the events' source blocks at the primal warp
    positions, outside the differentiated function: their integer
    starts carry no tangent (as under jax.jvp), so the derivative flows
    through the bilinear fractions alone, and a kernel never sees a
    forward-mode tensor."""
    wy, wx = cfg.patch_size_y, cfg.patch_size_x

    def evaluate(d):
        src1, src2, ok = sources(*warp(d))

        def fvec(dd):
            u1, v1, u2, v2 = warp(dd)
            return _apply_norm(_blend(src1, u1, v1, wy, wx),
                               _blend(src2, u2, v2, wy, wx), ok, cfg)

        f, jac = torch.func.jvp(fvec, (d,), (torch.ones_like(d),))
        return f, jac, (f * f).sum(-1)

    d = d_init
    lam = torch.full_like(d, 1e-3)
    strikes = torch.zeros_like(d, dtype=torch.int32)
    f, jac, cost = evaluate(d)
    for _ in range(cfg.max_iteration):
        g = (jac * f).sum(-1)
        h = (jac * jac).sum(-1)
        delta = -g / (h * (1.0 + lam) + 1e-12)
        d_try = d + delta
        f_try, jac_try, cost_try = evaluate(d_try)
        accept = cost_try < cost
        frozen = strikes >= 2
        do = accept & ~frozen
        small = (torch.abs(cost - cost_try) <= 1e-6 * cost) \
            | (torch.abs(delta) <= 1e-6 * (torch.abs(d) + 1e-6))
        strikes = torch.where(frozen, strikes,
                              torch.where(small, strikes + 1, 0))
        d = torch.where(do, d_try, d)
        f = torch.where(do[:, None], f_try, f)
        jac = torch.where(do[:, None], jac_try, jac)
        cost = torch.where(do, cost_try, cost)
        lam = torch.where(frozen, lam,
                          torch.where(accept, lam * 0.3, lam * 4.0))
        lam = torch.clamp(lam, 1e-9, 1e9)
    return d, cost, (jac * jac).sum(-1)


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
