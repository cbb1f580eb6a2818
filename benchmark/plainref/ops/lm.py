"""Frozen copy of esvo_tpu_torch/ops/lm.py's plain twin of K2 (the
per-event inverse-depth LM solve), without the kernel: ``lm_solve`` is
the twin."""
from __future__ import annotations

import math

import torch


def _warp_coeffs(P_left, P_right, Ainv, u_ev, v_ev, rows):
    """Per-event coefficients of u(z) = (Au z + Bu)/(C z + D) in both
    cameras (pallas_lm.py:95-122)."""
    Ai = Ainv.reshape(-1)
    P0, P1, P2 = P_left[0], P_left[1], P_left[2]
    pax = Ai[0] * u_ev + Ai[1] * v_ev + Ai[2]
    pay = Ai[3] * u_ev + Ai[4] * v_ev + Ai[5]
    paz = Ai[6] * u_ev + Ai[7] * v_ev + Ai[8]
    pbx = Ai[0] * P0[3] + Ai[1] * P1[3] + Ai[2] * P2[3]
    pby = Ai[3] * P0[3] + Ai[4] * P1[3] + Ai[5] * P2[3]
    pbz = Ai[6] * P0[3] + Ai[7] * P1[3] + Ai[8] * P2[3]
    qax = rows[0] * pax + rows[1] * pay + rows[2] * paz
    qay = rows[4] * pax + rows[5] * pay + rows[6] * paz
    qaz = rows[8] * pax + rows[9] * pay + rows[10] * paz
    qbx = rows[3] - (rows[0] * pbx + rows[1] * pby + rows[2] * pbz)
    qby = rows[7] - (rows[4] * pbx + rows[5] * pby + rows[6] * pbz)
    qbz = rows[11] - (rows[8] * pbx + rows[9] * pby + rows[10] * pbz)

    def proj(R):
        R0, R1, R2 = R[0], R[1], R[2]
        return (R0[0] * qax + R0[1] * qay + R0[2] * qaz,
                R0[0] * qbx + R0[1] * qby + R0[2] * qbz + R0[3],
                R1[0] * qax + R1[1] * qay + R1[2] * qaz,
                R1[0] * qbx + R1[1] * qby + R1[2] * qbz + R1[3],
                R2[0] * qax + R2[1] * qay + R2[2] * qaz,
                R2[0] * qbx + R2[1] * qby + R2[2] * qbz + R2[3])

    return proj(P_left), proj(P_right)


def _warp(coeff, z):
    Au, Bu, Av, Bv, C, D = coeff
    inv = 1.0 / (C * z + D)
    return ((Au * z + Bu) * inv, (Av * z + Bv) * inv,
            (Au * D - Bu * C) * inv * inv, (Av * D - Bv * C) * inv * inv)


def _sample(win, oy, ox, u, v, du, dv, wy, wx):
    """Bilinear (wy, wx) patch at (u, v) from each event's window with
    origin (oy, ox), its d-derivative, and the in-window test."""
    N, Wy, Wx = win.shape
    hy, hx = (wy - 1) // 2, (wx - 1) // 2
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fx = (u - u0)[:, None, None]
    fy = (v - v0)[:, None, None]
    ry = v0.to(torch.int64) - hy - oy
    rx = u0.to(torch.int64) - hx - ox
    ok = (ry >= 0) & (rx >= 0) & (ry + wy + 1 <= Wy) & (rx + wx + 1 <= Wx)
    ryc = torch.clamp(ry, 0, Wy - (wy + 1))
    rxc = torch.clamp(rx, 0, Wx - (wx + 1))
    dev = win.device
    rr = (ryc[:, None] + torch.arange(wy + 1, device=dev))[:, :, None]
    cc = (rxc[:, None] + torch.arange(wx + 1, device=dev))[:, None, :]
    n = torch.arange(N, device=dev)[:, None, None]
    S = win[n, rr, cc]                                     # (N, wy+1, wx+1)
    r = (1.0 - fx) * S[:, :, :wx] + fx * S[:, :, 1:]      # (N, wy+1, wx)
    patch = (1.0 - fy) * r[:, :wy] + fy * r[:, 1:]
    dS = S[:, :, 1:] - S[:, :, :wx]
    dpat_du = (1.0 - fy) * dS[:, :wy] + fy * dS[:, 1:]
    dpat_dv = r[:, 1:] - r[:, :wy]
    jac = dpat_du * du[:, None, None] + dpat_dv * dv[:, None, None]
    return patch.reshape(N, -1), jac.reshape(N, -1), ok


def tdist_weights(r: torch.Tensor, nu: float, scale2_init: float,
                  iters: int) -> torch.Tensor:
    """Student-t IRLS weights (..., P) of residuals r (..., P): the scale
    fixed point scale2 <- mean(r^2 (nu + 1) / (nu + r^2 / scale2)), zeros
    left out of the sum but not the mean, `iters` trips with a 5%
    freeze mask, reset to scale2_init where degenerate
    (DepthProblem.cpp:88-135; pallas_lm.py's and the JAX scan's)."""
    r2 = r * r
    P = r.shape[-1]
    nonzero = r != 0.0
    s2 = torch.full(r.shape[:-1], scale2_init, dtype=r.dtype,
                    device=r.device)
    done = torch.zeros(r.shape[:-1], dtype=torch.bool, device=r.device)
    for _ in range(iters):
        c = r2 * (nu + 1.0) / (nu + r2 / s2[..., None])
        s2_new = torch.where(nonzero, c, 0.0).sum(-1) / P
        degenerate = s2_new == 0.0
        s2_new = torch.where(degenerate, scale2_init, s2_new)
        conv = torch.abs(s2_new - s2) / torch.clamp(s2, min=1e-30) <= 0.05
        s2 = torch.where(done, s2, s2_new)
        done = done | conv | degenerate
    return (nu + 1.0) / (nu + r2 / s2[..., None])


def lm_solve_plain(P_left, P_right, Ainv, u_ev, v_ev, d_init, oy1, ox1,
                   oy2, ox2, rows_lv, win1, win2, *, wy: int, wx: int,
                   Wy: int, Wx: int, H: int, W: int, ls_norm: str,
                   nu: float, scale2_init: float, td_iters: int,
                   max_iteration: int):
    """The plain twin of kernel K2; same arguments and results as
    ``lm_solve``: (d, cost, jtj), each (N,)."""
    f32 = torch.float32
    P_left, P_right, Ainv = P_left.to(f32), P_right.to(f32), Ainv.to(f32)
    u_ev, v_ev = u_ev.to(f32), v_ev.to(f32)
    rows = rows_lv.to(f32)
    win1, win2 = win1.to(f32), win2.to(f32)
    oy1, ox1, oy2, ox2 = (o.to(torch.int64) for o in (oy1, ox1, oy2, ox2))
    hy, hx = (wy - 1) // 2, (wx - 1) // 2
    cl, cr = _warp_coeffs(P_left, P_right, Ainv, u_ev, v_ev, rows)
    w_oob = (nu + 1.0) / (nu + (255.0 / math.sqrt(scale2_init)) ** 2)

    def eval_fj(d):
        z = 1.0 / d
        u1, v1, du1z, dv1z = _warp(cl, z)
        u2, v2, du2z, dv2z = _warp(cr, z)
        dz = -z * z
        ok_warp = ((u1 >= hx) & (u1 <= W - hx) & (v1 >= hy)
                   & (v1 <= H - hy) & (u2 >= hx) & (u2 <= W - hx)
                   & (v2 >= hy) & (v2 <= H - hy))
        tau1, j1, ok1 = _sample(win1, oy1, ox1, u1, v1, du1z * dz,
                                dv1z * dz, wy, wx)
        tau2, j2, ok2 = _sample(win2, oy2, ox2, u2, v2, du2z * dz,
                                dv2z * dz, wy, wx)
        okx = (ok_warp & ok1 & ok2)[:, None]
        r_raw = tau1 - tau2
        dr = j1 - j2
        r = torch.where(okx, r_raw, torch.full_like(r_raw, 255.0))
        if ls_norm == "l2":
            f = r
            jac = torch.where(okx, dr, torch.zeros_like(dr))
        else:
            w = tdist_weights(r_raw, nu, scale2_init, td_iters)
            sq = torch.sqrt(torch.where(okx, w, torch.full_like(w, w_oob)))
            f = sq * r
            jac = torch.where(okx, sq * dr, torch.zeros_like(dr))
        return f, jac, (f * f).sum(1)

    d = torch.clamp(d_init.to(f32), min=1e-6)
    lam = torch.full_like(d, 1e-3)
    strikes = torch.zeros_like(d, dtype=torch.int32)
    f, jac, cost = eval_fj(d)
    for _ in range(max_iteration):
        g = (jac * f).sum(1)
        h = (jac * jac).sum(1)
        delta = -g / (h * (1.0 + lam) + 1e-12)
        d_try = d + delta
        f_try, jac_try, cost_try = eval_fj(d_try)
        accept = cost_try < cost
        frozen = strikes >= 2
        do = accept & ~frozen
        small = (torch.abs(cost - cost_try) <= 1e-6 * cost) \
            | (torch.abs(delta) <= 1e-6 * (torch.abs(d) + 1e-6))
        strikes = torch.where(frozen, strikes,
                              torch.where(small, strikes + 1,
                                          torch.zeros_like(strikes)))
        d = torch.where(do, d_try, d)
        f = torch.where(do[:, None], f_try, f)
        jac = torch.where(do[:, None], jac_try, jac)
        cost = torch.where(do, cost_try, cost)
        lam = torch.where(frozen, lam,
                          torch.where(accept, lam * 0.3, lam * 4.0))
        lam = torch.clamp(lam, 1e-9, 1e9)
    return d, cost, (jac * jac).sum(1)


lm_solve = lm_solve_plain
