"""K2: the fused per-event inverse-depth LM solve.

Counterpart of esvo_tpu/ops/pallas_lm.py. ``lm_solve`` launches the CUDA
kernel (csrc/lm.cu) for CUDA tensors and runs the plain twin
``lm_solve_plain`` for CPU tensors. The twin mirrors pallas_lm.py's math:
the analytic depth Jacobian of u(z) = (Az + B)/(Cz + D), bilinear
sampling by gather from each event's window, the Student-t scale fixed
point with its freeze mask, the OOB-255 sentinel, and the same
lambda/strike schedule.

The kernel is persistent: ``lm_launch_plan`` sizes its grid to what the
card holds at once (``kernel_info`` asks the CUDA occupancy calculator),
and its warps take events from a queue counter the wrapper zeroes.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from esvo_tpu_torch.ops import _build
from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel(
    "lm.cu", "esvo_lm_solve",
    [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_float] * 4
    + [ctypes.c_int] * 4)

# the kernel keeps at most 8 patch pixels per lane of a warp
MAX_PATCH_AREA = 256

_INFO: dict = {}   # kernel_info per (instantiation, window, device)


def patch_kpl(wy: int, wx: int) -> int:
    """Patch pixels each lane of the event's warp owns: ceil(wy*wx/32)."""
    area = wy * wx
    if not 0 < area <= MAX_PATCH_AREA:
        raise ValueError(f"patch area {area} not in 1..{MAX_PATCH_AREA}")
    return -(-area // 32)


def lm_launch_plan(wy: int, wx: int, Wy: int, Wx: int, N: int, sms: int,
                   blocks_per_sm: int, warps: int) -> dict:
    """The kernel's instantiation (kpl) and grid: what the card holds at
    once (sms x blocks_per_sm blocks of `warps` warps, as ``kernel_info``
    reports them), never more blocks than the N events fill. Raises
    where the kernel cannot take the shape."""
    kpl = patch_kpl(wy, wx)
    if Wy < wy + 1 or Wx < wx + 1:
        raise ValueError(f"window ({Wy}, {Wx}) does not hold a ({wy}+1, "
                         f"{wx}+1) bilinear patch")
    if Wy * Wx * 4 % 16:
        raise ValueError(f"a ({Wy}, {Wx}) f32 window is {Wy * Wx * 4} "
                         "bytes, not a multiple of the bulk copy's 16")
    return dict(kpl=kpl, grid=min(-(-N // warps), sms * blocks_per_sm))


def kernel_info(kpl: int, tdist: bool, Wy: int, Wx: int,
                device=None) -> dict:
    """One instantiation of the kernel for (Wy, Wx) windows, prepared on
    the device (once) and as the CUDA runtime reports it: blocks an SM
    holds, registers and local (spill) bytes a thread, warps and dynamic
    shared bytes a block (csrc/lm.cu owns the layout), the card's SMs."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (kpl, bool(tdist), Wy, Wx, index)
    if key not in _INFO:
        fn = _build._load(KERNEL.source).esvo_lm_kernel_info
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(index):
            err = fn(kpl, int(tdist), Wy, Wx, ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"esvo_lm_kernel_info failed: CUDA error {err}")
        name = f"lm_kernel<{kpl}, {'true' if tdist else 'false'}>"
        if out[0] < 1:
            raise RuntimeError(f"{name} does not fit on an SM with {out[3]} "
                               "bytes of shared memory")
        _INFO[key] = dict(
            name=name, blocks_per_sm=out[0], registers=out[1],
            local_bytes=out[2], smem_bytes=out[3], warps=out[4],
            static_smem_bytes=out[5],
            sms=torch.cuda.get_device_properties(index).multi_processor_count)
    return _INFO[key]


@functools.lru_cache(maxsize=64)
def _plan(wy: int, wx: int, Wy: int, Wx: int, N: int, tdist: bool,
          index: int) -> dict:
    """lm_launch_plan on the device's kernel_info, per shape and device."""
    info = kernel_info(patch_kpl(wy, wx), tdist, Wy, Wx, index)
    return lm_launch_plan(wy, wx, Wy, Wx, N, info["sms"],
                          info["blocks_per_sm"], info["warps"])


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


def lm_solve(P_left, P_right, Ainv, u_ev, v_ev, d_init, oy1, ox1, oy2, ox2,
             rows_lv, win1, win2, *, wy: int, wx: int, Wy: int, Wx: int,
             H: int, W: int, ls_norm: str, nu: float, scale2_init: float,
             td_iters: int, max_iteration: int, work=None):
    """Run the fused LM solve: kernel K2 on CUDA tensors, the plain twin
    on CPU tensors. u_ev/v_ev/d_init (N,) f32; oy*/ox* (N,) int32 window
    origins; rows_lv (12, N) f32; win1/win2 (N, Wy, Wx) f32. Returns
    (d, cost, jtj), each (N,) f32.

    work: optional (3,) int64 CUDA tensor; the kernel adds to it the
    residual evaluations, the in-bounds evaluations and the scale
    fixed-point trips it ran (what a roofline bound counts)."""
    kw = dict(wy=wy, wx=wx, Wy=Wy, Wx=Wx, H=H, W=W, ls_norm=ls_norm, nu=nu,
              scale2_init=scale2_init, td_iters=td_iters,
              max_iteration=max_iteration)
    if not win1.is_cuda:
        if work is not None:
            raise ValueError("work counts only the CUDA kernel's launches")
        return lm_solve_plain(P_left, P_right, Ainv, u_ev, v_ev, d_init,
                              oy1, ox1, oy2, ox2, rows_lv, win1, win2, **kw)
    if ls_norm not in ("Tdist", "l2"):
        raise ValueError(f"kernel K2 takes ls_norm Tdist or l2, not "
                         f"{ls_norm!r} (depth_refinement.solve runs the "
                         "scan for it)")
    N = u_ev.shape[0]
    f32 = torch.float32
    P_left, P_right, Ainv = (m.to(f32).contiguous()
                             for m in (P_left, P_right, Ainv))
    require(P_left, "P_left", f32, (3, 4))
    require(P_right, "P_right", f32, (3, 4))
    require(Ainv, "Ainv", f32, (3, 3))
    for name, t in (("u_ev", u_ev), ("v_ev", v_ev), ("d_init", d_init)):
        require(t, name, f32, (N,))
    for name, t in (("oy1", oy1), ("ox1", ox1), ("oy2", oy2), ("ox2", ox2)):
        require(t, name, torch.int32, (N,))
    require(rows_lv, "rows_lv", f32, (12, N))
    for name, t in (("win1", win1), ("win2", win2)):
        require(t, name, f32, (N, Wy, Wx))
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the bulk "
                             "copy")
    if work is not None:
        require(work, "work", torch.int64, (3,))
    tdist = ls_norm == "Tdist"
    device = win1.device
    plan = _plan(wy, wx, Wy, Wx, N, tdist, device.index)
    out = torch.empty((3, N), dtype=f32, device=device)
    if N == 0:
        return out[0], out[1], out[2]
    queue = torch.zeros(1, dtype=torch.int32, device=device)
    w_oob = (nu + 1.0) / (nu + (255.0 / math.sqrt(scale2_init)) ** 2)
    KERNEL.launch(P_left, P_right, Ainv, u_ev, v_ev, d_init, oy1, ox1, oy2,
                  ox2, rows_lv, win1, win2, out[0], out[1], out[2], queue,
                  work, N, wy, wx, Wy, Wx, H, W, int(tdist), nu, nu + 1.0,
                  scale2_init, w_oob, td_iters, max_iteration, plan["kpl"],
                  plan["grid"])
    return out[0], out[1], out[2]
