"""Frozen copy of esvo_tpu_torch/mapping/regularization.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Inverse-depth map regularization as dense windowed reductions
(port of esvo_tpu/mapping/regularization.py).

``regularize`` dispatches by ``kernel_takes``: a CUDA float32 grid whose
window's halo fits a block is one launch of kernel K5 (ops/regularize.py,
csrc/regularize.cu), bit for bit its plain twin ``regularize_plain``,
which runs every other grid, on every device. The twin walks the (2r+1)^2
window as shifted planes of the dense grid, in window row-major order
(the reference's iteration order); eager PyTorch runs that as ~43 small
launches an offset: (2r+1)^2 = 121 offsets at the rpg radius, 1,681 at
the DSEC radius.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from plainref.mapping.fusion import EMPTY, DepthGrid


def _reg_tdist_posterior(invD_a, s2_a, nu_a, invD_b, s2_b, nu_b):
    """Pairwise posterior of the regularization fold: nu_post =
    min(nu_prior, nu_obs) with no +1; nu = inf takes the Gaussian
    limit."""
    nu_u = torch.minimum(nu_a, nu_b)
    s_sum = s2_a + s2_b
    invD = (s2_b * invD_a + s2_a * invD_b) / s_sum
    d2 = (invD_a - invD_b) ** 2
    gauss = s2_a * s2_b / s_sum
    finite = torch.isfinite(nu_u)
    nu_safe = torch.where(finite, nu_u, torch.full_like(nu_u, 3.0))
    s2 = torch.where(finite,
                     (nu_safe + d2 / s_sum) / (nu_safe + 1.0) * gauss, gauss)
    return invD, s2, nu_u


@dataclass(frozen=True)
class RegularizationConfig:
    ls_norm: str = "Tdist"
    radius: int = 5
    min_neighbours: int = 8
    min_close_neighbours: int = 8


def regularize(grid: DepthGrid, cfg: RegularizationConfig) -> DepthGrid:
    """Smooth or invalidate every occupied cell over its (2r+1)^2 window:
    K5's plain twin ``regularize_plain`` on every device."""
    return regularize_plain(grid, cfg)


def regularize_plain(grid: DepthGrid,
                     cfg: RegularizationConfig) -> DepthGrid:
    r = cfg.radius
    H, W = grid.inv_depth.shape
    valid = grid.occupied
    invD = grid.inv_depth
    var = grid.variance
    std2 = 2.0 * torch.sqrt(torch.clamp(var, min=0.0))
    zero = torch.zeros_like(invD)

    def padded(a, fill):
        return F.pad(a, (r, r, r, r), value=fill)

    pv = padded(valid, False)
    pd = padded(invD, 0.0)
    pvar = padded(var, 1.0)
    ps2 = padded(grid.scale2, 1.0)
    pnu = padded(grid.nu, 1.0)

    n_count = zero
    close_count = zero
    wsum = zero
    wmean = zero
    t_started = torch.zeros_like(valid)
    t_nu, t_invD, t_s2 = zero, zero, torch.ones_like(invD)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            v_n = pv[dy:dy + H, dx:dx + W]
            d_n = pd[dy:dy + H, dx:dx + W]
            var_n = pvar[dy:dy + H, dx:dx + W]
            n_count = n_count + v_n
            diff = torch.abs(invD - d_n)
            close = v_n & ((diff < std2) | (
                diff < 2.0 * torch.sqrt(torch.clamp(var_n, min=0.0))))
            close_count = close_count + close
            if cfg.ls_norm == "l2":
                w = torch.where(close, 1.0 / torch.clamp(var_n, min=1e-20),
                                zero)
                wsum = wsum + w
                wmean = wmean + w * d_n
            else:
                s2_n = ps2[dy:dy + H, dx:dx + W]
                nu_n = pnu[dy:dy + H, dx:dx + W]
                init = close & ~t_started
                f_invD, f_s2, f_nu = _reg_tdist_posterior(
                    t_invD, t_s2, t_nu, d_n, s2_n, nu_n)
                upd = close & t_started
                t_invD = torch.where(init, d_n,
                                     torch.where(upd, f_invD, t_invD))
                t_s2 = torch.where(init, s2_n, torch.where(upd, f_s2, t_s2))
                t_nu = torch.where(init, nu_n, torch.where(upd, f_nu, t_nu))
                t_started = t_started | close

    enough = (n_count > cfg.min_neighbours) \
        & (close_count > cfg.min_close_neighbours)
    smoothed = (wmean / torch.clamp(wsum, min=1e-20) if cfg.ls_norm == "l2"
                else t_invD)
    new_invD = torch.where(valid & enough, smoothed,
                           torch.where(valid, torch.full_like(invD, EMPTY),
                                       invD))
    return grid.replace(inv_depth=new_invD)
