"""Frozen copy of esvo_tpu_torch/mapping/block_matching.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Stereo block matching over time surfaces
(port of esvo_tpu/mapping/block_matching.py).

Every event evaluates every disparity, and each event keeps the argmin of
its D ZNCC costs. ``best_disparity`` picks how, by configuration:

- on CUDA float32 surfaces with the "slice" (or "auto") strategy and a
  strip that fits a block, one launch of kernel K6 (ops/block_match.py,
  csrc/block_match.cu): a warp an event, templated on the patch, bit for
  bit the twin below;
- otherwise its plain twin ``best_disparity_plain``, on every device: the
  ZNCC cost of each pixel and disparity from separable box sums over the
  dense surfaces, each event's D costs gathered inside the disparity
  loop, so the (H, W, D) cube is never materialized. Two cost volumes,
  as in the JAX package:
  - "slice" (and "auto"): one disparity plane at a time, every box sum
    as f32 slice-adds in the JAX package's order; no matrix product (and
    so no TF32) is involved;
  - "matmul": C disparities at a time, the horizontal box of the
    left-right product as one product with the banded-ones matrix Bx, in
    full float32 (``highest_precision``). Its argmin equals the slice
    path's; its costs agree to float32 rounding.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from plainref.geometry.camera import StereoRig
from plainref.ops.interp import gather2d
from plainref.surface.time_surface import gaussian_blur

COST_STRATEGIES = ("auto", "slice", "matmul")


@dataclass(frozen=True)
class BlockMatchConfig:
    patch_size_x: int = 15
    patch_size_y: int = 7
    min_disparity: int = 1
    max_disparity: int = 40
    step: int = 1
    zncc_threshold: float = 0.1
    up_down: bool = False
    smooth_time_surface: bool = False
    # both neighbours of the minimum must be valid candidates; like the
    # reference, only applied when step > 1
    check_local_minimum: bool = True
    # "slice", "matmul", or "auto" (= "slice", whose arithmetic kernel K6
    # runs on the card; JAX picks "matmul" only on a TPU)
    cost_strategy: str = "auto"


@dataclass
class EventMatches:
    x_left: torch.Tensor       # (N, 2) rectified left coordinate
    x_left_raw: torch.Tensor   # (N, 2) raw left coordinate
    x_right: torch.Tensor      # (N, 2) rectified right coordinate
    t: torch.Tensor            # (N,) event timestamps
    inv_depth: torch.Tensor    # (N,) triangulated inverse depth
    cost: torch.Tensor         # (N,) ZNCC cost of the best match
    disparity: torch.Tensor    # (N,) best disparity
    valid: torch.Tensor        # (N,) bool


def derive_disparity_bounds(rig: StereoRig, inv_depth_min: float,
                            inv_depth_max: float,
                            cfg: BlockMatchConfig) -> tuple[int, int]:
    """Disparity search range d = f * b * invDepth, clamped to the
    configured bounds."""
    P = rig.left.params.P.double().cpu().numpy()
    f = 0.5 * (P[0, 0] + P[1, 1])
    b = float(rig.baseline)
    lo = max(int(np.floor(f * b * inv_depth_min)), 0)
    hi = int(np.ceil(f * b * inv_depth_max))
    return max(lo, cfg.min_disparity), min(hi, cfg.max_disparity)


def match_events(ts_left, ts_right, x_rect, x_raw, t, valid, mask,
                 rig: StereoRig, cfg: BlockMatchConfig) -> EventMatches:
    """Match N events against the right surface over the full disparity
    range."""
    out, _ = match_events_stats(ts_left, ts_right, x_rect, x_raw, t, valid,
                                mask, rig, cfg)
    return out


def match_events_stats(ts_left, ts_right, x_rect, x_raw, t, valid, mask,
                       rig: StereoRig, cfg: BlockMatchConfig):
    """As match_events, plus the failure taxonomy counters (input,
    out_of_bounds, info_noise_low, coarse_fail, fine_fail, matched) as a
    dict of int32 scalars."""
    if cfg.up_down:
        # vertical baseline: search along y by transposing the problem
        x_t = x_rect.flip(1)
        out, stats = _match_horizontal(ts_left.T, ts_right.T, x_t, t, valid,
                                       mask.T, rig, cfg, swap_patch=True)
        return EventMatches(
            x_left=x_t.flip(1), x_left_raw=x_raw,
            x_right=out.x_right.flip(1), t=t, inv_depth=out.inv_depth,
            cost=out.cost, disparity=out.disparity, valid=out.valid), stats
    out, stats = _match_horizontal(ts_left, ts_right, x_rect, t, valid, mask,
                                   rig, cfg, swap_patch=False)
    return EventMatches(x_left=x_rect, x_left_raw=x_raw, x_right=out.x_right,
                        t=t, inv_depth=out.inv_depth, cost=out.cost,
                        disparity=out.disparity, valid=out.valid), stats


def _box(img: torch.Tensor, hy: int, hx: int) -> torch.Tensor:
    """(2hy+1, 2hx+1) box sum with zero padding, as wy then wx slice-adds
    (the JAX package's order of additions)."""
    H, W = img.shape
    p = F.pad(img, (0, 0, hy, hy))
    out = torch.zeros_like(img)
    for dy in range(2 * hy + 1):
        out = out + p[dy:dy + H]
    p = F.pad(out, (hx, hx))
    out = torch.zeros_like(img)
    for dx in range(2 * hx + 1):
        out = out + p[:, dx:dx + W]
    return out


def _volume_slice(ts_left, ts_right, S_r, S_r2, m_l, sigma_l, flat,
                  dmin: int, dmax: int, hy: int, hx: int) -> torch.Tensor:
    """(N, D) event costs, one disparity plane at a time."""
    H, W = ts_left.shape
    P_area = (2 * hy + 1) * (2 * hx + 1)
    pad_r = F.pad(ts_right, (dmax, 0))
    pad_Sr = F.pad(S_r, (dmax, 0))
    pad_Sr2 = F.pad(S_r2, (dmax, 0))
    planes = []
    for d in range(dmin, dmax + 1):
        o = dmax - d

        def sl(p):
            return p[:, o:o + W]

        m_r = sl(pad_Sr) / P_area
        sigma_r = torch.sqrt(torch.clamp(sl(pad_Sr2) / P_area - m_r * m_r,
                                         min=0.0)) + 1e-6
        S_lr = _box(ts_left * sl(pad_r), hy, hx)
        ncc = (S_lr / P_area - m_l * m_r) / (sigma_l * sigma_r)
        cost = 0.5 * (1.0 - ncc)
        planes.append(cost.reshape(-1)[flat])                 # (N,)
    return torch.stack(planes, dim=1)


def _volume_matmul(ts_left, ts_right, S_r, S_r2, m_l, sigma_l, flat,
                   dmin: int, dmax: int, hy: int, hx: int) -> torch.Tensor:
    """(N, D) event costs, C = min(8, D) disparities at a time: the
    vertical box of each chunk's left-right products as slice-adds, the
    horizontal one as a product with Bx[w, x] = (|w - x| <= hx), the
    JAX package's zero-padding semantics."""
    H, W = ts_left.shape
    P_area = (2 * hy + 1) * (2 * hx + 1)
    D = dmax - dmin + 1
    C = min(8, D)
    lead = dmax + C - 1
    pad_r = F.pad(ts_right, (lead, 0))
    pad_Sr = F.pad(S_r, (lead, 0))
    pad_Sr2 = F.pad(S_r2, (lead, 0))
    cols = torch.arange(W, device=ts_left.device)
    Bx = (torch.abs(cols[:, None] - cols[None, :]) <= hx).to(ts_left.dtype)
    # disparity d0 + j of a chunk sits at column offset C - 1 - j of the
    # chunk's (H, W + C - 1) strip, which starts at column dmax - d0
    j = torch.arange(C, device=ts_left.device)

    def stack(p, d0):
        o = dmax - d0 + C - 1 - j                             # (C,)
        idx = o[:, None] + cols[None, :]                      # (C, W)
        return p[:, idx].permute(1, 0, 2)                     # (C, H, W)

    chunks = []
    for d0 in range(dmin, dmin + D, C):
        prod = ts_left[None] * stack(pad_r, d0)
        q = F.pad(prod, (0, 0, hy, hy))
        vbox = torch.zeros_like(prod)
        for dy in range(2 * hy + 1):
            vbox = vbox + q[:, dy:dy + H]
        S_lr = torch.matmul(vbox, Bx)                         # (C, H, W)
        m_r = stack(pad_Sr, d0) / P_area
        sigma_r = torch.sqrt(torch.clamp(stack(pad_Sr2, d0) / P_area
                                         - m_r * m_r, min=0.0)) + 1e-6
        ncc = (S_lr / P_area - m_l[None] * m_r) / (sigma_l[None] * sigma_r)
        cost = 0.5 * (1.0 - ncc)
        chunks.append(cost.reshape(C, -1)[:, flat])           # (C, N)
    return torch.cat(chunks)[:D].T


def best_disparity(ts_left, ts_right, ui, vi, dmin: int, dmax: int, hy: int,
                   hx: int, strategy: str):
    """(best, best_cost, dark) of N events at (ui, vi): the argmin index
    into [dmin, dmax] of each event's costs (1.0 where the disparity
    leaves the image), its cost, and the box of (ts_left < 1) at the
    event: K6's plain twin on every device."""
    return best_disparity_plain(ts_left, ts_right, ui, vi, dmin, dmax, hy,
                                hx, strategy)


def best_disparity_plain(ts_left, ts_right, ui, vi, dmin: int, dmax: int,
                         hy: int, hx: int, strategy: str):
    """K6's plain twin: the dense box planes, the "slice" or "matmul"
    volume of the N events' costs, the out-of-image mask and the
    argmin."""
    H, W = ts_left.shape
    P_area = (2 * hy + 1) * (2 * hx + 1)
    S_l = _box(ts_left, hy, hx)
    S_l2 = _box(ts_left * ts_left, hy, hx)
    m_l = S_l / P_area
    sigma_l = torch.sqrt(torch.clamp(S_l2 / P_area - m_l * m_l, min=0.0)) \
        + 1e-6
    S_r = _box(ts_right, hy, hx)
    S_r2 = _box(ts_right * ts_right, hy, hx)
    dark_l = _box((ts_left < 1.0).to(ts_left.dtype), hy, hx)

    flat = vi * W + ui
    volume = _volume_matmul if strategy == "matmul" else _volume_slice
    cost_vol = volume(ts_left, ts_right, S_r, S_r2, m_l, sigma_l, flat,
                      dmin, dmax, hy, hx)                     # (N, D)
    dark = dark_l.reshape(-1)[flat]

    ds = torch.arange(dmin, dmax + 1, device=ui.device)[None, :]
    ok_vol = (ui[:, None] - ds - hx >= 1) & (ui[:, None] - ds + hx < W - 1)
    cost_vol = torch.where(ok_vol, cost_vol, torch.ones_like(cost_vol))

    best = torch.argmin(cost_vol, dim=1)
    best_cost = torch.gather(cost_vol, 1, best[:, None])[:, 0]
    return best, best_cost, dark


def _match_horizontal(ts_left, ts_right, x_rect, t, valid, mask, rig, cfg,
                      swap_patch: bool):
    H, W = ts_left.shape
    wx = cfg.patch_size_y if swap_patch else cfg.patch_size_x
    wy = cfg.patch_size_x if swap_patch else cfg.patch_size_y
    hx, hy = (wx - 1) // 2, (wy - 1) // 2
    dmin, dmax = cfg.min_disparity, cfg.max_disparity
    if cfg.cost_strategy not in COST_STRATEGIES:
        raise ValueError(
            f"unknown cost_strategy {cfg.cost_strategy!r} "
            "(expected 'slice', 'matmul', or 'auto')")
    ts_left = ts_left.contiguous()
    ts_right = ts_right.contiguous()
    if cfg.smooth_time_surface:
        ts_left = gaussian_blur(ts_left, 5)
        ts_right = gaussian_blur(ts_right, 5)

    u = x_rect[:, 0]
    v = x_rect[:, 1]
    inb = valid & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    ui = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 1)
    inb = inb & gather2d(mask, vi, ui)
    inb = inb & (ui - hx >= 1) & (vi - hy >= 1) \
        & (ui + hx < W - 1) & (vi + hy < H - 1)

    P_area = wx * wy
    best, best_cost, dark = best_disparity(ts_left, ts_right, ui, vi, dmin,
                                           dmax, hy, hx, cfg.cost_strategy)
    noise_low = inb & (dark > 0.95 * P_area)
    inb = inb & ~noise_low

    def ok_at(idx):
        """The out-of-image mask of best_disparity at disparity index
        idx."""
        d = idx + dmin
        return (ui - d - hx >= 1) & (ui - d + hx < W - 1)

    best_disp = (best + dmin).to(ts_left.dtype)
    best_ok = ok_at(best)
    D = dmax - dmin + 1
    if cfg.check_local_minimum and cfg.step > 1:
        lo_ok = (best >= 1) & ok_at(torch.clamp(best - 1, min=0))
        hi_ok = (best <= D - 2) & ok_at(torch.clamp(best + 1, max=D - 1))
        local_min_ok = lo_ok & hi_ok
    else:
        local_min_ok = torch.ones_like(best_ok)

    below = best_cost <= cfg.zncc_threshold
    matched = inb & best_ok & below & local_min_ok

    def count(m):
        return torch.sum(m).to(torch.int32)

    stats = {
        "input": count(valid),
        "out_of_bounds": count(valid & ~inb & ~noise_low),
        "info_noise_low": count(noise_low),
        "coarse_fail": count(inb & ~(best_ok & below)),
        "fine_fail": count(inb & best_ok & below & ~local_min_ok),
        "matched": count(matched),
    }

    fx = rig.left.params.P[0, 0]
    depth = rig.baseline * fx / torch.clamp(best_disp, min=1e-6)
    zero = torch.zeros_like(depth)
    inv_depth = torch.where(matched, 1.0 / depth, zero)
    x_right = torch.stack([(ui - best_disp.to(torch.int64)).to(ts_left.dtype),
                           vi.to(ts_left.dtype)], dim=1)
    return EventMatches(
        x_left=x_rect, x_left_raw=x_rect, x_right=x_right, t=t,
        inv_depth=inv_depth,
        cost=torch.where(matched, best_cost, torch.ones_like(best_cost)),
        disparity=torch.where(matched, best_disp, zero),
        valid=matched), stats
