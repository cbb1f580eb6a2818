"""Frozen copy of esvo_tpu_torch/mapping/initialization.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Bootstrap depth and event denoising (port of
esvo_tpu/mapping/initialization.py).

The SGM bootstrap seeds the first depth map from the first time-surface
pair, as the reference does with OpenCV's StereoSGBM (48 disparities,
block 11, P1 = 8*11*11, P2 = 32*11*11, uniqueness 11):

- cost volume: absolute difference summed over the block (SAD), (H, W, D);
- path aggregation along 4 directions (left/right/up/down) with the SGM
  recurrence L(p,d) = C(p,d) + min(L(p-1,d), L(p-1,d+-1)+P1,
  min_d' L(p-1,d')+P2) - min_d' L(p-1,d'), as Python loops over the
  columns and rows (one small step per position: thousands of launches,
  once per bootstrap);
- winner-take-all (first index on ties, as in the JAX package) +
  uniqueness test + parabola sub-pixel refinement.

The denoising mask and the event selection of the mapping cycle follow.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from plainref.geometry.camera import StereoRig, cam_to_world
from plainref.mapping.depth_refinement import DepthEstimates
from plainref.ops.interp import gather2d
from plainref.surface.time_surface import median_blur_3x3


@dataclass(frozen=True)
class SGMConfig:
    num_disparities: int = 48
    block_size: int = 11
    p1: float = 8.0 * 11 * 11
    p2: float = 32.0 * 11 * 11
    uniqueness_ratio: float = 11.0
    init_variance: float = 0.001 ** 2


def _box_sum(img: torch.Tensor, k: int) -> torch.Tensor:
    """(..., H, W) separable block SUM with zero padding, window k x k. A
    sum, not a mean: P1 and P2 are calibrated against the summed cost."""
    r = k // 2
    H, W = img.shape[-2], img.shape[-1]
    p = F.pad(img, (0, 0, r, r))
    out = torch.zeros_like(img)
    for dy in range(k):
        out = out + p[..., dy:dy + H, :]
    p = F.pad(out, (r, r, 0, 0))
    out = torch.zeros_like(img)
    for dx in range(k):
        out = out + p[..., :, dx:dx + W]
    return out


def cost_volume(ts_left: torch.Tensor, ts_right: torch.Tensor,
                cfg: SGMConfig) -> torch.Tensor:
    """(H, W, D) SAD block cost. Disparity d matches left (y, x) with
    right (y, x - d); out-of-image candidates cost 255 a pixel."""
    ads = []
    for d in range(cfg.num_disparities):
        ad = torch.abs(ts_left - torch.roll(ts_right, d, dims=1))
        ad[:, :d] = 255.0
        ads.append(ad)
    vol = _box_sum(torch.stack(ads, dim=0), cfg.block_size)   # (D, H, W)
    return vol.permute(1, 2, 0)


def _aggregate_dir(cost_t: torch.Tensor, p1: float,
                   p2: float) -> torch.Tensor:
    """SGM recurrence along the leading axis of cost_t (S, L, D): position
    s in 0..S-1 over L lines."""
    out = torch.empty_like(cost_t)
    out[0] = cost_t[0]
    L = cost_t[0]
    inf_col = torch.full_like(L[:, :1], float("inf"))
    for s in range(1, cost_t.shape[0]):
        m = torch.amin(L, dim=-1, keepdim=True)
        up = torch.cat([L[:, 1:], inf_col], dim=-1) + p1
        down = torch.cat([inf_col, L[:, :-1]], dim=-1) + p1
        L = cost_t[s] + torch.minimum(torch.minimum(L, up),
                                      torch.minimum(down, m + p2)) - m
        out[s] = L
    return out


def semi_global_matching(ts_left: torch.Tensor, ts_right: torch.Tensor,
                         cfg: SGMConfig):
    """Returns (disparity (H, W) float, valid (H, W) bool)."""
    D = cfg.num_disparities
    C = cost_volume(ts_left, ts_right, cfg)
    Ct = C.permute(1, 0, 2)                           # columns first
    agg = _aggregate_dir(Ct, cfg.p1, cfg.p2).permute(1, 0, 2)
    agg = agg + _aggregate_dir(Ct.flip(0), cfg.p1,
                               cfg.p2).flip(0).permute(1, 0, 2)
    agg = agg + _aggregate_dir(C, cfg.p1, cfg.p2)
    agg = agg + _aggregate_dir(C.flip(0), cfg.p1, cfg.p2).flip(0)

    best = torch.argmin(agg, dim=-1)                  # first of equals
    best_cost = torch.amin(agg, dim=-1)
    ar = torch.arange(D, device=agg.device)
    # uniqueness (OpenCV SGBM): valid needs second * (100 - ratio) >=
    # best * 100, second = the least cost off best's neighbours
    masked = torch.where(torch.abs(ar - best[..., None]) <= 1,
                         float("inf"), agg)
    second = torch.amin(masked, dim=-1)
    unique = second * (100.0 - cfg.uniqueness_ratio) >= best_cost * 100.0

    bl = torch.clamp(best - 1, 0, D - 1)
    br = torch.clamp(best + 1, 0, D - 1)
    cl = torch.gather(agg, -1, bl[..., None])[..., 0]
    cr = torch.gather(agg, -1, br[..., None])[..., 0]
    denom = cl + cr - 2.0 * best_cost
    offset = torch.where(denom > 1e-9,
                         0.5 * (cl - cr) / torch.clamp(denom, min=1e-9),
                         torch.zeros_like(denom))
    offset = torch.clamp(offset, -0.5, 0.5)
    disp = best.to(ts_left.dtype) + offset
    valid = unique & (best > 0) & (best < D - 1)
    return disp, valid


def event_edge_mask(x_rect: torch.Tensor, valid: torch.Tensor, height: int,
                    width: int, radius: int = 0) -> torch.Tensor:
    """Binary edge mask from rectified event coordinates, dilated by
    `radius` (createEdgeMask)."""
    xi = torch.floor(x_rect[:, 0]).to(torch.int64)
    yi = torch.floor(x_rect[:, 1]).to(torch.int64)
    mask = torch.zeros(height * width, dtype=torch.uint8,
                       device=x_rect.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            x, y = xi + dx, yi + dy
            ok = valid & (x >= 0) & (x < width) & (y >= 0) & (y < height)
            idx = torch.clamp(y, 0, height - 1) * width \
                + torch.clamp(x, 0, width - 1)
            mask.scatter_reduce_(0, idx, ok.to(torch.uint8), "amax")
    return mask.reshape(height, width) > 0


def denoising_mask(x_raw: torch.Tensor, y_raw: torch.Tensor,
                   valid: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """Median-blurred binary event map: flicker / isolated-event
    rejection (createDenoisingMask)."""
    ok = valid & (x_raw >= 0) & (x_raw < width) & (y_raw >= 0) \
        & (y_raw < height)
    idx = (torch.clamp(y_raw, 0, height - 1).long() * width
           + torch.clamp(x_raw, 0, width - 1).long())
    vals = torch.where(ok, 255.0, 0.0).to(torch.float32)
    emap = torch.zeros(height * width, dtype=torch.float32,
                       device=x_raw.device)
    emap.scatter_reduce_(0, idx, vals, "amax", include_self=True)
    return median_blur_3x3(emap.reshape(height, width)) >= 128.0


def select_denoised(x_raw: torch.Tensor, y_raw: torch.Tensor,
                    valid: torch.Tensor, mask: torch.Tensor,
                    max_num: int) -> torch.Tensor:
    """Keep the first `max_num` events whose raw pixel survives the mask
    (extractDenoisedEvents)."""
    H, W = mask.shape
    ok = valid & gather2d(mask, torch.clamp(y_raw, 0, H - 1),
                          torch.clamp(x_raw, 0, W - 1))
    rank = torch.cumsum(ok.to(torch.int32), dim=0)
    return ok & (rank <= max_num)


def sgm_depth_points(ts_left: torch.Tensor, ts_right: torch.Tensor,
                     x_rect: torch.Tensor, ev_valid: torch.Tensor,
                     T_world_frame: torch.Tensor, rig: StereoRig,
                     cfg: SGMConfig, inv_depth_min: float,
                     inv_depth_max: float,
                     init_age: int = 0) -> DepthEstimates:
    """SGM disparity at each event's rectified pixel -> DepthEstimates,
    one per event (duplicates at a pixel are harmless: fusion
    canonicalizes them)."""
    H, W = ts_left.shape
    disp, dvalid = semi_global_matching(ts_left, ts_right, cfg)
    xi = torch.clamp(torch.floor(x_rect[:, 0]).to(torch.int32), 0, W - 1)
    yi = torch.clamp(torch.floor(x_rect[:, 1]).to(torch.int32), 0, H - 1)
    inb = ev_valid & (x_rect[:, 0] >= 0) & (x_rect[:, 0] < W) \
        & (x_rect[:, 1] >= 0) & (x_rect[:, 1] < H)
    d = gather2d(disp, yi, xi)
    ok = inb & gather2d(dvalid, yi, xi) & (d > 0)
    inv_depth = d / (rig.left.params.P[0, 0] * rig.baseline)
    ok = ok & (inv_depth >= inv_depth_min) & (inv_depth <= inv_depth_max)
    inv_depth = torch.where(ok, inv_depth, torch.ones_like(inv_depth))
    dt = ts_left.dtype
    x_img = torch.stack([xi, yi], dim=1).to(dt)
    p_cam = cam_to_world(rig.left.params.P, x_img, inv_depth)
    n = x_rect.shape[0]
    full = lambda v: torch.full((n,), v, dtype=dt, device=ts_left.device)
    return DepthEstimates(
        x=x_img,
        inv_depth=torch.where(ok, inv_depth, full(-1.0)),
        variance=full(cfg.init_variance), scale2=full(cfg.init_variance),
        nu=full(float("inf")), residual=full(0.0),
        age=torch.full((n,), init_age, dtype=torch.int32,
                       device=ts_left.device),
        p_cam=p_cam, T_world_cam=T_world_frame.expand(n, 4, 4),
        valid=ok)
