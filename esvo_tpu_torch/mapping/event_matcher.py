"""Temporal event-to-event stereo matching (port of
esvo_tpu/mapping/event_matcher.py; GTS, Ieng et al. 2018).

The comparison method of MVStereo modes 0 and 2 (the reference's
``EventMatcher``, esvo_core/src/core/EventMatcher.cpp): for each left
event, the right events inside +-time_threshold/2 of the same polarity
and within the epipolar band, the candidate whose triangulated depth best
explains both time surfaces (ZNCC of the two warped patches).

Right events are sorted by (epipolar row band, time) per polarity under a
composite int32 key, band << 21 | microseconds since the window's origin,
so each left event's candidates are one contiguous index range per row
band its epipolar interval touches. Candidates beyond the K slots are
counted (``window_overflow``), not silently dropped. All N x K candidate
checks, warps and patch ZNCCs run as one batched computation; the patch
windows go through ``ops.interp.patch_interpolate``, which sends 8-row
float32 windows of a CUDA surface (15x15 patches) to kernel K1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from esvo_tpu_torch.geometry.camera import StereoRig, cam_to_world
from esvo_tpu_torch.mapping.block_matching import EventMatches
from esvo_tpu_torch.ops.interp import patch_interpolate

T_BITS = 21          # rel-time in us < 2^21 (~2.1 s)


@dataclass(frozen=True)
class EventMatcherConfig:
    """Defaults: esvo_MVStereo.cpp's EventMatcher construction params."""
    time_threshold: float = 5e-5
    epipolar_threshold: float = 0.5
    ts_ncc_threshold: float = 0.1
    patch_size_x: int = 25
    patch_size_y: int = 25
    # candidate slots per left event, split over the NB epipolar row
    # bands (64 slots lose 0.5 % of candidates to hot-row bursts on the
    # JAX package's 480k ev/s campaign stream)
    max_candidates: int = 64


def match_events_temporal(*args, **kwargs) -> EventMatches:
    """match_events_temporal_stats without the stats dict."""
    return match_events_temporal_stats(*args, **kwargs)[0]


def _znorm(p: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(p, dim=(-2, -1), keepdim=True)
    sd = torch.sqrt(torch.mean((p - mu) ** 2, dim=(-2, -1),
                               keepdim=True)) + 1e-6
    return (p - mu) / sd


def match_events_temporal_stats(
        ts_left: torch.Tensor, ts_right: torch.Tensor,
        left_x_rect: torch.Tensor, left_t: torch.Tensor,
        left_p: torch.Tensor, left_valid: torch.Tensor,
        T_left_rv: torch.Tensor, right_x_rect: torch.Tensor,
        right_t: torch.Tensor, right_p: torch.Tensor,
        right_valid: torch.Tensor, rig: StereoRig,
        cfg: EventMatcherConfig):
    """Match N left events against M time-sorted right events.

    left_x_rect: (N, 2) rectified left coordinates; T_left_rv: (N, 4, 4)
    per-event transform virtual frame -> left camera at the surfaces'
    time; right_*: (M,) time-sorted right events, invalid lanes at the
    tail (io.events.frame_events' layout). Returns (EventMatches (N,)
    with the triangulated inverse depth, {"window_overflow": int32
    count of same-polarity in-window candidates lost to the K slots})."""
    N = left_x_rect.shape[0]
    M = right_t.shape[0]
    H, W = ts_left.shape
    dtype, dev = ts_left.dtype, ts_left.device
    wx, wy = cfg.patch_size_x, cfg.patch_size_y
    if (H + 2) << T_BITS >= 1 << 31:
        raise ValueError(f"surface height {H}: the (band << {T_BITS}) sort "
                         "key needs H + 2 < 1024 to fit int32")
    i32 = torch.int32

    t_lo = left_t - cfg.time_threshold / 2
    t_hi = left_t + cfg.time_threshold / 2
    e = cfg.epipolar_threshold
    # row bands touched by [y - e, y + e]: NB bands from floor(y - e)
    NB = int(np.ceil(2 * e)) + 1
    Kb = max(cfg.max_candidates // NB, 1)             # slots per band
    inf = torch.full_like(right_t, float("inf"))
    t0 = torch.minimum(torch.min(torch.where(right_valid, right_t, inf)),
                       torch.min(t_lo))
    t0 = torch.where(torch.isfinite(t0), t0, torch.zeros_like(t0))

    def us(t):
        # clamp in float before the cast: XLA's float -> int32 convert
        # saturates, PyTorch's is undefined out of range
        return torch.clamp((t - t0) * 1e6, 0, (1 << T_BITS) - 1).to(i32)

    def band(y):
        return torch.clamp(torch.floor(y), 0, H).to(i32)

    band_r = band(right_x_rect[:, 1])
    big = torch.full((M,), (H + 2) << T_BITS, dtype=i32, device=dev)

    def polarity_order(sel):
        key = torch.where(sel, (band_r << T_BITS) | us(right_t), big)
        order = torch.argsort(key, stable=True)        # BIG at the tail
        return order, key[order].contiguous()

    ord_pos, key_pos = polarity_order(right_valid & right_p)
    ord_neg, key_neg = polarity_order(right_valid & ~right_p)

    bands_l = torch.clamp(
        torch.floor(left_x_rect[:, 1] - e).to(i32)[:, None]
        + torch.arange(NB, dtype=i32, device=dev)[None, :], 0, H)
    q_lo = ((bands_l << T_BITS) | us(t_lo)[:, None]).contiguous()
    q_hi = ((bands_l << T_BITS) | us(t_hi)[:, None]).contiguous()

    def bounds(keys):
        return (torch.searchsorted(keys, q_lo, side="left"),
                torch.searchsorted(keys, q_hi, side="right"))

    lo_p, hi_p = bounds(key_pos)
    lo_n, hi_n = bounds(key_neg)
    pol = left_p[:, None]
    lo = torch.where(pol, lo_p, lo_n)                           # (N, NB)
    hi = torch.where(pol, hi_p, hi_n)
    window_overflow = torch.sum(torch.where(
        left_valid[:, None], torch.clamp(hi - lo - Kb, min=0),
        torch.zeros_like(lo))).to(i32)

    # Kb slots per band, concatenated to (N, NB * Kb)
    win = lo[:, :, None] + torch.arange(Kb, device=dev)[None, None, :]
    in_range = (win < hi[:, :, None]).reshape(N, NB * Kb)
    win_c = torch.clamp(win.reshape(N, NB * Kb), 0, M - 1)
    idx_c = torch.where(pol, ord_pos[win_c], ord_neg[win_c])
    c_t = right_t[idx_c]
    c_ok = (in_range & (c_t >= t_lo[:, None]) & (c_t <= t_hi[:, None])
            & left_valid[:, None])

    # epipolar check (EventMatcher.cpp:91-106)
    c_xr = right_x_rect[idx_c]                                  # (N, K, 2)
    xl = left_x_rect
    c_ok = (c_ok & (torch.abs(xl[:, None, 1] - c_xr[..., 1]) <= e)
            & (c_xr[..., 0] < xl[:, None, 0]))

    # motion-consistency check: triangulate, warp into both surfaces, ZNCC
    # (EventMatcher.cpp:110-162)
    P_left = rig.left.params.P.to(dtype)
    P_right = rig.right.params.P.to(dtype)
    b = rig.baseline.to(dtype)
    disp = xl[:, None, 0] - c_xr[..., 0]
    depth = b * P_left[0, 0] / torch.clamp(disp, min=1e-6)
    inv_depth = 1.0 / depth

    p_rv = cam_to_world(P_left, xl[:, None, :].expand(-1, disp.shape[1], -1),
                        inv_depth)                              # (N, K, 3)
    T = T_left_rv.to(dtype)
    p_left = (torch.einsum("nij,nkj->nki", T[:, :3, :3], p_rv)
              + T[:, None, :3, 3])

    def project(P):
        h = torch.einsum("ij,nkj->nki", P[:, :3], p_left) + P[:, 3]
        return h[..., :2] / h[..., 2:3]

    # patch_interpolate's containment check is strictly tighter than a
    # separate warp-bounds test
    p1, ok1 = patch_interpolate(ts_left, project(P_left), wy, wx)
    p2, ok2 = patch_interpolate(ts_right, project(P_right), wy, wx)
    c_ok = c_ok & ok1 & ok2

    ncc = torch.mean(_znorm(p1) * _znorm(p2), dim=(-2, -1))
    cost = torch.where(c_ok, 0.5 * (1.0 - ncc), torch.ones_like(ncc))

    best = torch.argmin(cost, dim=1)[:, None]       # first of equal minima
    take = lambda a: torch.take_along_dim(a, best, dim=1)[:, 0]
    best_cost = take(cost)
    matched = take(c_ok) & (best_cost <= cfg.ts_ncc_threshold)
    x_right = torch.take_along_dim(c_xr, best[..., None], dim=1)[:, 0]
    zero = torch.zeros_like(best_cost)
    matches = EventMatches(
        x_left=xl, x_left_raw=xl, x_right=x_right, t=left_t,
        inv_depth=torch.where(matched, take(inv_depth), zero),
        cost=torch.where(matched, best_cost, torch.ones_like(best_cost)),
        disparity=torch.where(matched, take(disp), zero),
        valid=matched)
    return matches, {"window_overflow": window_overflow}
