"""Frozen copy of esvo_tpu_torch/surface/time_surface.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Time-surface engine (port of esvo_tpu/surface/time_surface.py).

The per-pixel event queue of the reference collapses to a per-pixel last
timestamp grid per polarity; a surface at t_sync is
exp(-(t_sync - last_t) / decay), quantized to 8-bit levels, median
filtered and (BACKWARD mode) rectified by a bilinear remap.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from plainref._device import constant, resolve_device
from plainref.geometry.camera import (Camera, remap_bilinear,
                                            remap_bilinear_pair)

# "no event yet at this pixel": large, negative and finite in f32, so
# exp() stays defined and scatter-max of a masked lane is a no-op
NO_EVENT = -1e30


@dataclass
class EventBatch:
    """Fixed-capacity packed event frame. Invalid lanes have valid=False."""
    x: torch.Tensor      # (N,) int32 raw column
    y: torch.Tensor      # (N,) int32 raw row
    t: torch.Tensor      # (N,) float32 seconds
    p: torch.Tensor      # (N,) bool polarity (True = positive)
    valid: torch.Tensor  # (N,) bool

    @staticmethod
    def from_arrays(x, y, t, p, valid=None, device=None) -> "EventBatch":
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.int32, device=dev)
        y = torch.as_tensor(y, dtype=torch.int32, device=dev)
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        p = torch.as_tensor(p, dtype=torch.bool, device=dev)
        valid = (torch.ones_like(p) if valid is None
                 else torch.as_tensor(valid, dtype=torch.bool, device=dev))
        return EventBatch(x=x, y=y, t=t, p=p, valid=valid)


@dataclass
class TimeSurfaceState:
    last_t_pos: torch.Tensor   # (H, W) f32, last positive event time
    last_t_neg: torch.Tensor   # (H, W) f32, last negative event time


@dataclass(frozen=True)
class TimeSurfaceConfig:
    decay_sec: float = 0.03
    ignore_polarity: bool = True
    median_blur_kernel_size: int = 1
    # "backward" (decay at raw pixels, rectify the rendered image) or
    # "forward" (splat decayed values at rectified coordinates)
    mode: str = "backward"


def init_state(height: int, width: int, device=None) -> TimeSurfaceState:
    dev = resolve_device(device)
    return TimeSurfaceState(
        last_t_pos=torch.full((height, width), NO_EVENT, dtype=torch.float32,
                              device=dev),
        last_t_neg=torch.full((height, width), NO_EVENT, dtype=torch.float32,
                              device=dev))


def insert_events(state: TimeSurfaceState,
                  ev: EventBatch) -> TimeSurfaceState:
    """Scatter-max the event timestamps into the per-pixel grids (a new
    state; the input state is left as it was)."""
    H, W = state.last_t_pos.shape
    inb = ev.valid & (ev.x >= 0) & (ev.x < W) & (ev.y >= 0) & (ev.y < H)
    idx = (torch.clamp(ev.y, 0, H - 1).long() * W
           + torch.clamp(ev.x, 0, W - 1).long())
    no = torch.full_like(ev.t, NO_EVENT)
    tp = torch.where(inb & ev.p, ev.t, no)
    tn = torch.where(inb & ~ev.p, ev.t, no)

    def scatter_max(grid, vals):
        return grid.reshape(-1).clone().scatter_reduce_(
            0, idx, vals, "amax", include_self=True).reshape(H, W)

    return TimeSurfaceState(last_t_pos=scatter_max(state.last_t_pos, tp),
                            last_t_neg=scatter_max(state.last_t_neg, tn))


def _decayed(state: TimeSurfaceState, t_sync, decay_sec: float,
             ignore_polarity: bool):
    """Per-raw-pixel decayed value exp(-dt/decay) (signed if polarity is
    used) and the has-event mask."""
    last_t = torch.maximum(state.last_t_pos, state.last_t_neg)
    has_event = last_t > NO_EVENT * 0.5
    dt = torch.clamp(t_sync - last_t, min=0.0)
    val = torch.where(has_event, torch.exp(-dt / decay_sec),
                      torch.zeros_like(dt))
    if not ignore_polarity:
        pol = torch.where(state.last_t_pos >= state.last_t_neg, 1.0, -1.0)
        val = val * torch.where(has_event, pol, torch.ones_like(pol))
    return val, has_event


def _to_8bit_levels(img_unit: torch.Tensor,
                    ignore_polarity: bool) -> torch.Tensor:
    """Scale to 0..255 and quantize to integer levels (kept in f32).
    torch.round, like jnp.round, rounds half to even."""
    if ignore_polarity:
        scaled = 255.0 * img_unit
    else:
        scaled = 255.0 * (img_unit + 1.0) / 2.0
    return torch.clamp(torch.round(scaled), 0.0, 255.0)


def _pad(img: torch.Tensor, pad, mode: str) -> torch.Tensor:
    """F.pad on a 2D image; pad = (left, right, top, bottom)."""
    return F.pad(img[None, None], pad, mode=mode)[0, 0]


def median_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median with replicated borders, by the exchange network."""
    padded = _pad(img, (1, 1, 1, 1), "replicate")
    H, W = img.shape
    v = [padded[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]

    def s2(a, b):
        return torch.minimum(a, b), torch.maximum(a, b)

    v[0], v[3] = s2(v[0], v[3]); v[1], v[4] = s2(v[1], v[4])
    v[2], v[5] = s2(v[2], v[5])
    v[0], v[1] = s2(v[0], v[1]); v[0], v[2] = s2(v[0], v[2])
    v[4], v[5] = s2(v[4], v[5]); v[3], v[5] = s2(v[3], v[5])
    v[1], v[2] = s2(v[1], v[2]); v[3], v[4] = s2(v[3], v[4])
    v[1], v[3] = s2(v[1], v[3]); v[1], v[6] = s2(v[1], v[6])
    v[4], v[6] = s2(v[4], v[6]); v[2], v[6] = s2(v[2], v[6])
    v[2], v[3] = s2(v[2], v[3]); v[4], v[7] = s2(v[4], v[7])
    v[2], v[4] = s2(v[2], v[4]); v[3], v[7] = s2(v[3], v[7])
    v[4], v[8] = s2(v[4], v[8]); v[3], v[8] = s2(v[3], v[8])
    v[3], v[4] = s2(v[3], v[4])
    return v[4]


def median_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """(2k+1)x(2k+1) median filter (cv::medianBlur(ksize = 2k+1))."""
    if k <= 0:
        return img
    if k == 1:
        return median_blur_3x3(img)
    ks = 2 * k + 1
    padded = _pad(img, (k, k, k, k), "replicate")
    H, W = img.shape
    taps = torch.stack([padded[dy:dy + H, dx:dx + W]
                        for dy in range(ks) for dx in range(ks)])
    return torch.median(taps, dim=0).values


# OpenCV's fixed binomial kernels for ksize <= 7 at sigma 0
_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable Gaussian blur, OpenCV's sigma=0 kernel, reflect-101
    borders."""
    if ksize <= 1:
        return img
    if ksize in _SMALL_GAUSSIAN:
        k = constant(tuple(_SMALL_GAUSSIAN[ksize]), img.dtype, img.device)
    else:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
        xs = torch.arange(ksize, dtype=img.dtype, device=img.device) \
            - (ksize - 1) / 2
        k = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
        k = k / torch.sum(k)
    r = ksize // 2
    H, W = img.shape
    padded = _pad(img, (0, 0, r, r), "reflect")
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + k[i] * padded[i:i + H, :]
    padded = _pad(out, (r, r, 0, 0), "reflect")
    out2 = torch.zeros_like(img)
    for i in range(ksize):
        out2 = out2 + k[i] * padded[:, i:i + W]
    return out2


def _conv3(img: torch.Tensor, kernel) -> torch.Tensor:
    """3x3 correlation with reflect-101 border (cv::Sobel default)."""
    padded = _pad(img, (1, 1, 1, 1), "reflect")
    H, W = img.shape
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            w = kernel[dy][dx]
            if w != 0:
                out = out + w * padded[dy:dy + H, dx:dx + W]
    return out


def sobel_x(img: torch.Tensor) -> torch.Tensor:
    """d/du Sobel, unnormalized like cv::Sobel."""
    return _conv3(img, [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]])


def sobel_y(img: torch.Tensor) -> torch.Tensor:
    return _conv3(img, [[-1, -2, -1], [0, 0, 0], [1, 2, 1]])


def _unrectified(state: TimeSurfaceState, t_sync,
                 cfg: TimeSurfaceConfig) -> torch.Tensor:
    """A BACKWARD-mode surface before rectification: decay at raw pixels,
    8-bit levels, median blur."""
    val, _ = _decayed(state, t_sync, cfg.decay_sec, cfg.ignore_polarity)
    img = _to_8bit_levels(val, cfg.ignore_polarity)
    if cfg.median_blur_kernel_size > 0:
        img = median_blur(img, cfg.median_blur_kernel_size)
    return img


def render_backward(state: TimeSurfaceState, t_sync, camera: Camera,
                    cfg: TimeSurfaceConfig) -> torch.Tensor:
    """BACKWARD-mode surface at t_sync: decay at raw pixels, 8-bit levels,
    median blur, then rectify by bilinear remap (kernel K3 on the card).
    Returns (H, W) f32 with 0..255 values."""
    return remap_bilinear(_unrectified(state, t_sync, cfg), camera.inv_map,
                          fill=0.0)


def render_backward_pair(st_l: TimeSurfaceState, st_r: TimeSurfaceState,
                         t_sync, cam_l: Camera, cam_r: Camera,
                         cfg: TimeSurfaceConfig):
    """render_backward for both cameras of a rig, rectified together (one
    launch of kernel K3 on the card). Returns (left, right)."""
    return remap_bilinear_pair(_unrectified(st_l, t_sync, cfg), cam_l.inv_map,
                               _unrectified(st_r, t_sync, cfg), cam_r.inv_map,
                               fill=0.0)


def render_forward(state: TimeSurfaceState, t_sync, camera: Camera,
                   cfg: TimeSurfaceConfig) -> torch.Tensor:
    """FORWARD-mode surface: bilinear-splat each raw pixel's decayed value
    at its rectified LUT coordinate, clamp at 1."""
    H, W = state.last_t_pos.shape
    val, has_event = _decayed(state, t_sync, cfg.decay_sec,
                              cfg.ignore_polarity)
    u, v = camera.lut[..., 0], camera.lut[..., 1]
    ok = has_event & (u >= 0) & (v >= 0) & (torch.floor(u) + 1 < W) \
        & (torch.floor(v) + 1 < H)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    fu = u - u0
    fv = v - v0
    w = torch.where(ok, val, torch.zeros_like(val))
    u0c = torch.clamp(u0, 0, W - 1)
    v0c = torch.clamp(v0, 0, H - 1)
    u1c = torch.clamp(u0 + 1, 0, W - 1)
    v1c = torch.clamp(v0 + 1, 0, H - 1)
    acc = torch.zeros(H * W, dtype=val.dtype, device=val.device)
    for idx, wt in ((v0c * W + u0c, w * (1 - fu) * (1 - fv)),
                    (v0c * W + u1c, w * fu * (1 - fv)),
                    (v1c * W + u0c, w * (1 - fu) * fv),
                    (v1c * W + u1c, w * fu * fv)):
        acc.index_add_(0, idx.reshape(-1), wt.reshape(-1))
    acc = torch.clamp(acc.reshape(H, W), max=1.0)
    img = _to_8bit_levels(acc, cfg.ignore_polarity)
    if cfg.median_blur_kernel_size > 0:
        img = median_blur(img, cfg.median_blur_kernel_size)
    return img


def roll_ticks(state: TimeSurfaceState, frames: EventBatch,
               sync_times: torch.Tensor, camera: Camera,
               cfg: TimeSurfaceConfig):
    """Apply K event frames (leading K axis) and render K surfaces.
    Returns (new_state, surfaces (K, H, W))."""
    render = render_backward if cfg.mode == "backward" else render_forward
    surfaces = []
    for k in range(sync_times.shape[0]):
        ev = EventBatch(x=frames.x[k], y=frames.y[k], t=frames.t[k],
                        p=frames.p[k], valid=frames.valid[k])
        state = insert_events(state, ev)
        surfaces.append(render(state, sync_times[k], camera, cfg))
    return state, torch.stack(surfaces)

