"""Frozen copy of esvo_tpu_torch/ops/remap.py's plain twin of K3 (the
bilinear remap through a full-image map), without the kernel."""
from __future__ import annotations

import torch


def remap_plain(img: torch.Tensor, map_xy: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Bilinear resampling of img (H, W) at map_xy (..., 2), with `fill`
    for each tap outside the image (cv::remap BORDER_CONSTANT)."""
    H, W = img.shape
    x = map_xy[..., 0]
    y = map_xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(-1)

    def tap(yi, xi, w):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        v = flat[idx]
        return torch.where(inb, v, torch.full_like(v, fill)) * w

    return (tap(y0i, x0i, (1 - fx) * (1 - fy))
            + tap(y0i, x0i + 1, fx * (1 - fy))
            + tap(y0i + 1, x0i, (1 - fx) * fy)
            + tap(y0i + 1, x0i + 1, fx * fy))
