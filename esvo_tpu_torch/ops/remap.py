"""K3: bilinear remap through a fixed full-image map.

Counterpart of esvo_tpu/ops/pallas_remap.py (without its TPU band plan).
``remap`` launches the CUDA kernel (csrc/remap.cu) for a CUDA tensor and
runs the plain twin ``remap_plain`` for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel("remap.cu", "esvo_remap",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)


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


def remap(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """remap_plain(img, map_xy, fill=0) for a full (H, W, 2) map: kernel
    K3 on a CUDA tensor, the plain twin on a CPU tensor."""
    if not img.is_cuda:
        return remap_plain(img, map_xy, 0.0)
    H, W = img.shape
    require(img, "img", torch.float32)
    require(map_xy, "map_xy", torch.float32, (H, W, 2))
    out = torch.empty((H, W), dtype=torch.float32, device=img.device)
    KERNEL.launch(img, map_xy, out, H, W)
    return out
