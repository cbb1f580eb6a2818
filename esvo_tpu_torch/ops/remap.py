"""K3: bilinear remap through a fixed full-image map.

Counterpart of esvo_tpu/ops/pallas_remap.py (without its TPU band plan).
``remap`` (one camera) and ``remap_pair`` (both cameras of a rig, one
launch) launch the CUDA kernel (csrc/remap.cu) for CUDA tensors and run
the plain twin ``remap_plain`` for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel("remap.cu", "esvo_remap",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3)


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


def _check_camera(img: torch.Tensor, map_xy: torch.Tensor, H: int, W: int,
                  tag: str = "") -> None:
    require(img, "img" + tag, torch.float32, (H, W))
    require(map_xy, "map_xy" + tag, torch.float32, (H, W, 2))
    if map_xy.data_ptr() % 16:
        raise ValueError(f"map_xy{tag} must be 16-byte aligned (the kernel "
                         "loads two pixels' coordinates at once)")


def pair_outputs(H: int, W: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Two (H, W) outputs from one buffer, each starting on a 16-byte
    boundary (the kernel's vector stores)."""
    n = H * W
    stride = -(-n // 4) * 4
    buf = torch.empty(2 * stride, dtype=torch.float32, device=device)
    return buf[:n].view(H, W), buf[stride:stride + n].view(H, W)


def remap(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """remap_plain(img, map_xy, fill=0) for a full (H, W, 2) map: kernel
    K3 on a CUDA tensor, the plain twin on a CPU tensor."""
    if not img.is_cuda:
        return remap_plain(img, map_xy, 0.0)
    H, W = img.shape
    _check_camera(img, map_xy, H, W)
    out = torch.empty((H, W), dtype=torch.float32, device=img.device)
    KERNEL.launch(img, map_xy, out, None, None, None, 1, H, W)
    return out


def remap_pair(img_a: torch.Tensor, map_a: torch.Tensor, img_b: torch.Tensor,
               map_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """remap on two cameras' images of one (H, W): one launch of K3 for
    CUDA tensors, two calls of the twin for CPU tensors."""
    if not img_a.is_cuda:
        return remap_plain(img_a, map_a, 0.0), remap_plain(img_b, map_b, 0.0)
    H, W = img_a.shape
    if img_b.device != img_a.device:
        raise ValueError(f"images on {img_a.device} and {img_b.device}: the "
                         "pair takes one device")
    _check_camera(img_a, map_a, H, W, "_a")
    _check_camera(img_b, map_b, H, W, "_b")
    out_a, out_b = pair_outputs(H, W, img_a.device)
    KERNEL.launch(img_a, map_a, out_a, img_b, map_b, out_b, 2, H, W)
    return out_a, out_b
