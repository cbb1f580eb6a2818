"""K1: batched (h, w) window copy at clamped integer starts.

Counterpart of esvo_tpu/ops/pallas_patches.py. ``slice_patches`` launches
the CUDA kernel (csrc/patches.cu) for a CUDA tensor and runs the plain
twin ``slice_patches_plain`` for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel(
    "patches.cu", "esvo_slice_patches",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)


def slice_patches_plain(img: torch.Tensor, ul_y: torch.Tensor,
                        ul_x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N,) upper-left corners -> (N, h, w) windows; starts clamped to
    [0, H-h] x [0, W-w] like lax.dynamic_slice."""
    H, W = img.shape
    y0 = torch.clamp(ul_y.long(), 0, H - h)
    x0 = torch.clamp(ul_x.long(), 0, W - w)
    dev = img.device
    rows = y0[:, None, None] + torch.arange(h, device=dev)[None, :, None]
    cols = x0[:, None, None] + torch.arange(w, device=dev)[None, None, :]
    return img[rows, cols]


def slice_patches(img: torch.Tensor, ul_y: torch.Tensor, ul_x: torch.Tensor,
                  h: int, w: int) -> torch.Tensor:
    """The window copy: kernel K1 on a CUDA tensor, the plain twin on a
    CPU tensor."""
    if not img.is_cuda:
        return slice_patches_plain(img, ul_y, ul_x, h, w)
    H, W = img.shape
    n = ul_y.shape[0]
    if H < h or W < w:
        raise ValueError(f"window ({h}, {w}) larger than image ({H}, {W})")
    require(img, "img", torch.float32)
    require(ul_y, "ul_y", torch.int32, (n,))
    require(ul_x, "ul_x", torch.int32, (n,))
    out = torch.empty((n, h, w), dtype=torch.float32, device=img.device)
    KERNEL.launch(img, ul_y, ul_x, out, n, H, W, h, w)
    return out
