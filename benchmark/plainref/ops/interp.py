"""Frozen copy of esvo_tpu_torch/ops/interp.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Batched bilinear patch interpolation (port of esvo_tpu/ops/interp.py).

Semantics match the reference's patchInterpolation: the patch is anchored
at ``floor(location) - (w - 1) / 2``; validity requires the (wy+1, wx+1)
source window to lie inside the image (``upleft >= 0`` and
``upleft + w < size`` on both axes).
"""
from __future__ import annotations

import torch


def gather2d(img: torch.Tensor, yi: torch.Tensor,
             xi: torch.Tensor) -> torch.Tensor:
    """img[yi, xi] through one flat gather (indices clamped to the image,
    as jnp.take(mode="clip") does)."""
    H, W = img.shape
    idx = torch.clamp(yi.long() * W + xi.long(), 0, H * W - 1)
    return img.reshape(-1)[idx]


def slice_patches(img: torch.Tensor, ul_y: torch.Tensor, ul_x: torch.Tensor,
                  h: int, w: int) -> torch.Tensor:
    """Extract (h, w) blocks of img at integer upper-left corners.

    Two semantics, exactly as in the JAX package:
    - 8-row-aligned f32 windows (h*w > 64, h % 8 == 0) of a CUDA image go
      to kernel K1, which clamps each window's START into the image;
    - every other call (and every CPU call) is one flat gather that
      clamps each ELEMENT's index (edge replication).
    They agree for in-range starts; every caller on the mapping path
    clips its origins first."""
    shape = tuple(ul_y.shape)
    uy = ul_y.reshape(-1)
    ux = ul_x.reshape(-1)
    H, W = img.shape
    dev = img.device
    yy = torch.clamp(uy.long()[:, None, None]
                     + torch.arange(h, device=dev)[None, :, None], 0, H - 1)
    xx = torch.clamp(ux.long()[:, None, None]
                     + torch.arange(w, device=dev)[None, None, :], 0, W - 1)
    out = img.reshape(-1)[yy * W + xx]
    return out.reshape(shape + (h, w))


def slice_patches_pair(img_a: torch.Tensor, ul_y_a: torch.Tensor,
                       ul_x_a: torch.Tensor, img_b: torch.Tensor,
                       ul_y_b: torch.Tensor, ul_x_b: torch.Tensor, h: int,
                       w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """slice_patches on two images. Where slice_patches would send both
    to kernel K1 and the images share a shape, one K1 launch takes both;
    otherwise each goes its own way, as two slice_patches calls."""
    return (slice_patches(img_a, ul_y_a, ul_x_a, h, w),
            slice_patches(img_b, ul_y_b, ul_x_b, h, w))


def patch_interpolate(img: torch.Tensor, loc: torch.Tensor, wy: int, wx: int):
    """(wy, wx) bilinear patches of img centred at sub-pixel loc (..., 2)
    as (x, y). Returns (patch (..., wy, wx), ok (...,))."""
    H, W = img.shape
    hx = (wx - 1) // 2
    hy = (wy - 1) // 2
    x = loc[..., 0]
    y = loc[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ul_x = x0.to(torch.int32) - hx
    ul_y = y0.to(torch.int32) - hy
    ok = (ul_x >= 0) & (ul_y >= 0) & (ul_x + wx < W) & (ul_y + wy < H)
    src = slice_patches(img, ul_y, ul_x, wy + 1, wx + 1)
    fx = (x - x0)[..., None, None]
    fy = (y - y0)[..., None, None]
    r = (1.0 - fx) * src[..., :, :wx] + fx * src[..., :, 1:]
    patch = (1.0 - fy) * r[..., :wy, :] + fy * r[..., 1:, :]
    return patch, ok


def bilinear_sample(img: torch.Tensor, loc: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Plain bilinear point sample of img (H, W) at (x, y) locations
    (..., 2), `fill` outside the valid interpolation domain."""
    patch, ok = patch_interpolate(img, loc, 1, 1)
    val = patch[..., 0, 0]
    return torch.where(ok, val, torch.full_like(val, fill))
