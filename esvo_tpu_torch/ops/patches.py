"""K1: batched (h, w) window copy at clamped integer starts.

Counterpart of esvo_tpu/ops/pallas_patches.py. ``slice_patches`` (one
image) and ``slice_patches_pair`` (two images of one shape, one launch)
launch the CUDA kernel (csrc/patches.cu) for CUDA tensors and run the
plain twin ``slice_patches_plain`` for CPU tensors.

The kernel is persistent, one warp per window. The launcher picks its
instantiation (the runs of columns a lane owns) from the window shape;
``patches_launch_plan`` sizes its grid to what the card holds at once
(``kernel_info`` asks the CUDA occupancy calculator).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from esvo_tpu_torch.ops import _build
from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel(
    "patches.cu", "esvo_slice_patches",
    ([ctypes.c_void_p] * 4 + [ctypes.c_int]) * 2 + [ctypes.c_int] * 5)

_INFO: dict = {}   # kernel_info per (window shape, device)


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


def patches_launch_plan(n: int, sms: int, blocks_per_sm: int,
                        warps: int) -> int:
    """The grid for n windows: what the card holds at once (sms x
    blocks_per_sm blocks of `warps` warps, as ``kernel_info`` reports
    them), never more warps than windows, and 0 for n = 0."""
    return min(-(-n // warps), sms * blocks_per_sm)


def kernel_info(h: int, w: int, device=None) -> dict:
    """The kernel's instantiation for (h, w) windows as the CUDA runtime
    reports it on the device (once): its window plan (``rpl`` runs of
    ``vec`` columns a lane in bands of ``band_rows`` rows, csrc/patches.cu
    ``window_plan``), blocks an SM holds, registers and local (spill) bytes
    a thread, warps a block, the card's SMs. Raises ValueError where the
    kernel cannot take the shape."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (h, w, index)
    if key not in _INFO:
        fn = _build._load(KERNEL.source).esvo_patches_kernel_info
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 7)()
        with torch.cuda.device(index):
            err = fn(h, w, ctypes.addressof(out))
        if err == 1:    # cudaErrorInvalidValue: no plan for the shape
            raise ValueError(f"K1 takes windows of at least one row and "
                             f"1..1024 columns, got ({h}, {w})")
        if err != 0:
            raise RuntimeError(f"esvo_patches_kernel_info failed: CUDA error "
                               f"{err}")
        _INFO[key] = dict(
            name=f"slice_patches_kernel<{out[4]}, {out[5]}>", rpl=out[4],
            vec=out[5], band_rows=out[6], blocks_per_sm=out[0],
            registers=out[1], local_bytes=out[2], warps=out[3],
            sms=torch.cuda.get_device_properties(index).multi_processor_count)
    return _INFO[key]


@functools.lru_cache(maxsize=64)
def _grid(h: int, w: int, n: int, index: int) -> int:
    """patches_launch_plan on the device's kernel_info, per shape."""
    info = kernel_info(h, w, index)
    return patches_launch_plan(n, info["sms"], info["blocks_per_sm"],
                               info["warps"])


def _check_group(img, ul_y, ul_x, h, w, tag=""):
    H, W = img.shape
    if H < h or W < w:
        raise ValueError(f"window ({h}, {w}) larger than image ({H}, {W})")
    n = ul_y.shape[0]
    require(img, "img" + tag, torch.float32)
    require(ul_y, "ul_y" + tag, torch.int32, (n,))
    require(ul_x, "ul_x" + tag, torch.int32, (n,))
    return n


def slice_patches(img: torch.Tensor, ul_y: torch.Tensor, ul_x: torch.Tensor,
                  h: int, w: int) -> torch.Tensor:
    """The window copy: kernel K1 on a CUDA tensor, the plain twin on a
    CPU tensor."""
    if not img.is_cuda:
        return slice_patches_plain(img, ul_y, ul_x, h, w)
    n = _check_group(img, ul_y, ul_x, h, w)
    H, W = img.shape
    out = torch.empty((n, h, w), dtype=torch.float32, device=img.device)
    if n:
        KERNEL.launch(img, ul_y, ul_x, out, n, None, None, None, None, 0,
                      H, W, h, w, _grid(h, w, n, img.device.index))
    return out


def slice_patches_pair(img_a: torch.Tensor, ul_y_a: torch.Tensor,
                       ul_x_a: torch.Tensor, img_b: torch.Tensor,
                       ul_y_b: torch.Tensor, ul_x_b: torch.Tensor, h: int,
                       w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """slice_patches on two images of one (H, W): one launch of K1 for
    CUDA tensors, two calls of the twin for CPU tensors. Returns the two
    (n_a, h, w) and (n_b, h, w) windows, contiguous halves of one
    buffer."""
    if not img_a.is_cuda:
        return (slice_patches_plain(img_a, ul_y_a, ul_x_a, h, w),
                slice_patches_plain(img_b, ul_y_b, ul_x_b, h, w))
    if img_a.shape != img_b.shape or img_a.device != img_b.device:
        raise ValueError(f"images of shapes {tuple(img_a.shape)} and "
                         f"{tuple(img_b.shape)} on {img_a.device} and "
                         f"{img_b.device}: the pair takes one shape on one "
                         "device")
    na = _check_group(img_a, ul_y_a, ul_x_a, h, w, "_a")
    nb = _check_group(img_b, ul_y_b, ul_x_b, h, w, "_b")
    H, W = img_a.shape
    out = torch.empty((na + nb, h, w), dtype=torch.float32,
                      device=img_a.device)
    if na + nb:
        KERNEL.launch(img_a, ul_y_a, ul_x_a, out, na, img_b, ul_y_b, ul_x_b,
                      out[na:], nb, H, W, h, w,
                      _grid(h, w, na + nb, img_a.device.index))
    return out[:na], out[na:]
