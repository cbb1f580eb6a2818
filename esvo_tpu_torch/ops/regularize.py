"""K5: inverse-depth map regularization in one launch.

Counterpart of the fused XLA scan of esvo_tpu/mapping/regularization.py's
``regularize`` (not a Pallas kernel). ``regularize`` launches the CUDA
kernel (csrc/regularize.cu) on CUDA tensors; its plain twin is
``mapping/regularization.py::regularize_plain``, which that module's
``regularize`` runs for CPU tensors. On the card the kernel equals the
twin bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel("regularize.cu", "esvo_regularize",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_float])

# the kernel's tile (csrc/regularize.cu REG_TX x REG_TY) and the shared
# memory a block can take on Hopper
TILE = (32, 8)
MAX_SHARED_BYTES = 232448


def shared_bytes(radius: int) -> int:
    """Dynamic shared memory a block stages for `radius`: the tile and its
    halo, four float planes and the valid bytes."""
    return (TILE[0] + 2 * radius) * (TILE[1] + 2 * radius) * 17


def check_inputs(valid, invD, var, scale2, nu, radius: int) -> None:
    """The dtypes and shapes the kernel takes, on any device: a bool
    (H, W) valid plane, float32 (H, W) planes, a radius whose halo fits
    in a block's shared memory. Raises TypeError / ValueError."""
    shape = tuple(invD.shape)
    if len(shape) != 2:
        raise ValueError(f"invD must be (H, W), got {shape}")
    for a, name, dtype in ((valid, "valid", torch.bool),
                           (invD, "invD", torch.float32),
                           (var, "variance", torch.float32),
                           (scale2, "scale2", torch.float32),
                           (nu, "nu", torch.float32)):
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, invD "
                             f"{shape}")
        if a.device != invD.device:
            raise ValueError(f"{name} is on {a.device}, invD on "
                             f"{invD.device}")
    if radius < 0 or shared_bytes(radius) > MAX_SHARED_BYTES:
        raise ValueError(f"radius {radius}: K5 stages a halo of at most "
                         f"{MAX_SHARED_BYTES} bytes a block")


def regularize(valid, invD, var, scale2, nu, *, radius: int, tdist: bool,
               min_neighbours: int, min_close_neighbours: int
               ) -> torch.Tensor:
    """The regularized (H, W) inverse depth (regularize_plain's
    new_invD). CUDA tensors only: a CPU tensor raises."""
    check_inputs(valid, invD, var, scale2, nu, radius)
    args = [valid.contiguous().view(torch.uint8), invD.contiguous(),
            var.contiguous(), scale2.contiguous(), nu.contiguous()]
    # every plane lies on invD's device (check_inputs)
    require(args[1], "invD", torch.float32)
    H, W = invD.shape
    out = torch.empty((H, W), dtype=torch.float32, device=invD.device)
    KERNEL.launch(*args, out, H, W, radius, int(bool(tdist)),
                  min_neighbours, min_close_neighbours, 1e-20)
    return out
