"""K7: the fusion fold in one launch.

Counterpart of the fused XLA program of esvo_tpu/mapping/fusion.py's
``fuse_frame`` (its slot scatter and K-step fold; not a Pallas kernel).
``fold_slots`` launches the CUDA kernel (csrc/fuse.cu) on CUDA tensors;
its plain twin is ``mapping/fusion.py::fold_slots_plain``, which that
module's ``fuse_frame`` runs for CPU tensors (and, by configuration, for
grids that are not float32). On the card the kernel equals the twin bit
for bit.

The wrapper allocates its outputs with ``torch.empty`` (the fuse count
with ``torch.zeros``) and never syncs the host, so a CUDA graph captures
it.
"""
from __future__ import annotations

import ctypes

import torch

from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel("fuse.cu", "esvo_fuse",
                    [ctypes.c_void_p] * 26 + [ctypes.c_int] * 3)

F32 = torch.float32
I32 = torch.int32


def check_inputs(grid: dict, cand: dict, slots, cam) -> None:
    """The dtypes and shapes the kernel takes, on any device: the grid's
    float32 (H, W) planes invD, var, s2, nu, res, int32 age, x (H, W, 2)
    and p (H, W, 3); the candidates' float32 (M,) channels invD, var, s2,
    nu, res, int32 age and x (M, 2); int32 slots (K, H, W); cam, Ainv
    and b as 12 float32. Raises TypeError / ValueError."""
    if grid["invD"].dim() != 2:
        raise ValueError("the grid's invD must be (H, W), got "
                         f"{tuple(grid['invD'].shape)}")
    H, W = grid["invD"].shape
    M = cand["invD"].shape[0] if cand["invD"].dim() == 1 else -1
    K = slots.shape[0] if slots.dim() == 3 else -1
    want = [(grid[k], f"grid {k}", F32, (H, W))
            for k in ("invD", "var", "s2", "nu", "res")]
    want += [(grid["age"], "grid age", I32, (H, W)),
             (grid["x"], "grid x", F32, (H, W, 2)),
             (grid["p"], "grid p", F32, (H, W, 3))]
    want += [(cand[k], f"candidate {k}", F32, (M,))
             for k in ("invD", "var", "s2", "nu", "res")]
    want += [(cand["age"], "candidate age", I32, (M,)),
             (cand["x"], "candidate x", F32, (M, 2)),
             (slots, "slots", I32, (K, H, W)), (cam, "cam", F32, (12,))]
    for a, name, dtype, shape in want:
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if -1 in shape or tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, K7 wants "
                             f"{shape}")
        if a.device != grid["invD"].device:
            raise ValueError(f"{name} is on {a.device}, the grid on "
                             f"{grid['invD'].device}")


def fold_slots(grid: dict, cand: dict, slots, cam, *, tdist: bool):
    """Fold the candidates that ``slots`` names (slot k of each pixel, -1
    empty) into the grid in slot order. ``grid`` and ``cand`` hold the
    planes named in ``check_inputs``; cam is Ainv (row-major) then b of
    the camera's P. Returns the new grid as a dict of the same planes and
    num_fused (int64, 0-d). CUDA tensors only: a CPU tensor raises."""
    check_inputs(grid, cand, slots, cam)
    g = {k: v.contiguous() for k, v in grid.items()}
    c = {k: v.contiguous() for k, v in cand.items()}
    slots = slots.contiguous()
    # every input lies on the grid's device (check_inputs)
    require(g["invD"], "grid invD", F32)
    out = {k: torch.empty_like(v) for k, v in g.items()}
    num_fused = torch.zeros((), dtype=torch.int64, device=g["invD"].device)
    H, W = g["invD"].shape
    KERNEL.launch(*(g[k] for k in ("invD", "var", "s2", "nu", "res", "age",
                                   "x", "p")),
                  *(c[k] for k in ("invD", "var", "s2", "nu", "res", "age",
                                   "x")),
                  slots, cam.contiguous(),
                  *(out[k] for k in ("invD", "var", "s2", "nu", "res", "age",
                                     "x", "p")),
                  num_fused, H * W, slots.shape[0], int(bool(tdist)))
    return out, num_fused
