"""K7: the fusion fold, with its slot placement, in one launch.

Counterpart of the fused XLA program of esvo_tpu/mapping/fusion.py's
``fuse_frame`` (its slot rank, slot scatter and K-step fold; not a
Pallas kernel). ``fuse_runs`` launches the CUDA kernel (csrc/fuse.cu) on
CUDA tensors: each pixel's slots are its run of the sorted order that
``mapping/fusion.py::_sort_slots`` makes. Its plain twin is
``mapping/fusion.py::_assign_slots`` + ``fold_slots_plain``, which that
module's ``fuse_frame`` runs for CPU tensors (and, by configuration, for
grids that are not float32); ``fusion.run_bounds`` is the placement's
plain form. On the card the kernel equals the twin bit for bit.

The wrapper allocates its outputs with ``torch.empty`` (the two counts
with ``torch.zeros``) and never syncs the host, so a CUDA graph captures
it.
"""
from __future__ import annotations

import ctypes

import torch

from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel("fuse.cu", "esvo_fuse",
                    [ctypes.c_void_p] * 27 + [ctypes.c_int] * 5)

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64


def check_inputs(grid: dict, cand: dict, order, pix_sorted, cam) -> None:
    """The dtypes and shapes the kernel takes, on any device: the grid's
    float32 (H, W) planes invD, var, s2, nu, res, int32 age, x (H, W, 2)
    and p (H, W, 3); the M candidates' float32 (M,) channels invD, var,
    s2, nu, res, int32 age and x (M, 2); int64 order and pix_sorted of
    one length, a whole number of tiles a candidate (M * Kt); cam, Ainv
    and b as 12 float32. Raises TypeError / ValueError."""
    if grid["invD"].dim() != 2:
        raise ValueError("the grid's invD must be (H, W), got "
                         f"{tuple(grid['invD'].shape)}")
    H, W = grid["invD"].shape
    M = cand["invD"].shape[0] if cand["invD"].dim() == 1 else -1
    n = order.shape[0] if order.dim() == 1 else -1
    want = [(grid[k], f"grid {k}", F32, (H, W))
            for k in ("invD", "var", "s2", "nu", "res")]
    want += [(grid["age"], "grid age", I32, (H, W)),
             (grid["x"], "grid x", F32, (H, W, 2)),
             (grid["p"], "grid p", F32, (H, W, 3))]
    want += [(cand[k], f"candidate {k}", F32, (M,))
             for k in ("invD", "var", "s2", "nu", "res")]
    want += [(cand["age"], "candidate age", I32, (M,)),
             (cand["x"], "candidate x", F32, (M, 2)),
             (order, "order", I64, (n,)),
             (pix_sorted, "pix_sorted", I64, (n,)), (cam, "cam", F32, (12,))]
    for a, name, dtype, shape in want:
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if -1 in shape or tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, K7 wants "
                             f"{shape}")
        if a.device != grid["invD"].device:
            raise ValueError(f"{name} is on {a.device}, the grid on "
                             f"{grid['invD'].device}")
    if (M == 0) != (n == 0) or (M and n % M):
        raise ValueError(f"{n} sorted entries are no whole number of tiles "
                         f"of {M} candidates")
    if n >= 2 ** 31:
        raise ValueError(f"{n} sorted entries: K7 indexes them with int32")


def fuse_runs(grid: dict, cand: dict, order, pix_sorted, cam, *, K: int,
              tdist: bool):
    """Fold into each pixel the first min(run, K) candidates of its run
    of the sorted order (``order``: tiled ids, candidate id * Kt + tile;
    ``pix_sorted``: their pixels, ascending, H * W for an invalid one).
    ``grid`` and ``cand`` hold the planes named in ``check_inputs``; cam
    is Ainv (row-major) then b of the camera's P. Returns the new grid as
    a dict of the same planes, num_fused and num_dropped (int64, 0-d).
    CUDA tensors only: a CPU tensor raises."""
    check_inputs(grid, cand, order, pix_sorted, cam)
    g = {k: v.contiguous() for k, v in grid.items()}
    c = {k: v.contiguous() for k, v in cand.items()}
    # every input lies on the grid's device (check_inputs)
    require(g["invD"], "grid invD", F32)
    out = {k: torch.empty_like(v) for k, v in g.items()}
    counts = torch.zeros(2, dtype=I64, device=g["invD"].device)
    H, W = g["invD"].shape
    M, n = c["invD"].shape[0], order.shape[0]
    KERNEL.launch(*(g[k] for k in ("invD", "var", "s2", "nu", "res", "age",
                                   "x", "p")),
                  *(c[k] for k in ("invD", "var", "s2", "nu", "res", "age",
                                   "x")),
                  order.contiguous(), pix_sorted.contiguous(),
                  cam.contiguous(),
                  *(out[k] for k in ("invD", "var", "s2", "nu", "res", "age",
                                     "x", "p")),
                  counts, H * W, K, n // M if M else 1, n, int(bool(tdist)))
    return out, counts[0], counts[1]
