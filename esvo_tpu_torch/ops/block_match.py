"""K6: block matching's disparity scan in one launch.

Counterpart of the fused XLA program of esvo_tpu/mapping/block_matching.py's
``_match_horizontal`` (its scan over disparities; not a Pallas kernel).
``best_disparity`` launches the CUDA kernel (csrc/block_match.cu) on CUDA
tensors; its plain twin is
``mapping/block_matching.py::best_disparity_plain``, which that module's
``best_disparity`` runs for CPU tensors (and, by configuration, for the
"matmul" volume, dtypes other than float32 and strips too wide for a
block). On the card the kernel equals the twin bit for bit.

The wrapper allocates its outputs with ``torch.empty``, sets no
attribute and never syncs the host, so a CUDA graph captures it.
"""
from __future__ import annotations

import ctypes

import torch

from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel("block_match.cu", "esvo_block_match",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7)

# the shared memory a block takes without the opt-in attribute
MAX_SHARED_BYTES = 48 * 1024


def shared_bytes(wy: int, wx: int, n_disp: int) -> int:
    """Shared memory a block stages for a (wy, wx) patch over n_disp
    disparities: the left window, the right strip of wx + n_disp - 1
    columns, the column sums and the argmin's per-warp slots (as
    csrc/block_match.cu lays them out)."""
    sw = wx + n_disp - 1
    return 4 * (wy * wx + wy * sw + 2 * sw + 3 * wx + 2 + 64)


def check_inputs(ts_left, ts_right, ui, vi, dmin: int, dmax: int, hy: int,
                 hx: int) -> None:
    """The dtypes and shapes the kernel takes, on any device: float32
    (H, W) surfaces, int64 (N,) event columns and rows, 0 <= dmin <=
    dmax, and a strip that fits a block's shared memory. Raises
    TypeError / ValueError."""
    if ts_left.dim() != 2:
        raise ValueError(f"ts_left must be (H, W), got {tuple(ts_left.shape)}")
    shape = tuple(ts_left.shape)
    n = ui.shape[0] if ui.dim() == 1 else -1
    for a, name, dtype, want in ((ts_left, "ts_left", torch.float32, shape),
                                 (ts_right, "ts_right", torch.float32, shape),
                                 (ui, "ui", torch.int64, (n,)),
                                 (vi, "vi", torch.int64, (n,))):
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if n < 0 or tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}; K6 takes "
                             "(H, W) surfaces and (N,) ui / vi")
        if a.device != ts_left.device:
            raise ValueError(f"{name} is on {a.device}, ts_left on "
                             f"{ts_left.device}")
    if not (0 <= dmin <= dmax and hy >= 0 and hx >= 0):
        raise ValueError(f"disparities [{dmin}, {dmax}], half patch "
                         f"({hy}, {hx})")
    nbytes = shared_bytes(2 * hy + 1, 2 * hx + 1, dmax - dmin + 1)
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"K6 stages a strip of {nbytes} bytes a block, more "
                         f"than {MAX_SHARED_BYTES}")


def best_disparity(ts_left, ts_right, ui, vi, *, dmin: int, dmax: int,
                   hy: int, hx: int):
    """Each event's argmin disparity index into [dmin, dmax] (int64), its
    ZNCC cost (1.0 where the disparity leaves the image) and the box of
    (ts_left < 1) at the event: best_disparity_plain's outputs. CUDA
    tensors only: a CPU tensor raises."""
    check_inputs(ts_left, ts_right, ui, vi, dmin, dmax, hy, hx)
    args = [ts_left.contiguous(), ts_right.contiguous(), ui.contiguous(),
            vi.contiguous()]
    # every input lies on ts_left's device (check_inputs)
    require(args[0], "ts_left", torch.float32)
    H, W = ts_left.shape
    N = ui.shape[0]
    dev = ts_left.device
    best = torch.empty(N, dtype=torch.int64, device=dev)
    cost = torch.empty(N, dtype=torch.float32, device=dev)
    dark = torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        KERNEL.launch(*args, best, cost, dark, H, W, N, dmin, dmax, hy, hx)
    return best, cost, dark
