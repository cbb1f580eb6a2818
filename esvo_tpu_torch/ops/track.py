"""K4: the tracker's whole LM scan (10 rounds) in one launch.

Counterpart of the fused XLA scan of esvo_tpu/tracking/registration.py's
``solve`` (not a Pallas kernel). ``track_solve`` launches the CUDA kernel
(csrc/track.cu) on CUDA tensors; its plain twin is
``tracking/registration.py::solve_plain``, which ``registration.solve``
runs for CPU tensors (and, by configuration, for the numerical Jacobian
and for dtypes other than float32).

The wrapper copies the pose views into contiguous tensors, passes bool
tensors as bytes, allocates its outputs with ``torch.empty`` and never
syncs the host, so a CUDA graph captures it.
"""
from __future__ import annotations

import ctypes

import torch

from esvo_tpu_torch.ops import _build
from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel("track.cu", "esvo_track_solve",
                    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                    + [ctypes.c_float] * 2)
_INFO: dict = {}


def check_inputs(R, t, T_world_ref, points, point_valid, ts_negative,
                 grad_u, grad_v, P, mask) -> None:
    """The dtypes and shapes the kernel takes, on any device: float32
    poses, points (M, 3), bool point_valid (M,), float32 (H, W) surfaces,
    P (3, 4) and a bool (H, W) mask. Raises TypeError / ValueError."""
    H, W = ts_negative.shape if ts_negative.dim() == 2 else (-1, -1)
    M = points.shape[0] if points.dim() == 2 else -1
    want = [(R, "R", torch.float32, (3, 3)), (t, "t", torch.float32, (3,)),
            (T_world_ref, "T_world_ref", torch.float32, (4, 4)),
            (points, "points", torch.float32, (M, 3)),
            (point_valid, "point_valid", torch.bool, (M,)),
            (ts_negative, "ts_negative", torch.float32, (H, W)),
            (grad_u, "grad_u", torch.float32, (H, W)),
            (grad_v, "grad_v", torch.float32, (H, W)),
            (P, "P", torch.float32, (3, 4)),
            (mask, "mask", torch.bool, (H, W))]
    for a, name, dtype, shape in want:
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if -1 in shape or tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}; K4 takes "
                             "points (M, 3), point_valid (M,) and (H, W) "
                             "surfaces and mask")
        if a.device != ts_negative.device:
            raise ValueError(f"{name} is on {a.device}, the surfaces on "
                             f"{ts_negative.device}")
    if H < 2 or W < 2:
        raise ValueError(f"surfaces of {H}x{W}: K4 needs at least 2x2")


def track_solve(R, t, T_world_ref, points, point_valid, ts_negative, grad_u,
                grad_v, P, mask, *, batch_size: int, max_iteration: int,
                huber: bool, huber_threshold: float, lm_damping: float):
    """max_iteration one-step LM rounds from (R, t) = T_ref_left over
    rotating batches of the (M, 3) ref-frame points, as
    registration.solve_plain runs them with the analytic Jacobian.
    Returns (R (3, 3), t (3,), T_world_cur (4, 4), rms
    (max_iteration,)). CUDA tensors only: a CPU tensor raises."""
    check_inputs(R, t, T_world_ref, points, point_valid, ts_negative, grad_u,
                 grad_v, P, mask)
    if batch_size < 1 or max_iteration < 0:
        raise ValueError(f"batch_size {batch_size}, max_iteration "
                         f"{max_iteration}")
    args = [R.contiguous(), t.contiguous(), T_world_ref.contiguous(),
            points.contiguous(), point_valid.contiguous().view(torch.uint8),
            ts_negative.contiguous(), grad_u.contiguous(),
            grad_v.contiguous(), P.contiguous(),
            mask.contiguous().view(torch.uint8)]
    # every input lies on the surfaces' device (check_inputs)
    require(args[5], "ts_negative", torch.float32)
    H, W = ts_negative.shape
    out = torch.empty(9 + 3 + 16 + max_iteration, dtype=torch.float32,
                      device=ts_negative.device)
    R_out, t_out = out[:9].view(3, 3), out[9:12]
    T_out, rms = out[12:28].view(4, 4), out[28:]
    KERNEL.launch(*args, R_out, t_out, T_out, rms, points.shape[0], H, W,
                  batch_size, max_iteration, int(bool(huber)),
                  float(huber_threshold), float(lm_damping))
    return R_out, t_out, T_out, rms


def kernel_info(device=None) -> dict:
    """The kernel as the CUDA runtime reports it: registers and local
    (spill) bytes a thread, static shared bytes, threads of its one
    block, and the blocks an SM could hold (it launches one)."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _INFO:
        fn = _build._load(KERNEL.source).esvo_track_kernel_info
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(index):
            err = fn(ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"esvo_track_kernel_info failed: CUDA error "
                               f"{err}")
        _INFO[index] = dict(name="track_solve_kernel", registers=out[0],
                            local_bytes=out[1], smem_bytes=out[2],
                            threads=out[3], blocks_per_sm=out[4])
    return _INFO[index]
