"""K6: block matching's disparity scan in one launch.

Counterpart of the fused XLA program of esvo_tpu/mapping/block_matching.py's
``_match_horizontal`` (its scan over disparities; not a Pallas kernel).
``best_disparity`` launches the CUDA kernel (csrc/block_match.cu) on CUDA
tensors; its plain twin is
``mapping/block_matching.py::best_disparity_plain``, which that module's
``best_disparity`` runs for CPU tensors (and, by configuration, for the
"matmul" volume, dtypes other than float32 and strips too wide for a
block). On the card the kernel equals the twin bit for bit.

``launch_plan`` picks the kernel's instantiation: one warp an event, T
consecutive disparities a lane, ``block_match_kernel<WY, WX, T>`` for the
patches in ``PATCHES`` (the window in registers) and
``block_match_kernel<0, 0, 1>`` for any other.

The wrapper allocates its outputs with ``torch.empty``, sets no
attribute and never syncs the host, so a CUDA graph captures it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from esvo_tpu_torch.ops import _build
from esvo_tpu_torch.ops._build import CudaKernel, require

KERNEL = CudaKernel("block_match.cu", "esvo_block_match",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9)

# the shared memory a block takes without the opt-in attribute
MAX_SHARED_BYTES = 48 * 1024
# the (wy, wx) patches with an instantiation of their own: 7x15 (both
# presets) and 15x7 (up_down's swapped patch)
PATCHES = ((7, 15), (15, 7))
# disparities a lane (csrc/block_match.cu's BM_T_MIN, BM_T_MAX), events
# a block at most (BM_MAX_WARPS)
T_MIN, T_MAX = 2, 5
MAX_EVENTS_PER_BLOCK = 4

_INFO: dict = {}


def shared_bytes(wy: int, wx: int, n_disp: int) -> int:
    """Shared memory one event (a warp) stages for a (wy, wx) patch over
    n_disp disparities: the left window (whole float4s), its three column
    sums, the right strip's two column sums and the strip of wx + n_disp
    - 1 columns, rounded up to whole float4s (csrc/block_match.cu's
    bm_warp_floats)."""
    sw = wx + n_disp - 1
    n = -(-wy * wx // 4) * 4 + 3 * wx + 2 * sw + wy * sw
    return 4 * (-(-n // 4) * 4)


def launch_plan(wy: int, wx: int, n_disp: int) -> dict:
    """K6's launch for a (wy, wx) patch over n_disp disparities: the
    instantiation (``patch`` "7x15" / "15x7", or "generic" for any other
    patch), T disparities a lane (ceil(n_disp / 32) within [T_MIN,
    T_MAX]; 1 for the generic one), passes of 32 T disparities, events
    (warps) a block (as many as fit 48 KB, at most 4), threads and
    shared bytes a block."""
    own = (wy, wx) in PATCHES
    t = max(T_MIN, min(T_MAX, math.ceil(n_disp / 32))) if own else 1
    per_event = shared_bytes(wy, wx, n_disp)
    events = max(1, min(MAX_EVENTS_PER_BLOCK, MAX_SHARED_BYTES // per_event))
    name = f"block_match_kernel<{wy}, {wx}, {t}>" if own \
        else "block_match_kernel<0, 0, 1>"
    return dict(instantiation=name, patch=f"{wy}x{wx}" if own else "generic",
                T=t, passes=math.ceil(n_disp / (32 * t)),
                events_per_block=events, threads=32 * events,
                shared_bytes=events * per_event)


def kernel_info(wy: int, wx: int, n_disp: int, device=None) -> dict:
    """The plan's instantiation as the CUDA runtime reports it: blocks an
    SM holds, registers and local (spill) bytes a thread, shared bytes a
    block, beside ``launch_plan``'s fields."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (wy, wx, n_disp, index)
    if key not in _INFO:
        plan = launch_plan(wy, wx, n_disp)
        fn = _build._load(KERNEL.source).esvo_block_match_kernel_info
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            err = fn(wy, wx, plan["T"], plan["events_per_block"], n_disp,
                     ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"esvo_block_match_kernel_info failed: CUDA "
                               f"error {err}")
        _INFO[key] = dict(plan, blocks_per_sm=out[0], registers=out[1],
                          local_bytes=out[2], smem_bytes=out[3])
    return _INFO[key]


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
        raise ValueError(f"K6 stages a strip of {nbytes} bytes an event, "
                         f"more than a block's {MAX_SHARED_BYTES}")


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
        plan = launch_plan(2 * hy + 1, 2 * hx + 1, dmax - dmin + 1)
        KERNEL.launch(*args, best, cost, dark, H, W, N, dmin, dmax, hy, hx,
                      plan["T"], plan["events_per_block"])
    return best, cost, dark
