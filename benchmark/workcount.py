"""Least work of a kernel's call and the card's published peaks: the
roofline yardstick, frozen from chip_smoke.py (``bound``,
``_track_work``, ``close_pairs``, K2's window bytes in ``check_lm``,
K5's operations in ``check_regularize``).

A roofline share is the least time these counts allow, divided by the
kernel's device time a launch, in percent.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """Least time (s) on the card: bytes at HBM bandwidth or float32
    operations outside the tensor cores, whichever takes longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def track_work(n_points: int, n_valid: int, batch_size: int,
               rounds: int) -> tuple[int, int]:
    """(bytes, flops) of one K4 launch on M = n_points selected points of
    which the first n_valid are valid (the selection puts valid points
    first): each point of the visited non-empty batches once (12 B + its
    valid byte), the valid byte of the other visited points, per point
    and non-empty round 16 surface taps (floats) and 3 mask bytes, the
    outputs; ~250 flops per point and non-empty round and ~400 per
    non-empty round (the 6x6 algebra). An empty round costs nothing."""
    M = n_points
    B = min(batch_size, M)
    nb = max(M // batch_size, 1)
    starts = [min((it % nb) * batch_size, M - B) for it in range(rounds)]
    full = [s for s in starts if s < n_valid]
    used = {i for s in set(full) for i in range(s, s + B)}
    seen = {i for s in set(starts) for i in range(s, s + B)}
    nbytes = len(used) * 13 + len(seen - used) \
        + len(full) * B * (16 * 4 + 3) + (28 + rounds) * 4
    return nbytes, len(full) * (B * 250 + 400)


def lm_bytes(n: int, Wy: int, Wx: int) -> int:
    """K2's bytes for n events: both surfaces' (Wy, Wx) windows read
    once, the per-event inputs (3 + 4 + 12 words) and 33 shared words in,
    3 words out an event."""
    return 2 * n * Wy * Wx * 4 + n * (3 + 4 + 12) * 4 + 33 * 4 + 3 * n * 4


def lm_window(patch_y: int, patch_x: int, margin: int) -> tuple[int, int]:
    """depth_refinement._window_shape."""
    return patch_y + 1 + 2 * margin, patch_x + 1 + 2 * margin


def close_pairs(occupied: torch.Tensor, inv_depth: torch.Tensor,
                variance: torch.Tensor, r: int) -> int:
    """(valid centre, close neighbour) pairs over the (2r+1)^2 windows:
    the pairs the Tdist fold updates on (regularize_plain's `close`)."""
    H, W = inv_depth.shape
    std2 = 2.0 * torch.sqrt(torch.clamp(variance, min=0.0))
    pv = F.pad(occupied, (r, r, r, r), value=False)
    pd = F.pad(inv_depth, (r, r, r, r), value=0.0)
    ps = F.pad(std2, (r, r, r, r), value=2.0)
    total = torch.zeros((), dtype=torch.int64, device=inv_depth.device)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            diff = torch.abs(inv_depth - pd[dy:dy + H, dx:dx + W])
            close = occupied & pv[dy:dy + H, dx:dx + W] & (
                (diff < std2) | (diff < ps[dy:dy + H, dx:dx + W]))
            total += close.sum()
    return int(total)


def regularize_work(n_valid: int, pairs: int, r: int, H: int, W: int,
                    tdist: bool) -> tuple[int, int]:
    """(bytes, flops) of one K5 launch: five (H, W) planes in and one
    out; ~8 operations a (valid centre, window offset) pair and 12 more a
    close pair under Tdist (3 under l2)."""
    flops = n_valid * (2 * r + 1) ** 2 * 8 + pairs * (12 if tdist else 3)
    return H * W * (1 + 4 * 4 + 4), flops
