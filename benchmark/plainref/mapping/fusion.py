"""Frozen copy of esvo_tpu_torch/mapping/fusion.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Probabilistic depth propagation + fusion on a dense per-pixel grid
(port of esvo_tpu/mapping/fusion.py).

1. every history point is propagated into the current frame with
   first-order inverse-depth uncertainty propagation;
2. each emits 4 (fusion_radius 0) or (2r+1)^2 pixel candidates;
3. candidates are ordered by (pixel, variance, original index) — two
   stable sorts — and the best K per pixel go to per-pixel slots;
4. a K-step fold applies the reference's per-pixel rules (insert /
   compatible fuse / occlusion / replace).

On a CUDA float32 grid steps 3-4 after the sorts are one launch of
kernel K7 (ops/fuse.py, csrc/fuse.cu): one thread a pixel reads its run
of the sorted order (its slots) and folds it, bit for bit the plain twin
``_assign_slots`` + ``fold_slots_plain`` (a rank a candidate, a
(K, H, W) slot scatter and (H, W) elementwise math), which runs
everything else.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from plainref._device import constant, resolve_device
from plainref.geometry.camera import (Camera, cam_to_world, inv3,
                                            world_to_cam)
from plainref.mapping.depth_refinement import DepthEstimates

EMPTY = -1.0
# occupancy threshold shared by DepthGrid.occupied and the fuse fold
_OCC_EPS = -1e-6


@dataclass(frozen=True)
class FusionConfig:
    ls_norm: str = "Tdist"
    fusion_radius: int = 0
    max_candidates_per_pixel: int = 8


@dataclass
class DepthGrid:
    """Dense struct-of-arrays DepthMap; inv_depth == -1 marks an empty
    cell."""
    inv_depth: torch.Tensor   # (H, W)
    variance: torch.Tensor    # (H, W)
    scale2: torch.Tensor      # (H, W)
    nu: torch.Tensor          # (H, W)
    residual: torch.Tensor    # (H, W)
    age: torch.Tensor         # (H, W) int32
    x: torch.Tensor           # (H, W, 2) sub-pixel coordinate of the point
    p_cam: torch.Tensor       # (H, W, 3) point in the frame's camera

    @property
    def occupied(self) -> torch.Tensor:
        return self.inv_depth > _OCC_EPS

    def replace(self, **kw) -> "DepthGrid":
        return replace(self, **kw)


def _centers(height: int, width: int, dtype, device) -> torch.Tensor:
    gy, gx = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([gx + 0.5, gy + 0.5], dim=-1)


def empty_grid(height: int, width: int, dtype=torch.float32,
               device=None) -> DepthGrid:
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    hw = (height, width)
    return DepthGrid(
        inv_depth=torch.full(hw, EMPTY, **kw), variance=torch.zeros(hw, **kw),
        scale2=torch.zeros(hw, **kw), nu=torch.zeros(hw, **kw),
        residual=torch.zeros(hw, **kw),
        age=torch.zeros(hw, dtype=torch.int32, device=device),
        x=_centers(height, width, dtype, device),
        p_cam=torch.zeros(hw + (3,), **kw))


@dataclass
class Candidates:
    """Flat propagated-point candidates prior to the per-pixel fold."""
    inv_depth: torch.Tensor
    variance: torch.Tensor
    scale2: torch.Tensor
    nu: torch.Tensor
    residual: torch.Tensor
    age: torch.Tensor
    x: torch.Tensor        # (M, 2) propagated sub-pixel coordinate
    p_cam: torch.Tensor    # (M, 3) point in the target frame
    valid: torch.Tensor


def propagate_points(est: DepthEstimates, T_frame_world: torch.Tensor,
                     camera: Camera, cfg: FusionConfig) -> Candidates:
    """Propagate depth points into the target frame with first-order
    uncertainty propagation."""
    W, H = camera.width, camera.height
    P = camera.params.P
    T = torch.matmul(T_frame_world, est.T_world_cam)              # (N,4,4)
    p = torch.einsum("nij,nj->ni", T[:, :3, :3], est.p_cam) + T[:, :3, 3]
    x_prop = world_to_cam(P, p)
    ok = (est.valid & (x_prop[:, 0] >= 0) & (x_prop[:, 0] < W)
          & (x_prop[:, 1] >= 0) & (x_prop[:, 1] < H) & (p[:, 2] > 1e-6))
    inv_depth = 1.0 / torch.clamp(p[:, 2], min=1e-6)
    denom = ((T[:, 2, :2] * est.p_cam[:, :2]).sum(-1) + T[:, 2, 3]) \
        / est.p_cam[:, 2] + T[:, 2, 2]
    J = T[:, 2, 2] / torch.clamp(denom * denom, min=1e-20)
    J2 = J * J
    if cfg.ls_norm == "Tdist":
        nu = est.nu
        # nu = inf marks Gaussian points: propagate those by the
        # Gaussian rule (nu/(nu-2)*scale2 would be inf/inf)
        finite_nu = torch.isfinite(nu)
        scale2_t = J2 * est.scale2
        var_g = J2 * est.variance
        variance = torch.where(finite_nu, nu / (nu - 2.0) * scale2_t, var_g)
        scale2 = torch.where(finite_nu, scale2_t, var_g)
    else:
        variance = J2 * est.variance
        scale2 = variance
        nu = est.nu
    variance = torch.clamp(variance, min=1e-6)
    return Candidates(inv_depth=inv_depth, variance=variance, scale2=scale2,
                      nu=nu, residual=est.residual, age=est.age, x=x_prop,
                      p_cam=p, valid=ok)


def _splat_pixels(cand: Candidates, height: int, width: int, radius: int):
    """Each candidate's 4 (radius 0) or (2r+1)^2 target pixels: (pix,
    inb), both (M, Kt), the pixel id clamped into the image and whether
    the unclamped pixel lies inside."""
    col = torch.floor(cand.x[:, 0]).to(torch.int64)
    row = torch.floor(cand.x[:, 1]).to(torch.int64)
    if radius == 0:
        offs = [(dy, dx) for dy in (0, 1) for dx in (0, 1)]
    else:
        r = range(-radius, radius + 1)
        offs = [(dy, dx) for dy in r for dx in r]
    dev = col.device
    dy = constant(tuple(o[0] for o in offs), torch.int64, dev)
    dx = constant(tuple(o[1] for o in offs), torch.int64, dev)
    rows = row[:, None] + dy[None, :]
    cols = col[:, None] + dx[None, :]
    inb = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    pix = torch.clamp(rows, 0, height - 1) * width \
        + torch.clamp(cols, 0, width - 1)
    return pix, inb


def _splat(cand: Candidates, height: int, width: int, radius: int):
    """Expand each candidate to its 4 (radius 0) or (2r+1)^2 target
    pixels. Returns (tiled candidates, pixel ids)."""
    pix, inb = _splat_pixels(cand, height, width, radius)
    K = pix.shape[1]

    def tile(a):
        return a.repeat_interleave(K, dim=0)

    tiled = Candidates(
        inv_depth=tile(cand.inv_depth), variance=tile(cand.variance),
        scale2=tile(cand.scale2), nu=tile(cand.nu),
        residual=tile(cand.residual), age=tile(cand.age), x=tile(cand.x),
        p_cam=tile(cand.p_cam), valid=tile(cand.valid) & inb.reshape(-1))
    return tiled, pix.reshape(-1)


def _segment_rank(sorted_ids: torch.Tensor) -> torch.Tensor:
    """rank[i] = i - (first index of sorted_ids[i]'s segment)."""
    n = sorted_ids.shape[0]
    ar = torch.arange(n, device=sorted_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    start_pos = torch.where(is_start, ar, torch.zeros_like(ar))
    return ar - torch.cummax(start_pos, dim=0).values


def _sort_slots(pix, valid, val_key, hw: int):
    """The lexicographic (pixel, value, original index) order of the
    tiled candidates: a stable sort by value, then a stable sort by
    pixel. Invalid candidates key as (hw, inf) and sort last. `val_key`
    broadcasts against `valid` (pix, valid: (M * Kt,) or (M, Kt), read
    in row-major order). Returns (order, pix_sorted), both (M * Kt,)."""
    vk = torch.where(valid, val_key, torch.full_like(val_key, float("inf")))
    pk = torch.where(valid, pix, torch.full_like(pix, hw)).reshape(-1)
    order = torch.sort(vk.reshape(-1), stable=True).indices
    order = order[torch.sort(pk[order], stable=True).indices]
    return order, pk[order]


def _assign_slots(pix, valid, val_key, hw: int, K: int):
    """Slot id per candidate (rank*hw + pix, or hw*K = dropped) from the
    lexicographic (pixel, value, original index) order (``_sort_slots``).
    Returns (slot, num_dropped)."""
    M = pix.shape[0]
    order, pix_sorted = _sort_slots(pix, valid, val_key, hw)
    rank = _segment_rank(pix_sorted)
    keep = (pix_sorted < hw) & (rank < K)
    slot_sorted = torch.where(keep, rank * hw + pix_sorted,
                              torch.full_like(pix_sorted, hw * K))
    slot = torch.empty(M, dtype=torch.int64, device=pix.device)
    slot[order] = slot_sorted
    num_dropped = torch.sum((pix_sorted < hw) & (rank >= K))
    return slot, num_dropped


def run_bounds(pix_sorted, hw: int, K: int):
    """K7's slot placement, plain: each pixel's run [start, end) of
    ``_sort_slots``' order (its slots are the first min(end - start, K)
    entries, in slot order) and num_dropped, the runs' entries past K.
    Both bounds are (hw,) int64 from torch.searchsorted."""
    q = torch.arange(hw, dtype=pix_sorted.dtype, device=pix_sorted.device)
    start = torch.searchsorted(pix_sorted, q)
    end = torch.searchsorted(pix_sorted, q, right=True)
    return start, end, torch.clamp(end - start - K, min=0).sum()


def _student_t_update(invD_a, scale2_a, nu_a, invD_b, scale2_b, nu_b):
    """Student-t posterior of (a <- b); nu = inf takes the Gaussian-product
    limit. Returns (invD, scale2, nu, var)."""
    nu_u = torch.minimum(nu_a, nu_b)
    s_sum = scale2_a + scale2_b
    invD = (scale2_b * invD_a + scale2_a * invD_b) / s_sum
    d2 = (invD_a - invD_b) ** 2
    gauss = scale2_a * scale2_b / s_sum
    finite = torch.isfinite(nu_u)
    nu_safe = torch.where(finite, nu_u, torch.full_like(nu_u, 3.0))
    scale2 = torch.where(
        finite, (nu_safe + d2 / s_sum) / (nu_safe + 1.0) * gauss, gauss)
    nu = torch.where(finite, nu_u + 1.0, nu_u)
    var = torch.where(finite, nu / torch.clamp(nu - 2.0, min=1e-6) * scale2,
                      scale2)
    return invD, scale2, nu, var


def _scatter_slots(slot_idx, src, H: int, W: int, K: int) -> torch.Tensor:
    """(K, H, W) slot planes: src at each kept slot, 0 elsewhere (the
    dropped id hw*K lands in a spare cell that is cut off)."""
    buf = torch.zeros(H * W * K + 1, dtype=src.dtype, device=src.device)
    buf[slot_idx] = src
    return buf[:-1].reshape(K, H, W)


def camera_words(P: torch.Tensor) -> torch.Tensor:
    """The 12 words K7 back-projects with: inv3(P[:, :3]) row-major,
    then P[:, 3] (on P's device: no host copy)."""
    return torch.cat([inv3(P[:, :3]).reshape(-1), P[:, 3]])


def fuse_frame(grid: DepthGrid, cand: Candidates, camera: Camera,
               cfg: FusionConfig):
    """Fuse propagated candidates into the grid: the reference's
    per-pixel rules on the best K candidates per pixel, in
    variance-ascending order. Returns (grid, num_fusions, num_dropped).
    K7's plain twin on every device: ``_assign_slots`` +
    ``fold_slots_plain``."""
    H, W = grid.inv_depth.shape
    K = cfg.max_candidates_per_pixel
    tiled, pix = _splat(cand, H, W, cfg.fusion_radius)
    slot_idx, num_dropped = _assign_slots(pix, tiled.valid, tiled.variance,
                                          H * W, K)
    grid, num_fused = fold_slots_plain(grid, tiled, slot_idx, camera, cfg)
    return grid, num_fused, num_dropped


def fold_slots_plain(grid: DepthGrid, tiled: Candidates, slot_idx,
                     camera: Camera, cfg: FusionConfig):
    """K7's plain twin after ``_assign_slots``: scatter the 8 channels of
    the kept candidates to their (K, H, W) slots, then fold the K slots
    into the grid as (H, W) elementwise math. Returns (grid,
    num_fusions)."""
    H, W = grid.inv_depth.shape
    K = cfg.max_candidates_per_pixel
    dt = tiled.inv_depth.dtype
    buf = [_scatter_slots(slot_idx, a.to(dt), H, W, K) for a in (
        tiled.inv_depth, tiled.variance, tiled.scale2, tiled.nu,
        tiled.residual, tiled.age, tiled.x[:, 0], tiled.x[:, 1])]

    P = camera.params.P
    tdist = cfg.ls_norm == "Tdist"
    num_fused = torch.zeros((), dtype=torch.int64, device=slot_idx.device)
    g = {
        "invD": grid.inv_depth, "var": grid.variance, "s2": grid.scale2,
        "nu": grid.nu, "res": grid.residual, "age": grid.age,
        "x0": grid.x[..., 0], "x1": grid.x[..., 1],
        "p0": grid.p_cam[..., 0], "p1": grid.p_cam[..., 1],
        "p2": grid.p_cam[..., 2],
    }
    Ainv = inv3(P[:, :3])
    b = P[:, 3]

    def back_project_planes(x0, x1, invD):
        z = 1.0 / invD
        r0 = z * x0 - b[0]
        r1 = z * x1 - b[1]
        r2 = z - b[2]
        return (Ainv[0, 0] * r0 + Ainv[0, 1] * r1 + Ainv[0, 2] * r2,
                Ainv[1, 0] * r0 + Ainv[1, 1] * r1 + Ainv[1, 2] * r2,
                Ainv[2, 0] * r0 + Ainv[2, 1] * r1 + Ainv[2, 2] * r2)

    for k in range(K):
        c_invD, c_var, c_s2, c_nu, c_res = (buf[i][k] for i in range(5))
        c_age = buf[5][k].to(torch.int32)
        c_x0, c_x1 = buf[6][k], buf[7][k]
        c_ok = c_invD > 0.0
        c_p0, c_p1, c_p2 = back_project_planes(
            c_x0, c_x1, torch.clamp(c_invD, min=1e-12))
        occ = g["invD"] > _OCC_EPS
        ins = c_ok & ~occ
        pc0, pc1, pc2 = back_project_planes(g["x0"], g["x1"],
                                            torch.clamp(c_invD, min=1e-12))
        if tdist:
            std_g = torch.sqrt(torch.clamp(g["var"], min=0.0))
            std_c = torch.sqrt(torch.clamp(c_var, min=0.0))
            diff = torch.abs(c_invD - g["invD"])
            compat = (diff < 2.0 * std_g) | (diff < 2.0 * std_c)
        else:
            d2 = (c_invD - g["invD"]) ** 2
            compat = (d2 / torch.clamp(c_var, min=1e-20)
                      + d2 / torch.clamp(g["var"], min=1e-20)) < 5.99
        fuse = c_ok & occ & compat
        if tdist:
            f_invD, f_s2, f_nu, f_var = _student_t_update(
                g["invD"], g["s2"], g["nu"], c_invD, c_s2, c_nu)
            f_age = g["age"] + 2   # update_studentT age_++ and fusion age()++
        else:
            vsum = g["var"] + c_var
            f_invD = (g["var"] * c_invD + c_var * g["invD"]) / vsum
            f_var = g["var"] * c_var / vsum
            f_s2 = f_var
            f_nu = g["nu"]
            f_age = g["age"] + 1
        f_var = torch.clamp(f_var, min=1e-6)
        f_res = torch.minimum(g["res"], c_res)
        occluded = (g["invD"]
                    - 2.0 * torch.sqrt(torch.clamp(g["var"], min=0.0))) \
            > c_invD
        repl = (c_ok & occ & ~compat & ~occluded
                & (c_var < g["var"]) & (c_res < g["res"]))

        def pick(ins_v, fuse_v, repl_v, keep_v):
            out = torch.where(ins, ins_v, keep_v)
            out = torch.where(fuse, fuse_v, out)
            return torch.where(repl, repl_v, out)

        g = {
            "invD": pick(c_invD, f_invD, c_invD, g["invD"]),
            "var": pick(torch.clamp(c_var, min=1e-6), f_var, c_var, g["var"]),
            "s2": pick(c_s2, f_s2, c_s2, g["s2"]),
            "nu": pick(c_nu, f_nu, c_nu, g["nu"]),
            "res": pick(c_res, f_res, c_res, g["res"]),
            "age": pick(c_age, f_age, c_age, g["age"]),
            # insert keeps the pixel-centre x; replace adopts the
            # candidate's sub-pixel x
            "x0": pick(g["x0"], g["x0"], c_x0, g["x0"]),
            "x1": pick(g["x1"], g["x1"], c_x1, g["x1"]),
            "p0": pick(pc0, pc0, c_p0, g["p0"]),
            "p1": pick(pc1, pc1, c_p1, g["p1"]),
            "p2": pick(pc2, pc2, c_p2, g["p2"]),
        }
        num_fused = num_fused + torch.sum(fuse)

    grid = DepthGrid(
        inv_depth=g["invD"], variance=g["var"], scale2=g["s2"], nu=g["nu"],
        residual=g["res"], age=g["age"],
        x=torch.stack([g["x0"], g["x1"]], dim=-1),
        p_cam=torch.stack([g["p0"], g["p1"], g["p2"]], dim=-1))
    return grid, num_fused


def naive_fuse_frame(grid: DepthGrid, cand: Candidates, camera: Camera,
                     cfg: FusionConfig) -> DepthGrid:
    """Naive propagation fusion: insert if empty; else keep the closer
    point unless the candidate has a lower residual."""
    H, W = grid.inv_depth.shape
    K = cfg.max_candidates_per_pixel
    tiled, pix = _splat(cand, H, W, 0)
    slot_idx, _ = _assign_slots(pix, tiled.valid, tiled.residual, H * W, K)
    dt = tiled.inv_depth.dtype
    buf = [_scatter_slots(slot_idx, a.to(dt), H, W, K) for a in (
        tiled.inv_depth, tiled.variance, tiled.residual, tiled.age,
        tiled.x[:, 0], tiled.x[:, 1])]
    P = camera.params.P
    for k in range(K):
        c_invD = buf[0][k]
        c_ok = c_invD > 0.0
        c_var, c_res = buf[1][k], buf[2][k]
        c_age = buf[3][k].to(torch.int32)
        c_x = torch.stack([buf[4][k], buf[5][k]], dim=-1)
        c_p = cam_to_world(P, c_x, torch.clamp(c_invD, min=1e-12))
        occ = grid.occupied
        ins = c_ok & ~occ
        repl = c_ok & occ & ~(grid.inv_depth > c_invD) \
            & (c_res < grid.residual)
        take = ins | repl
        p_center = cam_to_world(P, grid.x, torch.clamp(c_invD, min=1e-12))
        var_c = torch.clamp(c_var, min=1e-6)
        grid = DepthGrid(
            inv_depth=torch.where(take, c_invD, grid.inv_depth),
            variance=torch.where(take, var_c, grid.variance),
            scale2=torch.where(take, var_c, grid.scale2),
            nu=torch.where(take, torch.full_like(c_var, float("inf")),
                           grid.nu),
            residual=torch.where(take, c_res, grid.residual),
            age=torch.where(take, c_age, grid.age),
            x=grid.x,
            p_cam=torch.where(take[..., None],
                              torch.where(ins[..., None], p_center, c_p),
                              grid.p_cam))
    return grid


def clean_grid(grid: DepthGrid, var_threshold: float, age_threshold: int,
               inv_depth_max: float, inv_depth_min: float) -> DepthGrid:
    """Remove points failing the DepthPoint validity predicate; removed
    cells get their pixel-centre x back."""
    ok = (grid.occupied & (grid.age >= age_threshold)
          & (grid.variance <= var_threshold)
          & (grid.inv_depth <= inv_depth_max)
          & (grid.inv_depth >= inv_depth_min))
    H, W = grid.inv_depth.shape
    centers = _centers(H, W, grid.x.dtype, grid.x.device)
    return grid.replace(
        inv_depth=torch.where(ok, grid.inv_depth,
                              torch.full_like(grid.inv_depth, EMPTY)),
        x=torch.where(ok[..., None], grid.x, centers))


def grid_points_world(grid: DepthGrid, T_world_frame: torch.Tensor):
    """All grid points in world coordinates + the occupancy mask."""
    p = torch.einsum("ij,hwj->hwi", T_world_frame[:3, :3], grid.p_cam) \
        + T_world_frame[:3, 3]
    return p, grid.occupied
