"""Keyframe graph: multi-view point association feeding the BA backend
(port of esvo_tpu/backend/keyframes.py).

Keyframes collect (pose, observed map points); points seen from several
keyframes are associated by voxel-hashed world-space proximity, giving
the observation graph that ``bundle_adjustment`` refines. Association is
host-side numpy (the per-keyframe point counts are small); the BA runs
on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from esvo_tpu_torch._device import resolve_device
from esvo_tpu_torch.backend.bundle_adjustment import BAProblem


@dataclasses.dataclass
class KeyframeGraph:
    """Accumulates keyframes + associated points."""
    fx: float
    fy: float
    cx: float
    cy: float
    voxel_size: float = 0.05

    def __post_init__(self):
        self.poses: list[np.ndarray] = []
        self.points: list[np.ndarray] = []     # world xyz per point id
        self.obs: list[tuple[int, int, float, float]] = []
        self._voxels: dict[tuple[int, int, int], int] = {}

    def _find_or_add_point(self, p: np.ndarray) -> int:
        key = tuple(np.floor(p / self.voxel_size).astype(int))
        idx = self._voxels.get(key)
        if idx is None:
            idx = len(self.points)
            self.points.append(p)
            self._voxels[key] = idx
        return idx

    def add_keyframe(self, T_world_kf: np.ndarray, pts_world: np.ndarray,
                     uv: np.ndarray, valid: np.ndarray) -> int:
        """Register a keyframe with its observed points.

        pts_world: (N, 3) points in world coordinates; uv: (N, 2) measured
        pixel of each point in this keyframe. Returns the keyframe index.
        """
        k = len(self.poses)
        self.poses.append(np.asarray(T_world_kf, np.float64))
        for p, (u, v), ok in zip(np.asarray(pts_world),
                                 np.asarray(uv), np.asarray(valid)):
            if not ok:
                continue
            i = self._find_or_add_point(p)
            self.obs.append((k, i, float(u), float(v)))
        return k

    @property
    def num_keyframes(self) -> int:
        return len(self.poses)

    @property
    def num_points(self) -> int:
        return len(self.points)

    def multiview_fraction(self) -> float:
        """Fraction of points observed in >= 2 DISTINCT keyframes
        (same-voxel duplicates within one keyframe constrain nothing
        across views)."""
        seen = set()
        kf_counts = np.zeros(len(self.points), int)
        for k, i, _, _ in self.obs:
            if (k, i) not in seen:
                seen.add((k, i))
                kf_counts[i] += 1
        return float((kf_counts >= 2).mean()) if len(kf_counts) else 0.0


def build_ba_problem(graph: KeyframeGraph, max_points: int | None = None,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> BAProblem:
    """Pack the graph into a fixed-shape BAProblem on `device` (``cuda``
    unless given), in `dtype` (the JAX package's default float: float32,
    float64 under jax_enable_x64)."""
    K = graph.num_keyframes
    if K == 0:
        raise ValueError("build_ba_problem: graph has no keyframes")
    pts = np.asarray(graph.points, np.float64).reshape(-1, 3)
    # explicit (0, 4) shape: an empty obs list yields an empty problem
    obs = np.asarray([(k, i, u, v) for (k, i, u, v) in graph.obs],
                     np.float64).reshape(-1, 4)
    if max_points is not None and len(pts) > max_points:
        # keep the most-observed points
        counts = np.zeros(len(pts), int)
        for k, i, *_ in graph.obs:
            counts[int(i)] += 1
        keep = np.argsort(-counts)[:max_points]
        remap = -np.ones(len(pts), int)
        remap[keep] = np.arange(len(keep))
        pts = pts[keep]
        sel = remap[obs[:, 1].astype(int)] >= 0
        obs = obs[sel]
        obs[:, 1] = remap[obs[:, 1].astype(int)]
    M = len(obs)
    # bucketed shapes, as the JAX package pads them: points to max_points
    # (when capped) and observations to the next multiple of 1024
    # (obs_valid=False lanes; zero-observation padded points take a zero
    # step under the damped diagonals)
    P = len(pts)
    if max_points is not None and P < max_points:
        pts = np.concatenate(
            [pts, np.tile([[0.0, 0.0, 1e3]], (max_points - P, 1))])
    Mp = max(((M + 1023) // 1024) * 1024, 1024)
    valid = np.zeros(Mp, bool)
    valid[:M] = True
    obs_pad = np.zeros((Mp, 4))
    obs_pad[:M] = obs
    dev = resolve_device(device)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    i = lambda a: torch.as_tensor(a.astype(np.int64), device=dev)
    return BAProblem(
        T_world_kf=f(np.stack(graph.poses)), points=f(pts),
        obs_kf=i(obs_pad[:, 0]), obs_point=i(obs_pad[:, 1]),
        obs_uv=f(obs_pad[:, 2:4]),
        obs_valid=torch.as_tensor(valid, device=dev),
        fx=f(graph.fx), fy=f(graph.fy), cx=f(graph.cx), cy=f(graph.cy))
