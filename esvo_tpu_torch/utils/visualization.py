"""False-colour map rendering of depth-map state (a numpy copy of
esvo_tpu/utils/visualization.py): inverse-depth, standard deviation, age
and cost maps through a 256-entry jet colormap, the tracker's
reprojection overlay and binary event maps, as (H, W, 3) or (H, W) uint8
arrays.
"""
from __future__ import annotations

import numpy as np


def jet_colormap() -> np.ndarray:
    """256 x 3 uint8 jet table (matches the classic OpenCV/Matlab jet ramp
    used by the reference's hard-coded r/g/b tables,
    Visualization.cpp:12-104)."""
    x = np.linspace(0.0, 1.0, 256)

    def ramp(v):
        return np.clip(1.5 - np.abs(v), 0.0, 1.0)

    r = ramp(4.0 * (x - 0.75))
    g = ramp(4.0 * (x - 0.50))
    b = ramp(4.0 * (x - 0.25))
    return (np.stack([r, g, b], axis=1) * 255).astype(np.uint8)


_JET = jet_colormap()


def _colorize(values: np.ndarray, valid: np.ndarray, vmin: float,
              vmax: float, background: int = 255) -> np.ndarray:
    # invalid cells can hold garbage incl. NaN — sanitize BEFORE the
    # table lookup (NaN would cast to INT32_MIN and index out of bounds)
    v = np.nan_to_num((values - vmin) / max(vmax - vmin, 1e-12), nan=0.0,
                      posinf=1.0, neginf=0.0)
    idx = np.clip((v * 255).astype(np.int32), 0, 255)
    img = _JET[idx]
    img = np.where(valid[..., None], img, np.uint8(background))
    return img.astype(np.uint8)


def plot_inv_depth_map(inv_depth: np.ndarray, valid: np.ndarray,
                       inv_depth_min: float, inv_depth_max: float):
    """Reference: plot_map(..., InvDepthMap, ...)
    (Visualization.cpp:128-160)."""
    return _colorize(np.asarray(inv_depth), np.asarray(valid),
                     inv_depth_min, inv_depth_max)


def plot_std_var_map(variance: np.ndarray, valid: np.ndarray,
                     std_var_threshold: float):
    return _colorize(np.sqrt(np.maximum(np.asarray(variance), 0.0)),
                     np.asarray(valid), 0.0, std_var_threshold)


def plot_age_map(age: np.ndarray, valid: np.ndarray, age_max: int):
    return _colorize(np.asarray(age).astype(np.float64), np.asarray(valid),
                     0.0, float(age_max))


def plot_cost_map(residual: np.ndarray, valid: np.ndarray,
                  cost_threshold: float):
    return _colorize(np.asarray(residual), np.asarray(valid), 0.0,
                     cost_threshold)


def plot_reprojection_map(pts_world: np.ndarray, valid: np.ndarray,
                          T_cam_world: np.ndarray, P: np.ndarray,
                          height: int, width: int,
                          background: np.ndarray | None = None):
    """Tracking reprojection overlay (reference solve visualization,
    RegProblemSolverLM.cpp:106-136): map points projected into the current
    camera drawn in green over the (negative) time surface (or white).

    pts_world: (M, 3); T_cam_world: current camera from world; P: (3, 4).
    background: optional (H, W) grayscale image.
    """
    if background is None:
        img = np.full((height, width, 3), 255, np.uint8)
    else:
        g = np.asarray(background).astype(np.uint8)
        img = np.stack([g, g, g], axis=-1)
    p = np.asarray(pts_world)[np.asarray(valid).astype(bool)]
    if len(p):
        pc = p @ np.asarray(T_cam_world)[:3, :3].T \
            + np.asarray(T_cam_world)[:3, 3]
        h = pc @ np.asarray(P)[:, :3].T + np.asarray(P)[:, 3]
        z = h[:, 2]
        ok = z > 1e-6
        # floor, not int-cast: truncation maps u in (-1, 0) onto column
        # 0 instead of rejecting it off-image (and biases positions)
        u = np.floor(h[:, 0] / np.maximum(z, 1e-6)).astype(np.int64)
        v = np.floor(h[:, 1] / np.maximum(z, 1e-6)).astype(np.int64)
        ok &= (u >= 0) & (u < width) & (v >= 0) & (v < height)
        img[v[ok], u[ok]] = (0, 255, 0)
    return img


def plot_event_map(x: np.ndarray, y: np.ndarray, valid: np.ndarray,
                   height: int, width: int) -> np.ndarray:
    """Binary event map (plot_eventMap, Visualization.cpp:96-125):
    white background, black events."""
    img = np.full((height, width), 255, np.uint8)
    ok = (np.asarray(valid) & (x >= 0) & (x < width) & (y >= 0)
          & (y < height))
    img[y[ok], x[ok]] = 0
    return img
