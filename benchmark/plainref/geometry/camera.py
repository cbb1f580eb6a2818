"""Frozen copy of esvo_tpu_torch/geometry/camera.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

Camera models, rectification maps and projections
(port of esvo_tpu/geometry/camera.py).

Supported distortion models: ``plumb_bob`` (radial-tangential, 4 or 5
coefficients) and ``equidistant`` (fisheye, 4 coefficients). The
containers are plain dataclasses of tensors with the JAX package's field
names.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from plainref._device import resolve_device
from plainref.ops.remap import remap_plain


@dataclass
class PinholeParams:
    K: torch.Tensor       # (3, 3) intrinsics of the raw sensor
    D: torch.Tensor       # (4,) or (5,) distortion coefficients
    R: torch.Tensor       # (3, 3) rectification rotation
    P: torch.Tensor       # (3, 4) projection of the rectified camera
    width: int
    height: int
    model: str = "plumb_bob"


@dataclass
class Camera:
    params: PinholeParams
    lut: torch.Tensor       # (H, W, 2) raw pixel -> rectified (x, y)
    inv_map: torch.Tensor   # (H, W, 2) rectified pixel -> raw (x, y)
    mask: torch.Tensor      # (H, W) bool; valid rectified pixels

    @property
    def width(self) -> int:
        return self.params.width

    @property
    def height(self) -> int:
        return self.params.height


@dataclass
class StereoRig:
    left: Camera
    right: Camera
    T_right_left: torch.Tensor   # (4, 4)
    baseline: torch.Tensor       # scalar


# ---------------------------------------------------------------------------
# distortion models
# ---------------------------------------------------------------------------

def _distort_normalized(model: str, D: torch.Tensor,
                        xy: torch.Tensor) -> torch.Tensor:
    """Apply lens distortion to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    if model == "plumb_bob":
        k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
        k3 = D[4] if D.shape[0] > 4 else 0.0
        r2 = x * x + y * y
        cdist = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * cdist + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * cdist + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([xd, yd], dim=-1)
    if model == "equidistant":
        k1, k2, k3, k4 = D[0], D[1], D[2], D[3]
        r = torch.sqrt(x * x + y * y)
        theta = torch.arctan(r)
        t2 = theta * theta
        theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8),
                            torch.ones_like(r))
        return torch.stack([x * scale, y * scale], dim=-1)
    raise ValueError(f"unsupported distortion model: {model}")


def _undistort_normalized(model: str, D: torch.Tensor, xy: torch.Tensor,
                          iters: int = 10) -> torch.Tensor:
    """Invert lens distortion on normalized coords (fixed point / Newton)."""
    x0, y0 = xy[..., 0], xy[..., 1]
    if model == "plumb_bob":
        k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
        k3 = D[4] if D.shape[0] > 4 else 0.0
        x, y = x0, y0
        for _ in range(iters):
            r2 = x * x + y * y
            icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (x0 - dx) * icdist
            y = (y0 - dy) * icdist
        return torch.stack([x, y], dim=-1)
    if model == "equidistant":
        k1, k2, k3, k4 = D[0], D[1], D[2], D[3]
        theta_d = torch.sqrt(x0 * x0 + y0 * y0)
        theta = theta_d
        for _ in range(iters):
            t2 = theta * theta
            f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) \
                - theta_d
            df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3
                                                           + t2 * 9 * k4)))
            theta = theta - f / df
        scale = torch.where(theta_d > 1e-8,
                            torch.tan(theta) / torch.clamp(theta_d, min=1e-8),
                            torch.ones_like(theta_d))
        return torch.stack([x0 * scale, y0 * scale], dim=-1)
    raise ValueError(f"unsupported distortion model: {model}")


# ---------------------------------------------------------------------------
# point rectification
# ---------------------------------------------------------------------------

def undistort_points(params: PinholeParams, pts: torch.Tensor) -> torch.Tensor:
    """Raw pixel coords (..., 2) -> rectified pixel coords (..., 2)
    (cv::undistortPoints with K, D, R, P)."""
    K, D, R, P = params.K, params.D, params.R, params.P
    x = (pts[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts[..., 1] - K[1, 2]) / K[1, 1]
    xy = _undistort_normalized(params.model, D, torch.stack([x, y], dim=-1))
    h = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    r = torch.einsum("ij,...j->...i", R, h)
    xn = r[..., 0] / r[..., 2]
    yn = r[..., 1] / r[..., 2]
    u = P[0, 0] * xn + P[0, 1] * yn + P[0, 2]
    v = P[1, 0] * xn + P[1, 1] * yn + P[1, 2]
    return torch.stack([u, v], dim=-1)


def distort_points(params: PinholeParams,
                   pts_rect: torch.Tensor) -> torch.Tensor:
    """Rectified pixel coords (..., 2) -> raw pixel coords (..., 2)
    (the per-pixel map of cv::initUndistortRectifyMap)."""
    K, D, R, P = params.K, params.D, params.R, params.P
    iR = torch.linalg.inv(P[:, :3] @ R)
    h = torch.cat([pts_rect, torch.ones_like(pts_rect[..., :1])], dim=-1)
    r = torch.einsum("ij,...j->...i", iR, h)
    xy = r[..., :2] / r[..., 2:3]
    xyd = _distort_normalized(params.model, D, xy)
    u = K[0, 0] * xyd[..., 0] + K[0, 2]
    v = K[1, 1] * xyd[..., 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)


def _pixel_grid(width: int, height: int, like: torch.Tensor) -> torch.Tensor:
    xs = torch.arange(width, dtype=like.dtype, device=like.device)
    ys = torch.arange(height, dtype=like.dtype, device=like.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)            # (H, W, 2)


def rectification_lut(params: PinholeParams) -> torch.Tensor:
    """(H, W, 2): for every raw pixel, its rectified coordinate."""
    return undistort_points(params,
                            _pixel_grid(params.width, params.height, params.K))


def inverse_rectification_map(params: PinholeParams) -> torch.Tensor:
    """(H, W, 2): for every rectified pixel, the raw coordinate to sample."""
    return distort_points(params,
                          _pixel_grid(params.width, params.height, params.K))


def remap_bilinear(img: torch.Tensor, map_xy: torch.Tensor,
                   fill: float = 0.0) -> torch.Tensor:
    """Bilinear resampling img (H, W) at map_xy (..., 2); out-of-bounds
    taps produce `fill` (cv::remap BORDER_CONSTANT): K3's plain twin."""
    return remap_plain(img, map_xy, fill)


def remap_bilinear_pair(img_a: torch.Tensor, map_a: torch.Tensor,
                        img_b: torch.Tensor, map_b: torch.Tensor,
                        fill: float = 0.0):
    """remap_bilinear on two cameras' images. Returns (a, b)."""
    return (remap_bilinear(img_a, map_a, fill),
            remap_bilinear(img_b, map_b, fill))


def valid_pixel_mask(params: PinholeParams,
                     inv_map: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W) bool: rectified pixels fully covered by the raw sensor
    (remap an all-ones image; threshold 0.999 plumb_bob, 0.1
    equidistant)."""
    inv = inverse_rectification_map(params) if inv_map is None else inv_map
    ones = torch.ones((params.height, params.width), dtype=inv.dtype,
                      device=inv.device)
    remapped = remap_bilinear(ones, inv, fill=0.0)
    thr = 0.999 if params.model == "plumb_bob" else 0.1
    return remapped > thr


def make_camera(params: PinholeParams) -> Camera:
    inv = inverse_rectification_map(params)
    return Camera(params=params, lut=rectification_lut(params), inv_map=inv,
                  mask=valid_pixel_mask(params, inv))


# ---------------------------------------------------------------------------
# projection (rectified frame)
# ---------------------------------------------------------------------------

def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of a 3x3 matrix."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e]),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f]),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d]),
    ])
    det = a * co[0, 0] + b * co[1, 0] + c * co[2, 0]
    return co / det


def cam_to_world(P: torch.Tensor, x: torch.Tensor, inv_depth) -> torch.Tensor:
    """Back-project rectified pixels x (..., 2) at inverse depth (...,) to
    3D points (..., 3): p = A^-1 (z [u, v, 1] - b) with P = [A | b]."""
    inv_depth = torch.as_tensor(inv_depth, dtype=x.dtype, device=x.device)
    z = 1.0 / inv_depth
    xh = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    rhs = z[..., None] * xh - P[:, 3]
    return torch.einsum("ij,...j->...i", inv3(P[:, :3]), rhs)


def world_to_cam(P: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Project 3D points (..., 3) in the rectified camera frame to pixels
    (..., 2)."""
    h = torch.einsum("ij,...j->...i", P[:, :3], p) + P[:, 3]
    return h[..., :2] / h[..., 2:3]


# ---------------------------------------------------------------------------
# constructors / loaders
# ---------------------------------------------------------------------------

def make_ideal_camera(width: int, height: int, fx: float, fy: float,
                      cx: float, cy: float, tx: float = 0.0,
                      dtype=torch.float32, device=None) -> Camera:
    """Distortion-free camera whose raw and rectified frames coincide;
    tx = P[0, 3] = -fx * baseline for the right camera of a pair."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], **kw)
    P = torch.tensor([[fx, 0, cx, tx], [0, fy, cy, 0], [0, 0, 1, 0]], **kw)
    params = PinholeParams(K=K, D=torch.zeros(4, **kw),
                           R=torch.eye(3, **kw), P=P, width=width,
                           height=height, model="plumb_bob")
    return make_camera(params)


def make_ideal_rig(width: int, height: int, fx: float, fy: float,
                   cx: float, cy: float, baseline: float,
                   dtype=torch.float32, device=None) -> StereoRig:
    left = make_ideal_camera(width, height, fx, fy, cx, cy, dtype=dtype,
                             device=device)
    right = make_ideal_camera(width, height, fx, fy, cx, cy,
                              tx=-fx * baseline, dtype=dtype, device=device)
    T_rl = torch.eye(4, dtype=dtype, device=left.lut.device)
    T_rl[0, 3] = -baseline
    return StereoRig(left=left, right=right, T_right_left=T_rl,
                     baseline=torch.tensor(baseline, dtype=dtype,
                                           device=left.lut.device))


def load_camera_yaml(path: str, dtype=torch.float32, device=None) -> Camera:
    """Load an ESVO-format calibration yaml (left.yaml / right.yaml)."""
    import yaml
    with open(path) as f:
        info = yaml.safe_load(f)
    kw = dict(dtype=dtype, device=resolve_device(device))

    def mat(key, shape):
        return torch.tensor(np.array(info[key]["data"], dtype=np.float64)
                            .reshape(shape), **kw)

    D = np.array(info["distortion_coefficients"]["data"],
                 dtype=np.float64).reshape(-1)
    # zero-pad short coefficient lists; keep a 5th plumb_bob coefficient
    D = np.pad(D[:5], (0, max(0, 5 - len(D))))
    params = PinholeParams(
        K=mat("camera_matrix", (3, 3)), D=torch.tensor(D, **kw),
        R=mat("rectification_matrix", (3, 3)),
        P=mat("projection_matrix", (3, 4)),
        width=int(info["image_width"]), height=int(info["image_height"]),
        model=str(info["distortion_model"]))
    return make_camera(params)


def load_rig(calib_dir: str, dtype=torch.float32, device=None) -> StereoRig:
    """Load a stereo rig from a calib directory holding left.yaml and
    right.yaml; baseline = |P_right[:, :3]^-1 P_right[:, 3]|."""
    import yaml
    left = load_camera_yaml(os.path.join(calib_dir, "left.yaml"), dtype,
                            device)
    right = load_camera_yaml(os.path.join(calib_dir, "right.yaml"), dtype,
                             device)
    with open(os.path.join(calib_dir, "left.yaml")) as f:
        info = yaml.safe_load(f)
    T = np.eye(4)
    T[:3, :] = np.array(info["T_right_left"]["data"],
                        dtype=np.float64).reshape(3, 4)
    Pr = right.params.P.double().cpu().numpy()
    baseline = float(np.linalg.norm(np.linalg.inv(Pr[:, :3]) @ Pr[:, 3]))
    dev = left.lut.device
    return StereoRig(left=left, right=right,
                     T_right_left=torch.tensor(T, dtype=dtype, device=dev),
                     baseline=torch.tensor(baseline, dtype=dtype, device=dev))
